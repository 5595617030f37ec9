"""Production fast paths: dispatch_solver + the gated bf16 throughput mode.

Demonstrates the round-4 production surface on two models:

1. a compressed-sensing GLM — dispatch routes to `SpectralVAMPSolver`
   (LMMSE fully in the SVD basis);
2. a two-layer relu network — dispatch routes to `MLVAMPSolver`
   (spectral-cached interior linear factor);

and the two-phase convergence-gated bf16 solve (`solve_gated_bf16`):
bf16-state sweeps to a coarse gate, one upcast, f32 polish to tol=1e-6.

Run: JAX_PLATFORMS=cpu python examples/glm/fast_paths.py (or on a GPU
with no JAX_PLATFORMS). Reference protocol analog:
examples/figures/compute_benchmark.py:16-70 (no fast path exists there).
"""
import numpy as np
import jax
import jax.numpy as jnp

import tramp_tpu as tt
from tramp_tpu.priors import GaussBernoulliPrior
from tramp_tpu.channels import LinearChannel, GaussianChannel, ReluChannel
from tramp_tpu.parallel import (EPSolver, dispatch_solver,
                                SpectralVAMPSolver, MLVAMPSolver)


def build_glm(N=1000, alpha=0.5, rho=0.25, noise=1e-2, seed=0):
    rng = np.random.RandomState(seed)
    W = rng.randn(int(alpha * N), N) / np.sqrt(N)
    teacher = (GaussBernoulliPrior(size=N, rho=rho) @ tt.V(id="x") @
               LinearChannel(jnp.asarray(W, jnp.float32)) @ tt.V(id="z") @
               GaussianChannel(var=noise) @ tt.O(id="y")).to_model()
    sample = teacher.sample(jax.random.PRNGKey(seed + 1))
    student = teacher.to_observed(
        {"y": jnp.asarray(sample["y"], jnp.float32)})
    return student, np.asarray(sample["x"])


def build_relu_net(N=1024, alpha=0.5, rho=0.25, noise=1e-2, seed=1):
    rng = np.random.RandomState(seed)
    W = rng.randn(int(alpha * N), N) / np.sqrt(N)
    x0 = (rng.rand(N) < rho) * rng.randn(N)
    y = np.maximum(W @ x0, 0.0) + np.sqrt(noise) * rng.randn(int(alpha * N))
    student = (GaussBernoulliPrior(size=N, rho=rho) @ tt.V(id="x") @
               LinearChannel(jnp.asarray(W, jnp.float32), name="W") @
               tt.V(id="z") @
               ReluChannel() @ tt.V(id="a") @
               GaussianChannel(var=noise) @ tt.O(id="y")
               ).to_model().to_observed(
                   {"y": jnp.asarray(y, jnp.float32)})
    return student, x0


def main():
    # 1. GLM: dispatched -> SpectralVAMP; engine as control
    student, x0 = build_glm()
    solver = dispatch_solver(student, max_iter=300, tol=1e-6)
    assert isinstance(solver, SpectralVAMPSolver)
    post, n_iter = solver.solve(student)
    mse = float(np.mean((np.asarray(post["x"]["r"]) - x0) ** 2))
    ep = EPSolver(student, damping=0.1, max_iter=300, tol=1e-6)
    post_ep, _ = ep.solve(student)
    mse_ep = float(np.mean((np.asarray(post_ep["x"]["r"]) - x0) ** 2))
    print(f"GLM    dispatch={type(solver).__name__:<20} "
          f"n_iter={int(n_iter):3d} mse={mse:.5f} (engine mse={mse_ep:.5f})")

    # 2. relu net: dispatched -> MLVAMP
    relu, x0r = build_relu_net()
    solver = dispatch_solver(relu, damping=0.1, max_iter=300, tol=1e-6)
    assert isinstance(solver, MLVAMPSolver)
    post, n_iter = solver.solve(relu)
    mse = float(np.mean((np.asarray(post["x"]["r"]) - x0r) ** 2))
    print(f"relu   dispatch={type(solver).__name__:<20} "
          f"n_iter={int(n_iter):3d} mse={mse:.5f}")

    # 3. gated bf16 throughput mode: tol=1e-6 convergence with bf16 sweeps
    post_g, n_tot, conv, info = ep.solve_gated_bf16(student)
    v_g = float(np.mean(np.asarray(post_g["x"]["v"])))
    v_f = float(np.mean(np.asarray(post_ep["x"]["v"])))
    print(f"gated  bf16_sweeps={info['n_iter_bf16']} "
          f"f32_polish={info['n_iter_f32']} conv={bool(conv)} "
          f"v_rel_err_vs_f32={abs(v_g - v_f) / v_f:.2e}")


if __name__ == "__main__":
    main()
