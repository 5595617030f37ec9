"""Two-layer phase retrieval: modulus MID-GRAPH.

    x (complex, sparse-ish) -> W1 (complex) -> |.| -> W2 (real) -> + noise -> y

This model is IMPOSSIBLE in the reference: its ModulusChannel posteriors
raise NotImplementedError (tramp/channels/activation/modulus_channel.py:29-37)
so modulus can only sit at the leaf (observed). tramp_tpu implements the
posteriors via radial quadrature of the phase-integrated tilted density
(tramp_tpu/channels/modulus_channel.py), unlocking modulus anywhere in the
tree. EP recovers x up to a global phase.

Usage:
  JAX_PLATFORMS=cpu python examples/glm/two_layer_phase_retrieval.py [--big]
"""
import argparse
import os

import numpy as np
import jax
import jax.numpy as jnp

import tramp_tpu as tt
from tramp_tpu.priors import GaussianPrior
from tramp_tpu.channels import (
    ComplexLinearChannel, LinearChannel, ModulusChannel, GaussianChannel)


def build(N, M1, M2, noise_var, key):
    k1, k2 = jax.random.split(key)
    W1 = (jax.random.normal(k1, (M1, N)) +
          1j * jax.random.normal(jax.random.fold_in(k1, 1), (M1, N))
          ) / jnp.sqrt(2 * N)
    W2 = jax.random.normal(k2, (M2, M1)) / jnp.sqrt(M1)
    teacher = (
        GaussianPrior(size=(2, N), mean=0.3) @ tt.V(id="x") @
        ComplexLinearChannel(W1, name="W_1") @ tt.V(id="z") @
        ModulusChannel() @ tt.V(id="a") @
        LinearChannel(W2, name="W_2") @ tt.V(id="u") @
        GaussianChannel(var=noise_var) @ tt.O(id="y")
    ).to_model()
    return teacher


def phase_mse(xhat, x0):
    "MSE up to a global phase (reference algos/metrics.py phase_mse)."
    xh = xhat[0] + 1j * xhat[1]
    x = x0[0] + 1j * x0[1]
    ip = np.vdot(xh.ravel(), x.ravel())
    phase = ip / max(abs(ip), 1e-30)
    return float(np.mean(np.abs(x - phase * xh) ** 2) / 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--big", action="store_true")
    args = ap.parse_args()
    N = 256 if args.big else 64
    M1, M2 = 3 * N, 3 * N
    teacher = build(N, M1, M2, 1e-4, jax.random.PRNGKey(0))
    sample = teacher.sample(jax.random.PRNGKey(1))
    student = teacher.to_observed({"y": sample["y"]})
    ep = tt.ExpectationPropagation(student)
    ep.iterate(max_iter=300, damping=0.3)
    d = ep.get_variable_data("x")
    mse = phase_mse(np.asarray(d["r"]), np.asarray(sample["x"]))
    tau = float(np.mean(np.asarray(sample["x"]) ** 2))
    print(f"N={N} M1={M1} M2={M2}: phase-mse={mse:.2e} "
          f"(tau_x={tau:.3f}, v={float(np.mean(np.asarray(d['v']))):.2e})")
    out = os.path.join(os.path.dirname(__file__), "output",
                       "two_layer_pr.csv")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(out, "w") as f:
        f.write("N,M1,M2,phase_mse,v\n")
        f.write(f"{N},{M1},{M2},{mse},{float(np.mean(np.asarray(d['v'])))}\n")


if __name__ == "__main__":
    main()
