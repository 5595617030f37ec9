"""Large (alpha, rho) phase diagram: the whole grid as ONE vmapped,
mesh-sharded SE solve.

The reference computes phase diagrams with a sequential python loop over
grid points (tramp/experiments/multiple_experiments.py:30-49). Here every
(alpha, rho) point is a leaf-slice of one stacked Model pytree: alpha is a
traced leaf of MarchenkoPasturChannel and rho of GaussBernoulliPrior, so
the full grid runs as a single fused while_loop, sharded over the device
mesh ('data' axis = grid points).

Run on CPU with a virtual mesh:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/figures/phase_diagram_sweep.py
"""
import argparse
import os
import time

import numpy as np
import jax
jax.config.update("jax_enable_x64", True)  # SE needs f64 quadrature accuracy

from tramp_tpu import glm_state_evolution
from tramp_tpu.parallel import (
    SESolver, stack_pytrees, make_mesh, shard_batched_model)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--big", action="store_true")
    args = p.parse_args()
    n_a, n_r = (40, 25) if args.big else (12, 8)
    alphas = np.linspace(0.05, 1.0, n_a)
    rhos = np.linspace(0.05, 0.8, n_r)

    grid = [(a, r) for a in alphas for r in rhos]
    models = [
        glm_state_evolution(
            alpha=a, prior_type="gauss_bernoulli", output_type="gaussian",
            prior_rho=r, output_var=1e-11)
        for a, r in grid
    ]
    stacked = stack_pytrees(models)

    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev, 1), ("data", "model"))
    # pad the grid to a multiple of the mesh for even sharding
    pad = (-len(grid)) % n_dev
    if pad:
        padded = stack_pytrees(models + models[:pad])
    else:
        padded = stacked
    padded = shard_batched_model(padded, mesh)

    solver = SESolver(models[0], max_iter=200, tol=1e-6)
    t0 = time.perf_counter()
    with mesh:
        post, n_iter = solver.solve_batch(padded)
        jax.block_until_ready(post)
    dt = time.perf_counter() - t0
    v = np.asarray(post["x"]["v"])[: len(grid)]
    print(f"{len(grid)} grid points on {n_dev} devices in {dt:.2f}s "
          f"({len(grid) / dt:.1f} points/s)")

    out = os.path.join(os.path.dirname(__file__), "output")
    os.makedirs(out, exist_ok=True)
    rows = ["alpha,rho,v_SE"]
    for (a, r), vi in zip(grid, v):
        rows.append(f"{a},{r},{float(np.mean(vi))}")
    csv = os.path.join(out, "phase_diagram.csv")
    with open(csv, "w") as f:
        f.write("\n".join(rows) + "\n")
    print(f"wrote {csv}")


if __name__ == "__main__":
    main()
