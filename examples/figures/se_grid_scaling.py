"""Mesh-scaling measurement (the BASELINE "near-linear multi-device
scaling" evidence, SURVEY.md §2.10 / §5.8).

Two measurements per mesh size (1, 2, 4, 8 devices):

1. **Per-device compiled FLOPs** of the sharded batched EP solve (XLA cost
   analysis of the post-SPMD-partitioned per-device executable). This is
   the hardware-independent scaling number: on a virtual CPU mesh the
   "devices" share the host's physical cores, so wall-clock cannot speed
   up, but per-device work dropping as 1/n proves the partitioner
   distributes the batch linearly (collectives only at the convergence
   reduction).
2. **Wall-clock SE phase-grid points/s**, honest but bounded by the host's
   physical core count on a virtual mesh (recorded in the JSON).

The reference computes such grids with a sequential Python loop
(tramp/experiments/multiple_experiments.py:38-47).

Usage:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python examples/figures/se_grid_scaling.py [--out SCALING.json]
"""
import argparse
import json
import os
import time

import numpy as np
import jax
import jax.numpy as jnp

from jax.sharding import Mesh

import tramp_tpu as tt
from tramp_tpu import glm_state_evolution
from tramp_tpu.priors import GaussBernoulliPrior
from tramp_tpu.channels import LinearChannel, GaussianChannel
from tramp_tpu.algos import CustomInit
from tramp_tpu.parallel import (
    EPSolver, SESolver, stack_pytrees, shard_batched_model, grid_combos,
    run_se_phase_grid, save_grid_csv)


GRID = dict(alpha=np.linspace(0.05, 1.0, 64), prior_rho=[0.25, 0.5])
MODEL = dict(prior_type="gauss_bernoulli", output_type="gaussian",
             output_var=1e-11)


def _build_ep(N, alpha, key):
    M = int(alpha * N)
    W = jax.random.normal(key, (M, N)) / jnp.sqrt(N)
    teacher = (GaussBernoulliPrior(size=N, rho=0.25) @ tt.V(id="x") @
               LinearChannel(W, name="W") @ tt.V(id="z") @
               GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    s = teacher.sample(jax.random.fold_in(key, 1))
    return teacher.to_observed({"y": s["y"]})


def per_device_flops(sizes, N=512, batch=16):
    "Per-device compiled FLOPs of the sharded batched EP solve."
    keys = jax.random.split(jax.random.PRNGKey(0), batch)
    models = [_build_ep(N, 0.5, k) for k in keys]
    stacked = stack_pytrees(models)
    solver = EPSolver(models[0], damping=0.1, max_iter=50, tol=1e-8)
    state = solver.init_state()
    out = {}
    for nd in sizes:
        mesh = Mesh(np.array(jax.devices()[:nd]), ("data",))
        sh = shard_batched_model(stacked, mesh)
        with mesh:
            comp = solver._jit_batch.lower(
                sh, state, jnp.asarray(50), jnp.asarray(1e-8)).compile()
        ca = comp.cost_analysis()
        ca = ca[0] if isinstance(ca, list) else ca
        out[nd] = float(ca.get("flops", float("nan")))
    return out


def se_points_per_s(n_dev, repeats=3):
    "Steady-state SE grid points/s on an n_dev mesh (compile excluded)."
    combos = grid_combos(GRID)
    models = [glm_state_evolution(**kw, **MODEL) for kw in combos]
    pad = (-len(models)) % n_dev
    models = models + [models[-1]] * pad
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    stacked = shard_batched_model(stack_pytrees(models), mesh)
    solver = SESolver(models[0], tol=1e-6, max_iter=200)
    init = CustomInit(a_init=[("x", "bwd", 0.0)])
    best = float("inf")
    with mesh:
        post, n_iter = solver.solve_batch(stacked, initializer=init)
        jax.block_until_ready(n_iter)  # compile + warmup
        for _ in range(repeats):
            t0 = time.time()
            post, n_iter = solver.solve_batch(stacked, initializer=init)
            jax.block_until_ready(n_iter)
            best = min(best, time.time() - t0)
    return len(combos) / best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    n_total = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8) if n <= n_total]

    flops = per_device_flops(sizes)
    for n in sizes:
        print(f"{n} device(s): per-device flops {flops[n]:.3e} "
              f"(x{flops[sizes[0]] / flops[n]:.2f} reduction)")

    pps = {n: se_points_per_s(n) for n in sizes}
    for n in sizes:
        print(f"{n} device(s): {pps[n]:.2f} SE points/s")

    base_f = flops[sizes[0]]
    report = {
        "per_device_flops": {str(n): flops[n] for n in sizes},
        "work_distribution_speedup": {
            str(n): round(base_f / flops[n], 3) for n in sizes},
        "se_grid_points": len(grid_combos(GRID)),
        "se_points_per_s": {str(n): round(pps[n], 2) for n in sizes},
        "backend": jax.default_backend(),
        "physical_cores": os.cpu_count(),
        "note": ("virtual CPU devices share the host's physical cores: "
                 "wall-clock cannot exceed core count; per_device_flops is "
                 "the hardware-independent scaling evidence"),
    }
    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    # grid CSV artifact through the host-0 aggregation path
    mesh = Mesh(np.array(jax.devices()[:sizes[-1]]), ("data",))
    df = run_se_phase_grid(glm_state_evolution, GRID, ids=("x",), a0=0.0,
                           mesh=mesh, **MODEL)
    save_grid_csv(df, (args.out or __file__).replace(".json", ".csv")
                  .replace(".py", ".csv"))


if __name__ == "__main__":
    main()
