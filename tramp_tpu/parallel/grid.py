"""Sharded phase-diagram grids: the reference's sequential experiment sweep
(tramp/experiments/multiple_experiments.py:30-49) as ONE batched, mesh-
sharded SE/EP solve, with host-0 CSV aggregation for multi-host runs
(SURVEY.md §2.10, §5.8).

Grid points are stacked along the leading (data) axis of one model pytree;
XLA inserts the collectives from the sharding annotations, and every
process receives the full result via process_allgather, so artifact output
is a single CSV written by process 0. Only run_se_phase_grid, which returns
a DataFrame, needs pandas.
"""
import itertools

import numpy as np
import jax

from .solver import SESolver, stack_pytrees
from .mesh import shard_batched_model


def grid_combos(grid_kwargs):
    "Cartesian product of the grid axes as a list of kwarg dicts."
    keys = list(grid_kwargs.keys())
    values = [np.atleast_1d(v) for v in grid_kwargs.values()]
    return [dict(zip(keys, combo))
            for combo in itertools.product(*values)]


def se_phase_grid_records(model_builder, grid_kwargs, ids=("x",), a0=None,
                          mesh=None, max_iter=200, tol=1e-6, damping=None,
                          solver_cls=SESolver, **model_kwargs):
    """Solve an SE phase grid as one fused batched solve.

    Parameters
    ----------
    model_builder : callable(**kwargs) -> Model. Grid axes must map to
        traced (data-leaf) constructor kwargs so the models stack.
    grid_kwargs : dict name -> list of values; the grid is their cartesian
        product (reference get_experiments_from_kwargs semantics).
    a0 : optional informed-init precision for ``ids[0]`` (CustomInit).
    mesh : optional jax Mesh; grid points are sharded over its 'data' axis
        (padded to a multiple of the data-axis size with repeated points).

    Returns a list of records (dicts), one per (grid point, variable id):
    grid kwargs + id + v + n_iter.
    """
    from ..algos import CustomInit

    combos = grid_combos(grid_kwargs)
    n = len(combos)
    models = [model_builder(**kw, **model_kwargs) for kw in combos]

    pad = 0
    if mesh is not None:
        data_par = mesh.shape.get("data", 1)
        pad = (-n) % data_par
        models = models + [models[-1]] * pad
    stacked = stack_pytrees(models)
    if mesh is not None:
        stacked = shard_batched_model(stacked, mesh)

    solver = solver_cls(models[0], damping=damping, tol=tol,
                        max_iter=max_iter)
    initializer = None
    if a0 is not None:
        initializer = CustomInit(a_init=[(ids[0], "bwd", a0)])
    ctx = mesh if mesh is not None else _nullcontext()
    with ctx:
        post, n_iter = solver.solve_batch(stacked, initializer=initializer)
        jax.block_until_ready(n_iter)

    records = []
    n_iter = np.asarray(_fetch(n_iter))[:n]
    for id in ids:
        v = np.asarray(_fetch(post[id]["v"])).reshape(len(models), -1)
        v = v.mean(axis=-1)[:n]
        for i, kw in enumerate(combos):
            rec = {k: np.asarray(val).item() for k, val in kw.items()}
            rec.update(id=id, v=float(v[i]), n_iter=int(n_iter[i]))
            records.append(rec)
    return records


def run_se_phase_grid(model_builder, grid_kwargs, **kwargs):
    """:func:`se_phase_grid_records` as a pandas DataFrame (pandas is an
    optional dependency, needed only here)."""
    try:
        import pandas as pd
    except ImportError as e:
        raise ImportError(
            "run_se_phase_grid returns a pandas DataFrame and needs the "
            "optional package 'pandas'; se_phase_grid_records returns the "
            "same rows as plain dicts") from e
    return pd.DataFrame(se_phase_grid_records(model_builder, grid_kwargs,
                                              **kwargs))


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()


def _fetch(arr):
    """Fetch a (possibly non-fully-addressable) global array to the host.
    Multi-process meshes go through process_allgather so every host sees
    the full grid."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        return multihost_utils.process_allgather(arr, tiled=True)
    return jax.device_get(arr)


def save_grid_csv(rows, csv_file):
    """Write the grid (a DataFrame or a list of records) to CSV on process 0
    only (the multi-host artifact path: every process holds the full
    gathered result, one host writes). Returns True on the writing
    process."""
    import csv

    if jax.process_index() != 0:
        return False
    if hasattr(rows, "to_dict"):
        rows = rows.to_dict("records")
    with open(csv_file, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]),
                                lineterminator="\n")
        writer.writeheader()
        writer.writerows(rows)
    return True
