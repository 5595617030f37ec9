"""Sharded checkpoint / resume for batched solves (orbax).

The sequential engine already persists its message state to .npz
(MessagePassing.save_state / load_state, mirroring the reference's
in-memory `old_message_dag` checkpoint). This module is the production
variant for the batched/sharded path: the solver state is a pytree of
(possibly mesh-sharded) jax Arrays, saved with orbax — which coordinates
across processes on a multi-host mesh and restores each shard to its
device — plus the per-lane iteration counters.

Typical use:

    solver = EPSolver(model, max_iter=200)
    post, state, n_iter = solver.solve_batch_with_state(stacked)
    save_checkpoint(path, state, n_iter)
    ...
    state, n_iter = restore_checkpoint(path, like=(state_template, n_iter0))
    post, state, n_iter = solver.solve_batch_with_state(
        stacked, state=state)          # resumes from the checkpoint
"""
import jax


def _checkpointer():
    "orbax is an optional dependency, imported only when a checkpoint is used."
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "tramp_tpu.parallel checkpoints need the optional package "
            "'orbax-checkpoint' (pip install orbax-checkpoint)") from e
    return ocp.StandardCheckpointer()


def save_checkpoint(path, state, n_iter):
    """Save a solver state pytree + iteration counters to ``path``
    (a directory; created). Sharded arrays are saved distributed; on a
    multi-host mesh every process must call this collectively."""
    ckptr = _checkpointer()
    ckptr.save(str(path), {"state": state, "n_iter": n_iter}, force=True)
    ckptr.wait_until_finished()
    return str(path)


def restore_checkpoint(path, like):
    """Restore a checkpoint written by :func:`save_checkpoint`.

    ``like`` is a ``(state, n_iter)`` template — concrete arrays or
    ShapeDtypeStructs carrying the target shardings (e.g. the initial
    batched state placed on the current mesh) — so each shard lands on
    the right device.
    """
    state_like, n_iter_like = like
    template = {
        "state": jax.tree.map(_abstract, state_like),
        "n_iter": _abstract(n_iter_like),
    }
    ckptr = _checkpointer()
    out = ckptr.restore(str(path), template)
    return out["state"], out["n_iter"]


def _abstract(x):
    x = jax.numpy.asarray(x)
    sharding = getattr(x, "sharding", None)
    return jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=sharding)
