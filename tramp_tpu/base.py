"""Core node classes of the tramp_tpu factor-graph IR.

Design (accelerator-first, not a translation of the reference's object graph):

- A *Factor* is a frozen-ish Python object whose numeric fields (weights,
  observations, hyperparameters) are pytree leaves and whose structural
  fields (shapes, names, region bounds) are static metadata. Factors are
  registered as pytrees, so a whole Model can be passed through
  ``jax.jit`` / ``jax.vmap`` / ``shard_map`` — thousands of problem
  instances become one stacked Model pytree.
- All ``compute_*`` methods are pure elementwise/matmul jnp functions with
  no data-dependent Python control flow: they trace once under jit.
- Message bookkeeping (cavity sums, clipping) lives in the engines
  (tramp_tpu/algos); factors only expose the local posterior/SE kernels.

Behavioral contracts mirror the reference (tramp/base.py:236-464 for
factors, tramp/base.py:49-233 for variables).
"""
import dataclasses

import jax
import jax.numpy as jnp

from . import config


def inv(v):
    "Numerically safe inverse. Reference tramp/base.py:44-46."
    return 1.0 / jnp.maximum(v, config.VMIN)


def compute_a_new(v, a, amin=config.AMIN, amax=config.AMAX):
    "Moment-matching precision update with clipping. Reference base.py:245-248."
    return jnp.clip(inv(v) - a, amin, amax)


def compute_ab_new(r, v, a, b, amin=config.AMIN, amax=config.AMAX):
    "Moment-matching natural-parameter update. Reference base.py:250-255."
    a_new = jnp.clip(inv(v) - a, amin, amax)
    b_new = r * (a + a_new) - b
    return a_new, b_new


class _Node:
    """Base for Factor/Variable; supports the ``@`` / ``+`` DAG algebra
    (reference tramp/base.py:57-63, 264-270)."""

    def __add__(self, other):
        from .models.dag_algebra import DAG
        return DAG(self) + other

    def __matmul__(self, other):
        from .models.dag_algebra import DAG
        return DAG(self) @ other

    def __repr__(self):
        fields = getattr(self, "_repr_fields", None)
        if fields is None:
            fields = list(getattr(self, "_data_fields", ())) + \
                list(getattr(self, "_meta_fields", ()))

        def fmt(v):
            # arrays are summarized (the reference's repr_init captures ctor
            # kwargs before arrays are attached, tramp/base.py:10-31)
            if hasattr(v, "shape") and getattr(v, "ndim", 0) > 0:
                return f"<array {tuple(v.shape)}>"
            return repr(v)

        args = ", ".join(f"{f}={fmt(getattr(self, f, None))}" for f in fields)
        return f"{type(self).__name__}({args})"


class Variable(_Node):
    """Variable node: pure structural metadata (id + arity). Message math for
    variables (cavity sums) is implemented in the engines.
    Reference tramp/base.py:49 and tramp/variables/sub_variables.py."""

    def __init__(self, id, n_prev, n_next):
        self.id = id
        self.n_prev = n_prev
        self.n_next = n_next

    _repr_fields = ("id", "n_prev", "n_next")

    def math(self):
        return rf"${self.id}$"


class Factor(_Node):
    """Factor node base.

    Subclasses declare:
      - ``_data_fields``: attribute names that are pytree leaves (arrays,
        numeric hyperparameters),
      - ``_meta_fields``: static attribute names (shapes, flags, ids),
    and implement the reference Factor contract
    (sample / second_moment / compute_*_posterior / compute_*_error /
    compute_log_partition / ...).
    """

    _data_fields = ()
    _meta_fields = ()
    n_prev = None  # number of input variables
    n_next = None  # number of output variables
    id = None

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.__dict__.get("_register", True):
            _register_factor(cls)

    # -- generic message computations (reference base.py:425-453) -------
    def compute_forward_message(self, az, bz, ax, bx):
        rx, vx = self.compute_forward_posterior(az, bz, ax, bx)
        if self.n_next == 1:
            return compute_ab_new(rx, vx, ax, bx)
        new = [compute_ab_new(rk, vk, ak, bk)
               for rk, vk, ak, bk in zip(rx, vx, ax, bx)]
        return [a for a, b in new], [b for a, b in new]

    def compute_backward_message(self, az, bz, ax, bx):
        rz, vz = self.compute_backward_posterior(az, bz, ax, bx)
        if self.n_prev == 1:
            return compute_ab_new(rz, vz, az, bz)
        new = [compute_ab_new(rk, vk, ak, bk)
               for rk, vk, ak, bk in zip(rz, vz, az, bz)]
        return [a for a, b in new], [b for a, b in new]

    def compute_forward_state_evolution(self, az, ax, tau_z):
        vx = self.compute_forward_error(az, ax, tau_z)
        if self.n_next == 1:
            return compute_a_new(vx, ax)
        return [compute_a_new(vk, ak) for vk, ak in zip(vx, ax)]

    def compute_backward_state_evolution(self, az, ax, tau_z):
        vz = self.compute_backward_error(az, ax, tau_z)
        if self.n_prev == 1:
            return compute_a_new(vz, az)
        return [compute_a_new(vk, ak) for vk, ak in zip(vz, az)]

    def math(self):
        return rf"$\mathrm{{{type(self).__name__}}}$"


def _register_factor(cls):
    data_fields = tuple(cls._data_fields)
    meta_fields = tuple(cls._meta_fields) + ("id",)

    def flatten(obj):
        children = tuple(getattr(obj, f) for f in data_fields)
        meta = tuple(getattr(obj, f, None) for f in meta_fields)
        return children, meta

    def unflatten(meta, children):
        obj = object.__new__(cls)
        for f, v in zip(data_fields, children):
            object.__setattr__(obj, f, v)
        for f, v in zip(meta_fields, meta):
            object.__setattr__(obj, f, v)
        return obj

    jax.tree_util.register_pytree_node(cls, flatten, unflatten)
    return cls
