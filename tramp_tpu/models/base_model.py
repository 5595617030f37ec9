"""Model: a lowered, schedule-ready view of a ModelDAG.

Accelerator-first lowering (vs reference tramp/models/base_model.py:28-148):
the DAG is flattened once into
  - ``nodes``: topologically ordered node objects,
  - ``edges``: ordered (u_idx, v_idx) pairs -> fixed message-slot layout,
  - per-node in/out edge index lists,
so the EP/SE sweep can be *unrolled at trace time* into a single XLA
computation. The Model is registered as a pytree whose leaves are the
factors' arrays: stacking Models of identical structure gives a batched
Model that vmap/pjit distribute across instances and chips.
"""
import jax
import jax.numpy as jnp

from ..base import Variable, Factor
from .dag_algebra import ModelDAG


def to_list(X):
    if not isinstance(X, tuple):
        X = (X,)
    return list(X)


class Model:
    def __init__(self, model_dag):
        if not isinstance(model_dag, ModelDAG):
            raise TypeError(f"model_dag {model_dag} is not a ModelDAG")
        self.model_dag = model_dag
        dag = model_dag.dag
        self.nodes = dag.topological_sort()
        self._index = {n: i for i, n in enumerate(self.nodes)}
        self.edges = [(self._index[u], self._index[v]) for u, v in dag.edges]
        # per-node ordered edge indices (order = successor/predecessor order,
        # which matches the reference's message parsing order)
        self.in_edges = [[] for _ in self.nodes]
        self.out_edges = [[] for _ in self.nodes]
        for e, (ui, vi) in enumerate(self.edges):
            self.out_edges[ui].append(e)
            self.in_edges[vi].append(e)

        self.forward_ordering = self.nodes
        self.variables = [n for n in self.nodes if isinstance(n, Variable)]
        self.variable_ids = [v.id for v in self.variables]
        if len(set(self.variable_ids)) != len(self.variable_ids):
            raise ValueError("duplicate variable ids")
        for v in self.variables:
            if v.id is None:
                raise ValueError(f"missing id for {v}")
        self.factors = [n for n in self.nodes if isinstance(n, Factor)]
        for idx, f in enumerate(self.factors):
            f.id = f"f_{idx}"
        self.factor_ids = [f.id for f in self.factors]
        self.n_variables = len(self.variables)
        self.n_factors = len(self.factors)
        self._shapes = None
        self._second_moments = None

    def __repr__(self):
        return f"Model(n_factors={self.n_factors}, n_variables={self.n_variables})"

    # -- structural helpers ---------------------------------------------
    def variable_index(self, id):
        for i, n in enumerate(self.nodes):
            if isinstance(n, Variable) and n.id == id:
                return i
        raise ValueError(f"id={id} not in variables")

    def plot(self, layout=None):
        return self.model_dag.plot(layout)

    def to_observed(self, observations):
        return Model(self.model_dag.to_observed(observations))

    # -- sampling and moments -------------------------------------------
    def sample(self, key=None):
        "Ancestral sampling. Reference base_model.py:71-94 (jax keys here)."
        if key is None or isinstance(key, int):
            key = jax.random.PRNGKey(key or 0)
        values = {}
        keys = jax.random.split(key, len(self.factors))
        k_idx = 0
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor):
                continue
            X_prev = [values[self.edges[e][0]] for e in self.in_edges[i]]
            X_next = to_list(node.sample(keys[k_idx], *X_prev))
            k_idx += 1
            for X, e in zip(X_next, self.out_edges[i]):
                values[self.edges[e][1]] = X
        return {
            n.id: values[i]
            for i, n in enumerate(self.nodes)
            if isinstance(n, Variable) and i in values
        }

    def init_shapes(self):
        "Variable shapes via abstract evaluation. Reference base_model.py:96-109."
        if self._shapes is not None:
            return self._shapes
        key = jax.random.PRNGKey(0)
        shapes = {}

        def shape_of(i):
            return shapes[i]

        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor):
                continue
            prev_shapes = [shapes[self.edges[e][0]] for e in self.in_edges[i]]
            dummies = [jnp.zeros(s) for s in prev_shapes]
            out = jax.eval_shape(
                lambda *zs, node=node: node.sample(key, *zs), *dummies)
            out = to_list(out) if isinstance(out, tuple) else [out]
            for o, e in zip(out, self.out_edges[i]):
                shapes[self.edges[e][1]] = o.shape
        self._shapes = shapes
        return shapes

    def init_second_moments(self):
        "Propagate tau through factors. Reference base_model.py:111-124."
        taus = {}
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Factor) or node.n_next == 0:
                continue
            tau_prev = [taus[self.edges[e][0]] for e in self.in_edges[i]]
            tau_next = to_list(node.second_moment(*tau_prev))
            for t, e in zip(tau_next, self.out_edges[i]):
                taus[self.edges[e][1]] = t
        self._second_moments = taus
        return taus

    def get_shapes(self):
        shapes = self.init_shapes()
        return {n.id: shapes[i] for i, n in enumerate(self.nodes)
                if isinstance(n, Variable) and i in shapes}

    def get_second_moments(self):
        taus = self.init_second_moments()
        return {n.id: taus[i] for i, n in enumerate(self.nodes)
                if isinstance(n, Variable) and i in taus}


def _model_flatten(model):
    children = tuple(model.factors)
    # aux must be one shared skeleton object across flatten/unflatten round
    # trips, otherwise vmap/jit tree-prefix matching and cache hits break.
    aux = getattr(model, "_aux_ref", model)
    return children, aux


def _model_unflatten(aux, children):
    # Rebind the (possibly traced) factor children onto a shallow copy of the
    # structural skeleton. Node identity changes but indices stay valid.
    model = object.__new__(Model)
    model.__dict__.update(aux.__dict__)
    model._aux_ref = aux
    new_nodes = list(aux.nodes)
    factors = list(children)
    fi = 0
    for i, n in enumerate(aux.nodes):
        if isinstance(n, Factor):
            new_nodes[i] = factors[fi]
            fi += 1
    model.nodes = new_nodes
    model.factors = factors
    model.forward_ordering = new_nodes
    return model


jax.tree_util.register_pytree_node(Model, _model_flatten, _model_unflatten)
