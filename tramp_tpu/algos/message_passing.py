"""Message-passing engine base.

Accelerator-first architecture (vs the reference's per-edge dict juggling in
tramp/algos/message_passing.py:58-357):

- Message state is a flat tuple of per-directed-edge dicts
  ``{"a": scalar-or-array, "b": array}`` (SE: ``{"a"}`` only) — a pytree.
- One EP/SE iteration is a *pure function* ``(model, state) -> state`` whose
  double sweep is unrolled at trace time from the static schedule; XLA fuses
  each node update into a handful of kernels.
- ``iterate`` runs either a fully fused ``lax.while_loop`` (fast path, used
  for benchmarking and batched sweeps) or a Python loop around the jitted
  single iteration (when host-side callbacks are requested). Both share the
  same step function.
- NaN guard: if a sweep produces any non-finite message the previous state
  is kept and the loop stops (mirrors the reference's rollback,
  message_passing.py:187-209).
- Damping: constant per-edge factor->variable damping
  ``new = d*old + (1-d)*new`` (message_passing.py:119-127).

Slot layout: model edge e gets slots 2e (direction "fwd") and 2e+1 ("bwd").
"""
import numpy as np
import jax
import jax.numpy as jnp

from ..base import Variable, Factor
from ..models import Model
from .initial_conditions import ConstantInit

FWD, BWD = 0, 1


def slot(e, direction):
    return 2 * e + direction


class MessagePassing:

    #: Increase-rollback (reference EarlyStopping, callbacks.py:195-243):
    #: when the convergence metric increases by more than
    #: ``rollback_increase`` after ``wait_increase`` iterations, revert to
    #: the previous state and stop. Enabled for SE (the reference's default
    #: SE callback), disabled for EP (whose default is a relative-r
    #: criterion without rollback).
    rollback_increase = None
    wait_increase = 5

    #: Engines whose _sweep is not abstractly traceable (the explain/latex
    #: wrappers print concrete values) opt out of init harmonization.
    harmonize = True

    def __init__(self, model, message_keys):
        if not isinstance(model, Model):
            raise ValueError(f"model {model} is not a Model")
        self.model = model
        self.message_keys = message_keys
        self.n_iter = 0
        self.state = None
        self._compiled = {}

        # static schedule ------------------------------------------------
        self.nodes = model.nodes
        self.edges = model.edges
        self.n_slots = 2 * len(model.edges)
        # variable node index adjacent to each edge
        self.edge_variable = [
            ui if isinstance(model.nodes[ui], Variable) else vi
            for (ui, vi) in model.edges
        ]
        # factor-emitted slots (fwd on factor->var edges, bwd on var->factor)
        self.factor_emitted = []
        for e, (ui, vi) in enumerate(model.edges):
            if isinstance(model.nodes[ui], Factor):
                self.factor_emitted.append(slot(e, FWD))
            else:
                self.factor_emitted.append(slot(e, BWD))
        self.variable_indices = [
            i for i, n in enumerate(self.nodes) if isinstance(n, Variable)]

        # -- pinned (constant) slots --------------------------------------
        # Factors whose emitted message is a MODEL CONSTANT (the Gaussian
        # likelihood's backward message a=1/var, b=y/var — the reference's
        # "constant message fast path", gaussian_likelihood.py:68-71) are
        # recomputed from the model at the TOP of every sweep instead of
        # being read back from the loop carry, and never damped (damping a
        # constant only delays it: d*c + (1-d)*c = c at the fixed point).
        # Variable cavity slots whose contributors are all pinned are
        # pinned too. Payoff: inside the fused loop these messages derive
        # from loop-invariant model leaves, so XLA's LICM hoists the
        # factor-side GEMMs that consume them (e.g. U^T (y/var) in the
        # GLM sweep — ~9% of the flagship's FLOPs) out of the loop.
        from .. import config
        self.pinned_factor = {}   # slot -> factor node index
        self.pinned_variable = {} # slot -> (sum of these pinned slots)
        if config.pin_constant_messages():
            self._init_pinned_slots()
        self.pinned = (frozenset(self.pinned_factor)
                       | frozenset(self.pinned_variable))

        # -- spectral-image carry (config.SPECTRAL_CARRY) ------------------
        # Factor node indices whose backward spectral image (U^T bx for a
        # dense LinearChannel) is carried in the state across sweeps: the
        # forward pass reads the image the previous backward pass computed
        # instead of re-materializing the same GEMM (the forward pass only
        # writes fwd slots, so bx — the bwd slot of the factor's out edge —
        # cannot have changed in between). Saves one thin (Nx, k) GEMM per
        # linear factor per sweep at ANY tree position; bit-identical
        # trajectories (same _mm on the same stored operand). The engine
        # hook `_init_spectral_factors` returns () by default; the EP
        # engine registers dense LinearChannels.
        self.spectral_factors = tuple(self._init_spectral_factors())
        self._spectral = frozenset(self.spectral_factors)

    def _init_pinned_slots(self):
        for i, node in enumerate(self.nodes):
            if isinstance(node, Variable):
                continue
            if node.n_next == 0 and self._constant_factor_message(node):
                for e in self.model.in_edges[i]:
                    self.pinned_factor[slot(e, BWD)] = i
            if node.n_prev == 0 and self._constant_factor_message(node):
                for e in self.model.out_edges[i]:
                    self.pinned_factor[slot(e, FWD)] = i
        for i, node in enumerate(self.nodes):
            if not isinstance(node, Variable):
                continue
            in_slots = ([slot(e, FWD) for e in self.model.in_edges[i]]
                        + [slot(e, BWD) for e in self.model.out_edges[i]])
            targets = ([(slot(e, BWD), slot(e, FWD))
                        for e in self.model.out_edges[i]]
                       + [(slot(e, FWD), slot(e, BWD))
                          for e in self.model.in_edges[i]])
            for excluded, out_slot in targets:
                contrib = [s for s in in_slots if s != excluded]
                if contrib and all(s in self.pinned_factor
                                   for s in contrib):
                    self.pinned_variable[out_slot] = tuple(contrib)

    def _constant_factor_message(self, node):
        "Engine hook: True when `node`'s emitted message is model-constant."
        return False

    def _init_spectral_factors(self):
        """Engine hook: factor node indices that carry a spectral image in
        the state (see __init__). Default: none."""
        return ()

    def _pinned_values(self, model):
        """{slot: message} for every pinned slot, computed from the model
        (loop-invariant). Factor slots first, then the variable cavities
        that sum them."""
        out = {}
        for s, i in self.pinned_factor.items():
            out[s] = self._factor_constant_message(model, i)
        for s, contrib in self.pinned_variable.items():
            out[s] = {
                key: sum(out[c][key] for c in contrib)
                for key in self.message_keys
            }
        return out

    # -- initial state ---------------------------------------------------
    #: SE messages are scalar `a`s: no variable shapes are required, which
    #: lets SE-only factors skip shape propagation entirely (the reference
    #: builds SE GLMs with size=None, generalized_linear_model.py:45)
    needs_shapes = True

    def init_state(self, initializer=None):
        initializer = initializer or ConstantInit(a=0, b=0)
        shapes = self.model.init_shapes() if self.needs_shapes else {}
        state = []
        for e, (ui, vi) in enumerate(self.edges):
            v_idx = self.edge_variable[e]
            var = self.nodes[v_idx]
            shape = shapes.get(v_idx)
            for direction, dname in ((FWD, "fwd"), (BWD, "bwd")):
                msg = {}
                for key in self.message_keys:
                    msg[key] = initializer.init(key, shape, var.id, dname)
                state.append(msg)
        if self.spectral_factors:
            # zero placeholder cache; shapes/dtypes harmonize with the rest
            state.append({
                str(i): jnp.zeros(self.nodes[i].k)
                for i in self.spectral_factors})
        state = self._harmonize_state(tuple(state))
        if self.spectral_factors:
            # exact init: the cache must equal U^T bx0 of the initialized
            # slots (the same value the uncached engine's first forward
            # pass would compute), so trajectories stay bit-identical even
            # under NoisyInit/CustomInit
            state = self._refresh_spectral_cache(state)
        return state

    def _refresh_spectral_cache(self, state, model=None):
        """Recompute each carried spectral image from the current slots.

        ``model`` defaults to the engine's construction-time model; the
        compiled run paths pass the RUNTIME model instead — under the
        batched solvers the engine's init_state() template is shared
        across lanes whose U leaves differ (in_axes=(0, None)), so the
        cache must be re-derived from each lane's own operator before the
        first sweep (bit-preserving: the refresh is the same matvec the
        first forward pass of the uncached engine would do)."""
        nodes = (self.nodes if model is None else model.nodes)
        cache = {}
        for i in self.spectral_factors:
            node = nodes[i]
            e_out = self.model.out_edges[i][0]
            bx = self._load_msg(state[slot(e_out, BWD)])["b"]
            cache[str(i)] = node.spectral_image(bx)
        return tuple(state[:self.n_slots]) + (cache,)

    def _harmonize_state(self, state):
        """Broadcast each slot's init values to the shapes a sweep emits.

        Diagonal-variance factors (isotropic=False) emit array precisions
        while the default init is a scalar a=0; the fused while_loop needs
        a shape-stable carry, so the init is pre-broadcast to the
        fixed-point shapes (two abstract sweeps reach them)."""
        if not self.harmonize:
            # engines that print concrete values inside _sweep (explain /
            # latex wrappers) cannot be traced abstractly; they run eagerly
            # and never enter the fused loop, so the raw init is fine
            return state
        damp = tuple([0.0] * self.n_slots)

        def two_sweeps(st):
            st = self._sweep(self.model, st, damp)
            return self._sweep(self.model, st, damp)

        out = jax.eval_shape(two_sweeps, state)
        new_state = []
        for msg, out_msg in zip(state[:self.n_slots], out[:self.n_slots]):
            new_msg = {}
            for key in self.message_keys:
                tgt = out_msg[key]
                new_msg[key] = jnp.broadcast_to(
                    jnp.asarray(msg[key], dtype=tgt.dtype), tgt.shape)
            new_state.append(new_msg)
        if self.spectral_factors:
            cache, out_cache = state[self.n_slots], out[self.n_slots]
            new_cache = {
                k: jnp.broadcast_to(
                    jnp.asarray(cache[k], out_cache[k].dtype),
                    out_cache[k].shape)
                for k in cache}
            return tuple(new_state) + (new_cache,)
        return tuple(new_state)

    # -- damping ---------------------------------------------------------
    def _damping_per_slot(self, damping):
        "Static per-slot damping coefficients (0 = undamped)."
        damp = [0.0] * self.n_slots
        if not damping:
            return tuple(damp)
        if isinstance(damping, float):
            for e in range(len(self.edges)):
                damp[self.factor_emitted[e]] = damping
            return tuple(damp)
        if isinstance(damping, list):
            # damp the factor->variable message with direction `direction`
            # arriving at variable `id` (reference configure_damping l:70-106)
            for (id, direction, d) in damping:
                v_idx = self.model.variable_index(id)
                want_dir = FWD if direction == "fwd" else BWD
                for e, (ui, vi) in enumerate(self.edges):
                    if self.edge_variable[e] != v_idx:
                        continue
                    if want_dir == FWD and isinstance(self.nodes[ui], Factor):
                        damp[slot(e, FWD)] = d
                    if want_dir == BWD and isinstance(self.nodes[vi], Factor):
                        damp[slot(e, BWD)] = d
            return tuple(damp)
        raise ValueError("damping must be None, float or list")

    # -- bf16 state storage (config.STATE_BF16) ---------------------------
    # b-message arrays are stored bfloat16 in the loop carry and upcast at
    # every read, so compute (cavity sums, factor math) stays float32 and
    # only the carried state pays the HBM traffic.
    def _store_msg(self, msg):
        from .. import config
        if not config.state_bf16():
            return msg
        out = {}
        for k, v in msg.items():
            if (k == "b" and hasattr(v, "dtype")
                    and v.dtype == jnp.float32):
                v = v.astype(jnp.bfloat16)
            out[k] = v
        return out

    def _load_msg(self, msg):
        return {
            k: (v.astype(jnp.float32)
                if hasattr(v, "dtype") and v.dtype == jnp.bfloat16 else v)
            for k, v in msg.items()
        }

    # -- node processing (called at trace time) --------------------------
    def _gather_factor_inputs(self, i, state):
        "az,bz from fwd slots of in-edges; ax,bx from bwd slots of out-edges."
        prev_msgs = [self._load_msg(state[slot(e, FWD)])
                     for e in self.model.in_edges[i]]
        next_msgs = [self._load_msg(state[slot(e, BWD)])
                     for e in self.model.out_edges[i]]
        return prev_msgs, next_msgs

    def _variable_out(self, i, state, direction):
        """Cavity messages from variable node i: for each out adjacency, sum
        all incoming messages except the opposite-direction message on that
        same adjacency (cancellation-free, reference base.py:183-207)."""
        in_slots = ([slot(e, FWD) for e in self.model.in_edges[i]]
                    + [slot(e, BWD) for e in self.model.out_edges[i]])
        out = {}
        if direction == FWD:
            targets = [(e, slot(e, BWD)) for e in self.model.out_edges[i]]
        else:
            targets = [(e, slot(e, FWD)) for e in self.model.in_edges[i]]
        loaded = {s: self._load_msg(state[s]) for s in in_slots}
        for e, excluded in targets:
            msg = {}
            for key in self.message_keys:
                msg[key] = sum(
                    loaded[s][key] for s in in_slots if s != excluded)
            out[slot(e, FWD if direction == FWD else BWD)] = msg
        return out

    def _posterior(self, i, state):
        in_slots = ([slot(e, FWD) for e in self.model.in_edges[i]]
                    + [slot(e, BWD) for e in self.model.out_edges[i]])
        post = {}
        for key in self.message_keys:
            post[key] = sum(
                self._load_msg(state[s])[key] for s in in_slots)
        return post

    # subclasses implement: _factor_forward / _factor_backward returning
    # {slot: msg} and `update(posterior)` -> variable data dict

    def _prepare(self, model):
        "Per-trace auxiliary data (e.g. second moments for SE)."
        return None

    def _msg_target(self, s):
        "Node index receiving the message in slot s."
        e, d = divmod(s, 2)
        ui, vi = self.edges[e]
        return vi if d == FWD else ui

    def _edge_objective(self, e, state):
        "Edge term of the Bethe objective: variable objective of fwd+bwd."
        v_idx = self.edge_variable[e]
        msgs = [state[slot(e, FWD)], state[slot(e, BWD)]]
        post = {k: sum(m[k] for m in msgs) for k in self.message_keys}
        return self.variable_objective(self.nodes[v_idx], v_idx, post)

    def _adaptive_update(self, state, s, new_msg, is_first, n_max=10):
        """Bethe-objective backtracking: accept new = old + beta*(new-old)
        with the largest beta in {1, 1/2, ..., 1/2^(n_max-1)} for which the
        local objective change dA >= 0; keep old otherwise.
        Reference message_passing.py:151-185 (compute_adaptive_damping)."""
        e, _ = divmod(s, 2)
        target_i = self._msg_target(s)
        old_msg = self._load_msg(state[s])

        def A_of(msg):
            st = list(state)
            st[s] = msg
            return self.node_objective_at(target_i, st) \
                - self._edge_objective(e, st)

        A_old = A_of(old_msg)
        accepted = old_msg
        # smallest beta first so that the largest beta with dA >= 0 wins —
        # identical to the reference's first-accept scan from beta=1 down.
        for n in reversed(range(n_max)):
            beta = 0.5**n
            cand = {k: old_msg[k] + beta * (new_msg[k] - old_msg[k])
                    for k in self.message_keys}
            ok = A_of(cand) - A_old >= 0
            accepted = {
                k: jnp.where(ok, cand[k], accepted[k])
                for k in self.message_keys
            }
        # first iteration: no damping (reference l:131-132, 153-154)
        return {
            k: jnp.where(is_first, new_msg[k], accepted[k])
            for k in self.message_keys
        }

    def _edge_dA(self, state, s, new_msg):
        """Local Bethe objective change of writing new_msg into slot s
        (reference compute_dA, message_passing.py:129-149)."""
        target_i = self._msg_target(s)
        e, _ = divmod(s, 2)

        def A_of(msg):
            st = list(state)
            st[s] = msg
            return self.node_objective_at(target_i, st) \
                - self._edge_objective(e, st)

        return A_of(new_msg) - A_of(state[s])

    def _sweep(self, model, state, damp, adaptive=False, is_first=False,
               update_dA=False):
        "One forward + backward sweep. Returns new state tuple."
        aux = self._prepare(model)
        state = list(state)
        if self.spectral_factors:
            # local cache copy at index n_slots; spectral factor reads go
            # through state[self.n_slots], writes through the ("spec", key)
            # update channel below
            cache = dict(state[self.n_slots])
            state[self.n_slots] = cache
        dA = {}
        # pinned slots: overwrite from the model BEFORE the passes so every
        # in-body read derives from loop-invariant leaves (LICM-hoistable).
        # Each component is broadcast to the incoming slot's shape: factors
        # may emit scalar constants (e.g. GaussianLikelihood's a=1/var)
        # while the harmonized while_loop carry holds array-shaped slots —
        # a raw overwrite would change the carry structure at trace time.
        for s, msg in self._pinned_values(model).items():
            old = self._load_msg(state[s])
            msg = {k: jnp.broadcast_to(jnp.asarray(v, jnp.asarray(old[k]).dtype),
                                       jnp.shape(old[k]))
                   for k, v in msg.items()}
            state[s] = self._store_msg(msg)

        def write(updates):
            for s, msg in updates.items():
                if isinstance(s, tuple):
                    # ("spec", key): carried spectral image — a derived
                    # quantity (U^T of a stored slot), never damped, never
                    # part of the Bethe objective
                    cache[s[1]] = msg
                    continue
                if s in self.pinned:
                    if update_dA:
                        # a pinned slot never changes within a sweep, so
                        # its local Bethe change is identically 0; keep
                        # the dA dict complete for downstream consumers
                        dA[s] = jnp.asarray(0.0)
                    continue  # pinned: already set, never damped
                if adaptive:
                    msg = self._adaptive_update(state, s, msg, is_first)
                else:
                    d = damp[s]
                    if d:
                        old = self._load_msg(state[s])
                        msg = {k: d * old[k] + (1.0 - d) * msg[k]
                               for k in self.message_keys}
                if update_dA:
                    dA[s] = self._edge_dA(state, s, msg)
                state[s] = self._store_msg(msg)

        # forward pass
        for i, node in enumerate(model.nodes):
            if isinstance(node, Variable):
                if node.n_next == 0:
                    continue
                write(self._variable_out(i, state, FWD))
            else:
                if node.n_next == 0:
                    continue
                write(self._factor_forward(i, node, state, aux))
        # backward pass
        for i in reversed(range(len(model.nodes))):
            node = model.nodes[i]
            if isinstance(node, Variable):
                if node.n_prev == 0:
                    continue
                write(self._variable_out(i, state, BWD))
            else:
                if node.n_prev == 0:
                    continue
                write(self._factor_backward(i, node, state, aux))
        if update_dA:
            return tuple(state), dA
        return tuple(state)

    # -- convergence metrics ----------------------------------------------
    def _metric(self, model, state, kind):
        """Per-variable stopping metric: posterior v (kind="v", reference
        EarlyStopping) or posterior r (kind="r", reference EarlyStoppingEP).
        """
        out = []
        for i in self.variable_indices:
            post = self._posterior(i, state)
            if kind == "v":
                out.append(jnp.mean(1.0 / post["a"]))
            else:
                # NaN-free also on the a=0,b=0 init state (where b/a would
                # be 0/0): posterior precisions after any sweep are >= AMIN,
                # so the floor only affects the first-iteration metric
                a = post["a"]
                tiny = jnp.finfo(jnp.result_type(a)).tiny
                out.append(post["b"] / jnp.maximum(a, tiny))
        return tuple(out)

    def _delta_increase(self, kind, new_m, old_m):
        """(convergence delta, divergence measure) for the chosen metric:
        kind="v": max |dv| and max dv (callbacks.py:220-236);
        kind="r": max relative r change, used for both (callbacks.py:265-277).
        """
        if kind == "v":
            deltas = jnp.stack(
                [jnp.max(jnp.abs(n - o)) for n, o in zip(new_m, old_m)])
            incs = jnp.stack(
                [jnp.max(n - o) for n, o in zip(new_m, old_m)])
            return deltas.max(), incs.max()

        def norm(x):
            return jnp.sqrt(jnp.mean(x**2))

        def rel(n, o):
            # dtype-aware division guard: 1e-300 underflows to 0 in float32,
            # turning the metric into 0/0 = NaN in an exactly-symmetric
            # phase (r = 0, e.g. zero-mean phase retrieval) and silently
            # disabling early-stop AND divergence rollback. finfo.tiny keeps
            # the guard live in every dtype: r = 0 with no change reads as
            # delta = 0 (converged-in-r), matching the f64 reference.
            nn = norm(n)
            return norm(n - o) / jnp.maximum(nn, jnp.finfo(nn.dtype).tiny)

        deltas = jnp.stack([rel(n, o) for n, o in zip(new_m, old_m)])
        d = deltas.max()
        return d, d

    def _stop_params(self, early_stop, tol):
        """Translate an EarlyStopping/EarlyStoppingEP callback (or the
        engine default) into static parameters for the fused loop:
        (metric kind, tol, wait_increase, max_increase)."""
        from .callbacks import EarlyStopping, EarlyStoppingEP
        if early_stop is not None:
            if isinstance(early_stop, EarlyStoppingEP):
                return ("r", early_stop.tol, early_stop.wait_increase,
                        early_stop.max_increase)
            if isinstance(early_stop, EarlyStopping):
                return ("v", early_stop.tol, early_stop.wait_increase,
                        early_stop.max_increase)
            raise ValueError(
                f"early_stop must be EarlyStopping or EarlyStoppingEP, "
                f"got {early_stop}")
        return (self.default_stop_kind, tol, self.wait_increase,
                self.rollback_increase)

    # -- finite guard -----------------------------------------------------
    def _all_finite(self, state):
        flags = [jnp.all(jnp.isfinite(msg[k]))
                 for msg in state[:self.n_slots] for k in self.message_keys]
        if self.spectral_factors:
            flags += [jnp.all(jnp.isfinite(v))
                      for v in state[self.n_slots].values()]
        return jnp.stack(flags).all()

    # -- iterate ----------------------------------------------------------
    def iterate(self, max_iter=200, callback=None, initializer=None,
                damping=None, warm_start=False, tol=1e-6, check_nan=True,
                early_stop=None, update_dA=False):
        """Run message passing.

        Fast path (callback=None): fused jit(while_loop) with early stopping
        on the convergence criterion and NaN rollback. ``early_stop`` may be
        an EarlyStopping/EarlyStoppingEP instance to override the engine's
        default stopping rule inside the fused loop (mirrors passing the
        callback in the reference).
        Callback path: Python loop over a jitted single iteration; callbacks
        see the live engine like in the reference. ``update_dA=True``
        (reference message_passing.py:330-344) additionally records the
        per-message local Bethe change in ``self.dA`` each iteration.

        NOTE: ``update_dA=True`` always takes the Python path (even with
        callback=None): the per-slot dA floats are materialized on host
        every iteration, which cannot live inside the fused while_loop.
        ``damping="adaptive"`` runs in EITHER path (the Bethe backtracking
        is branchless) — the two paths reach identical states
        (tests/test_ep_glm.py::test_adaptive_damping_fused_matches_python).
        """
        if warm_start:
            if self.state is None:
                raise ValueError("message state was never initialized")
        else:
            self.state = self.init_state(initializer)
            self.n_iter = 0
        adaptive = damping == "adaptive"
        damp = self._damping_per_slot(None if adaptive else damping)

        if callback is None and not update_dA:
            stop = self._stop_params(early_stop, tol)
            self._iterate_compiled(max_iter, damp, stop, check_nan, adaptive)
        else:
            callback = callback or (lambda algo, i, max_iter: False)
            self._iterate_python(max_iter, damp, callback, adaptive,
                                 update_dA)
        return self

    def _get_step(self, damp, key, adaptive=False, update_dA=False):
        k = ("step", damp, key, adaptive, update_dA)
        if k not in self._compiled:
            def step(model, state, is_first):
                return self._sweep(model, state, damp,
                                   adaptive=adaptive, is_first=is_first,
                                   update_dA=update_dA)
            self._compiled[k] = jax.jit(step)
        return self._compiled[k]

    def _iterate_python(self, max_iter, damp, callback, adaptive=False,
                        update_dA=False):
        step = self._get_step(damp, "py", adaptive, update_dA)
        for i in range(max_iter):
            out = step(self.model, self.state,
                       jnp.asarray(self.n_iter == 0))
            if update_dA:
                new_state, dA = out
                # per-slot local Bethe change, keyed like get_edges_data
                self.dA = {s: float(v) for s, v in dA.items()}
            else:
                new_state = out
            if bool(self._all_finite(new_state)):
                self.state = new_state
            else:
                break
            self.n_iter += 1
            stop = callback(self, i, max_iter)
            if stop:
                break

    def _iterate_compiled(self, max_iter, damp, stop, check_nan,
                          adaptive=False):
        kind, tol, wait_increase, max_increase = stop
        k = ("loop", damp, bool(check_nan), adaptive, kind,
             wait_increase, max_increase)
        if k not in self._compiled:
            def run(model, state, max_iter, tol, n_iter0):
                if self.spectral_factors:
                    # re-derive the carried images from THIS model's
                    # operators (the init-state template may be another
                    # lane's; bit-preserving — see _refresh_spectral_cache)
                    state = self._refresh_spectral_cache(state, model)

                def cond(carry):
                    state, old_m, i, done = carry
                    return (~done) & (i < max_iter)

                def body(carry):
                    state, old_m, i, done = carry
                    new_state = self._sweep(
                        model, state, damp, adaptive=adaptive,
                        is_first=(i + n_iter0 == 0))
                    ok = self._all_finite(new_state) if check_nan else True
                    new_state = jax.tree.map(
                        lambda n, o: jnp.where(ok, n, o), new_state, state)
                    new_m = self._metric(model, new_state, kind)
                    delta, inc = self._delta_increase(kind, new_m, old_m)
                    converged = (i > 0) & (delta < tol)
                    if max_increase is not None:
                        # divergence rollback: revert to the previous state
                        # and stop (reference callbacks.py:232-243, 275-283)
                        rb = (i > wait_increase) & (inc > max_increase)
                        new_state = jax.tree.map(
                            lambda n, o: jnp.where(rb, o, n),
                            new_state, state)
                        converged = converged | rb
                    return (new_state, new_m, i + 1,
                            converged | (~jnp.asarray(ok)))

                m0 = self._metric(model, state, kind)
                state, m, i, done = jax.lax.while_loop(
                    cond, body, (state, m0, jnp.asarray(0), jnp.asarray(False)))
                return state, i

            self._compiled[k] = jax.jit(run, static_argnames=())
        state, i = self._compiled[k](
            self.model, self.state, jnp.asarray(max_iter),
            jnp.asarray(tol), jnp.asarray(self.n_iter))
        self.state = state
        self.n_iter += int(i)

    # -- data access (reference message_passing.py:265-304) ---------------
    def get_variables_data(self, ids="all"):
        data = {}
        for i in self.variable_indices:
            var = self.nodes[i]
            if ids == "all" or var.id in ids:
                post = self._posterior(i, self.state)
                data[var.id] = self.update(self.nodes[i], post)
        return data

    def get_variable_data(self, id):
        data = self.get_variables_data(ids=[id])
        if id not in data:
            raise ValueError(f"id={id} not in variables")
        return data[id]

    def get_edges_data(self, keys):
        records = []
        for e, (ui, vi) in enumerate(self.edges):
            var = self.nodes[self.edge_variable[e]]
            fac = (self.nodes[ui] if isinstance(self.nodes[ui], Factor)
                   else self.nodes[vi])
            for direction, dname in ((FWD, "fwd"), (BWD, "bwd")):
                msg = self.state[slot(e, direction)]
                record = dict(x_id=var.id, f_id=fac.id, direction=dname)
                for key in keys:
                    if key in msg:
                        record[key] = np.asarray(msg[key])
                records.append(record)
        return records

    # -- on-device trace buffers (SURVEY §5.1: the on-device replacement
    # for the reference's host-side TrackEvolution callback) ---------------
    def run_trace(self, n_iter=50, damping=None, initializer=None,
                  warm_start=False):
        """Run exactly ``n_iter`` sweeps as one ``lax.scan``, stacking the
        per-iteration per-variable posterior summary (mean v) in the scan
        output — convergence curves with zero host round-trips.

        Returns {variable_id: (n_iter,) array}; also advances the engine
        state like iterate(warm_start=...)."""
        if warm_start:
            if self.state is None:
                raise ValueError("message state was never initialized")
        else:
            self.state = self.init_state(initializer)
            self.n_iter = 0
        damp = self._damping_per_slot(damping)
        k = ("trace", damp)
        if k not in self._compiled:
            def run(model, state, n_iter):
                if self.spectral_factors:
                    state = self._refresh_spectral_cache(state, model)

                def step(state, _):
                    new_state = self._sweep(model, state, damp)
                    vs = self._metric(model, new_state, "v")
                    return new_state, jnp.stack([jnp.mean(v) for v in vs])
                return jax.lax.scan(step, state, None, length=n_iter)

            self._compiled[k] = jax.jit(run, static_argnames=("n_iter",))
        state, trace = self._compiled[k](self.model, self.state, n_iter)
        self.state = state
        self.n_iter += int(n_iter)
        return {self.nodes[vi].id: trace[:, j]
                for j, vi in enumerate(self.variable_indices)}

    # -- checkpoint / resume ----------------------------------------------
    # The reference only checkpoints in memory (old_message_dag copy,
    # message_passing.py:356). The message state here is a pytree of
    # arrays, so persisting it is a flat .npz: resume = load + iterate
    # (warm_start=True).
    def save_state(self, path):
        "Persist the message state and iteration counter to ``path`` (.npz)."
        if self.state is None:
            raise ValueError("message state was never initialized")
        arrays = {"__n_iter__": np.asarray(self.n_iter)}
        for s, msg in enumerate(self.state[:self.n_slots]):
            for key in self.message_keys:
                arrays[f"s{s}_{key}"] = np.asarray(msg[key])
        if self.spectral_factors:
            for k, v in self.state[self.n_slots].items():
                arrays[f"spec_{k}"] = np.asarray(v)
        np.savez(path, **arrays)

    def load_state(self, path):
        """Restore a checkpoint written by ``save_state``. Follow with
        ``iterate(..., warm_start=True)`` to resume."""
        data = np.load(path)
        state = []
        for s in range(self.n_slots):
            msg = {key: jnp.asarray(data[f"s{s}_{key}"])
                   for key in self.message_keys}
            state.append(msg)
        state = tuple(state)
        if self.spectral_factors:
            if f"spec_{self.spectral_factors[0]}" in data.files:
                state = state + ({
                    str(i): jnp.asarray(data[f"spec_{i}"])
                    for i in self.spectral_factors},)
            else:
                # checkpoint from a SPECTRAL_CARRY=False run (or an older
                # version): rebuild the carried images from the slots
                state = self._refresh_spectral_cache(state)
        self.state = state
        self.n_iter = int(data["__n_iter__"])
        return self

    # -- objective (Bethe free entropy, reference l:306-328) ---------------
    def update_objective(self):
        A_nodes = 0.0
        for i, node in enumerate(self.nodes):
            A_nodes = A_nodes + self.node_objective_at(i, self.state)
        A_edges = 0.0
        for e in range(len(self.edges)):
            v_idx = self.edge_variable[e]
            msgs = [self.state[slot(e, FWD)], self.state[slot(e, BWD)]]
            post = {k: sum(m[k] for m in msgs) for k in self.message_keys}
            A_edges = A_edges + self.variable_objective(
                self.nodes[v_idx], v_idx, post)
        self.A_model = A_nodes - A_edges
        return self.A_model
