"""Spectral VAMP fast path for GLM chains: prior @ LinearChannel @
GaussianLikelihood.

VAMP (Rangan, Schniter, Fletcher, "Vector Approximate Message Passing",
2019 — the same moment-matching fixed point as EP on this factor chain)
keeps the Gaussian-likelihood LMMSE step ENTIRELY in the SVD basis: per
iteration only two dense GEMMs against the THIN factor V_k (Nz, k),
k = min(Nx, Nz), remain — V_k^T r2 into the spectral basis and
V_k (d - t) back out, the complement modes riding along analytically
(x2 = r2 + V_k (d - t), since d_perp = t_perp). That is 2 Nz k MACs
per iteration vs the generic engine's full per-sweep cost. The reference has no GLM
fast path (its embedded VAMP solver serves only the low-rank
factorization channels, tramp/channels/low_rank/AMP_matrix_factorization.py).

Iteration (standard VAMP form; gamma = cavity precisions):
  x1, v1 = prior_denoise(r1, gamma1)          # separable prior posterior
  alpha1 = gamma1 <v1>;  r2 = (x1 - alpha1 r1)/(1 - alpha1)
  gamma2 = gamma1 (1 - alpha1)/alpha1
  d  = (gamma2 V^T r2 + S U^T y / Delta) / (S^2/Delta + gamma2)   # LMMSE
  x2 = V d;  alpha2 = gamma2 <(S^2/Delta + gamma2)^{-1}>
  r1 = (x2 - alpha2 r2)/(1 - alpha2);  gamma1 = gamma2 (1 - alpha2)/alpha2

Fixed points match the generic EP engine to solver tolerance (tested,
tests/test_vamp_glm.py); convergence is measured on the mean posterior
variance <v1> like the reference's EarlyStopping.
"""
import numpy as np
import jax
import jax.numpy as jnp

from .. import config
from ..likelihoods import GaussianLikelihood
from ..channels import LinearChannel


def _find_glm_parts(model):
    "Extract the exact (prior, LinearChannel, GaussianLikelihood) chain."
    factors = list(model.factors)
    ok = (len(factors) == 3
          and factors[0].n_prev == 0
          and isinstance(factors[1], LinearChannel)
          and isinstance(factors[2], GaussianLikelihood)
          and factors[2].y is not None)
    if not ok:
        raise ValueError(
            "SpectralVAMPSolver needs exactly a prior @ LinearChannel @ "
            f"GaussianLikelihood chain, got {factors}")
    return factors[0], factors[1], factors[2]


def _variable_ids(model):
    "(signal id, observation-side id) of the prior->W->likelihood chain."
    x_id, z_id = model.variable_ids
    return x_id, z_id


class SpectralVAMPSolver:
    """VAMP on a GLM chain, diagonalized in the SVD basis.

    Parameters mirror EPSolver: `model` fixes the static structure; solve
    calls accept any same-structure pytree. `damping` damps the r1/gamma1
    update (rarely needed for i.i.d. ensembles)."""

    def __init__(self, model, damping=None, tol=1e-6, max_iter=200):
        _find_glm_parts(model)  # validate structure
        x_id, z_id = _variable_ids(model)
        self.tol = tol
        self.max_iter = max_iter
        self.damping = 0.0 if damping is None else float(damping)
        damp = self.damping

        def spectral(model):
            "Loop-invariant spectral quantities (thin k-length vectors)."
            prior, lin, lik = _find_glm_parts(model)
            Delta = lik.var
            uy = lin._mm(lin.U, lik.y, transpose=True)   # (k,)
            p = lin.s * uy / Delta                       # (k,)
            s2d = lin.s**2 / Delta                       # (k,)
            return prior, lin, p, s2d

        def step(model, carry):
            prior, lin, p, s2d = spectral(model)
            r1, gamma1 = carry
            x1, v1 = prior.compute_forward_posterior(gamma1, gamma1 * r1)
            v1 = jnp.mean(v1)
            alpha1 = jnp.clip(gamma1 * v1, 1e-11, 1.0 - 1e-11)
            r2 = (x1 - alpha1 * r1) / (1.0 - alpha1)
            gamma2 = jnp.clip(gamma1 * (1.0 - alpha1) / alpha1,
                              config.AMIN, config.AMAX)
            t = lin._mm(lin.V, r2, transpose=True)    # (k,)
            den = s2d + gamma2
            d = (gamma2 * t + p) / den
            if lin.k == lin.Nz:
                x2 = lin._mm(lin.V, d)
                inv_den_mean = jnp.mean(1.0 / den)
            else:
                # complement modes (s=0): d_perp = t_perp, so
                # x2 = V_k d + V_perp V_perp^T r2 = r2 + V_k (d - t)
                x2 = r2 + lin._mm(lin.V, d - t)
                inv_den_mean = (jnp.sum(1.0 / den)
                                + (lin.Nz - lin.k) / gamma2) / lin.Nz
            alpha2 = jnp.clip(gamma2 * inv_den_mean,
                              1e-11, 1.0 - 1e-11)
            r1_new = (x2 - alpha2 * r2) / (1.0 - alpha2)
            gamma1_new = jnp.clip(gamma2 * (1.0 - alpha2) / alpha2,
                                  config.AMIN, config.AMAX)
            if damp:
                r1_new = damp * r1 + (1.0 - damp) * r1_new
                gamma1_new = damp * gamma1 + (1.0 - damp) * gamma1_new
            return (r1_new, gamma1_new), (x1, v1)

        def init(model):
            prior, lin, p, s2d = spectral(model)
            r1 = jnp.zeros(lin.Nz, p.dtype)
            # uninformative start: prior-only cavity (reference a=0 init
            # clipped to AMIN)
            gamma1 = jnp.asarray(config.AMIN, p.dtype)
            return (r1, gamma1)

        def run(model, max_iter, tol):
            def cond(state):
                carry, old_v, i, done, conv = state
                return (~done) & (i < max_iter)

            def body(state):
                carry, old_v, i, done, conv = state
                new_carry, (x1, v1) = step(model, carry)
                ok = (jnp.all(jnp.isfinite(new_carry[0]))
                      & jnp.isfinite(new_carry[1]))
                new_carry = jax.tree.map(
                    lambda n, o: jnp.where(ok, n, o), new_carry, carry)
                delta = jnp.abs(v1 - old_v)
                converged = (i > 0) & (delta < tol)
                conv = conv | (~done & converged)
                done = done | converged | (~ok)
                return (new_carry, v1, i + 1, done, conv)

            carry0 = init(model)
            carry, v, i, done, conv = jax.lax.while_loop(
                cond, body, (carry0, jnp.asarray(jnp.inf, carry0[0].dtype),
                             jnp.asarray(0), jnp.asarray(False),
                             jnp.asarray(False)))
            # final posteriors from the converged cavity (keys = the
            # model's actual variable ids, matching the EPSolver contract)
            prior, lin, p, s2d = spectral(model)
            r1, gamma1 = carry
            x1, v1 = prior.compute_forward_posterior(gamma1, gamma1 * r1)
            v1 = jnp.mean(v1)
            # z = W x posterior: one readout LMMSE pass (not per-iteration)
            alpha1 = jnp.clip(gamma1 * v1, 1e-11, 1.0 - 1e-11)
            r2 = (x1 - alpha1 * r1) / (1.0 - alpha1)
            gamma2 = jnp.clip(gamma1 * (1.0 - alpha1) / alpha1,
                              config.AMIN, config.AMAX)
            t = lin._mm(lin.V, r2, transpose=True)    # (k,)
            den = s2d + gamma2
            d = (gamma2 * t + p) / den
            # z = W x: only the k signal modes contribute (s=0 beyond k)
            z_hat = lin._mm(lin.U, lin.s * d)
            v_z = jnp.sum(lin.s**2 / den) / lin.Nx
            return ({x_id: {"r": x1, "v": v1},
                     z_id: {"r": z_hat, "v": v_z}}, i, conv)

        self._step = step
        self._init = init
        self._run = run
        self._jit_single = jax.jit(run)
        self._jit_batch = jax.jit(jax.vmap(run, in_axes=(0, None, None)))

    def solve(self, model):
        post, n_iter, conv = self._jit_single(
            model, jnp.asarray(self.max_iter), jnp.asarray(self.tol))
        return post, n_iter

    def solve_info(self, model):
        return self._jit_single(
            model, jnp.asarray(self.max_iter), jnp.asarray(self.tol))

    def solve_batch(self, stacked_model):
        post, n_iter, conv = self._jit_batch(
            stacked_model, jnp.asarray(self.max_iter),
            jnp.asarray(self.tol))
        return post, n_iter
