"""Dense linear channel x = W z, diagonalized once in the SVD basis.

Design notes (vs reference tramp/channels/linear/linear_channel.py):
- the SVD is computed once at construction (host or device); EP messages are
  two dense matvecs in the SVD basis — pure GEMM work, batchable via vmap
  over instances and shardable over the mesh (only the contraction dims of
  U/V communicate).
- scalar messages (isotropic a) keep the resolvent a length-Nz vector; no
  data-dependent branching: az/ax == 0 edge cases use jnp.where.
"""
import jax.numpy as jnp

from .base_channel import Channel


class LinearChannel(Channel):
    """x = W z with W of shape (Nx, Nz).
    Reference linear_channel.py:18-143 (SVD precompute l:39-44, resolvent
    backward mean l:69-83, n_eff spectral sums l:58-67)."""

    _data_fields = ("W", "U", "s", "V", "spectrum", "singular")
    _meta_fields = ("Nx", "Nz", "k", "rank", "alpha", "name")

    def __init__(self, W, name="W", rank=None, svd=None):
        W = jnp.asarray(W)
        self.W = W
        self.Nx, self.Nz = W.shape
        self.name = name
        k = min(self.Nx, self.Nz)
        self.k = k
        if svd is not None:
            U, s, Vt = svd  # precomputed (e.g. on host in float64)
        else:
            U, s, Vt = jnp.linalg.svd(W, full_matrices=False)
        # THIN factors only (Nx,k) / (Nz,k): the orthogonal complements
        # never carry signal — modes beyond k see resolvent 1/az, which the
        # mean computations restore via the projector identity
        # V_perp V_perp^T = I - V_k V_k^T (see compute_backward_mean). At
        # alpha=1/2 this halves the per-sweep GEMM MACs AND the U/V weight
        # HBM traffic vs the full square factors.
        self.U = jnp.asarray(U)[:, :k]   # (Nx, k)
        self.V = jnp.asarray(Vt)[:k].T   # (Nz, k)
        self.s = jnp.asarray(s)[:k]      # (k,)
        # spectrum of W^T W, length Nz (padded with zeros)
        self.spectrum = jnp.zeros(self.Nz).at[:k].set(s**2)
        self.rank = rank if rank is not None else int(
            jnp.sum(s > s[0] * max(self.Nx, self.Nz) * 1e-12))
        self.singular = self.spectrum[:self.rank]
        self.alpha = self.Nx / self.Nz

    def sample(self, key, Z):
        return self.W @ Z

    def math(self):
        return rf"${self.name}$"

    def second_moment(self, tau_z):
        return tau_z * jnp.sum(self.spectrum) / self.Nx

    def compute_n_eff(self, az, ax):
        "Effective number of parameters / Nz. Reference l:58-67."
        ratio = az / jnp.maximum(ax, 1e-30)
        n_eff = jnp.sum(self.singular / (ratio + self.singular)) / self.Nz
        n_eff = jnp.where(ax == 0, 0.0, n_eff)
        return n_eff

    def _mm(self, A, x, transpose=False):
        """``A @ x`` (or ``A.T @ x``) for the SVD-basis factors. With
        config.matvec_bf16() both operands stream as bfloat16 with float32
        accumulation, halving their weight traffic; XLA hoists the
        loop-invariant casts out of the fused sweep loop. The bf16 operand
        rounding moves the fixed point, so the gate is off by default."""
        from .. import config
        if not config.matvec_bf16():
            return (A.T if transpose else A) @ x
        import jax
        dn = (((0 if transpose else 1,), (0,)), ((), ()))
        return jax.lax.dot_general(
            A.astype(jnp.bfloat16), x.astype(jnp.bfloat16), dn,
            preferred_element_type=jnp.float32)

    def _mean_svd(self, az, bz, ax, bx):
        """k-length spectral mean m = res_k (V^T bz + s U^T bx) with
        res_k = 1/(az + ax s^2), plus t = V^T bz (reused by the complement
        term of the backward mean). Ref linear_channel.py l:69-83, but on
        the THIN factors only — complement modes are handled analytically.
        Routed through the same _resolvent_mean as the spectral-carry
        kernels so the cached and uncached paths cannot drift apart."""
        t = self._mm(self.V, bz, transpose=True)   # (k,) or (k, B)
        u = self._mm(self.U, bx, transpose=True)   # (k,) or (k, B)
        m, _ = self._resolvent_mean(az, bz, ax, t, u)
        return m, t

    def compute_backward_mean(self, az, bz, ax, bx):
        m, t = self._mean_svd(az, bz, ax, bx)
        if self.k == self.Nz:
            return self._mm(self.V, m)
        # complement modes (s=0) have resolvent 1/az:
        #   V_perp V_perp^T bz / az = (bz - V_k V_k^T bz) / az
        return bz / az + self._mm(self.V, m - t / az)

    # -- spectral-carry kernels (engine SPECTRAL_CARRY support) -----------
    # The same math as _mean_svd / compute_*_mean, but parameterized on the
    # carried image u = U^T bx so the EP engine's cross-sweep cache stays
    # BIT-IDENTICAL to the uncached path by construction (the engine calls
    # THESE instead of duplicating the resolvent/projector expressions —
    # a drift here breaks both paths together, loudly).
    def spectral_image(self, bx):
        "The carried image u = U^T bx (k-length)."
        return self._mm(self.U, bx, transpose=True)

    def _resolvent_mean(self, az, bz, ax, t, u):
        res = 1.0 / (az + ax * self.s**2)
        s = self.s
        if bz.ndim > 1:
            res = res[..., None]
            s = s[:, None]
        return res * (t + s * u), s

    def spectral_forward_posterior(self, az, bz, ax, u):
        "(rx, vx) using the carried u = U^T bx; no fresh U^T GEMM."
        t = self._mm(self.V, bz, transpose=True)
        m, s = self._resolvent_mean(az, bz, ax, t, u)
        rx = self._mm(self.U, s * m)
        return rx, self.compute_forward_variance(az, ax)

    def spectral_backward_posterior(self, az, bz, ax, bx):
        "(rz, vz, u): the fresh u = U^T bx becomes the carried image."
        t = self._mm(self.V, bz, transpose=True)
        u = self.spectral_image(bx)
        m, _ = self._resolvent_mean(az, bz, ax, t, u)
        if self.k == self.Nz:
            rz = self._mm(self.V, m)
        else:
            rz = bz / az + self._mm(self.V, m - t / az)
        return rz, self.compute_backward_variance(az, ax), u

    def compute_forward_mean(self, az, bz, ax, bx):
        # rx = W rz = U (s * m): only the k signal modes contribute — one
        # (Nx, k) matmul instead of W @ (V @ rz_svd)'s Nz^2 + Nx*Nz
        m, _ = self._mean_svd(az, bz, ax, bx)
        s = self.s[:, None] if bz.ndim > 1 else self.s
        return self._mm(self.U, s * m)

    def compute_backward_variance(self, az, ax):
        az = jnp.maximum(1e-11, az)
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        s_mean = jnp.mean(self.singular)
        v0 = s_mean * self.rank / (self.Nx * az)  # ax == 0 limit (ref l:97-99)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * jnp.maximum(ax, 1e-30))
        return jnp.where(ax == 0, v0, v)

    def compute_backward_posterior(self, az, bz, ax, bx):
        return (self.compute_backward_mean(az, bz, ax, bx),
                self.compute_backward_variance(az, ax))

    def compute_forward_posterior(self, az, bz, ax, bx):
        return (self.compute_forward_mean(az, bz, ax, bx),
                self.compute_forward_variance(az, ax))

    def compute_backward_error(self, az, ax, tau_z):
        return self.compute_backward_variance(az, ax)

    def compute_forward_error(self, az, ax, tau_z):
        return self.compute_forward_variance(az, ax)

    def compute_log_partition(self, az, bz, ax, bx):
        rz = self.compute_backward_mean(az, bz, ax, bx)
        b = bz + self.W.T @ bx
        a = az + ax * self.spectrum
        return 0.5 * jnp.sum(b * rz) + 0.5 * jnp.sum(jnp.log(2 * jnp.pi / a))

    def compute_mutual_information(self, az, ax, tau_z):
        return jnp.mean(0.5 * jnp.log((az + ax * self.spectrum) * tau_z))

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))
