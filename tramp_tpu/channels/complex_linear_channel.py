"""Complex linear channel x = W z with complex SVD; complex arrays packed
as real (2, ...) arrays. Reference tramp/channels/linear/complex_linear_channel.py.

The SVD factors are stored as (2, n, n) re/im pairs and applied with real
matmuls (ops/dft.py:pair_matmul) — no complex dtype on device, at the
same cost as a complex matmul (XLA decomposes complex dots into real dots
anyway). The SVD itself is computed host-side
in numpy (complex128) at construction, like LinearChannel's host SVD path.
"""
import numpy as np
import jax.numpy as jnp

from .base_channel import Channel
from ..ops.dft import pack_const, pair_matmul


class ComplexLinearChannel(Channel):

    _data_fields = ("W", "U", "s", "V", "spectrum", "singular")
    _meta_fields = ("Nx", "Nz", "k", "rank", "alpha", "name")

    def __init__(self, W, name="W", rank=None, svd=None):
        W = np.asarray(W)
        self.Nx, self.Nz = W.shape
        self.name = name
        if svd is not None:
            U, s, Vh = (np.asarray(a) for a in svd)
        else:
            U, s, Vh = np.linalg.svd(W, full_matrices=False)
        k = min(self.Nx, self.Nz)
        self.k = k
        # THIN factors only, as in LinearChannel: complement modes (s=0,
        # resolvent 1/az) are restored via V_perp V_perp^H = I - V_k V_k^H
        self.W = pack_const(W)                    # (2, Nx, Nz)
        self.U = pack_const(U[:, :k])             # (2, Nx, k)
        self.V = pack_const(Vh[:k].conj().T)      # (2, Nz, k)
        s = s[:k]
        self.s = jnp.asarray(np.real(s))
        spectrum = np.zeros(self.Nz)
        spectrum[:k] = np.real(s) ** 2
        self.spectrum = jnp.asarray(spectrum)
        self.rank = rank if rank is not None else int(
            np.sum(s > s[0] * max(self.Nx, self.Nz) * 1e-12))
        self.singular = self.spectrum[:self.rank]
        self.alpha = self.Nx / self.Nz

    def sample(self, key, Z):
        return pair_matmul(self.W, Z)

    def math(self):
        return rf"${self.name}$"

    def second_moment(self, tau_z):
        return tau_z * jnp.sum(self.spectrum) / self.Nx

    def compute_n_eff(self, az, ax):
        ratio = az / jnp.maximum(ax, 1e-30)
        n_eff = jnp.sum(self.singular / (ratio + self.singular)) / self.Nz
        return jnp.where(ax == 0, 0.0, n_eff)

    def _mean_svd(self, az, bz, ax, bx):
        """k-length packed spectral mean m = res_k (V^H bz + s U^H bx),
        plus t = V^H bz for the complement term (thin factors, as in
        LinearChannel._mean_svd)."""
        u = pair_matmul(self.U, bx, adjoint=True)   # (2, k)
        t = pair_matmul(self.V, bz, adjoint=True)   # (2, k)
        resolvent = 1.0 / (az + ax * self.s**2)
        return resolvent * (t + self.s * u), t

    def compute_backward_mean(self, az, bz, ax, bx):
        m, t = self._mean_svd(az, bz, ax, bx)
        if self.k == self.Nz:
            return pair_matmul(self.V, m)
        # complement modes (s=0): V_perp V_perp^H bz / az = (bz - V t)/az
        return bz / az + pair_matmul(self.V, m - t / az)

    def compute_forward_mean(self, az, bz, ax, bx):
        # rx = W rz = U (s * m): only the k signal modes contribute
        m, _ = self._mean_svd(az, bz, ax, bx)
        return pair_matmul(self.U, self.s * m)

    def compute_backward_variance(self, az, ax):
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        s_mean = jnp.mean(self.singular)
        v0 = s_mean * self.rank / (self.Nx * az)
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
        b = bz + pair_matmul(self.W, bx, adjoint=True)
        a = az + ax * self.spectrum
        return 0.5 * jnp.sum(b * rz) + jnp.sum(jnp.log(2 * jnp.pi / a))

    def compute_mutual_information(self, az, ax, tau_z):
        return jnp.mean(0.5 * jnp.log((az + ax * self.spectrum) * tau_z))

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))
