"""Unitary DFT channel x = FFT z (ortho-normalized): messages are FFTs.
Reference tramp/channels/linear/dft_channel.py.

Two spectral modes (chosen at construction, ops/dft.py:packed_mode):
complex dtype + XLA FFT (the default), or packed-real (2, ...) pairs + real
DFT matmuls (config.FFT_MODE = "matmul"; the output x is a packed pair in
BOTH modes — complex variables use the reference's complex2array layout).
"""
import jax.numpy as jnp

from ..ops import dft
from .base_channel import Channel
from ..utils.misc import complex2array, array2complex


class DFTChannel(Channel):

    _data_fields = ()
    _meta_fields = ("real", "packed")

    def __init__(self, real=True):
        self.real = real
        self.packed = dft.packed_mode()

    def sample(self, key, Z):
        if self.packed:
            if self.real:
                return dft.fftn_real(Z, norm="ortho")
            return dft.fftn_pair(Z, norm="ortho")
        if not self.real:
            Z = array2complex(Z)
        return complex2array(dft.fftn(Z, norm="ortho"))

    def math(self):
        return r"$\mathcal{F}$"

    def second_moment(self, tau_z):
        return tau_z

    def compute_forward_message(self, az, bz, ax, bx):
        if self.packed:
            bx_new = (dft.fftn_real(bz, norm="ortho") if self.real
                      else dft.fftn_pair(bz, norm="ortho"))
            return az, bx_new
        if not self.real:
            bz = array2complex(bz)
        bx_new = complex2array(dft.fftn(bz, norm="ortho"))
        return az, bx_new

    def compute_backward_message(self, az, bz, ax, bx):
        if self.packed:
            bz_new = (dft.ifftn_pair_real(bx, norm="ortho") if self.real
                      else dft.ifftn_pair(bx, norm="ortho"))
            return ax, bz_new
        bz_new = dft.ifftn(array2complex(bx), norm="ortho")
        bz_new = jnp.real(bz_new) if self.real else complex2array(bz_new)
        return ax, bz_new

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        _, bz_new = self.compute_backward_message(az, bz, ax, bx)
        b = bz + bz_new
        a = az + ax
        coef = 0.5 if self.real else 1.0
        n = b.size if self.real else b.size / 2
        return 0.5 * jnp.sum(b**2 / a) + coef * n * jnp.log(2 * jnp.pi / a)

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * jnp.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))
