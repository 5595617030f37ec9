"""Gradient channel x = grad z: d circular first-derivative convolutions,
output shape (d,) + shape. FFT over the spatial axes only.
Reference tramp/channels/linear/gradient_channel.py.

Two spectral modes (ops/dft.py:packed_mode): complex dtype + XLA FFT (the
default), or packed-real (2, ...) pairs + real DFT matmuls
(config.FFT_MODE = "matmul")."""
import numpy as np
import jax.numpy as jnp
from ..ops import dft
from ..ops.dft import fftn, ifftn

from .base_channel import Channel
from ..utils.conv_filters import gradient_filters


class GradientChannel(Channel):

    _data_fields = ("filter", "w_fft", "w_fft_bar", "spectrum")
    _meta_fields = ("shape", "d", "real", "axes", "packed")

    def __init__(self, shape, real=True):
        self.d = len(shape)
        self.shape = tuple(shape)
        self.real = real
        self.packed = dft.packed_mode()
        f = gradient_filters(shape)
        self.filter = jnp.asarray(f)
        self.axes = tuple(range(1, self.d + 1))
        w_fft_bar = np.fft.fftn(f, axes=self.axes)
        if self.packed:
            # (2, d) + shape real pairs instead of complex leaves
            self.w_fft_bar = dft.pack_const(w_fft_bar)
            self.w_fft = dft.pack_const(np.conjugate(w_fft_bar))
        else:
            self.w_fft_bar = jnp.asarray(w_fft_bar)
            self.w_fft = jnp.asarray(np.conjugate(w_fft_bar))
        self.spectrum = jnp.asarray(
            (np.abs(w_fft_bar) ** 2).sum(axis=0))

    def convolve(self, z):
        if self.packed:
            z_fft = dft.fftn_real(z) if self.real else dft.fftn_pair(z)
            prod = dft.pair_mul(self.w_fft, z_fft[:, None])
            return (dft.ifftn_pair_real(prod, axes=self.axes) if self.real
                    else dft.ifftn_pair(prod, axes=self.axes))
        z_fft = fftn(z)
        x = ifftn(self.w_fft * z_fft[None], axes=self.axes)
        return jnp.real(x) if self.real else x

    def sample(self, key, Z):
        return self.convolve(Z)

    def math(self):
        return r"$\nabla$"

    def second_moment(self, tau_z):
        return tau_z * jnp.mean(self.spectrum) / self.d

    def compute_n_eff(self, az, ax):
        ratio = az / jnp.maximum(ax, 1e-30)
        n_eff = jnp.mean(self.spectrum / (ratio + self.spectrum))
        return jnp.where(ax == 0, 0.0, n_eff)

    def compute_backward_mean(self, az, bz, ax, bx, return_fft=False):
        resolvent = 1.0 / (az + ax * self.spectrum)
        if self.packed:
            if self.real:
                bx_fft = dft.fftn_real(bx, axes=self.axes)
                bz_fft = dft.fftn_real(bz)
            else:
                # bx is packed (2, d)+shape; axes index the unpacked shape
                bx_fft = dft.fftn_pair(bx, axes=self.axes)
                bz_fft = dft.fftn_pair(bz)
            acc = jnp.sum(dft.pair_mul(self.w_fft_bar, bx_fft), axis=1)
            rz_fft = resolvent * (bz_fft + acc)
            if return_fft:
                return rz_fft
            return (dft.ifftn_pair_real(rz_fft) if self.real
                    else dft.ifftn_pair(rz_fft))
        bx_fft = fftn(bx, axes=self.axes)
        bz_fft = fftn(bz)
        rz_fft = resolvent * (bz_fft
                              + jnp.sum(self.w_fft_bar * bx_fft, axis=0))
        if return_fft:
            return rz_fft
        rz = ifftn(rz_fft)
        return jnp.real(rz) if self.real else rz

    def compute_forward_mean(self, az, bz, ax, bx):
        rz_fft = self.compute_backward_mean(az, bz, ax, bx, return_fft=True)
        if self.packed:
            prod = dft.pair_mul(self.w_fft, rz_fft[:, None])
            return (dft.ifftn_pair_real(prod, axes=self.axes) if self.real
                    else dft.ifftn_pair(prod, axes=self.axes))
        rx = ifftn(self.w_fft * rz_fft[None], axes=self.axes)
        return jnp.real(rx) if self.real else rx

    def compute_backward_variance(self, az, ax):
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        v0 = jnp.mean(self.spectrum) / az
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (jnp.maximum(ax, 1e-30) * self.d)
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
        rx = self.compute_forward_mean(az, bz, ax, bx)
        a = az + ax * self.spectrum
        return (0.5 * jnp.sum(bz * rz) + 0.5 * jnp.sum(bx * rx)
                + 0.5 * jnp.sum(jnp.log(2 * jnp.pi / a)))
