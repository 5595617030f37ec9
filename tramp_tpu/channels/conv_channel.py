"""Circular convolution channels diagonalized by the FFT: the resolvent
messages are elementwise in Fourier space (no O(N^2) anywhere).
Reference tramp/channels/linear/conv_channel.py.

jnp.fft lowers to XLA's FFT (cuFFT on the GPU); spectra are precomputed
host-side as numpy constants."""
import numpy as np
import jax.numpy as jnp
from ..ops import dft
from ..ops.dft import fftn, ifftn

from .base_channel import Channel
from ..utils.conv_filters import (
    gaussian_filter, differential_filter, laplacian_filter)
from ..utils.misc import complex2array, array2complex


class ConvChannel(Channel):
    """x = w * z (circular). filter weights w[u] = f*[-u]; w_fft = conj(f_fft).
    Reference conv_channel.py:13-165.

    Two spectral modes (ops/dft.py:packed_mode): complex dtype + XLA FFT
    (the default), or packed-real (2, ...) pairs + real DFT matmuls
    (config.FFT_MODE = "matmul")."""

    _data_fields = ("filter", "w_fft", "w_fft_bar", "spectrum")
    _meta_fields = ("shape", "real", "packed")

    def __init__(self, filter, real=True):
        filter = np.asarray(filter)
        self.shape = filter.shape
        self.real = real
        self.packed = dft.packed_mode()
        self.filter = jnp.asarray(filter)
        w_fft_bar = np.fft.fftn(filter)
        if self.packed:
            self.w_fft_bar = dft.pack_const(w_fft_bar)
            self.w_fft = dft.pack_const(np.conjugate(w_fft_bar))
        else:
            self.w_fft_bar = jnp.asarray(w_fft_bar)
            self.w_fft = jnp.asarray(np.conjugate(w_fft_bar))
        self.spectrum = jnp.asarray(np.abs(w_fft_bar) ** 2)

    def convolve(self, z):
        if self.packed:
            z_fft = dft.fftn_real(z) if self.real else dft.fftn_pair(z)
            prod = dft.pair_mul(self.w_fft, z_fft)
            return (dft.ifftn_pair_real(prod) if self.real
                    else dft.ifftn_pair(prod))
        x = ifftn(self.w_fft * fftn(z))
        return jnp.real(x) if self.real else x

    def sample(self, key, Z):
        if self.packed:
            return self.convolve(Z)
        if not self.real:
            Z = array2complex(Z)
        X = self.convolve(Z)
        return X if self.real else complex2array(X)

    def math(self):
        return r"$\ast$"

    def second_moment(self, tau_z):
        return tau_z * jnp.mean(self.spectrum)

    def compute_n_eff(self, az, ax):
        ratio = az / jnp.maximum(ax, 1e-30)
        n_eff = jnp.mean(self.spectrum / (ratio + self.spectrum))
        return jnp.where(ax == 0, 0.0, n_eff)

    def compute_backward_mean(self, az, bz, ax, bx, return_fft=False):
        resolvent = 1.0 / (az + ax * self.spectrum)
        if self.packed:
            if self.real:
                bx_fft = dft.fftn_real(bx)
                bz_fft = dft.fftn_real(bz)
            else:
                bx_fft = dft.fftn_pair(bx)
                bz_fft = dft.fftn_pair(bz)
            rz_fft = resolvent * (bz_fft
                                  + dft.pair_mul(self.w_fft_bar, bx_fft))
            if return_fft:
                return rz_fft
            return (dft.ifftn_pair_real(rz_fft) if self.real
                    else dft.ifftn_pair(rz_fft))
        if not self.real:
            bz = array2complex(bz)
            bx = array2complex(bx)
        bx_fft = fftn(bx)
        bz_fft = fftn(bz)
        rz_fft = resolvent * (bz_fft + self.w_fft_bar * bx_fft)
        if return_fft:
            return rz_fft
        rz = ifftn(rz_fft)
        return jnp.real(rz) if self.real else complex2array(rz)

    def compute_forward_mean(self, az, bz, ax, bx):
        rz_fft = self.compute_backward_mean(az, bz, ax, bx, return_fft=True)
        if self.packed:
            prod = dft.pair_mul(self.w_fft, rz_fft)
            return (dft.ifftn_pair_real(prod) if self.real
                    else dft.ifftn_pair(prod))
        rx = ifftn(self.w_fft * rz_fft)
        return jnp.real(rx) if self.real else complex2array(rx)

    def compute_backward_variance(self, az, ax):
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_variance(self, az, ax):
        v0 = jnp.mean(self.spectrum) / az
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / jnp.maximum(ax, 1e-30)
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
        coef = 0.5 if self.real else 1.0
        return (0.5 * jnp.sum(bz * rz) + 0.5 * jnp.sum(bx * rx)
                + coef * jnp.sum(jnp.log(2 * jnp.pi / a)))

    def compute_mutual_information(self, az, ax, tau_z):
        return jnp.mean(0.5 * jnp.log((az + ax * self.spectrum) * tau_z))

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))


class DifferentialChannel(ConvChannel):
    _meta_fields = ("shape", "real", "D1", "D2")

    def __init__(self, D1, D2, shape, real=True):
        self.D1 = tuple(np.ravel(D1))
        self.D2 = tuple(np.ravel(D2)) if D2 is not None else None
        f = differential_filter(shape=shape, D1=D1, D2=D2)
        super().__init__(filter=f, real=real)

    def math(self):
        return r"$\partial$"


class LaplacianChannel(ConvChannel):
    def __init__(self, shape, real=True):
        super().__init__(filter=laplacian_filter(shape), real=real)

    def math(self):
        return r"$\Delta$"


class Blur1DChannel(ConvChannel):
    _meta_fields = ("shape", "real", "sigma")

    def __init__(self, sigma, N, real=True):
        self.sigma = sigma
        super().__init__(filter=gaussian_filter(sigma=sigma, N=N), real=real)


class Blur2DChannel(ConvChannel):
    _meta_fields = ("shape", "real", "sigma")

    def __init__(self, sigma, shape, real=True):
        if len(sigma) != 2:
            raise ValueError("sigma must be a length 2 array")
        if len(shape) != 2:
            raise ValueError("shape must be a length 2 tuple")
        self.sigma = tuple(sigma)
        f0 = gaussian_filter(sigma=sigma[0], N=shape[0])
        f1 = gaussian_filter(sigma=sigma[1], N=shape[1])
        super().__init__(filter=np.outer(f0, f1), real=real)
