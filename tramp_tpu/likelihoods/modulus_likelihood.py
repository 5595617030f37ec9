"""Modulus likelihood y = |z| for complex z (phase retrieval).
Complex arrays are packed as real arrays Z with Z[0]=Re, Z[1]=Im; ALL
arithmetic is on the real planes (no complex dtype anywhere, exactly
equivalent to the complex form). Reference tramp/likelihoods/modulus_likelihood.py."""
import jax.numpy as jnp

from .base_likelihood import Likelihood
from ..utils.integration import gaussian_measure, gaussian_measure_2d


def i0e(x):
    "Exponentially scaled modified Bessel I0 (jax.scipy.special.i0e)."
    from jax.scipy.special import i0e as _i0e
    return _i0e(x)


def i1e(x):
    from jax.scipy.special import i1e as _i1e
    return _i1e(x)


def ive_ratio(r):
    "I(r) = I1e(r)/I0e(r), ~1 for r >> 1. Reference l:9-20."
    return i1e(r) / i0e(r)


def pair_abs(bz):
    """|bz| for packed bz (leading re/im axis). Gradient-safe at bz = 0:
    sqrt'(0) = inf would leak NaN into autodiff (log partitions are smooth
    even functions of |bz|, so the true gradient there is 0)."""
    sq = bz[0] ** 2 + bz[1] ** 2
    safe = jnp.where(sq == 0, 1.0, sq)
    return jnp.where(sq == 0, 0.0, jnp.sqrt(safe))


def pair_normalize(bz):
    "bz / |bz| for packed bz, 0 where bz == 0. Reference l:23-29."
    b = pair_abs(bz)
    return jnp.where(b == 0, 0.0, bz / jnp.where(b == 0, 1.0, b))


class ModulusLikelihood(Likelihood):

    _data_fields = ("y",)
    _meta_fields = ("y_name", "isotropic")

    def __init__(self, y, y_name="y", isotropic=True):
        self.y_name = y_name
        self.isotropic = isotropic
        self.y = None if y is None else jnp.asarray(y)

    def sample(self, key, Z):
        return pair_abs(Z)

    def math(self):
        return r"$|\cdot|$"

    def scalar_backward_mean(self, az, bz, y):
        "Packed (re/im) posterior mean y*I along the bz phase direction."
        b = pair_abs(bz)
        I = ive_ratio(b * y)
        return pair_normalize(bz) * y * I

    def scalar_backward_variance(self, az, bz, y):
        b = pair_abs(bz)
        I = ive_ratio(b * y)
        # 0.5 factor: averaging over the complex coordinate
        return 0.5 * y**2 * (1.0 - I**2)

    def scalar_log_partition(self, az, bz, y):
        b = pair_abs(bz) if bz.shape[0] == 2 else jnp.abs(bz)
        return (-0.5 * az * y**2
                + jnp.log(2 * jnp.pi * y * i0e(b * y)) + b * y)

    def compute_backward_posterior(self, az, bz, y):
        b = pair_abs(bz)
        I = ive_ratio(b * y)
        rz = pair_normalize(bz) * y * I
        vz = 0.5 * y**2 * (1.0 - I**2)
        if self.isotropic:
            vz = jnp.mean(vz)
        return rz, vz

    def compute_log_partition(self, az, bz, y):
        b = pair_abs(bz)
        A = (-0.5 * az * y**2
             + jnp.log(2 * jnp.pi * y * i0e(b * y)) + b * y)
        # 0.5 factor: averaging over the complex coordinate
        return jnp.mean(A) / 2

    def beliefs_measure(self, az, tau_z, f):
        """Reference l:101-120. The reference branches eagerly on
        u_eff == 0 (uninformative belief az*tau_z <= 1: no integration over
        b); az is traced inside the fused SE loop here, so both branches are
        evaluated and blended with a where (the zero branch's 1D measure is
        cheap)."""
        u_eff = jnp.maximum(0.0, az * tau_z - 1.0)
        pos = u_eff > 0
        u_safe = jnp.where(pos, u_eff, 1.0)
        sz_eff = jnp.sqrt(az * u_safe)

        # typical case u_eff > 0:
        # integrand relu(b)*relu(y)*ive(0, b y)*f (ive = scaled Bessel i0e)
        def f_typical(xi_b, xi_y):
            b = sz_eff * xi_b
            y = b / az + xi_y / jnp.sqrt(az)
            coef = 2 * jnp.pi / jnp.sqrt(u_safe)
            bz = jnp.stack([b, jnp.zeros_like(b)], axis=0)
            return (coef * jnp.maximum(b, 0.0) * jnp.maximum(y, 0.0)
                    * i0e(b * y) * f(bz, y))

        I_typical = gaussian_measure_2d(0.0, 1.0, 0.0, 1.0, f_typical)

        # special case az*tau_z <= 1 (b pinned at 0, 1D measure over y)
        def f_zero(xi_y):
            y = xi_y / jnp.sqrt(az)
            coef_y = jnp.sqrt(2 * jnp.pi * az)
            bz = jnp.stack([jnp.zeros_like(y), jnp.zeros_like(y)], axis=0)
            return coef_y * jnp.maximum(y, 0.0) * f(bz, y)

        I_zero = gaussian_measure(0.0, 1.0, f_zero)
        return jnp.where(pos, I_typical, I_zero)
