"""The generic nonlinearity engine: activations as mixtures of linear
regions, merged by a softmax over per-region log partitions.
Reference tramp/channels/activation/piecewise_linear_channel.py.

The regions list is static; the per-region truncated-Gaussian moments are
pure elementwise jnp code, so XLA fuses the whole posterior into one
elementwise chain (one pass over the data)."""
import functools

import jax
import jax.numpy as jnp
from jax.scipy.special import logsumexp

from .base_channel import Channel
from ..utils.linear_region import LinearRegion


class PiecewiseLinearChannel(Channel):

    _data_fields = ()
    _meta_fields = ("name", "region_specs")

    def __init__(self, name, regions):
        self.name = name
        # keep static, hashable region parameters for pytree metadata
        self.region_specs = tuple(
            (r["zmin"], r["zmax"], r["x0"], r["slope"]) for r in regions
        )

    @property
    def regions(self):
        return [LinearRegion(zmin=zmin, zmax=zmax, x0=x0, slope=slope)
                for (zmin, zmax, x0, slope) in self.region_specs]

    @property
    def n_regions(self):
        return len(self.region_specs)

    def sample(self, key, Z):
        return sum(region.sample(Z) for region in self.regions)

    def math(self):
        return rf"$\mathrm{{{self.name}}}$"

    def second_moment(self, tau_z):
        taus = [region.second_moment(tau_z) for region in self.regions]
        ps = [region.proba_tau(tau_z) for region in self.regions]
        return sum(p * tau for p, tau in zip(ps, taus))

    def _merge_elementwise(self, rs, vs, As):
        """Softmax-weighted mixture of region moments, no isotropic reduce.

        Unrolled over the static regions: stacking them into (K, ...)
        arrays and reducing over K splits XLA's elementwise fusion."""
        A_max = jax.lax.stop_gradient(functools.reduce(jnp.maximum, As))
        ws = [jnp.exp(A - A_max) for A in As]
        Z = sum(ws)
        ps = [w / Z for w in ws]
        r = sum(p * r_k for p, r_k in zip(ps, rs))
        # cross-region variance sum_{i<j} p_i p_j (r_i-r_j)^2
        #   = E[r^2] - E[r]^2 over region weights
        Dr = sum(p * r_k**2 for p, r_k in zip(ps, rs)) - r**2
        v = sum(p * v_k for p, v_k in zip(ps, vs)) + Dr
        return r, v

    def merge_estimates(self, rs, vs, As):
        "Merged posterior with isotropic variance. Reference l:27-37."
        r, v = self._merge_elementwise(rs, vs, As)
        return r, jnp.mean(v)

    # elementwise SE integrands (see Channel.scalar_* in base_channel.py)
    def _region_moments(self, az, bz, ax, bx, direction):
        rgs = self.regions
        if direction == "fwd":
            rs = [rg.forward_mean(az, bz, ax, bx) for rg in rgs]
            vs = [rg.forward_variance(az, bz, ax, bx) for rg in rgs]
        else:
            rs = [rg.backward_mean(az, bz, ax, bx) for rg in rgs]
            vs = [rg.backward_variance(az, bz, ax, bx) for rg in rgs]
        As = [rg.log_partitions(az, bz, ax, bx) for rg in rgs]
        return rs, vs, As

    def scalar_forward_variance(self, az, bz, ax, bx):
        return self._merge_elementwise(
            *self._region_moments(az, bz, ax, bx, "fwd"))[1]

    def scalar_backward_variance(self, az, bz, ax, bx):
        return self._merge_elementwise(
            *self._region_moments(az, bz, ax, bx, "bwd"))[1]

    def scalar_log_partition(self, az, bz, ax, bx):
        As = jnp.stack(
            [rg.log_partitions(az, bz, ax, bx) for rg in self.regions], 0)
        return logsumexp(As, axis=0)

    def compute_forward_posterior(self, az, bz, ax, bx):
        rs = [rg.forward_mean(az, bz, ax, bx) for rg in self.regions]
        vs = [rg.forward_variance(az, bz, ax, bx) for rg in self.regions]
        As = [rg.log_partitions(az, bz, ax, bx) for rg in self.regions]
        return self.merge_estimates(rs, vs, As)

    def compute_backward_posterior(self, az, bz, ax, bx):
        rs = [rg.backward_mean(az, bz, ax, bx) for rg in self.regions]
        vs = [rg.backward_variance(az, bz, ax, bx) for rg in self.regions]
        As = [rg.log_partitions(az, bz, ax, bx) for rg in self.regions]
        return self.merge_estimates(rs, vs, As)

    def compute_log_partition(self, az, bz, ax, bx):
        As = jnp.stack(
            [rg.log_partitions(az, bz, ax, bx) for rg in self.regions], axis=0)
        return jnp.sum(logsumexp(As, axis=0))

    def beliefs_measure(self, az, ax, tau_z, f):
        return sum(
            rg.beliefs_measure(az, ax, tau_z, f) for rg in self.regions)


class LeakyReluChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "slope")

    def __init__(self, slope):
        self.slope = slope
        neg = dict(zmin=-jnp.inf, zmax=0.0, slope=slope, x0=0.0)
        pos = dict(zmin=0.0, zmax=jnp.inf, slope=1.0, x0=0.0)
        super().__init__(name="l-relu", regions=[pos, neg])


class SgnChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-jnp.inf, zmax=0.0, slope=0.0, x0=-1.0)
        pos = dict(zmin=0.0, zmax=jnp.inf, slope=0.0, x0=+1.0)
        super().__init__(name="sgn", regions=[pos, neg])


class AbsChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-jnp.inf, zmax=0.0, slope=-1.0, x0=0.0)
        pos = dict(zmin=0.0, zmax=jnp.inf, slope=+1.0, x0=0.0)
        super().__init__(name="abs", regions=[pos, neg])


class AsymmetricAbsChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "shift")

    def __init__(self, shift=1e-4):
        self.shift = shift
        neg = dict(zmin=-jnp.inf, zmax=shift, slope=-1.0, x0=0.0)
        pos = dict(zmin=shift, zmax=jnp.inf, slope=+1.0, x0=0.0)
        super().__init__(name="a-abs", regions=[pos, neg])


class ReluChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-jnp.inf, zmax=0.0, slope=0.0, x0=0.0)
        pos = dict(zmin=0.0, zmax=jnp.inf, slope=1.0, x0=0.0)
        super().__init__(name="relu", regions=[pos, neg])


class HardTanhChannel(PiecewiseLinearChannel):
    def __init__(self):
        neg = dict(zmin=-jnp.inf, zmax=-1.0, slope=0.0, x0=-1.0)
        mid = dict(zmin=-1.0, zmax=+1.0, slope=1.0, x0=0.0)
        pos = dict(zmin=1.0, zmax=jnp.inf, slope=0.0, x0=1.0)
        super().__init__(name="h-tanh", regions=[pos, mid, neg])


class HardSigmoidChannel(PiecewiseLinearChannel):
    def __init__(self):
        L = 2.5
        neg = dict(zmin=-jnp.inf, zmax=-L, slope=0.0, x0=0.0)
        mid = dict(zmin=-L, zmax=+L, slope=1.0 / (2 * L), x0=0.5)
        pos = dict(zmin=L, zmax=jnp.inf, slope=0.0, x0=1.0)
        super().__init__(name="h-sigm", regions=[pos, mid, neg])


class SymmetricDoorChannel(PiecewiseLinearChannel):
    _meta_fields = ("name", "region_specs", "width")

    def __init__(self, width):
        self.width = width
        neg = dict(zmin=-jnp.inf, zmax=-width, slope=0.0, x0=+1.0)
        mid = dict(zmin=-width, zmax=+width, slope=0.0, x0=-1.0)
        pos = dict(zmin=+width, zmax=jnp.inf, slope=0.0, x0=+1.0)
        super().__init__(name="door", regions=[pos, mid, neg])
