"""Ensemble-averaged linear channels for state evolution (no matrix, no N).
Reference tramp/channels/linear/analytical_linear_channel.py and
tramp/ensembles/marchenko_pastur_ensemble.py."""
import numpy as np
import jax
import jax.numpy as jnp

from .base_channel import Channel
from ..utils.integration import composite_gauss_legendre


class AnalyticalLinearChannel(Channel):
    "SE-only channel parameterized by a spectral ensemble. Ref l:8-64."

    _data_fields = ()
    _meta_fields = ("name", "alpha", "ensemble")

    def __init__(self, ensemble, name="W"):
        self.name = name
        self.alpha = ensemble.alpha
        self.ensemble = ensemble

    def sample(self, key, Z):
        N = Z.shape[0]
        F = self.ensemble.generate(key, N)
        return F @ Z

    def math(self):
        return rf"${self.name}$"

    def second_moment(self, tau_z):
        return tau_z * (self.ensemble.mean_spectrum / self.alpha)

    def compute_n_eff(self, az, ax):
        gamma = ax / jnp.maximum(az, 1e-30)
        n_eff = 1.0 - self.ensemble.eta_transform(gamma)
        n_eff = jnp.where(ax == 0, 0.0, n_eff)
        return n_eff

    def compute_backward_error(self, az, ax, tau_z):
        az = jnp.maximum(1e-11, az)
        n_eff = self.compute_n_eff(az, ax)
        return (1.0 - n_eff) / az

    def compute_forward_error(self, az, ax, tau_z):
        v0 = self.ensemble.mean_spectrum / (self.alpha * jnp.maximum(az, 1e-30))
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * jnp.maximum(ax, 1e-30))
        return jnp.where(ax == 0, v0, v)

    def compute_mutual_information(self, az, ax, tau_z):
        gamma = ax / az
        S = self.ensemble.shannon_transform(gamma)
        return 0.5 * jnp.log(az * tau_z) + 0.5 * S

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + self.alpha * ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))


class MarchenkoPasturChannel(AnalyticalLinearChannel):
    """Closed-form Marchenko-Pastur SE channel. Reference l:68-92.

    ``alpha`` is a pytree *leaf* (all MP transforms are closed-form jnp
    expressions in alpha), so stacked models over an (alpha, rho) grid vmap
    into a single compiled SE sweep — the batched phase-diagram axis."""

    _data_fields = ("alpha",)
    _meta_fields = ("name",)

    def __init__(self, alpha, name="W"):
        self.name = name
        self.alpha = alpha

    @property
    def ensemble(self):
        from ..ensembles.marchenko_pastur_ensemble import (
            MarchenkoPasturEnsemble)
        return MarchenkoPasturEnsemble(alpha=float(self.alpha))

    def sample(self, key, Z):
        N = Z.shape[0]
        M = int(float(self.alpha) * N)
        F = jax.random.normal(key, (M, N)) / jnp.sqrt(N)
        return F @ Z

    def second_moment(self, tau_z):
        # int z dMP(z) = alpha exactly (bulk mean; the atom at 0 contributes
        # nothing), so mean_spectrum / alpha = 1
        return tau_z * jnp.ones_like(jnp.asarray(self.alpha))

    def _F(self, gamma):
        "(sqrt(gamma z_max + 1) - sqrt(gamma z_min + 1))^2, MP edges."
        sqa = jnp.sqrt(self.alpha)
        z_max = (1 + sqa) ** 2
        z_min = (1 - sqa) ** 2
        return (jnp.sqrt(gamma * z_max + 1)
                - jnp.sqrt(gamma * z_min + 1)) ** 2

    def compute_n_eff(self, az, ax):
        gamma = ax / jnp.maximum(az, 1e-30)
        F = self._F(gamma)
        eta = 1 - F / (4 * jnp.maximum(gamma, 1e-30))
        n_eff = 1.0 - eta
        return jnp.where(ax == 0, 0.0, n_eff)

    def compute_forward_error(self, az, ax, tau_z):
        v0 = 1.0 / jnp.maximum(az, 1e-30)
        n_eff = self.compute_n_eff(az, ax)
        v = n_eff / (self.alpha * jnp.maximum(ax, 1e-30))
        return jnp.where(ax == 0, v0, v)

    def compute_mutual_information(self, az, ax, tau_z):
        gamma = ax / az
        F = self._F(gamma)
        S = (jnp.log(1 + self.alpha * gamma - F / 4)
             + self.alpha * jnp.log(1 + gamma - F / 4)
             - F / (4 * gamma))
        return 0.5 * jnp.log(az * tau_z) + 0.5 * S

    def compute_precision(self, vz, vx, tau_z):
        ax = 1.0 / vx - 1.0 / vz
        az = (1.0 - self.alpha * ax * vx) / vz
        return az, ax

    def compute_dual_mutual_information(self, vz, vx, tau_z):
        Iz = 0.5 * jnp.log(tau_z / vz) - 0.5
        J = 0.5 * self.alpha * (jnp.log(vz / vx) + vx / vz - 1.0)
        return J + Iz

    def compute_dual_free_energy(self, mz, mx, tau_z):
        tau_x = self.second_moment(tau_z)
        I_dual = self.compute_dual_mutual_information(
            tau_z - mz, tau_x - mx, tau_z)
        return I_dual - 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e)
