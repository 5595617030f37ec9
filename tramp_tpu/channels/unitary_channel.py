"""Complex unitary channel x = U z, packed-real representation.
Reference tramp/channels/linear/unitary_channel.py.

The unitary matrix is stored as a (2, N, N) re/im pair and applied with
real matmuls (ops/dft.py:pair_matmul) — no complex dtype anywhere, at the
same cost as a complex matmul (XLA decomposes complex dots into real dots
anyway).
Messages stay in the packed (2, N) layout of utils.misc.complex2array.
"""
import numpy as np
import jax.numpy as jnp

from .base_channel import Channel
from ..ops.dft import pack_const, pair_matmul


def check_unitary(U):
    if U.shape[0] != U.shape[1]:
        raise ValueError(f"U.shape = {U.shape}")
    if not np.allclose(np.asarray(U) @ np.asarray(U).conj().T,
                       np.identity(U.shape[0]), atol=1e-6):
        raise ValueError("U not unitary")


class UnitaryChannel(Channel):

    _data_fields = ("U",)
    _meta_fields = ("name", "N")

    def __init__(self, U, name="U"):
        U = np.asarray(U)
        check_unitary(U)
        self.name = name
        self.N = U.shape[0]
        self.U = pack_const(U)   # (2, N, N) re/im pair

    def sample(self, key, Z):
        return pair_matmul(self.U, Z)

    def math(self):
        return rf"${self.name}$"

    def second_moment(self, tau_z):
        return tau_z

    def compute_forward_message(self, az, bz, ax, bx):
        return az, pair_matmul(self.U, bz)

    def compute_backward_message(self, az, bz, ax, bx):
        return ax, pair_matmul(self.U, bx, adjoint=True)

    def compute_forward_state_evolution(self, az, ax, tau_z):
        return az

    def compute_backward_state_evolution(self, az, ax, tau_z):
        return ax

    def compute_log_partition(self, az, bz, ax, bx):
        b = bz + pair_matmul(self.U, bx, adjoint=True)
        a = az + ax
        return 0.5 * jnp.sum(b**2 / a) + self.N * jnp.log(2 * jnp.pi / a)

    def compute_mutual_information(self, az, ax, tau_z):
        return 0.5 * jnp.log((ax + az) * tau_z)

    def compute_free_energy(self, az, ax, tau_z):
        tau_x = self.second_moment(tau_z)
        I = self.compute_mutual_information(az, ax, tau_z)
        return (0.5 * (az * tau_z + ax * tau_x) - I
                + 0.5 * jnp.log(2 * jnp.pi * tau_z / jnp.e))
