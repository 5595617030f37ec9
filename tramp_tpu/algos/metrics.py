"""Metrics. Reference tramp/algos/metrics.py."""
import jax.numpy as jnp
import numpy as np



def mean_squared_error(x_true, x_pred):
    return float(jnp.mean((jnp.asarray(x_true) - jnp.asarray(x_pred)) ** 2))


def sign_symmetric_mse(x_true, x_pred):
    "MSE up to a global sign."
    x_true = jnp.asarray(x_true)
    x_pred = jnp.asarray(x_pred)
    mse_pos = jnp.mean((x_true - x_pred) ** 2)
    mse_neg = jnp.mean((x_true + x_pred) ** 2)
    return float(jnp.minimum(mse_pos, mse_neg))


def phase_symmetric_mse(x_true, x_pred):
    """MSE up to a global phase (100-angle scan, reference l:19-26).
    Computed on the packed re/im planes (no complex dtype)."""
    x_true = jnp.asarray(x_true)
    xp = jnp.asarray(x_pred)
    phis = jnp.linspace(0, 2 * jnp.pi, 100)
    c, s = jnp.cos(phis)[:, None], jnp.sin(phis)[:, None]
    # e^{i phi} (re + i im): re' = c re - s im ; im' = s re + c im
    packed = jnp.stack([c * xp[0][None] - s * xp[1][None],
                        s * xp[0][None] + c * xp[1][None]], axis=1)
    mses = jnp.mean((x_true[None] - packed) ** 2, axis=(1, 2))
    return float(jnp.min(mses))


def overlap(x_true, x_pred):
    return float(jnp.mean(jnp.asarray(x_true) * jnp.asarray(x_pred)))


METRICS = {
    "sign_mse": sign_symmetric_mse,
    "phase_mse": phase_symmetric_mse,
    "mse": mean_squared_error,
    "overlap": overlap,
}
