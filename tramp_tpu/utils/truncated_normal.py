"""Numerically stable moments of the truncated normal distribution.

Branchless JAX rewrite of the reference's regime-switching implementation
(tramp/utils/truncated_normal.py:32-298, itself based on
cossio/TruncatedNormal.jl). Every regime (inf / close / neg / pos / other)
is evaluated on sanitized in-regime inputs and combined with ``jnp.where``
so the functions are jit-, vmap- and autodiff-safe on every backend.

Interval bounds ``zmin``/``zmax`` must be *static* Python floats (possibly
+-inf): factor regions are compile-time constants, so the inf cases are
dispatched at trace time exactly like the reference's if/elif on the bounds
(truncated_normal.py:239-247).
"""
import jax.numpy as jnp

from .special import (
    erf, erfcx, log_Phi, log_Phi_erfcx, norm_cdf, SQRT2, SQRT_PI)

_CLOSE_THRESH = 1e-7


def _switch(x, y):
    "Order so that |x| <= |y|. Reference truncated_normal.py:14-18."
    cond = jnp.abs(x) > jnp.abs(y)
    return jnp.where(cond, y, x), jnp.where(cond, x, y)


def _masks(x, y):
    close = jnp.abs(x - y) <= _CLOSE_THRESH
    neg = (x < 0) & (y < 0) & ~close
    pos = (x > 0) & (y > 0) & ~close
    other = ~(close | neg | pos)
    return close, neg, pos, other


def _where4(masks, vals):
    close, neg, pos, other = masks
    v_close, v_neg, v_pos, v_other = vals
    out = jnp.where(close, v_close, v_other)
    out = jnp.where(neg, v_neg, out)
    out = jnp.where(pos, v_pos, out)
    return out


def _sanitize(mask, x, y, x_def, y_def):
    "Clamp inputs to an in-regime default where the branch is not selected."
    return jnp.where(mask, x, x_def), jnp.where(mask, y, y_def)


def F0(x, y):
    "log|erf(y) - erf(x)| for finite x, y. Reference truncated_normal.py:66-91."
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    # close: Taylor expansion of log|erf(x+e) - erf(x)|
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    e_safe = jnp.maximum(jnp.abs(e), 1e-300) * jnp.where(e < 0, -1.0, 1.0)
    f_close = (
        -xc * e
        + (1.0 / 6.0) * (xc**2 - 2.0) * e**2
        # deliberate bug-for-bug compatibility: the e**4 factor of the
        # next Taylor term is missing in the reference too
        # (/root/reference/tramp/utils/truncated_normal.py:41); kept as-is
        # so fixed points match the reference bitwise in the close regime
        - (1.0 / 180.0) * (xc**4 + 2.0 * xc**2 - 8.0)
        + jnp.log(2.0 * jnp.abs(e_safe) / SQRT_PI)
    ) - xc**2
    # neg: both negative, use erfcx(-.)
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = jnp.exp(xn**2 - yn**2)  # |x|<=|y| so <= 1
    f_neg = jnp.log(jnp.abs(Dn * erfcx(-yn) - erfcx(-xn))) - xn**2
    # pos: both positive
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = jnp.exp(xp**2 - yp**2)
    f_pos = jnp.log(jnp.abs(erfcx(xp) - Dp * erfcx(yp))) - xp**2
    # other: opposite signs (or zero), direct difference is stable
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    f_other = jnp.log(jnp.abs(erf(yo) - erf(xo)))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F1(x, y):
    """(exp(-x^2) - exp(-y^2)) / (erf(y) - erf(x)) for finite x, y.
    Reference truncated_normal.py:94-147."""
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    f_close = SQRT_PI * (
        xc
        + 0.5 * e
        - (1.0 / 6.0) * e**2
        - (1.0 / 12.0) * e**3
        + (1.0 / 90.0) * xc * (xc**2 + 1.0) * e**4
    )
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = jnp.exp(xn**2 - yn**2)
    f_neg = (1.0 - Dn) / (Dn * erfcx(-yn) - erfcx(-xn))
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = jnp.exp(xp**2 - yp**2)
    f_pos = (1.0 - Dp) / (erfcx(xp) - Dp * erfcx(yp))
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    Do = jnp.exp(xo**2 - yo**2)
    f_other = jnp.exp(-xo**2) * (1.0 - Do) / (erf(yo) - erf(xo))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F2(x, y):
    """(x exp(-x^2) - y exp(-y^2)) / (erf(y) - erf(x)) for finite x, y.
    Reference truncated_normal.py:150-204."""
    x, y = _switch(x, y)
    masks = _masks(x, y)
    close, neg, pos, other = masks
    xc, yc = _sanitize(close, x, y, 0.0, 0.0)
    e = yc - xc
    f_close = SQRT_PI * (
        xc**2 - 0.5
        + xc * e
        - (1.0 / 3.0) * (xc**2 - 1.0) * e**2
        - (1.0 / 3.0) * xc * e**3
        + (1.0 / 90.0) * (2.0 * xc**4 + 3.0 * xc**2 - 8.0) * e**4
    )
    xn, yn = _sanitize(neg, x, y, -1.0, -2.0)
    Dn = jnp.exp(xn**2 - yn**2)
    f_neg = (xn - Dn * yn) / (Dn * erfcx(-yn) - erfcx(-xn))
    xp, yp = _sanitize(pos, x, y, 1.0, 2.0)
    Dp = jnp.exp(xp**2 - yp**2)
    f_pos = (xp - Dp * yp) / (erfcx(xp) - Dp * erfcx(yp))
    xo, yo = _sanitize(other, x, y, -1.0, 1.0)
    Do = jnp.exp(xo**2 - yo**2)
    f_other = jnp.exp(-xo**2) * (xo - Do * yo) / (erf(yo) - erf(xo))
    return _where4(masks, (f_close, f_neg, f_pos, f_other))


def F0_inf(x, sign):
    "F0(x, sign*inf). Reference truncated_normal.py:32-34."
    return jnp.log(erfcx(sign * x)) - x**2


def F1_inf(x, sign):
    "F1(x, sign*inf). Reference truncated_normal.py:94-96."
    return sign / erfcx(sign * x)


def F2_inf(x, sign):
    "F2(x, sign*inf). Reference truncated_normal.py:150-152."
    return sign * x / erfcx(sign * x)


def G0(x, y):
    "log|Phi(y) - Phi(x)|. Reference truncated_normal.py:207-209."
    return jnp.log(0.5) + F0(x / SQRT2, y / SQRT2)


def G1(x, y):
    "[N(x) - N(y)] / [Phi(y) - Phi(x)]. Reference truncated_normal.py:212-214."
    return jnp.sqrt(2.0 / jnp.pi) * F1(x / SQRT2, y / SQRT2)


def G2(x, y):
    "[y N(y) - x N(x)] / [Phi(y) - Phi(x)]. Reference truncated_normal.py:217-219."
    return (2.0 / SQRT_PI) * F2(x / SQRT2, y / SQRT2)


def G0_inf(x, sign):
    """G0(x, sign*inf) = log Phi(-sign*x). Reference truncated_normal.py:222-225.
    Routed through erfcx (not log_ndtr) so the half-infinite moment trio
    G0/G1/G2_inf shares a single erf expansion per element via CSE."""
    return log_Phi_erfcx(-sign * x)


def G1_inf(x, sign):
    return jnp.sqrt(2.0 / jnp.pi) * F1_inf(x / SQRT2, sign)


def G2_inf(x, sign):
    return (2.0 / SQRT_PI) * F2_inf(x / SQRT2, sign)


def _check_bounds(zmin, zmax):
    if not (zmin < zmax):
        raise ValueError(f"need zmin < zmax, got [{zmin}, {zmax}]")


def _g1(r0, v0, zmin, zmax):
    s0 = jnp.sqrt(v0)
    if zmax == jnp.inf and zmin == -jnp.inf:
        return jnp.zeros_like(r0 / s0)
    if zmax == jnp.inf:
        return G1_inf((zmin - r0) / s0, +1.0)
    if zmin == -jnp.inf:
        return G1_inf((zmax - r0) / s0, -1.0)
    return G1((zmin - r0) / s0, (zmax - r0) / s0)


def _g2(r0, v0, zmin, zmax):
    s0 = jnp.sqrt(v0)
    if zmax == jnp.inf and zmin == -jnp.inf:
        return jnp.zeros_like(r0 / s0)
    if zmax == jnp.inf:
        return G2_inf((zmin - r0) / s0, +1.0)
    if zmin == -jnp.inf:
        return G2_inf((zmax - r0) / s0, -1.0)
    return G2((zmin - r0) / s0, (zmax - r0) / s0)


def truncated_normal_mean(r0, v0, zmin, zmax):
    """Mean of N(z | r0, v0) restricted to [zmin, zmax] (static bounds).
    Reference truncated_normal.py:234-247."""
    _check_bounds(zmin, zmax)
    return r0 + jnp.sqrt(v0) * _g1(r0, v0, zmin, zmax)


def truncated_normal_var(r0, v0, zmin, zmax):
    """Variance of N(z | r0, v0) restricted to [zmin, zmax] (static bounds).
    Reference truncated_normal.py:250-266."""
    _check_bounds(zmin, zmax)
    g1 = _g1(r0, v0, zmin, zmax)
    g2 = _g2(r0, v0, zmin, zmax)
    return v0 * (1.0 + g2 - g1**2)


def truncated_normal_log_proba(r0, v0, zmin, zmax):
    """log P(z in [zmin, zmax]) under N(z | r0, v0) (static bounds).
    Reference truncated_normal.py:269-281."""
    _check_bounds(zmin, zmax)
    s0 = jnp.sqrt(v0)
    if zmax == jnp.inf and zmin == -jnp.inf:
        return jnp.zeros_like(r0 / s0)
    if zmax == jnp.inf:
        return G0_inf((zmin - r0) / s0, +1.0)
    if zmin == -jnp.inf:
        return G0_inf((zmax - r0) / s0, -1.0)
    return G0((zmin - r0) / s0, (zmax - r0) / s0)


def truncated_normal_proba(r0, v0, zmin, zmax):
    """P(z in [zmin, zmax]) under N(z | r0, v0) (static bounds).
    Reference truncated_normal.py:284-291."""
    _check_bounds(zmin, zmax)
    s0 = jnp.sqrt(v0)
    hi = 1.0 if zmax == jnp.inf else norm_cdf((zmax - r0) / s0)
    lo = 0.0 if zmin == -jnp.inf else norm_cdf((zmin - r0) / s0)
    return hi - lo


def truncated_normal_logZ(r0, v0, zmin, zmax):
    """Log partition of N(z | r0, v0) delta_[zmin, zmax](z) (static bounds).
    Reference truncated_normal.py:294-298."""
    g0 = truncated_normal_log_proba(r0, v0, zmin, zmax)
    return 0.5 * jnp.log(2.0 * jnp.pi * v0) + 0.5 * r0**2 / v0 + g0
