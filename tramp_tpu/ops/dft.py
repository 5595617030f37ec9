"""DFT ops for the FFT-parametrized channels (conv/gradient/DFT,
reference tramp/channels/linear/conv_channel.py:82-98).

``config.FFT_MODE``: None (or "xla") = native complex64 and jnp.fft, which
every installed backend executes; "matmul" = an explicit packed-real path:
complex quantities as (2, ...) re/im pairs and DFTs as dense O(n^2) real
matmuls per axis, with the (n, n) DFT matrices built once on host and
cached.
"""
import functools

import numpy as np
import jax.numpy as jnp


def _use_matmul():
    from .. import config
    return config.FFT_MODE == "matmul"


@functools.lru_cache(maxsize=64)
def _dft_matrix(n, inverse, dtype_name):
    """Symmetric (n, n) DFT matrix F[k, j] = exp(-+2i pi k j / n).
    Cached as NUMPY (a jnp constant created inside a trace would leak a
    tracer out of the lru_cache)."""
    sign = 2j if inverse else -2j
    k = np.arange(n)
    F = np.exp(sign * np.pi * np.outer(k, k) / n)
    if inverse:
        F = F / n
    return F.astype(dtype_name)


def _axes_of(x, axes):
    if axes is None:
        return tuple(range(jnp.ndim(x)))
    return tuple(a % jnp.ndim(x) for a in axes)


def _matmul_dft(x, axes, inverse):
    x = jnp.asarray(x)
    cdtype = ("complex128" if x.dtype in (jnp.float64, jnp.complex128)
              else "complex64")
    x = x.astype(cdtype)
    for ax in _axes_of(x, axes):
        F = _dft_matrix(x.shape[ax], inverse, cdtype)
        # y[..., k, ...] = sum_j x[..., j, ...] F[k, j]; F is symmetric so
        # contracting x's axis with F's second index == first
        x = jnp.moveaxis(
            jnp.tensordot(x, F, axes=((ax,), (1,))), -1, ax)
    return x


def _apply_norm(x, axes, norm, inverse):
    if norm == "ortho":
        n = np.prod([x.shape[a] for a in _axes_of(x, axes)])
        # forward/backward carry 1 and 1/n by construction; ortho moves
        # both to 1/sqrt(n)
        scale = np.sqrt(n) if inverse else 1.0 / np.sqrt(n)
        return x * jnp.asarray(scale, x.real.dtype)
    return x


def fftn(x, axes=None, norm=None):
    "jnp.fft.fftn drop-in with the explicit matmul path."
    if not _use_matmul():
        return jnp.fft.fftn(x, axes=axes, norm=norm)
    return _apply_norm(_matmul_dft(x, axes, inverse=False), axes, norm,
                       inverse=False)


def ifftn(x, axes=None, norm=None):
    "jnp.fft.ifftn drop-in with the explicit matmul path."
    if not _use_matmul():
        return jnp.fft.ifftn(x, axes=axes, norm=norm)
    return _apply_norm(_matmul_dft(x, axes, inverse=True), axes, norm,
                       inverse=True)


# ---------------------------------------------------------------------------
# Packed-real spectral ops: complex arrays represented as a real array with
# a LEADING axis of length 2 = (re, im) — the same layout as
# utils.misc.complex2array (and the reference's packed representation,
# tramp/utils/misc.py:13-27). All arithmetic below is real adds/muls and
# real matmuls; selected by config.FFT_MODE = "matmul".
# ---------------------------------------------------------------------------

def packed_mode():
    """True when the spectral channels should store/compute packed-real
    (config.FFT_MODE = "matmul"); the default is native complex64."""
    return _use_matmul()


def pack_const(z):
    "Host-side: numpy complex constant -> jnp (2,)+shape real pair."
    z = np.asarray(z)
    return jnp.asarray(np.stack([z.real, z.imag], axis=0))


def pair_mul(p, q):
    "Complex multiply of two pairs (leading 2-axis)."
    pr, pi = p[0], p[1]
    qr, qi = q[0], q[1]
    return jnp.stack([pr * qr - pi * qi, pr * qi + pi * qr], axis=0)


def pair_conj(p):
    return jnp.stack([p[0], -p[1]], axis=0)


def pair_abs2(p):
    return p[0] * p[0] + p[1] * p[1]


@functools.lru_cache(maxsize=64)
def _cos_sin(n, dtype_name):
    """Symmetric (n, n) cos/sin DFT matrices, cached as NUMPY (a jnp
    constant created inside a trace would leak a tracer out of the cache;
    numpy constants embed into each trace safely)."""
    k = np.arange(n)
    th = 2.0 * np.pi * np.outer(k, k) / n
    return (np.cos(th).astype(dtype_name), np.sin(th).astype(dtype_name))


def _dft_pair(re, im, axes, inverse):
    """DFT of re + i*im along `axes` (indices into re's shape) via real
    matmuls: X = x C -+ i x S per axis. Returns (re', im')."""
    dtype_name = str(re.dtype)
    ndim = re.ndim
    axes = (tuple(range(ndim)) if axes is None
            else tuple(a % ndim for a in axes))
    # forward e^{-i theta} = C - iS: Re' = re C + im S ; Im' = im C - re S
    # inverse e^{+i theta} = C + iS: Re' = re C - im S ; Im' = im C + re S
    sgn = -1.0 if inverse else 1.0
    for ax in axes:
        n = re.shape[ax]
        C, S = _cos_sin(n, dtype_name)

        def t(x, M, ax=ax):
            return jnp.moveaxis(jnp.tensordot(x, M, axes=((ax,), (1,))),
                                -1, ax)
        re, im = (t(re, C) + sgn * t(im, S),
                  t(im, C) - sgn * t(re, S))
        if inverse:
            re, im = re / n, im / n
    return re, im


def fftn_real(x, axes=None, norm=None):
    """DFT of a REAL array -> pair (2,)+shape. Packed-real path. The
    first transformed axis uses the closed real-input form re' = x C,
    im' = -x S (two matmuls instead of the generic pair's four on a
    zero imaginary plane — the input-side mirror of
    ifftn_pair_real's real-output shortcut)."""
    x = jnp.asarray(x)
    ndim = x.ndim
    ax_t = (tuple(range(ndim)) if axes is None
            else tuple(a % ndim for a in axes))
    ax0 = ax_t[0]
    C, S = _cos_sin(x.shape[ax0], str(x.dtype))

    def t(v, M, ax=ax0):
        return jnp.moveaxis(jnp.tensordot(v, M, axes=((ax,), (1,))),
                            -1, ax)
    re, im = t(x, C), -t(x, S)
    if len(ax_t) > 1:
        re, im = _dft_pair(re, im, ax_t[1:], inverse=False)
    p = jnp.stack([re, im], axis=0)
    return _apply_norm_pair(p, p[0], axes, norm)


def fftn_pair(p, axes=None, norm=None):
    "DFT of a pair -> pair. `axes` index into the UNPACKED shape p[0]."
    re, im = _dft_pair(p[0], p[1], axes, inverse=False)
    out = jnp.stack([re, im], axis=0)
    return _apply_norm_pair(out, out[0], axes, norm)


def ifftn_pair(p, axes=None, norm=None):
    "Inverse DFT of a pair -> pair."
    re, im = _dft_pair(p[0], p[1], axes, inverse=True)
    out = jnp.stack([re, im], axis=0)
    return _apply_norm_pair(out, out[0], axes, norm, inverse=True)


def ifftn_pair_real(p, axes=None, norm=None):
    "Inverse DFT of a pair, REAL part only (half the matmuls)."
    dtype_name = str(p.dtype)
    re, im = p[0], p[1]
    ndim = re.ndim
    ax_t = (tuple(range(ndim)) if axes is None
            else tuple(a % ndim for a in axes))
    # all but the last axis need full complex planes; final axis only re
    for i, ax in enumerate(ax_t):
        n = re.shape[ax]
        C, S = _cos_sin(n, dtype_name)

        def t(x, M, ax=ax):
            return jnp.moveaxis(jnp.tensordot(x, M, axes=((ax,), (1,))),
                                -1, ax)
        if i + 1 < len(ax_t):
            re, im = (t(re, C) - t(im, S)) / n, (t(im, C) + t(re, S)) / n
        else:
            re = (t(re, C) - t(im, S)) / n
    out = re
    if norm == "ortho":
        n_tot = np.prod([p[0].shape[a] for a in ax_t])
        out = out * jnp.asarray(np.sqrt(n_tot), out.dtype)
    return out


def _apply_norm_pair(p, plane0, axes, norm, inverse=False):
    if norm != "ortho":
        return p
    ndim = plane0.ndim
    ax_t = (tuple(range(ndim)) if axes is None
            else tuple(a % ndim for a in axes))
    n = np.prod([plane0.shape[a] for a in ax_t])
    scale = np.sqrt(n) if inverse else 1.0 / np.sqrt(n)
    return p * jnp.asarray(scale, p.dtype)


def pair_matmul(Ap, zp, adjoint=False):
    """A @ z (or A^H @ z) for a packed matrix Ap (2, n, m) and packed
    operand zp (2, m, ...): 4 real matmuls (the complex-free path for the
    complex linear/unitary channels)."""
    Ar, Ai = Ap[0], Ap[1]
    zr, zi = zp[0], zp[1]
    if adjoint:
        # A^H z = (Ar^T - i Ai^T)(zr + i zi)
        re = Ar.T @ zr + Ai.T @ zi
        im = Ar.T @ zi - Ai.T @ zr
    else:
        re = Ar @ zr - Ai @ zi
        im = Ar @ zi + Ai @ zr
    return jnp.stack([re, im], axis=0)
