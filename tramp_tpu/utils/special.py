"""Special functions needed by the belief kernels, implemented branchless
for XLA (every regime is computed on sanitized inputs and selected with
``jnp.where`` so the kernels are jit-, vmap- and grad-safe).

Provides the scaled complementary error function ``erfcx`` (absent from
jax.scipy) plus the log-Gaussian-cdf helpers that the reference keeps in
tramp/utils/misc.py:55-83, built on jax.scipy.special (erfc/ndtr/log_ndtr)
with full float64 accuracy for CPU parity testing.
"""
import jax
import jax.numpy as jnp
from jax.scipy import special as jsp

SQRT2 = 1.4142135623730951
SQRT_PI = 1.7724538509055159
SQRT_2PI = 2.5066282746310002

# |x| below which exp(x^2)*erfc(x) is computed directly without overflow.
# DTYPE-AWARE: float64 exp overflows at x ~ 26.6 (erfc underflows ~27), but
# float32 exp(x^2) overflows already at x ~ 9.4 while erfc underflows to 0,
# so the f64 threshold would produce inf * 0 = NaN for x in [9.4, 25] in
# f32 (seen as first-sweep NaNs in the VAE-prior chain). The 5-term
# asymptotic series at x=9 has relative error ~6e-10, below f32 eps.
_ERFCX_DIRECT_MAX_F64 = 25.0
_ERFCX_DIRECT_MAX_F32 = 9.0


def _erfcx_direct_max(dtype):
    return (_ERFCX_DIRECT_MAX_F64 if jnp.finfo(dtype).bits >= 64
            else _ERFCX_DIRECT_MAX_F32)


erf = jsp.erf


@jax.custom_jvp
def erfcx(x):
    """Scaled complementary error function exp(x**2) * erfc(x).

    Matches scipy.special.erfcx on the real line, including the reference's
    overflow-to-inf behavior for large negative arguments
    (tramp/utils/truncated_normal.py uses erfcx throughout F0/F1/F2).
    """
    x = jnp.asarray(x)
    ax = jnp.abs(x)
    dmax = _erfcx_direct_max(ax.dtype)
    # direct product, safe for |x| <= dmax (dtype-aware, see above)
    axc = jnp.minimum(ax, dmax)
    direct = jnp.exp(axc * axc) * jsp.erfc(axc)
    # asymptotic series for |x| > dmax:
    # erfcx(x) ~ (1/(x sqrt(pi))) * sum_n (-1)^n (2n-1)!! / (2x^2)^n
    axa = jnp.maximum(ax, dmax)
    z = 1.0 / (2.0 * axa * axa)
    poly = 1.0 + z * (-1.0 + z * (3.0 + z * (-15.0 + z * (105.0 + z * -945.0))))
    asym = poly / (axa * SQRT_PI)
    pos = jnp.where(ax <= dmax, direct, asym)
    # negative arguments: erfcx(x) = 2 exp(x^2) - erfcx(-x); overflows to +inf
    # for x << 0 exactly as scipy does.
    neg = 2.0 * jnp.exp(jnp.square(x)) - pos
    return jnp.where(x >= 0, pos, neg)


@erfcx.defjvp
def _erfcx_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    y = erfcx(x)
    # d/dx erfcx(x) = 2 x erfcx(x) - 2/sqrt(pi)
    return y, (2.0 * x * y - 2.0 / SQRT_PI) * dx


def norm_cdf(x):
    "Standard normal cdf Phi(x). Reference tramp/utils/misc.py:55-57."
    return jsp.ndtr(x)


def norm_pdf(x):
    "Standard normal pdf N(x). Reference tramp/utils/misc.py:60-62."
    return jnp.exp(-0.5 * jnp.square(x)) / SQRT_2PI


def log_Phi(x):
    "log Phi(x), stable for large |x|. Reference truncated_normal.py:22-30."
    return jsp.log_ndtr(x)


@jax.custom_jvp
def log_Phi_erfcx(x):
    """log Phi(x) expressed through ``erfcx`` so that adjacent moment
    kernels (G1_inf/G2_inf, which evaluate erfcx at the same standardized
    argument) share ONE erf expansion via XLA CSE instead of paying a
    second, independent log_ndtr expansion (round-3 transcendental-count
    reduction for the piecewise-linear denoisers; accuracy identical to
    log_ndtr to ~1 ulp, see test_special.py).

    x <= 0: Phi(x) = 0.5 erfc(-x/sqrt2) = 0.5 erfcx(-x/sqrt2) e^{-x^2/2}
    x >  0: Phi(x) = 1 - Phi(-x), via log1p (cancellation-free).

    A custom JVP supplies the analytic derivative (log Phi)'(x) =
    N(x)/Phi(x) = 1/(sqrt(2 pi) 0.5 erfcx(-x/sqrt2)): differentiating
    through the branchless primal would leak NaN (zero cotangent into the
    untaken branch times its infinite local jacobian at extreme |x|), and
    the analytic form REUSES the primal's erfcx(-u) via CSE. Inputs are
    clamped to +-1e15: values match log_ndtr in the representable range
    (lower(-inf) saturates at -5e29 instead of -inf — identical under any
    downstream exp/softmax)."""
    u = jnp.clip(x / SQRT2, -1e15, 1e15)
    lower = jnp.log(0.5 * erfcx(-u)) - u * u
    upper = jnp.log1p(-0.5 * erfcx(u) * jnp.exp(-u * u))
    return jnp.where(x <= 0, lower, upper)


@jax.custom_jvp
def _log_Phi_prime(x):
    "(log Phi)'(x) = N(x)/Phi(x), erfcx-shared with the log_Phi primal."
    u = jnp.clip(x / SQRT2, -1e15, 1e15)
    # erfcx(-u) -> inf for x >> 0 gives the correct 0 slope
    return 1.0 / (SQRT_2PI * 0.5 * erfcx(-u))


@_log_Phi_prime.defjvp
def _log_Phi_prime_jvp(primals, tangents):
    # closed-form recursion y' = -y (x + y): keeps EVERY derivative order
    # finite (differentiating 1/erfcx(-u) directly hits inf/inf = NaN
    # where erfcx overflows, x > ~37.6 in f64). x clamped like the primal
    # so x = +-inf gives 0 * inf = NaN -> 0 * clamp = 0.
    (x,), (dx,) = primals, tangents
    y = _log_Phi_prime(x)
    xc = jnp.clip(x, -SQRT2 * 1e15, SQRT2 * 1e15)
    return y, (-y * (xc + y)) * dx


@log_Phi_erfcx.defjvp
def _log_Phi_erfcx_jvp(primals, tangents):
    (x,), (dx,) = primals, tangents
    return log_Phi_erfcx(x), _log_Phi_prime(x) * dx


def log_norm_cdf_prime(x):
    "(log Phi)'(x) = N(x)/Phi(x). Reference tramp/utils/misc.py:65-70."
    return 1.0 / (SQRT_2PI * 0.5 * erfcx(-x / SQRT2))


def phi_0(x):
    "phi(x) = x^2/2 + log Phi(x). Reference tramp/utils/misc.py:74-76."
    return jnp.log(0.5 * erfcx(-x / SQRT2))


def phi_1(x):
    "phi'(x) = x + N/Phi. Reference tramp/utils/misc.py:79-81."
    return x + log_norm_cdf_prime(x)


def phi_2(x):
    "phi''(x) = 1 - N/Phi * (x + N/Phi). Reference tramp/utils/misc.py:84-86."
    y = log_norm_cdf_prime(x)
    return 1.0 - y * (x + y)
