"""L0 oracle tests: special functions vs scipy (scipy is a test-only oracle,
mirroring the reference's reliance on scipy.special in
tramp/utils/truncated_normal.py and tramp/utils/misc.py)."""
import numpy as np
import scipy.special as sp
import pytest
import jax
import jax.numpy as jnp

from tramp_tpu.utils import special as ts
from tramp_tpu.utils import truncated_normal as tn


def test_erfcx_matches_scipy():
    x = np.concatenate([
        np.linspace(-26, 26, 2001),
        np.array([-100.0, -30.0, 30.0, 100.0, 1e3, 1e6]),
        np.array([0.0, 1e-12, -1e-12]),
    ])
    got = np.asarray(ts.erfcx(jnp.asarray(x)))
    want = sp.erfcx(x)
    mask = np.isfinite(want)
    np.testing.assert_allclose(got[mask], want[mask], rtol=5e-13)
    # overflow behavior for very negative arguments matches scipy (inf)
    assert np.isinf(np.asarray(ts.erfcx(jnp.asarray(-40.0))))


def test_erfcx_gradient():
    # d/dx erfcx = 2x erfcx(x) - 2/sqrt(pi)
    for x0 in [-5.0, -0.3, 0.0, 0.7, 4.0, 30.0]:
        g = jax.grad(lambda x: ts.erfcx(x))(x0)
        want = 2 * x0 * sp.erfcx(x0) - 2 / np.sqrt(np.pi)
        np.testing.assert_allclose(g, want, rtol=1e-10)


def test_phi_functions():
    x = np.linspace(-20, 20, 401)
    np.testing.assert_allclose(
        np.asarray(ts.phi_0(jnp.asarray(x))),
        np.log(0.5 * sp.erfcx(-x / np.sqrt(2))),
        rtol=1e-12,
    )
    # phi_1 = x + N/Phi
    d = np.sqrt(2 * np.pi) * 0.5 * sp.erfcx(-x / np.sqrt(2))
    np.testing.assert_allclose(
        np.asarray(ts.phi_1(jnp.asarray(x))), x + 1.0 / d, rtol=1e-12)


@pytest.mark.parametrize("bounds", [
    (0.0, np.inf), (-np.inf, 0.0), (-1.0, 1.0), (0.5, 2.5), (-3.0, -0.5),
    (1e-4, np.inf), (-np.inf, -8.0), (5.0, 9.0),
])
def test_truncated_normal_vs_scipy(bounds):
    from scipy.stats import truncnorm
    zmin, zmax = bounds
    rng = np.random.RandomState(0)
    r0 = rng.uniform(-6, 6, size=50)
    v0 = 10 ** rng.uniform(-3, 2, size=50)
    s0 = np.sqrt(v0)
    a, b = (zmin - r0) / s0, (zmax - r0) / s0
    want_mean = truncnorm.mean(a, b, loc=r0, scale=s0)
    want_var = truncnorm.var(a, b, loc=r0, scale=s0)
    got_mean = np.asarray(tn.truncated_normal_mean(
        jnp.asarray(r0), jnp.asarray(v0), zmin, zmax))
    got_var = np.asarray(tn.truncated_normal_var(
        jnp.asarray(r0), jnp.asarray(v0), zmin, zmax))
    np.testing.assert_allclose(got_mean, want_mean, rtol=1e-8, atol=1e-10)
    # NOTE: deep-tail intervals lose relative precision to cancellation in
    # v0*(1+g2-g1^2) (the reference's formula, truncated_normal.py:250-266);
    # absolute accuracy ~1e-9 is retained, which EP's precision clipping
    # (AMIN=1e-11) renders harmless.
    np.testing.assert_allclose(got_var, want_var, rtol=1e-6, atol=5e-9)
    # log proba: use scipy's stable log_ndtr for one-sided intervals, and the
    # naive difference only where it is well conditioned (mass not tiny).
    got_logp = np.asarray(tn.truncated_normal_log_proba(
        jnp.asarray(r0), jnp.asarray(v0), zmin, zmax))
    if zmax == np.inf:
        want_logp = sp.log_ndtr(-a)
        np.testing.assert_allclose(got_logp, want_logp, rtol=1e-7, atol=1e-9)
    elif zmin == -np.inf:
        want_logp = sp.log_ndtr(b)
        np.testing.assert_allclose(got_logp, want_logp, rtol=1e-7, atol=1e-9)
    else:
        mass = sp.ndtr(b) - sp.ndtr(a)
        good = mass > 1e-8
        want_logp = np.log(np.where(good, mass, 1.0))
        np.testing.assert_allclose(
            got_logp[good], want_logp[good], rtol=1e-6, atol=1e-12)


def test_truncated_normal_extreme_tails():
    # our implementation must stay finite deep in the tail
    r0 = jnp.asarray([-30.0, -100.0])
    v0 = jnp.asarray([1.0, 1.0])
    m = np.asarray(tn.truncated_normal_mean(r0, v0, 0.0, np.inf))
    v = np.asarray(tn.truncated_normal_var(r0, v0, 0.0, np.inf))
    assert np.all(np.isfinite(m)) and np.all(m > 0)
    assert np.all(np.isfinite(v)) and np.all(v > 0)
    lz = np.asarray(tn.truncated_normal_logZ(r0, v0, 0.0, np.inf))
    assert np.all(np.isfinite(lz))


def test_quadrature_vs_scipy():
    from scipy.integrate import quad
    from tramp_tpu.utils.integration import (
        gaussian_measure, truncated_gaussian_measure)

    def f(x):
        return np.tanh(x) ** 2 + 0.3 * x

    for (m, s) in [(0.0, 1.0), (2.0, 0.5), (-1.0, 3.0)]:
        want = quad(
            lambda u: np.exp(-0.5 * u**2) / np.sqrt(2 * np.pi) * f(m + s * u),
            -10, 10)[0]
        got = float(gaussian_measure(m, s, lambda x: jnp.tanh(x) ** 2 + 0.3 * x))
        np.testing.assert_allclose(got, want, rtol=1e-9)

    # truncated measure with an interval
    want = quad(
        lambda z: np.exp(-0.5 * (z - 0.3) ** 2 / 4.0)
        / np.sqrt(2 * np.pi * 4.0) * np.cos(z), -1.0, 2.5)[0]
    got = float(truncated_gaussian_measure(0.3, 2.0, -1.0, 2.5, jnp.cos))
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_erfcx_float32_mid_range():
    """f32 regression (round-3): the direct exp(x^2)*erfc(x) product must
    not be used where f32 exp overflows (x ~ 9.4-25): that produced
    inf * 0 = NaN and first-sweep NaNs in the VAE-prior chain. The
    threshold is dtype-aware; f32 values must match f64 to f32 accuracy."""
    from tramp_tpu.utils.special import erfcx

    xs = np.array([5.0, 8.9, 9.1, 10.0, 12.0, 20.0, 24.9, 25.1, 30.0, 100.0])
    got32 = np.asarray(erfcx(jnp.asarray(xs, jnp.float32)), np.float64)
    want = sp.erfcx(xs)
    assert np.all(np.isfinite(got32))
    np.testing.assert_allclose(got32, want, rtol=2e-6)
    # negative side still overflows to inf exactly like scipy
    neg = np.asarray(erfcx(jnp.asarray([-15.0], jnp.float32)))
    assert np.isinf(neg).all()


# -- piecewise-linear channels vs a scipy float64 truncated-normal oracle --

PL_CHANNELS = [
    ("sgn", lambda ch: ch.SgnChannel()),
    ("abs", lambda ch: ch.AbsChannel()),
    ("relu", lambda ch: ch.ReluChannel()),
    ("leaky_relu", lambda ch: ch.LeakyReluChannel(slope=0.3)),
    ("hard_tanh", lambda ch: ch.HardTanhChannel()),
    ("door", lambda ch: ch.SymmetricDoorChannel(width=0.7)),
]


def _pl_oracle(specs, az, bz, ax, bx):
    """Posterior (rz, mean vz, rx, mean vx) and total log partition of a
    piecewise-linear channel, region by region with scipy's truncated
    normal in float64 (reference linear_region.py / truncated_normal.py)."""
    from scipy.stats import truncnorm
    rz, vz, rx, vx, logZ = [], [], [], [], []
    for zmin, zmax, x0, slope in specs:
        a = az + slope**2 * ax
        b = bz + slope * (bx - ax * x0)
        r0, s0 = b / a, np.sqrt(1.0 / a)
        lo, hi = (zmin - r0) / s0, (zmax - r0) / s0
        m = truncnorm.mean(lo, hi, loc=r0, scale=s0)
        v = truncnorm.var(lo, hi, loc=r0, scale=s0)
        # log of the mass in [lo, hi], from the upper tail side of each
        log_mass = sp.log_ndtr(hi) + np.log(-np.expm1(
            sp.log_ndtr(lo) - sp.log_ndtr(hi)))
        logZ.append(0.5 * b**2 / a + 0.5 * np.log(2 * np.pi / a) + log_mass
                    - 0.5 * ax * x0**2 + bx * x0)
        rz.append(m)
        vz.append(v)
        rx.append(x0 + slope * m)
        vx.append(slope**2 * v)
    logZ = np.stack(logZ)
    p = np.exp(logZ - logZ.max(0))
    p /= p.sum(0)

    def merge(rs, vs):
        rs, vs = np.stack(rs), np.stack(vs)
        r = (p * rs).sum(0)
        return r, ((p * (vs + rs**2)).sum(0) - r**2).mean()

    top = logZ.max(0)
    total = (top + np.log(np.exp(logZ - top).sum(0))).sum()
    return merge(rz, vz) + merge(rx, vx) + (total,)


@pytest.mark.parametrize("make", [m for _, m in PL_CHANNELS],
                         ids=[n for n, _ in PL_CHANNELS])
def test_pl_channel_vs_scipy_oracle(make):
    """Region-path posterior and log partition of each piecewise-linear
    channel match the scipy float64 truncated-normal oracle."""
    from tramp_tpu import channels
    channel = make(channels)
    rng = np.random.RandomState(3)
    az, ax = 1.7, 0.9
    bz, bx = rng.randn(64) * 1.5, rng.randn(64) * 1.5
    rz, vz, rx, vx, logZ = _pl_oracle(channel.region_specs, az, bz, ax, bx)
    got_rz, got_vz = channel.compute_backward_posterior(az, bz, ax, bx)
    got_rx, got_vx = channel.compute_forward_posterior(az, bz, ax, bx)
    got_logZ = channel.compute_log_partition(az, bz, ax, bx)
    np.testing.assert_allclose(np.asarray(got_rz), rz, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(got_vz), vz, rtol=1e-7)
    np.testing.assert_allclose(np.asarray(got_rx), rx, rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(float(got_vx), vx, rtol=1e-7, atol=1e-12)
    np.testing.assert_allclose(float(got_logZ), logZ, rtol=1e-9)


@pytest.mark.gpu
@pytest.mark.parametrize("make", [m for _, m in PL_CHANNELS],
                         ids=[n for n, _ in PL_CHANNELS])
def test_pl_channel_float32_on_gpu(gpu, make):
    """The same posterior compiled for the card in float32 (the f32 erfcx
    branch) stays finite and within float32 reach of the float64 oracle."""
    from tramp_tpu import channels
    channel = make(channels)
    rng = np.random.RandomState(4)
    az, ax = 1.7, 0.9
    bz, bx = rng.randn(4096) * 4, rng.randn(4096) * 4
    rz, vz, rx, vx, _ = _pl_oracle(channel.region_specs, az, bz, ax, bx)
    f32 = jax.device_put(jnp.asarray(np.stack([bz, bx]), jnp.float32), gpu)
    got_rz, got_vz = jax.jit(channel.compute_backward_posterior)(
        jnp.float32(az), f32[0], jnp.float32(ax), f32[1])
    assert np.isfinite(np.asarray(got_rz)).all()
    np.testing.assert_allclose(np.asarray(got_rz, np.float64), rz,
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(float(got_vz), vz, rtol=1e-4)
