"""Packed-real spectral path (ops/dft.py, config.FFT_MODE = "matmul"):
parity with the native complex64 jnp.fft path at machine precision.

Complex quantities are (2, ...) re/im pairs (the reference's own
complex2array layout, tramp/utils/misc.py:13-27) and DFTs are real cos/sin
matmuls. The default is native complex64 + jnp.fft on every backend.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tramp_tpu import config
from tramp_tpu.ops import dft


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def test_pair_dft_matches_numpy(rng):
    x = rng.randn(5, 7)
    p = dft.fftn_real(jnp.asarray(x))
    want = np.fft.fftn(x)
    np.testing.assert_allclose(np.asarray(p[0]), want.real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p[1]), want.imag, atol=1e-12)
    back = dft.ifftn_pair_real(p)
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-12)
    z = x + 0.5j * x**2
    pc = dft.fftn_pair(jnp.asarray(np.stack([z.real, z.imag])))
    wc = np.fft.fftn(z)
    np.testing.assert_allclose(np.asarray(pc[0]), wc.real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(pc[1]), wc.imag, atol=1e-12)
    ip = dft.ifftn_pair(pc)
    np.testing.assert_allclose(np.asarray(ip[0]), z.real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(ip[1]), z.imag, atol=1e-12)


def test_pair_dft_axes_and_ortho(rng):
    x = rng.randn(3, 5, 7)
    p = dft.fftn_real(jnp.asarray(x), axes=(1, 2), norm="ortho")
    want = np.fft.fftn(x, axes=(1, 2), norm="ortho")
    np.testing.assert_allclose(np.asarray(p[0]), want.real, atol=1e-12)
    np.testing.assert_allclose(np.asarray(p[1]), want.imag, atol=1e-12)
    back = dft.ifftn_pair_real(
        jnp.asarray(np.stack([want.real, want.imag])), axes=(1, 2),
        norm="ortho")
    np.testing.assert_allclose(np.asarray(back), x, atol=1e-12)


def _channel_outputs(rng_seed):
    from tramp_tpu.channels import (
        Blur2DChannel, DFTChannel, GradientChannel)

    rng = np.random.RandomState(rng_seed)
    bz = jnp.asarray(rng.randn(8, 12))
    bx = jnp.asarray(rng.randn(8, 12))
    out = {}
    ch = Blur2DChannel(sigma=(1.0, 2.0), shape=(8, 12))
    out["blur_bwd"] = ch.compute_backward_posterior(1.3, bz, 0.7, bx)[0]
    out["blur_fwd"] = ch.compute_forward_posterior(1.3, bz, 0.7, bx)[0]
    out["blur_sample"] = ch.sample(jax.random.PRNGKey(0), bz)
    g = GradientChannel(shape=(8, 12))
    bxg = jnp.asarray(rng.randn(2, 8, 12))
    out["grad_bwd"] = g.compute_backward_posterior(1.3, bz, 0.7, bxg)[0]
    out["grad_fwd"] = g.compute_forward_posterior(1.3, bz, 0.7, bxg)[0]
    out["grad_lp"] = g.compute_log_partition(1.3, bz, 0.7, bxg)
    d = DFTChannel(real=True)
    out["dft_fwd"] = d.compute_forward_message(1.0, bz, 0.5, None)[1]
    out["dft_bwd"] = d.compute_backward_message(
        1.0, bz, 0.5, jnp.stack([bz, bz * 0.3]))[1]
    out["dft_lp"] = d.compute_log_partition(
        1.0, bz, 0.5, jnp.stack([bz, bz * 0.3]))
    return out


def test_packed_channels_match_complex_channels():
    config.FFT_MODE = "xla"
    try:
        a = _channel_outputs(3)
    finally:
        config.FFT_MODE = None
    config.FFT_MODE = "matmul"
    try:
        b = _channel_outputs(3)
    finally:
        config.FFT_MODE = None
    for k in a:
        np.testing.assert_allclose(
            np.asarray(a[k]), np.asarray(b[k]), atol=1e-11, err_msg=k)


def test_sparse_gradient_ep_matches_across_modes():
    "End-to-end EP fixed point identical in packed vs complex mode."
    from tramp_tpu.variables import (
        SIMOVariable, MILeafVariable, SILeafVariable as O)
    from tramp_tpu.priors import GaussianPrior, GaussBernoulliPrior
    from tramp_tpu.channels import GradientChannel, GaussianChannel
    from tramp_tpu.algos import ExpectationPropagation

    N, rho, noise_var = 64, 0.1, 1e-2
    rng = np.random.RandomState(1)
    z0 = (rng.rand(1, N) < rho) * rng.randn(1, N)
    x0 = z0.ravel().cumsum()
    x0 = x0 - x0.mean()
    y = x0 + np.sqrt(noise_var) * rng.randn(N)

    def solve():
        student = (
            GaussianPrior(size=(N,)) @
            SIMOVariable(id="x", n_next=2) @ (
                GaussianChannel(var=noise_var) @ O("y") + (
                    GradientChannel(shape=(N,)) +
                    GaussBernoulliPrior(size=(1, N), rho=rho)
                ) @ MILeafVariable(id="z", n_prev=2)
            )
        ).to_model().to_observed({"y": jnp.asarray(y)})
        ep = ExpectationPropagation(student)
        ep.iterate(max_iter=200, damping=0.1)
        return np.asarray(ep.get_variable_data("x")["r"])

    config.FFT_MODE = "xla"
    try:
        r_xla = solve()
    finally:
        config.FFT_MODE = None
    config.FFT_MODE = "matmul"
    try:
        r_mm = solve()
    finally:
        config.FFT_MODE = None
    np.testing.assert_allclose(r_mm, r_xla, rtol=1e-9, atol=1e-12)


def test_probe_is_config_overridable():
    "FFT_MODE picks the spectral path; the auto value (None) is native."
    assert config.FFT_MODE is None
    assert dft.packed_mode() is False
    config.FFT_MODE = "matmul"
    try:
        assert dft.packed_mode() is True
    finally:
        config.FFT_MODE = None
    config.FFT_MODE = "xla"
    try:
        assert dft.packed_mode() is False
    finally:
        config.FFT_MODE = None


def test_complex_matmul_fftn_matches_jnp(rng):
    """The complex-dtype fftn/ifftn wrappers' matmul path matches jnp.fft
    at machine precision, including axes and ortho norms."""
    x = rng.randn(6, 10) + 1j * rng.randn(6, 10)
    for axes in (None, (1,), (0, 1)):
        for norm in (None, "ortho"):
            config.FFT_MODE = "matmul"
            try:
                got_f = np.asarray(dft.fftn(jnp.asarray(x), axes=axes,
                                            norm=norm))
                got_i = np.asarray(dft.ifftn(jnp.asarray(x), axes=axes,
                                             norm=norm))
            finally:
                config.FFT_MODE = None
            np.testing.assert_allclose(
                got_f, np.fft.fftn(x, axes=axes, norm=norm), atol=1e-12)
            np.testing.assert_allclose(
                got_i, np.fft.ifftn(x, axes=axes, norm=norm), atol=1e-12)
