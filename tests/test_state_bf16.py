"""bfloat16 message-state storage (config.STATE_BF16): the b-message
arrays are carried in bf16 while ALL compute — cavity sums, factor math,
metrics — stays float32 via upcast-at-read.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp

import tramp_tpu as tt
from tramp_tpu import config


def _build(N=256, alpha=0.7, rho=0.3, noise_var=1e-2):
    from tramp_tpu.priors import GaussBernoulliPrior
    from tramp_tpu.channels import LinearChannel, GaussianChannel

    M = int(alpha * N)
    W = jax.random.normal(jax.random.PRNGKey(0), (M, N)) / jnp.sqrt(N)
    teacher = (GaussBernoulliPrior(size=N, rho=rho) @ tt.V(id="x") @
               LinearChannel(W) @ tt.V(id="z") @
               GaussianChannel(var=noise_var) @ tt.O(id="y")).to_model()
    sample = teacher.sample(jax.random.PRNGKey(1))
    return teacher.to_observed(
        {"y": jnp.asarray(sample["y"], jnp.float32)}), sample


def test_bf16_state_close_to_f32_fixed_point():
    with jax.enable_x64(False):
        student, sample = _build()

        def solve():
            ep = tt.ExpectationPropagation(student)
            ep.iterate(max_iter=100, damping=0.1)
            d = ep.get_variable_data("x")
            return (np.asarray(d["r"], np.float64),
                    float(np.mean(np.asarray(d["v"]))))

        config.STATE_BF16 = False
        try:
            r32, v32 = solve()
        finally:
            config.STATE_BF16 = None
        config.STATE_BF16 = True
        try:
            rb, vb = solve()
        finally:
            config.STATE_BF16 = None
        # bf16 resolution (~0.4%) bounds the achievable parity
        assert np.linalg.norm(rb - r32) / np.linalg.norm(r32) < 2e-2
        assert abs(vb - v32) / v32 < 2e-2
        # reconstruction quality unchanged at the task level
        x0 = np.asarray(sample["x"], np.float64)
        mse32 = np.mean((r32 - x0) ** 2)
        mseb = np.mean((rb - x0) ** 2)
        assert abs(mseb - mse32) / mse32 < 0.05


def test_bf16_state_carry_dtype():
    "b slots carried bf16, a slots kept f32; compute emits f32 posteriors."
    with jax.enable_x64(False):
        student, _ = _build(N=64)
        config.STATE_BF16 = True
        try:
            ep = tt.ExpectationPropagation(student)
            state = ep.init_state()
            state = ep._sweep(student, state,
                              ep._damping_per_slot(0.1))
            for msg in state[:ep.n_slots]:
                assert msg["b"].dtype == jnp.bfloat16
            post = ep._posterior(ep.variable_indices[0], state)
            assert post["b"].dtype == jnp.float32
            assert post["a"].dtype == jnp.float32
        finally:
            config.STATE_BF16 = None


def test_pinned_constant_messages_same_fixed_point():
    """config.PIN_CONSTANT_MESSAGES: the Gaussian likelihood's constant
    message is pinned (recomputed from the model in-body, never damped);
    fixed points match the unpinned default (only the transient differs).
    Default is OFF, see config.py."""
    student, sample = _build()

    def solve():
        ep = tt.ExpectationPropagation(student)
        ep.iterate(max_iter=200, damping=0.1)
        d = ep.get_variable_data("x")
        return np.asarray(d["r"], np.float64), ep

    r_default, ep_d = solve()
    assert not ep_d.pinned
    config.PIN_CONSTANT_MESSAGES = True
    try:
        r_pinned, ep_p = solve()
        assert ep_p.pinned_factor, "likelihood slot not detected"
        assert ep_p.pinned_variable, "cavity slot not propagated"
    finally:
        config.PIN_CONSTANT_MESSAGES = None
    np.testing.assert_allclose(r_pinned, r_default, rtol=1e-4, atol=1e-9)


def test_pinning_covers_gaussian_prior_and_likelihood():
    "With a Gaussian prior BOTH chain ends pin (fwd root + bwd leaf slots)."
    from tramp_tpu.priors import GaussianPrior
    from tramp_tpu.channels import LinearChannel, GaussianChannel

    N = 64
    W = jax.random.normal(jax.random.PRNGKey(5), (48, N)) / jnp.sqrt(N)
    teacher = (GaussianPrior(size=N) @ tt.V(id="x") @
               LinearChannel(W) @ tt.V(id="z") @
               GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    sample = teacher.sample(jax.random.PRNGKey(6))
    student = teacher.to_observed({"y": sample["y"]})

    def solve():
        ep = tt.ExpectationPropagation(student)
        ep.iterate(max_iter=200, damping=0.1)
        return np.asarray(ep.get_variable_data("x")["r"], np.float64), ep

    r_default, _ = solve()
    config.PIN_CONSTANT_MESSAGES = True
    try:
        r_pinned, ep_p = solve()
        # prior fwd slot AND likelihood bwd slot detected
        assert len(ep_p.pinned_factor) == 2, ep_p.pinned_factor
    finally:
        config.PIN_CONSTANT_MESSAGES = None
    np.testing.assert_allclose(r_pinned, r_default, rtol=1e-6, atol=1e-10)
