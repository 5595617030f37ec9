"""Global configuration for tramp_tpu.

The reference (sphinxteam/tramp) is float64 numpy throughout. On the
accelerator we default to float32 and allow float64 on CPU for
bitwise-tolerant parity testing (enable via ``jax.config.jax_enable_x64``).
"""
import jax
import jax.numpy as jnp

#: Precision clipping bounds for message precisions.
#: Mirrors reference tramp/base.py:238-239 (AMIN=1e-11, AMAX=1e11).
AMIN = 1e-11
AMAX = 1e11

#: Floor for the numerically safe inverse, reference tramp/base.py:44-46.
VMIN = 1e-20

#: Default number of Gauss-Hermite nodes used to replace the reference's
#: adaptive scipy.integrate.quad over [-10, 10] (tramp/utils/integration.py:27).
GH_NODES = 127

#: Default number of Gauss-Legendre nodes for truncated-interval measures.
GL_NODES = 65


#: bfloat16 weight streaming for the dense SVD-basis matvecs of
#: LinearChannel: None = auto (False), True / False = force. Casting the
#: loop-invariant U/V factors to bf16 *before* the GEMM halves their
#: weight traffic; XLA's while-loop LICM hoists the casts out of the sweep
#: loop, and accumulation stays float32 (preferred_element_type). The
#: bf16 operand rounding moves the fixed point; the auto value stays False
#: until a benchmark cell shows the gate pays for that.
MATVEC_BF16 = None


def matvec_bf16():
    "Resolve the MATVEC_BF16 gate at trace time (None = auto: False)."
    if MATVEC_BF16 is not None:
        return bool(MATVEC_BF16)
    return False


#: bfloat16 storage for the b-message arrays of the EP state: b slots
#: are stored bf16 in the while_loop carry and upcast to float32 at every
#: read (cavity sums, factor math, metrics), so all COMPUTE stays f32 and
#: only the carried state is compressed. None = auto (currently False:
#: throughput-mode opt-in), True/False = force.
#:
#: CAVEAT: bf16 resolution (~0.4% relative) floors the achievable
#: fixed-point accuracy AND the relative-r convergence delta — solves
#: gated on tol <= 1e-4 will typically run to max_iter. Intended for the
#: fixed-sweep-count throughput path; accuracy impact is measured in
#: bench.py.
STATE_BF16 = None


def state_bf16():
    "Resolve the STATE_BF16 gate at trace time."
    if STATE_BF16 is not None:
        return bool(STATE_BF16)
    return False


#: Pin model-constant factor messages (Gaussian likelihood/prior fast
#: paths): pinned slots are recomputed from model leaves at the top of
#: every sweep (loop-invariant, so XLA hoists their consumer GEMMs — e.g.
#: U^T (y/var), 9.1% of the flagship sweep's FLOPs, verified in the
#: compiled cost analysis) and are never damped (d*c + (1-d)*c = c at the
#: fixed point; transient differs, fixed points identical — tested).
#: DEFAULT OFF: the hoisted loop-invariant (batch x M) buffer can force a
#: worse while-loop schedule, which outweighs the FLOP reduction; flip on
#: only where a benchmark cell shows a gain.
PIN_CONSTANT_MESSAGES = None


def pin_constant_messages():
    "Resolve the PIN_CONSTANT_MESSAGES gate (None = auto: False)."
    if PIN_CONSTANT_MESSAGES is not None:
        return bool(PIN_CONSTANT_MESSAGES)
    return False


#: Spectral-image carry for dense LinearChannels in the generic tree
#: engine: the backward pass's U^T bx is kept in the message state and
#: reused by the next forward pass (bx cannot change in between — the
#: forward pass writes only fwd slots), saving one thin (Nx, k) GEMM per
#: linear factor per sweep: 2 Nz k + 3 Nx k -> 2 Nz k + 2 Nx k MACs.
#: This generalizes the chain-only ML-VAMP carry discipline
#: (parallel/ml_vamp.py:16-47) to linear factors at ANY tree position
#: (TV, committee, sparse-gradient models). The carried image is a
#: length-k vector (tiny next to the (N,) slots), unlike the round-3
#: constant-message-pinning negative which parked a (batch x M) buffer in
#: the carry. The cached value is recomputed by the same _mm on the same
#: stored operand, so trajectories are BIT-IDENTICAL to the uncached
#: engine. None = auto (True), True/False = force.
SPECTRAL_CARRY = None


def spectral_carry():
    "Resolve the SPECTRAL_CARRY gate (None = auto: True)."
    if SPECTRAL_CARRY is not None:
        return bool(SPECTRAL_CARRY)
    return True


#: FFT implementation for the conv/gradient/DFT channels: None (or "xla")
#: = native complex64 and jnp.fft; "matmul" = the packed-real dense-DFT
#: matmul path (O(n^2) per axis, exact parity with jnp.fft to dtype
#: accuracy — see ops/dft.py).
FFT_MODE = None


def default_dtype():
    """Default floating dtype: float64 when x64 is enabled, else float32."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
