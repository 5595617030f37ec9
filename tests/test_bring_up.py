"""What the program needs from the machine it runs on: no platform-keyed
defaults, no second process on the accelerator, optional packages imported
only where used, the compile-cache location, and a smoke run that refuses
to run without a GPU."""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_matvec_bf16_auto_is_false(monkeypatch, platform):
    "The auto value of the bf16 weight-streaming gate depends on no platform."
    from tramp_tpu import config
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert config.MATVEC_BF16 is None
    with jax.enable_x64(False):
        assert config.matvec_bf16() is False


def test_auto_fft_mode_is_native_without_a_subprocess(monkeypatch):
    """The default FFT mode is native complex64 + jnp.fft on every backend,
    decided without starting a process (a second process would open the
    accelerator again)."""
    from tramp_tpu import config
    from tramp_tpu.ops import dft
    from tramp_tpu.channels import GradientChannel

    def refuse(*args, **kwargs):
        raise AssertionError("no subprocess may be started")

    monkeypatch.setattr(subprocess, "run", refuse)
    monkeypatch.setattr(subprocess, "Popen", refuse)
    assert config.FFT_MODE is None
    assert dft.packed_mode() is False
    ch = GradientChannel(shape=(16,))
    assert not ch.packed and jnp.iscomplexobj(ch.w_fft)
    z = np.random.RandomState(0).randn(16)
    got = np.asarray(ch.convolve(jnp.asarray(z)))
    monkeypatch.undo()   # numpy's assert helpers may start processes
    want = np.real(np.fft.ifft(np.asarray(ch.w_fft) * np.fft.fft(z)[None]))
    np.testing.assert_allclose(got, want, atol=1e-12)


def _run_blocked(blocked, code):
    "Run `code` in a CPU child in which importing `blocked` fails."
    prelude = "import sys\n" + "".join(
        f"sys.modules[{m!r}] = None\n" for m in blocked)
    return subprocess.run(
        [sys.executable, "-c", prelude + code], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)


def test_parallel_imports_without_orbax_and_pandas():
    """The production entry points import without the optional packages;
    checkpointing names the missing one when it is used."""
    out = _run_blocked(
        ["orbax", "orbax.checkpoint", "pandas"],
        "import tramp_tpu.parallel\n"
        "from tramp_tpu.parallel import dispatch_solver, EPSolver\n"
        "try:\n"
        "    tramp_tpu.parallel.save_checkpoint('/nonexistent', {}, 0)\n"
        "except ImportError as e:\n"
        "    print('MSG', e)\n")
    assert out.returncode == 0, out.stderr
    assert "MSG" in out.stdout and "orbax" in out.stdout, out.stdout


@pytest.mark.parametrize("env_dir", [None, "custom_cache"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """chip_smoke.py and bench.py keep the compile cache in
    $JAX_COMPILATION_CACHE_DIR when set, else in <repo>/.jax_cache."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    if env_dir is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        want = os.path.join(REPO, ".jax_cache")
    else:
        want = str(tmp_path / env_dir)
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    assert chip_smoke.compile_cache_dir() == want
    prev = jax.config.jax_compilation_cache_dir
    try:
        chip_smoke.enable_compile_cache()
        assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_chip_smoke_refuses_cpu():
    "Without a GPU the smoke run exits non-zero and prints no ok line."
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "no GPU" in out.stderr
