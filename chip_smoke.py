#!/usr/bin/env python
"""Smoke run of the Tree-AMP main path on NVIDIA GPUs.

    python chip_smoke.py           # one card (the phases below)
    python chip_smoke.py --multi   # four cards: __graft_entry__.dryrun_multichip(4)

Every phase drives the entry points a user calls (the ``@`` model DSL,
``parallel.dispatch_solver``, ``EPSolver``, ``StateEvolution``) at full
width, compares the result with a plain reference, and asserts. One card:

- flagship compressed-sensing GLM, N = 10^4, alpha = 0.5 (M = 5000),
  rho = 0.25, noise 1e-2. A batch of lanes shares W (thin SVD on the
  device, inside ``LinearChannel(W)``) and each lane has its own y; the
  batch is solved by ``dispatch_solver`` (SpectralVAMPSolver) and by
  ``EPSolver``. The two fixed points agree, and the empirical mse tracks the
  state-evolution prediction. One instance, given the same host float64
  thin SVD on both sides, matches its float64 CPU solve.
- two-layer relu net, N = 4096, alpha = 0.5 (the erfcx-heavy
  piecewise-linear denoiser): ML-VAMP vs EPSolver vs float64 CPU.
- sparse-gradient model, N = 400: native complex64 FFT (cuFFT) vs the
  packed-real matmul DFT (``config.FFT_MODE = "matmul"``) vs float64 CPU,
  all under the engine's default stopping rule (its increase test halts
  this model after a few sweeps on every side, as in bench.py).

Each comparison runs at the default matmul precision (TF32 on the GPU) and
under ``jax.default_matmul_precision("highest")``; both errors are printed.
The bounds are the bench's accuracy bounds. The float64 CPU references run
in a child process with the CPU platform forced, so only this process opens
the card. Exit code 0 only if every check passed; the last stdout line is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
There is no CPU fallback: without a GPU the script exits non-zero.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
PRECISIONS = ("default", "highest")

#: name -> upper bound on the measured value (bench.py ACCURACY_BOUNDS)
BOUNDS = {
    "flagship.v_rel_err_f32_vs_f64": 1e-1,
    "flagship.mse_rel_err_f32_vs_f64": 1.5e-1,
    "vamp_glm.v_rel_err_vs_ep_f32": 2e-2,
    "vamp_glm.mse_rel_err_vs_ep_f32": 2e-2,
    # |mean mse - v_SE| / (3 sd-of-mean + 10% v_SE), the ensemble band
    "flagship.ep_tracks_se_max_dev": 1.0,
    "nonlinear.mlvamp_v_rel_err_vs_ep_f32": 2e-2,
    "nonlinear.mlvamp_mse_rel_err_vs_ep_f32": 2e-2,
    "relu_net.v_rel_err_f32_vs_f64": 5e-2,
    "relu_net.mse_rel_err_f32_vs_f64": 5e-2,
    "sparse_gradient.v_rel_err_f32_vs_f64": 5e-2,
    "sparse_gradient.mse_rel_err_f32_vs_f64": 5e-2,
    "sparse_gradient.v_rel_err_fft_vs_matmul": 5e-2,
    "sparse_gradient.mse_rel_err_fft_vs_matmul": 5e-2,
}

#: full-width sizes (bench.py's flagship, relu-net and sparse-gradient)
SIZES = dict(flagship_n=10_000, alpha=0.5, rho=0.25, noise=1e-2,
             batch=256, relu_n=4096, grad_n=400, grad_rho=0.04)


def compile_cache_dir():
    "$JAX_COMPILATION_CACHE_DIR if set, else <repo>/.jax_cache."
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(REPO, ".jax_cache"))


def enable_compile_cache():
    import jax
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())


class SmokeFailure(AssertionError):
    "A phase's result is wrong (raised even under python -O)."


def require(ok, message):
    if not ok:
        raise SmokeFailure(message)


def rel_err(got, want):
    return abs(got - want) / abs(want)


# -- problem instances: host numpy float64, identical for every side ------

def flagship_instance(n, alpha, rho, noise):
    "Compressed-sensing GLM y = W x0 + noise, Gauss-Bernoulli x0."
    rng = np.random.RandomState(0)
    m = int(alpha * n)
    W = rng.randn(m, n) / np.sqrt(n)
    x0 = (rng.rand(n) < rho) * rng.randn(n)
    y = W @ x0 + np.sqrt(noise) * rng.randn(m)
    return W, x0, y


def relu_instance(n, alpha, rho, noise):
    "Two-layer relu net y = relu(W x0) + noise (bench.py build_nonlinear)."
    rng = np.random.RandomState(11)
    m = int(alpha * n)
    W = rng.randn(m, n) / np.sqrt(n)
    x0 = (rng.rand(n) < rho) * rng.randn(n)
    y = np.maximum(W @ x0, 0.0) + np.sqrt(noise) * rng.randn(m)
    return W, x0, y


def sparse_gradient_instance(n, rho, noise):
    "Piecewise-constant x0 (cumsum of a sparse draw) seen in noise."
    rng = np.random.RandomState(1)
    z0 = (rng.rand(1, n) < rho) * rng.randn(1, n)
    x0 = z0.ravel().cumsum()
    x0 = x0 - x0.mean()
    y = x0 + np.sqrt(noise) * rng.randn(n)
    return x0, y


# -- models (the README's DSL) --------------------------------------------

def glm_model(W, rho, noise, dtype, svd=None, y=None):
    import jax.numpy as jnp
    import tramp_tpu as tt
    from tramp_tpu.priors import GaussBernoulliPrior
    from tramp_tpu.channels import LinearChannel, GaussianChannel

    if svd is not None:
        svd = tuple(jnp.asarray(a, dtype) for a in svd)
    model = (GaussBernoulliPrior(size=W.shape[1], rho=rho) @ tt.V(id="x") @
             LinearChannel(jnp.asarray(W, dtype), svd=svd, name="W") @
             tt.V(id="z") @ GaussianChannel(var=noise) @ tt.O(id="y")
             ).to_model()
    if y is not None:
        model = model.to_observed({"y": jnp.asarray(y, dtype)})
    return model


def relu_model(W, y, svd, rho, noise, dtype):
    import jax.numpy as jnp
    import tramp_tpu as tt
    from tramp_tpu.priors import GaussBernoulliPrior
    from tramp_tpu.channels import LinearChannel, GaussianChannel, ReluChannel

    svd = tuple(jnp.asarray(a, dtype) for a in svd)
    return (GaussBernoulliPrior(size=W.shape[1], rho=rho) @ tt.V(id="x") @
            LinearChannel(jnp.asarray(W, dtype), svd=svd, name="W") @
            tt.V(id="z") @ ReluChannel() @ tt.V(id="a") @
            GaussianChannel(var=noise) @ tt.O(id="y")
            ).to_model().to_observed({"y": jnp.asarray(y, dtype)})


def sparse_gradient_model(y, rho, noise, dtype):
    import jax.numpy as jnp
    from tramp_tpu.variables import (
        SIMOVariable, MILeafVariable, SILeafVariable as O)
    from tramp_tpu.priors import GaussianPrior, GaussBernoulliPrior
    from tramp_tpu.channels import GradientChannel, GaussianChannel

    n = y.shape[0]
    return (
        GaussianPrior(size=(n,)) @
        SIMOVariable(id="x", n_next=2) @ (
            GaussianChannel(var=noise) @ O("y") + (
                GradientChannel(shape=(n,)) +
                GaussBernoulliPrior(size=(1, n), rho=rho)
            ) @ MILeafVariable(id="z", n_prev=2)
        )
    ).to_model().to_observed({"y": jnp.asarray(y, dtype)})


def summarize(post, x0, n_iter, conv):
    "Posterior of x -> {v, mse, n_iter, conv}, reduced on the host in f64."
    r = np.asarray(post["x"]["r"], np.float64)
    v = np.asarray(post["x"]["v"], np.float64)
    require(np.isfinite(r).all() and np.isfinite(v).all(), "non-finite x")
    return dict(v=float(np.mean(v)), mse=float(np.mean((r - x0) ** 2)),
                n_iter=int(n_iter), conv=bool(conv))


def timed(fn):
    """(result, compile_s, steady_s): the first call compiles and runs, the
    second runs the compiled program again."""
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, first, time.perf_counter() - t0


# -- float64 CPU references (child process) -------------------------------

def cpu_reference(npz_path):
    """float64 CPU EPSolver fixed points of the single instances, on the
    same host SVDs the GPU side uses. Runs with the CPU platform forced."""
    import jax
    jax.config.update("jax_enable_x64", True)
    from tramp_tpu.parallel import EPSolver

    def solve(model, x0, max_iter=500):
        post, n_iter, conv = EPSolver(model, damping=0.1, max_iter=max_iter,
                                      tol=1e-6).solve_info(model)
        return summarize(post, x0, n_iter, conv)

    d = np.load(npz_path)
    n, alpha, rho, noise = (float(d[k]) for k in
                            ("flagship_n", "alpha", "rho", "noise"))
    out = {}
    W, x0, y = flagship_instance(int(n), alpha, rho, noise)
    out["flagship"] = solve(glm_model(W, rho, noise, "float64", y=y, svd=(
        d["f_U"], d["f_s"], d["f_Vt"])), x0)
    W, x0, y = relu_instance(int(d["relu_n"]), alpha, rho, noise)
    out["relu_net"] = solve(relu_model(W, y, (d["r_U"], d["r_s"], d["r_Vt"]),
                                       rho, noise, "float64"), x0)
    grad_rho = float(d["grad_rho"])
    x0, y = sparse_gradient_instance(int(d["grad_n"]), grad_rho, noise)
    out["sparse_gradient"] = solve(
        sparse_gradient_model(y, grad_rho, noise, "float64"), x0,
        max_iter=1000)
    print(json.dumps(out))


def start_cpu_reference(sizes, workdir):
    """Host float64 thin SVDs (shared by both sides) to an npz, then the
    CPU child. Returns (child, svds)."""
    t0 = time.perf_counter()
    W, _, _ = flagship_instance(sizes["flagship_n"], sizes["alpha"],
                                sizes["rho"], sizes["noise"])
    f_svd = np.linalg.svd(W, full_matrices=False)
    W, _, _ = relu_instance(sizes["relu_n"], sizes["alpha"], sizes["rho"],
                            sizes["noise"])
    r_svd = np.linalg.svd(W, full_matrices=False)
    path = os.path.join(workdir, "svd.npz")
    np.savez(path, f_U=f_svd[0], f_s=f_svd[1], f_Vt=f_svd[2],
             r_U=r_svd[0], r_s=r_svd[1], r_Vt=r_svd[2], **sizes)
    print(f"host f64 thin SVDs: {time.perf_counter() - t0:.1f} s", flush=True)
    # the card stays hidden from the child; JAX's CUDA plugin then logs a
    # CUDA_ERROR_NO_DEVICE traceback on stderr, which is expected
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-reference", path],
        env=env, stdout=subprocess.PIPE, text=True)
    return child, {"flagship": f_svd, "relu_net": r_svd}


def wait_cpu_reference(child, timeout=900):
    out, _ = child.communicate(timeout=timeout)
    if child.returncode != 0:
        raise RuntimeError(f"CPU reference failed (rc {child.returncode})")
    return json.loads(out.strip().splitlines()[-1])


# -- phases ---------------------------------------------------------------

def _batched(model, ys):
    "Model with the observation leaf replaced by ys, plus vmap in_axes."
    import jax
    y_leaf = model.factors[-1].y
    leaves, treedef = jax.tree.flatten(model)
    axes = [0 if leaf is y_leaf else None for leaf in leaves]
    leaves = [ys if leaf is y_leaf else leaf for leaf in leaves]
    return (jax.tree.unflatten(treedef, leaves),
            jax.tree.unflatten(treedef, axes))


def phase_flagship_batch(sizes, checks):
    """Batch of lanes sharing W, each with its own y: dispatched vs engine
    fixed point and empirical mse vs the SE prediction."""
    import jax
    import jax.numpy as jnp
    from tramp_tpu import glm_state_evolution, StateEvolution
    from tramp_tpu.parallel import (
        EPSolver, SpectralVAMPSolver, dispatch_solver)

    n, alpha, rho, noise, B = (sizes[k] for k in
                               ("flagship_n", "alpha", "rho", "noise",
                                "batch"))
    W, _, _ = flagship_instance(n, alpha, rho, noise)
    t0 = time.perf_counter()
    teacher = glm_model(W, rho, noise, jnp.float32)   # thin SVD on device
    jax.block_until_ready(teacher.factors[1].U)
    print(f"flagship: device thin SVD of {W.shape} in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    samples = jax.jit(jax.vmap(lambda m, k: m.sample(k),
                               in_axes=(None, 0)))(teacher, keys)
    x0s = samples["x"]
    student = teacher.to_observed({"y": samples["y"][0]})
    model_in, axes = _batched(student, samples["y"])

    se = StateEvolution(glm_state_evolution(
        alpha=alpha, prior_type="gauss_bernoulli", output_type="gaussian",
        prior_rho=rho, output_var=noise))
    se.iterate(max_iter=500)
    v_se = float(np.mean(np.asarray(se.get_variable_data("x")["v"])))

    vamp = dispatch_solver(student, max_iter=500, tol=1e-6)
    require(isinstance(vamp, SpectralVAMPSolver), f"dispatched {vamp}")
    # stop on the mean-variance delta like VAMP: the relative-r delta can
    # stall at the TF32 rounding floor when many lanes share one W
    ep = EPSolver(student, damping=0.1, max_iter=500, tol=1e-6,
                  stop_kind="v")
    vamp_run = jax.jit(jax.vmap(vamp._run, in_axes=(axes, None, None)))
    ep_run = jax.jit(jax.vmap(ep._run, in_axes=(axes, None, None, None)))
    mi, tol = jnp.asarray(500), jnp.asarray(1e-6)

    def lane_mse(post):
        return jnp.mean((post["x"]["r"] - x0s) ** 2, axis=1)

    for prec in PRECISIONS:
        with jax.default_matmul_precision(prec):
            res = {}
            for name, call in (
                    ("dispatched", lambda: vamp_run(model_in, mi, tol)),
                    ("engine", lambda: ep_run(model_in, ep.init_state(),
                                              mi, tol))):
                out, c_s, s_s = timed(call)
                post, n_iter, conv = out[0], out[-2], out[-1]
                mse = np.asarray(lane_mse(post), np.float64)
                v = np.asarray(jnp.mean(post["x"]["v"].reshape(B, -1),
                                        axis=1), np.float64)
                require(np.isfinite(mse).all() and np.isfinite(v).all(),
                        f"{name}: non-finite posterior ({prec})")
                conv = np.asarray(conv)
                require(conv.all(), f"{name}: {int((~conv).sum())} of {B} "
                                    f"lanes did not converge ({prec})")
                dev = abs(mse.mean() - v_se) / (
                    3 * mse.std() / np.sqrt(B) + 0.1 * v_se)
                res[name] = dict(v=v.mean(), mse=mse.mean())
                print(f"flagship batch {B} {name} [{prec}]: compile+run "
                      f"{c_s:.2f} s, steady {s_s:.3f} s, n_iter mean "
                      f"{np.asarray(n_iter).mean():.1f} max "
                      f"{int(np.asarray(n_iter).max())}, mse {mse.mean():.5f}"
                      f" vs SE {v_se:.5f}", flush=True)
                checks.append(("flagship.ep_tracks_se_max_dev", prec,
                               f"{name}", dev))
            d, e = res["dispatched"], res["engine"]
            checks.append(("vamp_glm.v_rel_err_vs_ep_f32", prec, "batch",
                           rel_err(d["v"], e["v"])))
            checks.append(("vamp_glm.mse_rel_err_vs_ep_f32", prec, "batch",
                           rel_err(d["mse"], e["mse"])))


def solve_arms(problem, x0, arms, out):
    """Solve each arm (name -> (solver, model)) at both precisions; record
    the x summaries in out[(problem, name, precision)]."""
    import jax
    for prec in PRECISIONS:
        with jax.default_matmul_precision(prec):
            for name, (solver, model) in arms.items():
                res, c_s, s_s = timed(lambda: solver.solve_info(model))
                got = out[(problem, name, prec)] = summarize(
                    res[0], x0, *res[1:])
                print(f"{problem} {name} [{prec}]: compile+run {c_s:.2f} s, "
                      f"steady {s_s:.3f} s, {got}", flush=True)


def check_pair(out, checks, problem, key, a, b):
    "Relative v and mse error of arm a against arm b, per precision."
    for prec in PRECISIONS:
        got, want = out[(problem, a, prec)], out[(problem, b, prec)]
        for q in ("v", "mse"):
            checks.append((key.format(q), prec, "",
                           rel_err(got[q], want[q])))


def phase_flagship_instance(sizes, svd, out):
    "One instance on the host SVD: dispatched and engine, float32 GPU."
    import jax.numpy as jnp
    from tramp_tpu.parallel import EPSolver, dispatch_solver

    n, alpha, rho, noise = (sizes[k] for k in
                            ("flagship_n", "alpha", "rho", "noise"))
    W, x0, y = flagship_instance(n, alpha, rho, noise)
    model = glm_model(W, rho, noise, jnp.float32, svd=svd, y=y)
    solve_arms("flagship", x0, {
        "dispatched": (dispatch_solver(model, max_iter=500, tol=1e-6),
                       model),
        "engine": (EPSolver(model, damping=0.1, max_iter=500, tol=1e-6,
                            stop_kind="v"), model)}, out)


def phase_relu(sizes, svd, out, checks):
    "Two-layer relu net: dispatched ML-VAMP vs the engine, float32 GPU."
    import jax.numpy as jnp
    from tramp_tpu.parallel import EPSolver, MLVAMPSolver, dispatch_solver

    W, x0, y = relu_instance(sizes["relu_n"], sizes["alpha"], sizes["rho"],
                             sizes["noise"])
    model = relu_model(W, y, svd, sizes["rho"], sizes["noise"], jnp.float32)
    mlvamp = dispatch_solver(model, damping=0.1, max_iter=500, tol=1e-6)
    require(isinstance(mlvamp, MLVAMPSolver), f"dispatched {mlvamp}")
    solve_arms("relu_net", x0, {
        "dispatched": (mlvamp, model),
        "engine": (EPSolver(model, damping=0.1, max_iter=500, tol=1e-6),
                   model)}, out)
    check_pair(out, checks, "relu_net",
               "nonlinear.mlvamp_{}_rel_err_vs_ep_f32", "dispatched", "engine")


def phase_sparse_gradient(sizes, out, checks):
    "GradientChannel on native complex64 + cuFFT vs the packed matmul DFT."
    import jax.numpy as jnp
    from tramp_tpu import config
    from tramp_tpu.parallel import EPSolver

    x0, y = sparse_gradient_instance(sizes["grad_n"], sizes["grad_rho"],
                                     sizes["noise"])
    arms = {}
    for name, mode in (("fft", None), ("matmul", "matmul")):
        config.FFT_MODE = mode     # read when the channel is built
        try:
            model = sparse_gradient_model(y, sizes["grad_rho"],
                                          sizes["noise"], jnp.float32)
        finally:
            config.FFT_MODE = None
        arms[name] = (EPSolver(model, damping=0.1, max_iter=1000, tol=1e-6),
                      model)
    solve_arms("sparse_gradient", x0, arms, out)
    check_pair(out, checks, "sparse_gradient",
               "sparse_gradient.{}_rel_err_fft_vs_matmul", "fft", "matmul")


def compare_with_cpu(out, ref, checks):
    "float32 GPU fixed points vs the float64 CPU ones."
    print(f"float64 CPU references: {ref}", flush=True)
    for (problem, name, prec), got in out.items():
        want = ref[problem]
        checks.append((f"{problem}.v_rel_err_f32_vs_f64", prec, name,
                       rel_err(got["v"], want["v"])))
        checks.append((f"{problem}.mse_rel_err_f32_vs_f64", prec, name,
                       rel_err(got["mse"], want["mse"])))


def report(checks):
    "Print every check; fail if any is outside its bound or not finite."
    failed = []
    for key, prec, what, value in checks:
        bound = BOUNDS[key]
        ok = bool(np.isfinite(value) and value < bound)
        print(f"check {key} [{prec}] {what}: {value:.3e} "
              f"(bound {bound:.0e}) {'ok' if ok else 'FAILED'}", flush=True)
        if not ok:
            failed.append(f"{key} [{prec}] {what}")
    require(not failed, f"checks outside their bounds: {failed}")


def require_gpu(count):
    import jax
    if jax.default_backend() != "gpu":
        sys.exit(f"chip_smoke: JAX found no GPU (default backend "
                 f"{jax.default_backend()!r}); there is no CPU fallback")
    if len(jax.devices()) < count:
        sys.exit(f"chip_smoke: needs {count} GPUs, JAX sees "
                 f"{len(jax.devices())}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    for line in smi.stdout.strip().splitlines():
        print(f"nvidia-smi: {line}", flush=True)


def run_one_card(sizes):
    out, checks = {}, []
    with tempfile.TemporaryDirectory() as workdir:
        child, svds = start_cpu_reference(sizes, workdir)
        try:
            t0 = time.perf_counter()
            phase_flagship_batch(sizes, checks)
            phase_flagship_instance(sizes, svds["flagship"], out)
            phase_relu(sizes, svds["relu_net"], out, checks)
            phase_sparse_gradient(sizes, out, checks)
            print(f"GPU phases: {time.perf_counter() - t0:.1f} s", flush=True)
            compare_with_cpu(out, wait_cpu_reference(child), checks)
        finally:
            if child.poll() is None:
                child.kill()
                child.wait()
    report(checks)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: run __graft_entry__.dryrun_multichip(4)"
                         " and nothing else")
    ap.add_argument("--cpu-reference", metavar="NPZ",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.cpu_reference:
        cpu_reference(args.cpu_reference)
        return
    enable_compile_cache()
    import jax
    count = 4 if args.multi else 1
    require_gpu(count)
    t0 = time.perf_counter()
    if args.multi:
        sys.path.insert(0, REPO)
        import __graft_entry__
        __graft_entry__.dryrun_multichip(count)
    else:
        run_one_card(SIZES)
    print(f"chip_smoke total: {time.perf_counter() - t0:.1f} s", flush=True)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
