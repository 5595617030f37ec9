"""JMLR figure: sparse phase retrieval (y = |Fx|, real) — EP, SE, Bayes opt.

Reference analog: examples/figures/sparse_phase_retrieval.py (run_EP
l:49-62, run_SE l:65-78, run_BO l:81-94, protocol l:97-116: abs output,
prior_mean=0.01 symmetry breaking, rho=0.6, EP damping 0.3 with
EarlyStopping(wait_increase=10), SE uninformed init a0=0.1, BO informed
init a0=1e3, sign-symmetric mse).

Batched protocol: per-alpha EP seed batches via EPSolver.solve_batch;
SE/BO alpha grids as single vmapped SESolver solves with per-grid-point
CustomInit lists.
"""
import argparse
import logging
import os

import numpy as np
import pandas as pd
import jax
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp

from tramp_tpu import glm_generative, glm_state_evolution
from tramp_tpu.algos import CustomInit, EarlyStopping
from tramp_tpu.algos.metrics import sign_symmetric_mse
from tramp_tpu.experiments import BayesOptimalScenario
from tramp_tpu.parallel import EPSolver, SESolver, stack_pytrees


def run_ep_curve(alphas, N, rho, n_seeds):
    records = []
    for alpha in alphas:
        students, x_true = [], []
        for seed in range(n_seeds):
            model = glm_generative(
                N=N, alpha=float(alpha), ensemble_type="gaussian",
                prior_type="gauss_bernoulli", output_type="abs",
                prior_rho=rho, prior_mean=0.01,
                key=jax.random.PRNGKey(seed))
            sc = BayesOptimalScenario(model, x_ids=["x"])
            sc.setup(seed=seed)
            students.append(sc.student)
            x_true.append(sc.x_true["x"])
        # wait_increase=10: tolerate the symmetry-breaking transient
        # (reference sparse_phase_retrieval.py:57 EarlyStopping(wait_increase=10))
        solver = EPSolver(students[0], damping=0.3, max_iter=200, tol=1e-6,
                          wait_increase=10)
        post, _ = solver.solve_batch(stack_pytrees(students))
        r = np.asarray(post["x"]["r"])
        mse = np.mean([sign_symmetric_mse(r[i], x_true[i])
                       for i in range(n_seeds)])
        records.append(dict(source="EP", alpha=float(alpha), rho=rho,
                            v=float(mse)))
    return pd.DataFrame(records)


def run_se_curve(alphas, rho, source):
    models = [
        glm_state_evolution(
            alpha=float(a), prior_type="gauss_bernoulli", output_type="abs",
            prior_rho=rho, prior_mean=0.01)
        for a in alphas
    ]
    solver = SESolver(models[0], max_iter=200, tol=1e-6)
    a0 = 1e3 if source == "BO" else 0.1  # reference l:72,89
    inits = [CustomInit(a_init=[("x", "bwd", a0)]) for _ in alphas]
    post, _ = solver.solve_batch(stack_pytrees(models), initializer=inits)
    v = np.asarray(post["x"]["v"]).reshape(len(alphas), -1).mean(axis=1)
    return pd.DataFrame([
        dict(source=source, alpha=float(a), rho=rho, v=float(vi))
        for a, vi in zip(alphas, v)
    ])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--big", action="store_true",
                   help="full JMLR protocol (N=2000, 25 seeds, 120-pt grids)")
    p.add_argument("--plot", action="store_true")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    N = 2000 if args.big else 250
    n_seeds = 25 if args.big else 4
    rho = 0.6
    ep_alphas = np.linspace(0.03, 1.2, 40 if args.big else 8)
    se_alphas = np.linspace(0.01, 1.2, 120 if args.big else 25)

    df = pd.concat([
        run_ep_curve(ep_alphas, N, rho, n_seeds),
        run_se_curve(se_alphas, rho, "SE"),
        run_se_curve(se_alphas, rho, "BO"),
    ], ignore_index=True)
    out = os.path.join(os.path.dirname(__file__), "output")
    os.makedirs(out, exist_ok=True)
    csv = os.path.join(out, "sparse_phase_retrieval.csv")
    df.to_csv(csv, index=False)
    print(df.groupby("source")["v"].describe().to_string())
    print(f"wrote {csv}")

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 6))
        d = df[df.source == "EP"]
        ax.plot(d["alpha"], d["v"], "C1o", label="EP")
        d = df[df.source == "SE"].sort_values("alpha")
        ax.plot(d["alpha"], d["v"], "C0-", label="SE")
        d = df[df.source == "BO"].sort_values("alpha")
        ax.plot(d["alpha"], d["v"], "C2--", label="Bayes opt.")
        ax.set(xlabel="alpha", ylabel="MSE")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out, "sparse_phase_retrieval.png"), dpi=120)
        print(f"wrote {out}/sparse_phase_retrieval.png")


if __name__ == "__main__":
    main()
