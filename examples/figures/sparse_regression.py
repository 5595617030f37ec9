"""JMLR figure: sparse linear regression MSE vs alpha — EP, SE, Bayes opt.

Reference analog: examples/figures/sparse_regression.py (run_EP l:49-60,
run_SE l:63-73, run_BO l:76-88, protocol l:90-106: EP on N=2000 instances
averaged over 25 seeds, SE/BO on 100-point alpha grids, BO with informed
init a0 = 10**(3*exp(alpha))).

Batched protocol: the per-alpha EP seed average is ONE vmapped
EPSolver.solve_batch (seeds stacked as a leading model axis); the SE and
BO alpha grids are each ONE vmapped SESolver.solve_batch with alpha as a
traced Marchenko-Pastur leaf — per-alpha informed inits enter as a list
of CustomInit (stacked initial states).
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
from tramp_tpu.algos import CustomInit
from tramp_tpu.algos.metrics import mean_squared_error
from tramp_tpu.experiments import BayesOptimalScenario
from tramp_tpu.parallel import EPSolver, SESolver, stack_pytrees


def run_ep_curve(alphas, N, rho, noise_var, n_seeds):
    "Per alpha: n_seeds EP instances as one batched solve; mean empirical mse."
    records = []
    for alpha in alphas:
        students, x_true = [], []
        for seed in range(n_seeds):
            model = glm_generative(
                N=N, alpha=float(alpha), ensemble_type="gaussian",
                prior_type="gauss_bernoulli", output_type="gaussian",
                prior_rho=rho, output_var=noise_var,
                key=jax.random.PRNGKey(seed))
            sc = BayesOptimalScenario(model, x_ids=["x"])
            sc.setup(seed=seed)
            students.append(sc.student)
            x_true.append(sc.x_true["x"])
        solver = EPSolver(students[0], max_iter=200, tol=1e-6)
        post, _ = solver.solve_batch(stack_pytrees(students))
        r = np.asarray(post["x"]["r"])
        mse = np.mean([mean_squared_error(r[i], x_true[i])
                       for i in range(n_seeds)])
        records.append(dict(source="EP", alpha=float(alpha), rho=rho,
                            v=float(mse)))
    return pd.DataFrame(records)


def run_se_curve(alphas, rho, noise_var, source):
    "One batched SE solve over the alpha grid (uninformed SE or informed BO)."
    models = [
        glm_state_evolution(
            alpha=float(a), prior_type="gauss_bernoulli",
            output_type="gaussian", prior_rho=rho, output_var=noise_var)
        for a in alphas
    ]
    solver = SESolver(models[0], max_iter=200, tol=1e-6)
    if source == "BO":
        # informed init scaled to avoid issues at low alpha (reference l:82-84)
        inits = [CustomInit(a_init=[("x", "bwd", 10.0 ** (3 * np.exp(a)))])
                 for a in alphas]
    else:
        inits = None
    post, n_iter = solver.solve_batch(stack_pytrees(models), initializer=inits)
    v = np.asarray(post["x"]["v"]).reshape(len(alphas), -1).mean(axis=1)
    return pd.DataFrame([
        dict(source=source, alpha=float(a), rho=rho, v=float(vi))
        for a, vi in zip(alphas, v)
    ])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--big", action="store_true",
                   help="full JMLR protocol (N=2000, 25 seeds, 100-pt grids)")
    p.add_argument("--plot", action="store_true")
    args = p.parse_args()
    logging.basicConfig(level=logging.INFO)
    N = 2000 if args.big else 250
    n_seeds = 25 if args.big else 4
    rho, noise_var = 0.5, 1e-10
    ep_alphas = np.linspace(0.03, 0.99, 33 if args.big else 9)
    se_alphas = np.linspace(0.01, 1.0, 100 if args.big else 25)

    df = pd.concat([
        run_ep_curve(ep_alphas, N, rho, noise_var, n_seeds),
        run_se_curve(se_alphas, rho, noise_var, "SE"),
        run_se_curve(se_alphas, rho, noise_var, "BO"),
    ], ignore_index=True)
    out = os.path.join(os.path.dirname(__file__), "output")
    os.makedirs(out, exist_ok=True)
    csv = os.path.join(out, "sparse_regression.csv")
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
        ax.set(xlabel="alpha", ylabel="MSE", yscale="log")
        ax.legend()
        fig.tight_layout()
        fig.savefig(os.path.join(out, "sparse_regression.png"), dpi=120)
        print(f"wrote {out}/sparse_regression.png")


if __name__ == "__main__":
    main()
