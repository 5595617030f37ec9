"""Worker for the multi-process (simulated multi-host) EP test.

Each process owns 4 virtual CPU devices; 2 processes form one 8-device
global mesh (data axis = problem instances, 'DCN' analog). Every process
builds the same 8 stacked GLM instances, shards them over the global mesh,
runs the batched EP solve, and checks its addressable shards against the
locally-computed single-process result.

Usage: python multihost_worker.py <process_id> <num_processes> <port>
"""
import os
import sys

proc_id, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"

import jax  # noqa: E402

jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=proc_id)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P  # noqa

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tramp_tpu as tt  # noqa: E402
from tramp_tpu.priors import GaussBernoulliPrior  # noqa: E402
from tramp_tpu.channels import LinearChannel, GaussianChannel  # noqa: E402
from tramp_tpu.parallel import EPSolver, stack_pytrees  # noqa: E402


def build(N, alpha, key):
    M = int(alpha * N)
    W = jax.random.normal(key, (M, N)) / jnp.sqrt(N)
    teacher = (GaussBernoulliPrior(size=N, rho=0.3) @ tt.V(id="x") @
               LinearChannel(W, name="W") @ tt.V(id="z") @
               GaussianChannel(var=1e-2) @ tt.O(id="y")).to_model()
    sample = teacher.sample(jax.random.fold_in(key, 1))
    return teacher.to_observed({"y": sample["y"]})


def main():
    n_dev = jax.device_count()
    assert n_dev == 4 * nproc, (n_dev, nproc)
    keys = jax.random.split(jax.random.PRNGKey(0), n_dev)
    models = [build(48, 0.5, k) for k in keys]
    stacked = stack_pytrees(models)

    mesh = Mesh(np.array(jax.devices()), ("data",))
    sharding = NamedSharding(mesh, P("data"))

    def shard(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == n_dev:
            return jax.device_put(x, sharding)
        return jax.device_put(x, NamedSharding(mesh, P()))

    sharded = jax.tree.map(shard, stacked)

    solver = EPSolver(models[0], damping=0.1, max_iter=60, tol=1e-10)
    with mesh:
        post, n_iter = solver.solve_batch(sharded)
        r_global = post["x"]["r"]
        jax.block_until_ready(r_global)

    # single-process truth for the instances this process can address
    for shard_piece in r_global.addressable_shards:
        idx = shard_piece.index[0].start or 0
        want, _ = solver.solve(models[idx])
        np.testing.assert_allclose(
            np.asarray(shard_piece.data)[0], np.asarray(want["x"]["r"]),
            rtol=1e-8, err_msg=f"instance {idx}")

    # SE phase grid sharded over the 2-process ('DCN') mesh, aggregated via
    # process_allgather, CSV written by host 0 only
    import tempfile
    from tramp_tpu import glm_state_evolution
    from tramp_tpu.parallel import run_se_phase_grid, save_grid_csv

    df = run_se_phase_grid(
        glm_state_evolution,
        grid_kwargs={"alpha": np.linspace(0.1, 1.0, 2 * n_dev),
                     "prior_rho": [0.25]},
        ids=("x",), a0=0.0, mesh=mesh,
        prior_type="gauss_bernoulli", output_type="gaussian",
        output_var=1e-11)
    assert len(df) == 2 * n_dev, len(df)
    assert np.isfinite(df["v"]).all()
    csv_path = os.path.join(tempfile.gettempdir(),
                            f"tramp_grid_{port}.csv")
    wrote = save_grid_csv(df, csv_path)
    assert wrote == (proc_id == 0), (wrote, proc_id)
    if proc_id == 0:
        assert os.path.exists(csv_path)
        n_rows = sum(1 for _ in open(csv_path)) - 1
        assert n_rows == 2 * n_dev, n_rows
        os.unlink(csv_path)

    print(f"proc {proc_id}: OK ({len(r_global.addressable_shards)} shards, "
          f"grid {len(df)} pts)", flush=True)


if __name__ == "__main__":
    main()
