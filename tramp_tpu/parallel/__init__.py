from .solver import (EPSolver, SESolver, stack_pytrees,
                     solve_batch_shard_map)
from .mesh import make_mesh, shard_batched_model, shard_batched_state
from .grid import (run_se_phase_grid, se_phase_grid_records, save_grid_csv,
                   grid_combos)
from .checkpoint import save_checkpoint, restore_checkpoint
from .vamp_glm import SpectralVAMPSolver
from .ml_vamp import MLVAMPSolver, dispatch_solver

__all__ = [
    "EPSolver", "SESolver", "stack_pytrees", "solve_batch_shard_map",
    "make_mesh",
    "shard_batched_model", "shard_batched_state",
    "run_se_phase_grid", "se_phase_grid_records", "save_grid_csv",
    "grid_combos",
    "save_checkpoint", "restore_checkpoint",
    "SpectralVAMPSolver", "MLVAMPSolver", "dispatch_solver",
]
