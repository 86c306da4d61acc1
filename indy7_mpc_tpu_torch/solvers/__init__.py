"""SQP solvers: the SQP kernel and its plain version.

The package exports the readable solver (``solvers/sqp.py``) and the
solver selection (``solvers/select.py``); ``is_cuda_device`` takes the
place of the TPU package's ``is_tpu_device``.
"""
from .sqp import SolverState, SQPResult, SQPStats, solve, batch_solve
from .select import default_batch_solve_fn, default_single_solve_fn, is_cuda_device

__all__ = [
    "SolverState",
    "SQPResult",
    "SQPStats",
    "solve",
    "batch_solve",
    "default_batch_solve_fn",
    "default_single_solve_fn",
    "is_cuda_device",
]
