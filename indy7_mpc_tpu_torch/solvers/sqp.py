"""Solver result types (port of ``indy7_mpc_tpu/solvers/sqp.py:30-69``).

The port has no vmap solver and no iterative QP backends, so the state is
the per-lane Levenberg rho only.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SQPConfig


class SolverState(NamedTuple):
    """Per-lane solver state carried across solves (the Levenberg rho)."""

    rho: torch.Tensor  # (B,)

    @staticmethod
    def init(cfg: SQPConfig, batch_shape=(), device=None):
        # float32 like the TPU package, so both start from the same rho.
        return SolverState(
            rho=torch.full(batch_shape, cfg.rho, dtype=torch.float32, device=device)
        )


class SQPStats(NamedTuple):
    """Per-solve diagnostics (the reference's stats schema)."""

    iterations: torch.Tensor  # (B,) iteration count; see each solver
    step_sizes: torch.Tensor  # (B, max_iters) ||alpha * dz|| per iteration
    alphas: torch.Tensor      # (B, max_iters) line-search alphas (0 = reject)


class SQPResult(NamedTuple):
    X: torch.Tensor
    U: torch.Tensor
    state: SolverState
    stats: SQPStats
