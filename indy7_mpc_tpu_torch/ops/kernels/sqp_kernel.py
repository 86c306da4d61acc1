"""Kernel K1: the batched SQP solve (``csrc/sqp_kernel.cu``) and its wrapper.

Replaces ``indy7_mpc_tpu/ops/pallas/sqp_kernel.py``.  For CPU tensors the
wrapper runs the plain PyTorch version (``solvers/sqp_lane.py``); for CUDA
tensors it launches the kernel or raises.  Unlike the TPU kernel, any lane
count B is taken: the lane padding to 8/128 was a TPU tiling artifact.

The kernel runs one thread block per lane with the lane's whole horizon in
dynamic shared memory, so the horizon N is bounded: :func:`shared_bytes`
gives the bytes for N, and an N past :data:`MAX_N` raises ``ValueError``
before any launch.
"""
from __future__ import annotations

import ctypes

import torch

from ...config import CostConfig, SQPConfig
from ...solvers.sqp_lane import solve_lane_major
from .. import lane_rbd as LR
from . import _abi, _build

MAX_ALPHAS = 16  # kMaxAlphas in csrc/sqp_kernel.cu
# Shared floats per knot and of the fixed region (kKnotFloats,
# kFixedFloats in csrc/sqp_kernel.cu), and the dynamic shared memory one
# block may use on sm_90 (kSmemLimit).
KNOT_FLOATS, FIXED_FLOATS, SMEM_LIMIT = 329, 684, 232_448
THREADS = 256  # threads per block (one block per lane)


def shared_bytes(N: int) -> int:
    """Dynamic shared memory of one K1 block at horizon N, in bytes."""
    return 4 * (N * KNOT_FLOATS + FIXED_FLOATS)


MAX_N = (SMEM_LIMIT // 4 - FIXED_FLOATS) // KNOT_FLOATS  # 174


def check_horizon(N: int) -> int:
    """The shared bytes of horizon N; raises ValueError if they exceed what
    a block may use (N > MAX_N)."""
    need = shared_bytes(N)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the SQP kernel keeps the horizon in shared memory: N={N} needs "
            f"{need} bytes, a block may use {SMEM_LIMIT} (N <= {MAX_N})"
        )
    return need


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _check(name, t, shape, device):
    if t.device != device or t.dtype != torch.float32:
        raise ValueError(
            f"{name}: expected float32 on {device}, got {t.dtype} on {t.device}"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def require_kernel_config(cost_cfg: CostConfig, sqp_cfg: SQPConfig) -> None:
    """The configurations the kernel and its plain version implement: the
    Gauss-Newton formulation with the Riccati QP backend.  Anything else
    raises ValueError."""
    from ...solvers.select import kernel_supports

    if not kernel_supports(cost_cfg, sqp_cfg):
        raise ValueError(
            "the SQP kernel and its plain version implement formulation='gn' with "
            f"qp_backend='riccati' only, got {cost_cfg.formulation!r} with "
            f"{sqp_cfg.qp_backend!r}"
        )


def sqp_solve(
    sm: LR.StaticModel,
    cost_cfg: CostConfig,
    sqp_cfg: SQPConfig,
    dt: float,
    xs,
    goals,
    X,
    U,
    wrench=None,
    rho=None,
    stages: int = 4,
    *,
    threads: int = THREADS,
):
    """Batched SQP solve on lane-major tensors (the contract of the TPU
    package's ``sqp_solve_pallas``).

    xs (12, B), goals (N, 3, B), X (N, 12, B), U (N-1, 6, B), wrench (6, B)
    or None, rho (B,) or None.  Returns (X (N, 12, B), U (N-1, 6, B),
    rho (B,), alphas (iters, B), steps (iters, B)).  On CUDA every tensor
    must be float32 and contiguous, and N at most MAX_N.  Any configuration
    other than formulation 'gn' with qp_backend 'riccati' raises.

    ``stages`` < 4 cuts every SQP iteration after stage 1 (linearize), 2
    (+ Riccati sweep) or 3 (+ rollout), as the TPU kernel's profiling cut
    does: the outputs are then meaningless, and the plain version, which
    has no cut, raises.  ``threads`` (a multiple of 32 up to 256) is the
    block size; the result is the same bits for every block size.
    """
    require_kernel_config(cost_cfg, sqp_cfg)
    if stages not in (1, 2, 3, 4):
        raise ValueError(f"stages must be 1, 2, 3 or 4, got {stages}")
    if xs.device.type == "cpu":
        if stages != 4:
            raise ValueError("the plain SQP solve has no stage cut: stages must be 4")
        X, U, rho, alphas, steps, _ = solve_lane_major(
            sm, cost_cfg, sqp_cfg, dt, xs, goals, X, U, wrench=wrench, rho=rho
        )
        return X, U, rho, alphas, steps
    if xs.device.type != "cuda":
        raise ValueError(f"sqp_solve: unsupported device {xs.device}")
    if sqp_cfg.num_alphas > MAX_ALPHAS:
        raise ValueError(f"the SQP kernel takes at most {MAX_ALPHAS} alphas")
    device = xs.device
    N, B = X.shape[0], X.shape[-1]
    if N < 2 or B < 1:
        raise ValueError(f"sqp_solve: need N >= 2 and B >= 1, got N={N}, B={B}")
    check_horizon(N)
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads must be a multiple of 32 in [32, 256], got {threads}")
    if rho is None:
        rho = torch.full((B,), sqp_cfg.rho, dtype=torch.float32, device=device)
    _check("xs", xs, (12, B), device)
    _check("goals", goals, (N, 3, B), device)
    _check("X", X, (N, 12, B), device)
    _check("U", U, (N - 1, 6, B), device)
    _check("rho", rho, (B,), device)
    if wrench is not None:
        _check("wrench", wrench, (6, B), device)

    lib = _build.load_library()
    iters = sqp_cfg.max_iters
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    Xo, Uo, rho_out = empty(N, 12, B), empty(N - 1, 6, B), empty(B)
    alphas, steps = empty(iters, B), empty(iters, B)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.indy7_sqp_solve(
            _abi.model_consts(sm),
            _abi.solve_params(cost_cfg, sqp_cfg, dt, N, B, wrench is not None, stages),
            _ptr(xs), _ptr(goals), _ptr(X), _ptr(U),
            None if wrench is None else _ptr(wrench), _ptr(rho),
            _ptr(Xo), _ptr(Uo), _ptr(rho_out), _ptr(alphas), _ptr(steps),
            threads, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"SQP kernel launch failed: CUDA error {rc}")
    sqp_solve.launches += 1
    return Xo, Uo, rho_out, alphas, steps


sqp_solve.launches = 0  # kernel launches (CPU calls do not count)
