"""Kernel K1: the batched SQP solve (``csrc/sqp_kernel.cu``) and its wrapper.

Replaces ``indy7_mpc_tpu/ops/pallas/sqp_kernel.py``.  For CPU tensors the
wrapper runs the plain PyTorch version (``solvers/sqp_lane.py``); for CUDA
tensors it launches the kernel or raises.  Unlike the TPU kernel, any lane
count B is taken: the lane padding to 8/128 was a TPU tiling artifact.

The kernel keeps the lane's horizon in dynamic shared memory: one thread
block per lane up to :data:`MAX_SEGMENT` knots, past that a thread-block
cluster of C blocks per lane, each holding a segment of ceil(N / C) knots
and reading the others' over distributed shared memory.  C is the smallest
size whose segment fits a block (:func:`cluster_size`), at most
:data:`MAX_CLUSTER`, or what the card schedules if less
(:func:`max_cluster`).  :func:`shared_bytes` gives a block's bytes, and an
N past :func:`max_horizon` raises ``ValueError`` before any launch.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ... import tracing
from ...config import CostConfig, SQPConfig
from ...solvers.sqp_lane import solve_lane_major
from .. import lane_rbd as LR
from . import _abi, _build

# Shared floats per knot and of the fixed region at up to ALPHA_SLOTS
# alphas, the work floats of a knot in them (kKnotFloats, kFixedFloats,
# kAlphaSlots, kWork in csrc/sqp_kernel.cu), the dynamic shared memory one
# block may use on sm_90 (kSmemLimit), and the portable cluster size
# (kMaxCluster).
KNOT_FLOATS, FIXED_FLOATS, ALPHA_SLOTS, WORK_FLOATS = 329, 684, 16, 48
SMEM_LIMIT, MAX_CLUSTER = 232_448, 8
THREADS = 256  # threads per block


def layout(num_alphas: int = ALPHA_SLOTS):
    """(floats a knot, floats of the fixed region) for ``num_alphas``
    alphas: past ALPHA_SLOTS the merits take a slot an alpha, and the
    work region two floats an alpha where that exceeds WORK_FLOATS."""
    slots = max(ALPHA_SLOTS, num_alphas)
    return (KNOT_FLOATS + max(WORK_FLOATS, 2 * slots) - WORK_FLOATS,
            FIXED_FLOATS + slots - ALPHA_SLOTS)


def shared_bytes(knots: int, num_alphas: int = ALPHA_SLOTS) -> int:
    """Dynamic shared memory of one K1 block holding ``knots`` knots."""
    knot, fixed = layout(num_alphas)
    return 4 * (knots * knot + fixed)


def max_segment(num_alphas: int = ALPHA_SLOTS) -> int:
    """The most knots one block holds."""
    knot, fixed = layout(num_alphas)
    return (SMEM_LIMIT // 4 - fixed) // knot


def cluster_size(N: int, num_alphas: int = ALPHA_SLOTS) -> int:
    """The smallest cluster whose blocks' segments of ceil(N / C) knots
    fit a block (1 up to :data:`MAX_SEGMENT` knots)."""
    return -(-N // max_segment(num_alphas))


def max_horizon(num_alphas: int = ALPHA_SLOTS, clusters: int = MAX_CLUSTER) -> int:
    """The longest horizon a cluster of at most ``clusters`` blocks holds."""
    return clusters * max_segment(num_alphas)


MAX_SEGMENT = max_segment()  # 174
MAX_N = max_horizon()  # 1,392


def check_horizon(N: int, num_alphas: int = ALPHA_SLOTS, cluster=None,
                  clusters: int = MAX_CLUSTER):
    """(C, a block's shared bytes) of horizon N: C is ``cluster`` if given,
    else :func:`cluster_size`.  Raises ValueError if N needs a cluster of
    more than ``clusters`` blocks (N > :func:`max_horizon`), or if the
    given cluster is out of [1, ``clusters``], leaves a block without
    knots or a segment past a block's shared memory."""
    limit = max_horizon(num_alphas, clusters)
    if cluster is None:
        if N > limit:
            raise ValueError(
                f"the SQP kernel keeps the horizon in the shared memory of a cluster of at "
                f"most {clusters} blocks of {SMEM_LIMIT} bytes, {max_segment(num_alphas)} "
                f"knots each: N={N} exceeds N <= {limit}"
            )
        cluster = cluster_size(N, num_alphas)
    if not 1 <= cluster <= clusters:
        raise ValueError(f"cluster must be in [1, {clusters}], got {cluster}")
    seg = -(-N // cluster)
    if (cluster - 1) * seg >= N:
        raise ValueError(f"a cluster of {cluster} leaves a block without knots at N={N}")
    need = shared_bytes(seg, num_alphas)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"the SQP kernel keeps the horizon in shared memory: {seg} knots a block at "
            f"N={N} in clusters of {cluster} need {need} bytes, a block may use {SMEM_LIMIT}"
        )
    return cluster, need


@functools.lru_cache(maxsize=None)
def _max_cluster(index: int) -> int:
    lib = _build.load_library()
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = lib.indy7_sqp_max_cluster(ctypes.byref(out))
    if rc != 0:
        raise RuntimeError(f"SQP kernel cluster query failed: CUDA error {rc}")
    return out.value


def max_cluster(device) -> int:
    """The largest cluster of K1 blocks (at most :data:`MAX_CLUSTER`) the
    card ``device`` can hold resident, asked once per card."""
    device = torch.device(device)
    return _max_cluster(device.index if device.index is not None else torch.cuda.current_device())


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
    cluster=None,
):
    """Batched SQP solve on lane-major tensors (the contract of the TPU
    package's ``sqp_solve_pallas``).

    xs (12, B), goals (N, 3, B), X (N, 12, B), U (N-1, 6, B), wrench (6, B)
    or None, rho (B,) or None.  Returns (X (N, 12, B), U (N-1, 6, B),
    rho (B,), alphas (iters, B), steps (iters, B)).  On CUDA every tensor
    must be float32 and contiguous, and N at most :func:`max_horizon`.  Any
    configuration other than formulation 'gn' with qp_backend 'riccati'
    raises.

    ``stages`` < 4 cuts every SQP iteration after stage 1 (linearize), 2
    (+ Riccati sweep) or 3 (+ rollout), as the TPU kernel's profiling cut
    does: the outputs are then meaningless, and the plain version, which
    has no cut, raises.  ``threads`` (a multiple of 32 up to 256) is the
    block size and ``cluster`` the blocks a lane (default
    :func:`cluster_size`); the result is the same bits for every block and
    cluster size.

    On CUDA every launch passes the card's stage clocks
    (``tracing.k1_clocks``); with tracing on, K1 adds its cycles by stage
    to them (``tracing.k1_stage_cycles``), with the same outputs.
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
    device = xs.device
    N, B = X.shape[0], X.shape[-1]
    if N < 2 or B < 1 or sqp_cfg.num_alphas < 1:
        raise ValueError(f"sqp_solve: need N >= 2, B >= 1 and num_alphas >= 1, got N={N}, "
                         f"B={B}, num_alphas={sqp_cfg.num_alphas}")
    if threads % 32 or not 32 <= threads <= 256:
        raise ValueError(f"threads must be a multiple of 32 in [32, 256], got {threads}")
    blocks, _ = check_horizon(N, sqp_cfg.num_alphas, cluster)
    if blocks > 1:  # and within the clusters this card holds resident
        check_horizon(N, sqp_cfg.num_alphas, cluster, clusters=max_cluster(device))
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
    clock_on, clocks = tracing.k1_clocks(device)
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
            _ptr(clock_on), _ptr(clocks), threads, blocks, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"SQP kernel launch failed: CUDA error {rc}")
    sqp_solve.launches += 1
    return Xo, Uo, rho_out, alphas, steps


sqp_solve.launches = 0  # kernel launches (CPU calls do not count)
