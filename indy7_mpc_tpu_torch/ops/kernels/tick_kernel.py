"""Kernel K2: the tick epilogue (``csrc/tick_kernel.cu``) and its wrapper.

Replaces ``indy7_mpc_tpu/ops/pallas/tick_kernel.py``: consensus scoring,
argmin, winner gather, ground-truth plant tick and trace FK in one launch.
For CPU tensors the wrapper runs the plain PyTorch version, composed from
``sim/plant.py`` and ``ee_pos``; for CUDA tensors it launches the kernel or
raises.  ``plant=False`` skips the plant step (the host tick's consensus
reads no plant state); ``x_next`` is then None.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ...config import PlantConfig
from ...sim.plant import plant_friction, plant_step, predict_next_states
from .. import lane_rbd as LR
from . import _abi, _build
from .sqp_kernel import _check, _ptr

THREADS = 512  # threads of K2's one block: 64 teams of 8, B=64 in one round


class TickEpilogue(NamedTuple):
    err: torch.Tensor     # (B,) squared consensus errors
    best: torch.Tensor    # () int64 winning lane
    x_next: Optional[torch.Tensor]  # (12,) plant state after the tick, or None
    u: torch.Tensor       # (6,) applied control (pre-clamp, = U_best[0])
    eep: torch.Tensor     # (3,) EE position of the observed state
    f_est: torch.Tensor   # (6,) winning wrench hypothesis


def first_argmin(err):
    """argmin with a first-index tie-break where a NaN wins (first NaN
    first), as ``jnp.argmin`` does."""
    return torch.argmin(torch.where(torch.isnan(err), float("-inf"), err))


def tick_epilogue_plain(
    smc: LR.StaticModel,
    smp: LR.StaticModel,
    cfg: PlantConfig,
    dt: float,
    x_cur,
    x_last,
    u_last,
    f_batch_T,
    U0_T,
    f_true,
    noise: Optional[torch.Tensor] = None,
    plant: bool = True,
) -> TickEpilogue:
    """The plain PyTorch version of K2 (any device, any float dtype)."""
    x_pred = predict_next_states(smc, x_last, u_last, dt, f_batch_T)
    err = ((x_pred - x_cur[:, None]) ** 2).sum(0)
    best = first_argmin(err)
    u = U0_T.index_select(1, best.view(1))[:, 0]
    f_est = f_batch_T.index_select(1, best.view(1))[:, 0]
    x_next = None
    if plant:
        x_next = plant_step(
            smp, x_cur[:, None], u[:, None], dt,
            wrench_world=f_true[:, None],
            substeps=cfg.substeps,
            friction=plant_friction(cfg),
            noise=noise if cfg.torque_noise_std else None,
            velocity_saturation=cfg.velocity_saturation,
        )[:, 0]
    eep = torch.stack(LR.ee_pos(smc, [x_cur[i] for i in range(6)]))
    return TickEpilogue(err, best, x_next, u, eep, f_est)


def tick_epilogue(
    smc: LR.StaticModel,
    smp: LR.StaticModel,
    plant_cfg: Optional[PlantConfig],
    dt: float,
    x_cur,
    x_last,
    u_last,
    f_batch_T,
    U0_T,
    f_true,
    noise: Optional[torch.Tensor] = None,
    plant: bool = True,
    threads: int = THREADS,
) -> TickEpilogue:
    """Everything after the batched solve, in one kernel launch.

    x_cur, x_last (12,); u_last (6,); f_batch_T, U0_T (6, B) lane-major;
    f_true (6,); noise (substeps, 6) actuation noise already scaled by its
    standard deviation, or None.  ``smc`` is the controller model
    (consensus, FK), ``smp`` the plant model.  ``plant=False`` skips the
    plant step and returns ``x_next=None``.  On CUDA every tensor must be
    float32 and contiguous; ``threads`` (a power of two, 32 to 512) is
    the block size, which does not change the result.
    """
    cfg = plant_cfg or PlantConfig()
    if x_cur.device.type == "cpu":
        return tick_epilogue_plain(
            smc, smp, cfg, dt, x_cur, x_last, u_last, f_batch_T, U0_T,
            f_true, noise, plant,
        )
    if x_cur.device.type != "cuda":
        raise ValueError(f"tick_epilogue: unsupported device {x_cur.device}")
    device = x_cur.device
    B = f_batch_T.shape[-1]
    if B < 1:
        raise ValueError("tick_epilogue: need at least one hypothesis")
    for name, t, shape in (
        ("x_cur", x_cur, (12,)), ("x_last", x_last, (12,)),
        ("u_last", u_last, (6,)), ("f_batch_T", f_batch_T, (6, B)),
        ("U0_T", U0_T, (6, B)), ("f_true", f_true, (6,)),
    ):
        _check(name, t, shape, device)
    if threads not in (32, 64, 128, 256, 512):
        raise ValueError(f"tick_epilogue: threads must be a power of two in [32, 512], "
                         f"got {threads}")
    use_noise = plant and bool(cfg.torque_noise_std) and noise is not None
    if use_noise:
        _check("noise", noise, (cfg.substeps, 6), device)

    lib = _build.load_library()
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=device)
    err, u, eep, f_est = empty(B), empty(6), empty(3), empty(6)
    x_next = empty(12) if plant else None
    best = torch.empty((), dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.indy7_tick_epilogue(
            _abi.model_consts(smc), _abi.model_consts(smp),
            _abi.plant_params(cfg, dt, B, use_noise, plant),
            _ptr(x_last), _ptr(u_last), _ptr(f_batch_T), _ptr(U0_T),
            _ptr(x_cur), _ptr(f_true), _ptr(noise) if use_noise else None,
            _ptr(err), _ptr(best), _ptr(x_next) if plant else None, _ptr(u),
            _ptr(eep), _ptr(f_est), threads, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"tick kernel launch failed: CUDA error {rc}")
    tick_epilogue.launches += 1
    return TickEpilogue(err, best, x_next, u, eep, f_est)


tick_epilogue.launches = 0  # kernel launches (CPU calls do not count)
