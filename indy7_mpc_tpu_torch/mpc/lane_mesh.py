"""The hypothesis lanes over the ranks of a process group: the mesh, the
consensus over every rank's lanes and the resampling on global lane
indices.

A tick holds a contiguous block of the B lanes on each rank
(:class:`LaneMesh`); a one-rank mesh holds them all and makes no
collective, which is the single-process tick.  The ticks of
``fused_tick.py`` and ``readable_tick.py`` take a mesh, and
``parallel/`` builds them over a ``torch.distributed`` group.

The consensus is the one cross-rank step (:func:`cross_rank_consensus`):
each rank scores its own lanes, the (B,) errors are summed over the ranks
into every rank (each rank writes its block into zeros, so the sum is
exact and keeps NaN), every rank picks the same winner with
``first_argmin`` (the first NaN first, ties to the lowest global lane),
and the winner's trajectory and wrench reach every rank by a second sum
over a buffer that only the owning rank fills.  Two all-reduces a tick,
and no host read but the copies gloo makes of CUDA tensors.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import SampleConfig
from ..ops.kernels.tick_kernel import first_argmin


def default_device(rank: int) -> torch.device:
    """The card of a rank: ``cuda:<rank % device count>``."""
    return torch.device("cuda", rank % max(1, torch.cuda.device_count()))


@dataclasses.dataclass(frozen=True)
class LaneMesh:
    """One rank's view of the 1-D lane mesh: its process group (None: a
    single rank, no collectives), its rank, the number of ranks and the
    device its lanes live on.  A gloo group takes CUDA tensors as they
    are: it copies them through the host itself."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device

    def lanes(self, B: int) -> slice:
        """This rank's contiguous block of B lanes; ValueError when B does
        not divide over the ranks."""
        if B % self.size:
            raise ValueError(f"B={B} must divide over {self.size} ranks")
        per = B // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum ``t`` over the ranks, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, group=self.group)
        return t

    def gather(self, local: torch.Tensor) -> torch.Tensor:
        """The whole lane-sharded tensor on every rank, from each rank's
        block ``local`` (b, ...): each rank writes its block into zeros and
        the ranks sum, which is exact and keeps NaN.  Call it on every
        rank."""
        if self.size == 1:
            return local
        B = local.shape[0] * self.size
        full = local.new_zeros((B,) + tuple(local.shape[1:]))
        full[self.lanes(B)] = local
        return self.all_reduce(full)


def single_rank_mesh(device=None) -> LaneMesh:
    """One rank and no collectives, the single-process run; ``device``
    defaults to the card."""
    return LaneMesh(None, 0, 1, default_device(0) if device is None else torch.device(device))


def make_lane_mesh(group=None, device=None) -> LaneMesh:
    """The lane mesh over ``group`` (default: the initialized default
    group).  Without an initialized group it is :func:`single_rank_mesh`.
    ``device`` defaults to the rank's card."""
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return single_rank_mesh(device)
    rank = dist.get_rank(group)
    device = default_device(rank) if device is None else torch.device(device)
    return LaneMesh(group, rank, dist.get_world_size(group), device)


class Winner(NamedTuple):
    best: torch.Tensor       # () int64 winning global lane
    X_best: torch.Tensor     # (N, nx) its trajectory
    U_best: torch.Tensor     # (N-1, nu)
    f_est: torch.Tensor      # (6,) its wrench hypothesis
    sqp_iters: torch.Tensor  # () its SQP iterations


def cross_rank_consensus(mesh: LaneMesh, err, X, U, f_batch, iters) -> Winner:
    """The winning lane over every rank, and its data on every rank.

    ``err`` (b,), ``X`` (b, N, nx), ``U`` (b, N-1, nu), ``f_batch`` (b, 6)
    and ``iters`` (b,) are this rank's block.  The (B,) errors are gathered
    on every rank (:meth:`LaneMesh.gather`) and ``first_argmin`` picks the
    winner: the first NaN, else the least error, ties to the lowest global
    lane, as the single-process tick.  The owning rank writes the winner's
    row into a buffer the others leave zero, and the ranks sum it."""
    b = err.shape[0]
    best = first_argmin(mesh.gather(err))
    if mesh.size == 1:  # the winner's row is here
        idx = best.reshape(1)
        return Winner(best, *(t.index_select(0, idx)[0] for t in (X, U, f_batch, iters)))
    local = best - mesh.rank * b
    owns = (local >= 0) & (local < b)
    idx = local.clamp(0, b - 1).reshape(1)
    dtype = torch.promote_types(X.dtype, f_batch.dtype)
    rows = [t.index_select(0, idx).reshape(-1).to(dtype) for t in (X, U, f_batch, iters)]
    payload = torch.cat(rows)
    payload = mesh.all_reduce(torch.where(owns, payload, torch.zeros_like(payload)))
    Xb, Ub, fb, it = payload.split([r.numel() for r in rows])
    return Winner(best, Xb.reshape(X.shape[1:]).to(X.dtype), Ub.reshape(U.shape[1:]).to(U.dtype),
                  fb.to(f_batch.dtype), it[0].to(iters.dtype))


def resample_lanes(mesh: LaneMesh, normals, f_batch, best, f_best, cfg: SampleConfig):
    """``sampled.resample_wrench_batch`` on this rank's block with global
    lane indices: ``normals`` (B, 6) are the full draws (the rank keeps its
    block), ``f_batch`` (b, 6) its hypotheses, ``best`` the global winner
    and ``f_best`` (6,) its wrench.  The winner's row is restored on the
    rank that owns it, and only global lane 0 is pinned."""
    sl = mesh.lanes(normals.shape[0])
    if f_batch.shape[0] != sl.stop - sl.start:
        raise ValueError(f"f_batch has {f_batch.shape[0]} lanes, this rank owns "
                         f"{sl.stop - sl.start} of {normals.shape[0]}")
    lane = torch.arange(sl.start, sl.stop, device=f_batch.device)
    f = f_best + cfg.f_ext_resample_std * normals[sl]
    f = torch.where((lane == best)[:, None], f_best, f)
    f[:, 3:] = 0.0
    if sl.start == 0:
        f[0] = 0.0
    return f * cfg.decay
