"""Multi-process scale-out of the lane axis on ``torch.distributed`` (port
of ``indy7_mpc_tpu/parallel/distributed.py``).

One process per rank, one device each.  The lane axis is split into one
contiguous block per rank (:func:`process_lane_slice`); lane arrays are
held as each rank's block, everything else is replicated, and the
consensus argmin runs as a collective (``mpc/lane_mesh.py::cross_rank_consensus``).

Usage (one process per rank):

    from indy7_mpc_tpu_torch.parallel import distributed as dist
    mesh = dist.initialize("tcp://host0:8476", num_processes, process_id)
    f_local = dist.global_lanes(mesh, f_batch_full)   # (B, 6) -> (B/R, 6)
    tick = make_sharded_sampled_tick(..., mesh)        # same code path
    out = tick(...)                                    # global consensus

On the CPU, and for ranks that share one card, pass ``backend="gloo"``
(NCCL refuses two ranks of one group on one device); the CPU rig passes
``device="cpu"`` too.  Nothing here changes the backend or the device on
its own.
"""
from __future__ import annotations

import torch
import torch.distributed as tdist

from ..mpc.lane_mesh import LaneMesh, default_device, make_lane_mesh
from .sharding import shard_lanes


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    backend: str = "nccl",
    device=None,
) -> LaneMesh:
    """Join the process group as rank ``process_id`` of ``num_processes``
    and return the lane mesh (:func:`global_lane_mesh`).

    ``coordinator_address`` is an init URL (``tcp://host:port``,
    ``file:///path``) or ``host:port``.  ``device`` defaults to the card
    ``cuda:<process_id % device count>``.  A process already in a group
    of the same size, rank and backend gets that group's mesh; any other
    group raises RuntimeError."""
    device = default_device(process_id) if device is None else torch.device(device)
    if tdist.is_initialized():
        have = (tdist.get_world_size(), tdist.get_rank(), tdist.get_backend())
        if have != (num_processes, process_id, backend):
            raise RuntimeError(
                f"already rank {have[1]} of {have[0]} on {have[2]}; asked for rank "
                f"{process_id} of {num_processes} on {backend}")
        return global_lane_mesh(device=device)
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    tdist.init_process_group(backend, init_method=init, world_size=num_processes,
                             rank=process_id)
    return global_lane_mesh(device=device)


# The TPU package's names for the mesh's operations.
global_lane_mesh = make_lane_mesh       # (group=None, device=None): every rank's lanes
process_lane_slice = LaneMesh.lanes     # (mesh, B): this rank's block; ValueError if B % R
global_lanes = shard_lanes              # (mesh, full batch): this rank's block on its device
gather_lanes = LaneMesh.gather          # (mesh, block): the whole batch, on every rank


def replicated_global(mesh: LaneMesh, value) -> torch.Tensor:
    """A host value copied whole to the mesh's device, the same on every
    rank."""
    return shard_lanes(mesh, value, None)


def fetch_replicated(t: torch.Tensor):
    """Host (numpy) copy of a replicated tensor."""
    return t.detach().cpu().numpy()
