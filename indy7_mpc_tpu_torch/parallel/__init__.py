"""Lane-axis scale-out over the ranks of a ``torch.distributed`` process
group (port of ``indy7_mpc_tpu/parallel``): K1 and K2 on each rank's lane
block, the consensus argmin as a collective, the rest replicated.
Importing it starts no process group."""
from ..mpc.lane_mesh import (
    LaneMesh,
    cross_rank_consensus,
    make_lane_mesh,
    resample_lanes,
    single_rank_mesh,
)
from .sharding import (
    LANE_AXIS,
    KernelLanesLoopTick,
    make_sharded_batch_solve,
    make_sharded_sampled_loop,
    make_sharded_sampled_tick,
    shard_lanes,
)

from . import distributed

__all__ = [
    "LANE_AXIS",
    "KernelLanesLoopTick",
    "LaneMesh",
    "cross_rank_consensus",
    "distributed",
    "make_lane_mesh",
    "make_sharded_batch_solve",
    "make_sharded_sampled_loop",
    "make_sharded_sampled_tick",
    "resample_lanes",
    "shard_lanes",
    "single_rank_mesh",
]
