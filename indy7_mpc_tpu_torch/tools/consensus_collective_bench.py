"""The sharded tick's per-tick collective cost alone (port of
``tools/consensus_collective_bench.py``).

The lane-sharded closed loop's only traffic between ranks is the
consensus: ``mpc/lane_mesh.py::cross_rank_consensus``, two all-reduces
(the (B,) errors, then the winner's X, U, wrench and iteration count).
This bench spawns ``--procs`` ranks (``parallel/_worker.py::spawn``), each
holding its block of B lanes at horizon N, and times only that call on
each rank (``multihost_bench.time_consensus``: CUDA events on a card, the
host clock on the CPU), so the measurement isolates the collective from
the solve.  On one card the ranks share ``cuda:0`` over gloo (NCCL refuses
two ranks of one group on one device); ``--backend nccl`` needs a card a
rank.  Prints one JSON line: rank 0's µs a tick and the bytes the two
all-reduces carry (``parallel/sharding.py::consensus_bytes``).

Usage: python3 -m indy7_mpc_tpu_torch.tools.consensus_collective_bench
           [--procs 2] [--B 256] [--N 64] [--backend gloo|nccl]
           [--device cuda|cpu]
       ... --worker --coordinator HOST:PORT --procs R --proc-id I
           (one rank by hand; rank 0 prints the line)
"""
from __future__ import annotations

import argparse
import json
import sys

import torch.distributed

from ..examples import protocol
from ..multihost_bench import cards, time_consensus
from ..parallel import _worker
from ..parallel import distributed as dist


def report(args, us_by_rank, nbytes) -> dict:
    dev = protocol.device(args.device)
    return {
        "metric": "consensus_collective_cost",
        "procs": args.procs,
        "devices": args.procs,  # one device a rank
        "cards": cards(args.procs, args.device),
        "device_kind": protocol.device_label(dev),
        "backend": args.backend,
        "B": args.B,
        "N": args.N,
        "us_per_tick": us_by_rank[0],
        "us_per_tick_by_rank": us_by_rank,
        "bytes_per_tick": nbytes,
        "protocol": (
            "cross_rank_consensus alone (two all-reduces: the (B,) errors, then the winner's "
            "X, U, wrench and count; the argmin between them) at the production shape, each "
            "rank on its lane block; CUDA events per call over 200 calls on a card, the host "
            "clock on the CPU; rank 0's figure"
        ),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="localhost:8731")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    protocol.device(args.device)
    rank_device = "cpu" if args.device == "cpu" else None  # None: a rank's card
    if args.worker:
        mesh = dist.initialize(args.coordinator, args.procs, args.proc_id, args.backend,
                               rank_device)
        try:
            us, nbytes = time_consensus(mesh, args.B, args.N)
        finally:
            torch.distributed.destroy_process_group()
        if mesh.rank == 0:
            print(json.dumps(report(args, [us], nbytes)), flush=True)
        return 0
    ranks = _worker.spawn(time_consensus, args.procs, args.B, args.N, device=rank_device,
                          backend=args.backend, timeout=args.timeout)
    print(json.dumps(report(args, [us for us, _ in ranks], ranks[0][1])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
