"""Multi-process scaling efficiency of the lane-sharded closed loop at the
production configuration, written to ``MULTIHOST_EFF_TORCH.json`` (port of
``tools/multihost_eff.py``; never writes the TPU tool's
``MULTIHOST_EFF.json``).

For each rank count of ``--procs`` it runs ``multihost_bench --efficiency``
(``multihost_bench.launch``): the full sampled-MPC closed loop at N=64, 2
SQP iterations, B lanes, ``--ticks`` ticks in chunks of ``--chunk``, its
lanes split over the ranks (K1 and K2 on each rank's block, the consensus
argmin as a collective, the carry on the device), against one rank with
all B lanes; then the weak-scaling rows, ``--lanes-per-proc`` lanes a rank
at 1 and each count of ``--procs``.  Each rank count's consensus alone is
kept as a ``collective_accounting`` row.

The file states the backend and the cards the ranks had.  Ranks that share
one card (``cards`` below the rank count: gloo, since NCCL refuses two
ranks of one group on one device) measure the code path and the process
group's overhead, not scaling; the file says so and gives no figure for
cards the run did not have.

Usage: python3 -m indy7_mpc_tpu_torch.tools.multihost_eff [--B 256]
           [--ticks 500] [--chunk 10] [--procs 2,4] [--lanes-per-proc 128]
           [--out MULTIHOST_EFF_TORCH.json] [--backend gloo|nccl]
           [--device cuda|cpu] [--N 64] [--sqp-iters 2]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from .. import multihost_bench
from ..examples import protocol

ROOT = Path(__file__).resolve().parents[2]


def run_bench(args, procs, B, efficiency):
    argv = ["--procs", str(procs), "--B", str(B), "--N", str(args.N),
            "--sqp-iters", str(args.sqp_iters), "--ticks", str(args.ticks),
            "--chunk", str(args.chunk), "--device", args.device, "--backend", args.backend,
            "--timeout", str(args.timeout)]
    return multihost_bench.launch(multihost_bench.build_parser().parse_args(
        argv + (["--efficiency"] if efficiency else [])))


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--chunk", type=int, default=10)
    ap.add_argument("--procs", default="2,4")
    ap.add_argument("--lanes-per-proc", type=int, default=128,
                    help="weak-scaling rows: fixed lanes per process")
    ap.add_argument("--out", default=str(ROOT / "MULTIHOST_EFF_TORCH.json"))
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=3600.0)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = protocol.device(args.device)
    counts = [int(p) for p in args.procs.split(",")]

    results, accounting = [], []
    for procs in counts:
        multi, eff = run_bench(args, procs, args.B, efficiency=True)
        # The worker's collective accounting beside the efficiency.
        for k in ("consensus_us_per_tick", "consensus_bytes_per_tick"):
            eff[k] = multi[k]
        results.append(eff)
        accounting.append({
            "metric": "consensus_collective_cost", "procs": procs, "devices": procs,
            "cards": eff["cards"], "B": args.B, "N": args.N,
            "us_per_tick": multi["consensus_us_per_tick"],
            "bytes_per_tick": multi["consensus_bytes_per_tick"],
            "fraction_of_production_tick": multi["consensus_us_per_tick"] / (
                multi["tick_s"] * 1e6),
            "protocol": "multihost_bench.time_consensus on rank 0 after the loop (the "
                        "consensus_collective_bench measurement), over the same run's tick"})

    # Weak scaling: FIXED lanes per process (B = lanes_per_proc * procs);
    # ideal is constant solves/s a process.
    weak = []
    for procs in [1] + counts:
        B = args.lanes_per_proc * procs
        (rec,) = run_bench(args, procs, B, efficiency=False)
        row = {"metric": "weak_scaling", "procs": procs, "cards": multihost_bench.cards(
                   procs, args.device), "B": B, "lanes_per_proc": args.lanes_per_proc,
               "solves_per_sec_per_proc": rec["solves_per_sec"] / procs,
               "solves_per_sec": rec["solves_per_sec"]}
        for k in ("consensus_us_per_tick", "consensus_bytes_per_tick"):
            if k in rec:
                row[k] = rec[k]
        print(json.dumps(row), flush=True)
        weak.append(row)

    shared = any(r["cards"] < r["procs"] for r in results)
    label = protocol.device_label(dev)
    doc = {
        "protocol": (
            "full sampled-MPC closed loop (solve + consensus + resample + plant + reference "
            "advance; K1 and K2 on each rank's lane block, the consensus as two all-reduces), "
            "lane axis sharded over torch.distributed ranks, one process a rank, carry on the "
            f"device across ticks, {args.chunk} ticks a loop call; efficiency = multi-process "
            "solves/s over one process with all B lanes (multihost_bench --efficiency)"
        ),
        "config": {"B": args.B, "N": args.N, "sqp_iters": args.sqp_iters, "ticks": args.ticks,
                   "chunk": args.chunk, "backend": args.backend, "device": label,
                   "cards": {str(r["procs"]): r["cards"] for r in results}},
        "results": results,
        "collective_accounting": accounting,
        "weak_scaling": weak,
        "notes": {
            "backend": f"{args.backend} on {label}",
            "cards": (
                "CPU ranks, the kernels' plain versions: not a device figure"
                if dev.type == "cpu" else
                "the ranks shared one card (cards < procs): their efficiency measures the "
                "sharded code path and the process group's overhead on that card, not scaling; "
                "no figure here stands for ranks with cards of their own"
                if shared else "each rank had a card of its own"
            ),
            "measured_solver": (
                "the kernels' plain versions on the CPU" if dev.type == "cpu" else
                "K1 (the SQP kernel) and K2 (the tick kernel) on each rank's lane block"
            ),
        },
        "target": ">=0.8 (BASELINE.md north star)",
    }
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
