#!/usr/bin/env python3
"""The readings that a point-to-goal cell's limits are set from.

    python3 mpcbench/goal_control.py --workload <cell> --seeds S1,S2,... --seconds S
        [--control-seeds K] [--control-records R] [--witness-seeds W]

``control.py`` for the ``goal_chain`` driver: runs the cell once per seed
in one process, as ``run.py`` does without tracing, and prints a JSON line
per seed with the program's numbers.  For the first K seeds it also puts
the control in the program's place: the reference computed in bfloat16
(the precision below the float32 that the configuration states) over the
first R of the run's compared spans, through the same comparison
(``goal_compare.goal_control``); for the first W seeds the witness, the
reference in float32.  The last line gives, per number, the largest of
the program's readings, the smallest of the control's and the witness's
largest.  The benchmark's own runs never run this.
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from mpcbench import goal_compare, harness  # noqa: E402
from mpcbench.reference import goal_chain as rg  # noqa: E402

CONTROL_DTYPE = torch.bfloat16
WITNESS_DTYPE = torch.float32


def control_gaps(cell: harness.Cell, run: harness.Run, records: int,
                 dtype=CONTROL_DTYPE) -> dict:
    """The numbers of the reference in ``dtype`` in the program's place,
    over the first ``records`` of ``run``'s compared spans."""
    dep = rg.Deployment.from_config(cell.config)
    goals = run.values["goals"]
    low = rg.Models(dep, dtype)
    spans = [goal_compare.goal_control(low, goals, s) for s in run.values["spans"][:records]]
    return goal_compare.goal_gaps(rg.Models(dep), goals, spans, cell.limits.get("trace_gap", 0.0))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--control-records", type=int, default=4)
    p.add_argument("--witness-seeds", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.use_checkout_caches()
    cell = harness.load_cell(args.workload)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("goal_control: no CUDA device", file=sys.stderr)
        return 2
    say = lambda s: print(s, file=sys.stderr, flush=True)
    lower, upper, witness = {}, {}, {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = harness.Context(cell, seed, args.seconds, False, dev, time.perf_counter(), say)
        run = harness.load_driver(cell.mix).run(ctx)
        line = {"workload": cell.name, "seed": seed, "program": run.gaps,
                "attempted": run.attempted, "failed": run.failed,
                "switches": run.values["switches"], "end_to_end": run.end_to_end}
        for k, v in run.gaps.items():
            lower[k] = max(lower.get(k, 0.0), v)
        if i < args.control_seeds:
            t = time.perf_counter()
            line["control"] = control_gaps(cell, run, args.control_records)
            line["control_s"] = time.perf_counter() - t
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        if i < args.witness_seeds:
            line["witness"] = control_gaps(cell, run, args.control_records, WITNESS_DTYPE)
            for k, v in line["witness"].items():
                witness[k] = max(witness.get(k, 0.0), v)
        print(json.dumps(line), flush=True)
    print(json.dumps({"workload": cell.name, "lower": lower, "upper": upper, "witness": witness,
                      "upper_over_lower": {k: upper[k] / lower[k] if lower.get(k) else None
                                           for k in upper}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
