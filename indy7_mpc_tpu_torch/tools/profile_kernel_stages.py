"""Attribute K1's time to its four stages by prefix truncation (port of
``tools/profile_kernel_stages.py``).

Times ``sqp_solve`` at ``stages=1..4`` (each SQP iteration cut after
linearize / Riccati backward sweep / forward rollout / full), CUDA-event
µs per launch over ``--iters`` launches queued behind a device sleep
(``measure.queued_events``), on random inputs (``measure.k1_inputs``, as
``chip_smoke.py`` phase 3 times K1).  Differences between consecutive rows
are each stage's share.  Prints the TPU tool's lines, then one JSON line.

The plain version has no stage cut: on the CPU the tool exits with the
wrapper's message and prints no table.

Usage: python3 -m indy7_mpc_tpu_torch.tools.profile_kernel_stages [B] [N]
           [--iters 50] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .. import measure
from ..config import CostConfig, SQPConfig
from ..examples import protocol
from ..models import indy7
from ..ops import lane_rbd as LR
from ..ops.kernels.sqp_kernel import sqp_solve

DT = 0.01
NAMES = {1: "linearize", 2: "+riccati bwd", 3: "+fwd rollout", 4: "+line search (full)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("N", nargs="?", type=int, default=32)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    B, N = args.B, args.N
    sm = LR.static_model(indy7(torch.float32, dev))
    cost, sqp = CostConfig(), SQPConfig(max_iters=2)
    inputs, w = measure.k1_inputs(dev, B, N)

    def launch(stages):
        return lambda: sqp_solve(sm, cost, sqp, DT, *inputs, wrench=w, stages=stages)

    try:
        launch(1)()
    except ValueError as e:  # the plain version: no stage cut
        raise SystemExit(f"profile_kernel_stages: {e}")
    label = protocol.device_label(dev)
    print(f"# device={label} B={B} N={N} iters={sqp.max_iters}", flush=True)
    rows, prev = [], 0.0
    for stages in (1, 2, 3, 4):
        us = measure.queued_events(launch(stages), args.iters)[0] * 1e3
        print(f"stages<={stages} {NAMES[stages]:<22} {us:8.1f} us "
              f"(delta {max(us - prev, 0.0):8.1f} us)", flush=True)
        rows.append({"stages": stages, "name": NAMES[stages], "us": us, "delta_us": us - prev})
        prev = us
    print(json.dumps({"device": label, "B": B, "N": N, "iters": sqp.max_iters,
                      "launches_timed": args.iters, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
