"""Point-to-goal MPC (port of ``examples/point_to_goal.py``).

Drives the end effector through a chain of three goal points taken from
forward kinematics with ``run_mpc`` (N=32, 3 SQP iterations; on the card
K1 and K2 at B=1 each step).  With ``--compare`` it also runs the
batch-1-against-batch-64 disturbance study: both sampled controllers hold
a constant reference under an unmodeled wrench f_ext = [5, 0, 15] N, and
the B=64 one should estimate it and hold a smaller tracking error.
Prints JSON with the TPU script's keys (plus ``device``).

Usage: python3 -m indy7_mpc_tpu_torch.examples.point_to_goal [--compare]
           [--steps 300] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from ..dynamics import ee_pos
from ..models import indy7
from ..mpc import run_mpc, run_sampled_mpc
from . import protocol

F_EXT = [5.0, 0.0, 15.0, 0.0, 0.0, 0.0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)

    model = indy7(torch.float32, dev)
    cost_cfg, sqp_cfg, mpc_cfg = CostConfig(), SQPConfig(max_iters=3), MPCConfig(N=32,
                                                                                 dt=protocol.DT)
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    ee0 = ee_pos(model, x0[:6]).cpu().numpy().astype(np.float64)
    # The notebooks' FK-derived goal chain.
    goals = np.stack([ee0 + [0.10, -0.10, -0.10], ee0 + [-0.15, 0.05, -0.20],
                      ee0 + [0.05, 0.15, -0.05]])

    t0 = time.time()
    _, trace = run_mpc(model, cost_cfg, sqp_cfg, mpc_cfg, x0, goals, args.steps)
    d = trace.goal_dist.cpu().numpy()
    out = {
        "mode": "point_to_goal",
        "steps": args.steps,
        "initial_dist": float(d[0]),
        "final_dist": float(d[-1]),
        "min_dist": float(d.min()),
        "goal_switches": int((np.diff(trace.goal_idx.cpu().numpy()) != 0).sum()),
        "wall_s": time.time() - t0,
        "device": protocol.device_label(dev),
    }
    print(json.dumps(out, indent=2), flush=True)

    if args.compare:
        ref = np.tile(goals[0], (args.steps + mpc_cfg.N, 1)).astype(np.float32)
        results = {}
        for B in (1, 64):
            scfg = SampleConfig(batch_size=B, f_ext_std=0.0 if B == 1 else 15.0,
                                f_ext_resample_std=0.0 if B == 1 else 1.0)
            gen = torch.Generator(device=dev).manual_seed(42)
            _, tr = run_sampled_mpc(model, cost_cfg, sqp_cfg, mpc_cfg, scfg, x0, ref,
                                    args.steps, F_EXT, gen, f_true_walk=False)
            te = tr.tracking_error.cpu().numpy().astype(np.float64)
            results[f"batch{B}"] = {
                "tracking_error_mean": float(te.mean()),
                "tracking_error_tail": float(te[-50:].mean()),
                "f_est_final": tr.f_est[-1, :3].cpu().numpy().round(2).tolist(),
            }
        print(json.dumps({"mode": "sampled_comparison", "f_true": F_EXT[:3], **results,
                          "device": protocol.device_label(dev)}, indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
