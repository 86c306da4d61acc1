"""The runs behind the gates of ``chip_smoke.py``'s QP-backend phase: how
close each readable QP backend's SQP solve comes to the Riccati solve's,
and how far the PCG closed loop's tracking moves from the Riccati loop's.

Usage: python3 -m indy7_mpc_tpu_torch.qp_gates [--device cpu]
           [--seeds 7 1 2 3 4] [--out PATH]

On the card unless ``--device cpu``.  It prints, and writes as JSON to
``--out``:
  * at phase 3's inputs (``measure.k1_inputs``, B=64, N=64), 2 SQP
    iterations: the range of the diagonal of ADMM's H on the first QP's
    Gauss-Newton blocks; each backend's merit over the Riccati solve's
    (max and median over lanes) and the lanes that got below their
    starting merit, in float32 at the defaults, and PCG also with a cap
    of 2,000 CG iterations, in float32 and in float64;
  * the fig-8 readable tick (``fused=False``, B=64, N=64, perturbed
    plant) on PCG against the same tick on Riccati, from one carry with
    the same draws, 10 ticks, for each seed of ``--seeds``, and on the
    first seed with PCG capped at 1 and at 8 CG iterations: the mean
    tracking error of each and the PCG loop's gap over the Riccati one.

It checks nothing.  A CPU run takes about 10 minutes.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from . import measure
from .config import PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig
from .models import indy7
from .mpc import draw_tick, init_loop_carry, reference, run_sampled_mpc
from .ops import admm, kkt
from .ops.kkt import QPBlocks
from .solvers import sqp as readable

B, N, DT, TICKS = 64, 64, 0.01, 10


def merit_section(dev):
    cost = CostConfig()
    args, w = measure.k1_inputs(dev, B, N)
    bmajor = [args[0].T] + [a.permute(2, 0, 1) for a in args[1:]] + [w.T]
    xs, goals, X, U, wb = bmajor
    X0 = torch.cat([xs[:, None], X[:, 1:]], 1)
    model = indy7(torch.float32, dev)

    blocks = kkt.build_qp_gn(model, cost, X0, U, goals, DT, wrench_world=wb)
    D, _ = admm._build_H(QPBlocks(*(b.double() for b in blocks)),
                         torch.full((B,), 1e-6, dtype=torch.float64, device=dev), 1e-6, 1e3)
    diag = D.diagonal(dim1=-2, dim2=-1)
    out = {"admm_H_diagonal": [diag.min().item(), diag.max().item()]}
    print(f"ADMM's H on the first QP: diagonal from {diag.min().item():.3g} to "
          f"{diag.max().item():.3g}", flush=True)

    runs = {"riccati": SQPConfig(), "riccati_pscan": SQPConfig(qp_backend="riccati_pscan"),
            "pcg": SQPConfig(qp_backend="pcg"), "admm": SQPConfig(qp_backend="admm"),
            "pcg_cap2000": SQPConfig(qp_backend="pcg", pcg_max_iters=2000)}
    for dtype in (torch.float32, torch.float64):
        m = indy7(dtype, dev)
        a = [t.to(dtype) for t in bmajor]
        start = readable.merit(m, cost, 10.0, X0.to(dtype), a[3], a[1], a[0], DT, a[4])
        base = None
        for name, cfg in runs.items():
            if dtype == torch.float64 and name not in ("riccati", "pcg_cap2000"):
                continue
            res = readable.batch_solve(m, cost, cfg, DT, *a[:4], wrench_world_batch=a[4])
            merit = readable.merit(m, cost, cfg.merit_mu, res.X, res.U, a[1], a[0], DT, a[4])
            base = merit if name == "riccati" else base
            ratio = (merit / base).double()
            row = {"ratio_max": ratio.max().item(), "ratio_p50": ratio.median().item(),
                   "lanes_below_start": int((merit < start).sum()),
                   "finite": bool(torch.isfinite(res.X).all() and torch.isfinite(res.U).all())}
            if res.stats.pcg_iters is not None:
                its = res.stats.pcg_iters
                row["inner_iters"] = [int(its.min()), int(its.max())]
            key = f"{name}_{str(dtype)[6:]}"
            out[key] = row
            print(f"{key}: merit / Riccati's max {row['ratio_max']:.4f}, p50 "
                  f"{row['ratio_p50']:.4f}; {row['lanes_below_start']} of {B} lanes below "
                  f"their start; finite {row['finite']}"
                  + (f"; inner iterations {row['inner_iters']}" if "inner_iters" in row else ""),
                  flush=True)
    return out


def loop_section(dev, seeds):
    model = indy7(torch.float32, dev)
    mcfg = MPCConfig(N=N, dt=DT)
    scfg = SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(measure.INIT_Q)
    out = []
    for i, seed in enumerate(seeds):
        gen = torch.Generator(device=dev).manual_seed(seed)
        carry0 = init_loop_carry(model, mcfg, scfg, x0, measure.F_TRUE0, gen)
        draws = [draw_tick(gen, scfg, PERTURBED_PLANT, dev, torch.float32) for _ in range(TICKS)]
        cfgs = {"riccati": SQPConfig(), "pcg": SQPConfig(qp_backend="pcg")}
        if i == 0:
            cfgs.update(pcg_cap1=SQPConfig(qp_backend="pcg", pcg_max_iters=1),
                        pcg_cap8=SQPConfig(qp_backend="pcg", pcg_max_iters=8))
        te = {}
        for name, cfg in cfgs.items():
            trace = run_sampled_mpc(model, CostConfig(), cfg, mcfg, scfg, x0, ref, TICKS,
                                    measure.F_TRUE0, None, plant_cfg=PERTURBED_PLANT,
                                    carry0=carry0, draws=draws, fused=False)[1]
            te[name] = trace.tracking_error.double().mean().item()
        row = {"seed": seed, "tracking_m": te,
               "gap": {k: v / te["riccati"] - 1.0 for k, v in te.items() if k != "riccati"}}
        out.append(row)
        print(f"seed {seed}: mean tracking over {TICKS} ticks " + ", ".join(
            f"{k} {v:.4f} m" for k, v in te.items()) + "; over Riccati's: " + ", ".join(
            f"{k} {100 * v:+.1f}%" for k, v in row["gap"].items()), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seeds", type=int, nargs="+", default=[7, 1, 2, 3, 4])
    ap.add_argument("--out", help="write the results as JSON here")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("qp_gates: no CUDA device (pass --device cpu for the CPU)", file=sys.stderr)
            return 1
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "merit": merit_section(dev), "loop": loop_section(dev, args.seeds)}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
