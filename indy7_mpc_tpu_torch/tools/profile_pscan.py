"""A/B of the two exact QP backends at the production shape (port of
``tools/profile_pscan.py``).

Times the readable solver's QP step with ``riccati`` (the sequential
sweep over N) against ``riccati_pscan`` (the suffix scan, log2 N levels)
on the same random float32 blocks (``measure.qp_blocks``), B lanes, in a
chain of ``--chain`` solves where each solve's A depends on the previous
solve's result (so no solve can be skipped or reordered), each chain
followed by a sync (``measure.blocking_us``, 5 chains after a warm-up).  A
null chain of the same length without the solve is timed the same way
and subtracted.  Prints the TPU tool's lines, then one JSON line.

Usage: python3 -m indy7_mpc_tpu_torch.tools.profile_pscan [B] [N]
           [--chain 50] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

from .. import measure
from ..examples import protocol
from ..ops import riccati, riccati_pscan

BACKENDS = (("riccati (sequential)", riccati.solve),
            ("riccati_pscan (assoc-scan)", riccati_pscan.solve_pscan))
REPS = 5


def chain(solve, blocks, xs0, rho, R):
    """``R`` chained solves: each perturbs A by the carried state, so the
    backward pass under test depends on the chain, and feeds its first
    knot's state back.  Returns the last carried state (B, 12)."""
    x = xs0
    for _ in range(R):
        b = blocks._replace(A=blocks.A + 1e-9 * x[:, None, :, None])
        x = solve(b, x, rho).X[:, 0] * 1e-6 + xs0
    return x


def null_chain(xs0, R):
    """The chain's structure without the solve."""
    x = xs0
    for _ in range(R):
        x = x * (1.0 - 1e-12) + 1e-12 * xs0
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("B", nargs="?", type=int, default=64)
    ap.add_argument("N", nargs="?", type=int, default=64)
    ap.add_argument("--chain", type=int, default=50, help="chained solves per timed call")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    B, N, R = args.B, args.N, args.chain
    blocks, xs0, rho = measure.qp_blocks(dev, B, N)
    label = protocol.device_label(dev)
    print(f"# device={label} B={B} N={N} (batched exact QP solve, {R}-chain, blocking "
          "dispatches)", flush=True)
    t_null = measure.blocking_us(lambda: null_chain(xs0, R), REPS, dev, warmup=1).mean()
    rows = []
    for name, solve in BACKENDS:
        out = []
        t_full = measure.blocking_us(lambda: out.append(chain(solve, blocks, xs0, rho, R)),
                                     REPS, dev, warmup=1).mean()
        us = (t_full - t_null) / R
        mean_abs = float(out[-1].abs().mean())
        print(f"{name:<28} {us:8.0f} us per batched QP solve (chain {t_full / 1e3:.1f} ms, "
              f"null {t_null / 1e3:.1f} ms, |out| {mean_abs:.3e})", flush=True)
        rows.append({"backend": name, "us_per_solve": us, "chain_ms": t_full / 1e3,
                     "null_ms": t_null / 1e3, "out_mean_abs": mean_abs})
    print(json.dumps({"device": label, "B": B, "N": N, "chain": R, "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
