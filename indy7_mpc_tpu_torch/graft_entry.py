"""Entry points: the single-device batched solve and a multi-rank dry run
(port of ``__graft_entry__.py``).

  * :func:`entry` returns ``(fn, args)``: the batched SQP-MPC solve step,
    B lanes of the Indy7 trajectory optimizer under per-lane wrench
    hypotheses (the core of the sampled controller), on kernel K1 on the
    card and on its plain version on the CPU, at N=8, B=8;
  * :func:`dryrun_multichip` runs the whole sharded closed loop
    (``parallel/``: each rank's lane block solved and scored, the
    consensus over the ranks, the replicated plant step, the reference
    advance) on ``n`` ranks spawned over gloo, 3 ticks twice, and checks
    that the traces are finite.

Usage: python3 -m indy7_mpc_tpu_torch.graft_entry [--ranks R] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from .examples import protocol
from .models import indy7

N, B, DT = 8, 8, 0.01
COST, SQP = CostConfig(), SQPConfig(max_iters=2)


def entry(device="cuda", dtype=torch.float32):
    """``(fn, args)``: ``fn(xs_b, goals_b, X_b, U_b, wrench_b) -> (X, U)``,
    the B-major batched solve, with its example arguments (the TPU
    entry's: zero states, a fixed goal, lanes 1..B-1 pushed by 5 N in x)."""
    from .solvers import sqp_cuda

    dev = protocol.device(device)
    model = indy7(dtype, dev)

    def fn(xs_b, goals_b, X_b, U_b, wrench_b):
        res = sqp_cuda.batch_solve(model, COST, SQP, DT, xs_b, goals_b, X_b, U_b,
                                   wrench_world_batch=wrench_b)
        return res.X, res.U

    z = lambda *shape: torch.zeros(shape, dtype=dtype, device=dev)
    goals_b = torch.tensor([0.3, 0.2, 0.6], dtype=dtype, device=dev).expand(B, N, 3).clone()
    wrench_b = z(B, 6)
    wrench_b[1:, 0] = 5.0
    return fn, (z(B, 12), goals_b, z(B, N, 12), z(B, N - 1, 6), wrench_b)


def _dryrun_rank(mesh, ticks):
    """One rank of :func:`dryrun_multichip`: the sharded loop from a cold
    start, ``ticks`` ticks twice (the carry kept on the rank between the
    calls); returns the traces' tracking errors and the final state."""
    from .mpc import init_loop_carry
    from .parallel import make_sharded_sampled_loop, shard_lanes

    lanes = 2 * mesh.size
    model = indy7(torch.float32, mesh.device)
    mpc_cfg = MPCConfig(N=N, dt=DT)
    sample_cfg = SampleConfig(batch_size=lanes, f_ext_std=5.0, f_ext_resample_std=0.5)
    gen = torch.Generator(device=mesh.device).manual_seed(0)
    ref = torch.tensor([0.3, 0.2, 0.6]).expand(64, 3)
    loop, layout = make_sharded_sampled_loop(model, COST, SQP, mpc_cfg, sample_cfg, mesh, ref,
                                             ticks, f_true_walk=False, generator=gen)
    carry = init_loop_carry(model, mpc_cfg, sample_cfg,
                            torch.zeros(12, device=mesh.device), [3.0, 0.0, -5.0, 0, 0, 0], gen)
    carry = shard_lanes(mesh, carry, layout)
    errs = []
    for _ in range(2):  # the second call starts from the sharded carry
        carry, trace = loop(carry)
        errs.append(trace.tracking_error.cpu().numpy())
    return {"tracking_error": np.concatenate(errs), "x": carry.x.cpu().numpy(),
            "block": tuple(carry.f_batch.shape)}


def dryrun_multichip(n_devices: int, device="cuda", ticks: int = 3) -> list:
    """The sharded closed loop on ``n_devices`` ranks (B = 2 a rank, N=8),
    spawned processes over gloo: rank r on card r modulo the cards (they
    share one card when there are fewer), or all on the CPU with
    ``device="cpu"``.  Raises unless every rank's traces and state are
    finite and each holds its 2 lanes.  Returns the ranks' results."""
    from .parallel._worker import spawn

    dev = protocol.device(device)
    out = spawn(_dryrun_rank, n_devices, ticks, device=None if dev.type == "cuda" else "cpu",
                backend="gloo")
    for r in out:
        if not (np.isfinite(r["tracking_error"]).all() and np.isfinite(r["x"]).all()):
            raise RuntimeError(f"dry run: a rank's trace is not finite: {r}")
        if r["block"] != (2, 6):
            raise RuntimeError(f"dry run: a rank holds a block of {r['block']}, want (2, 6)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: the cards, or 1)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = protocol.device(args.device)
    fn, fargs = entry(dev)
    X, U = fn(*fargs)
    protocol.synchronize(dev)
    print("entry ok:", tuple(X.shape), tuple(U.shape), flush=True)
    ranks = args.ranks or max(1, torch.cuda.device_count() if dev.type == "cuda" else 1)
    dryrun_multichip(ranks, device=dev)
    print(f"dryrun_multichip ok ({ranks} ranks)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
