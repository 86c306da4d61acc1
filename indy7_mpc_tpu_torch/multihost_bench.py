"""Lane-sharded closed-loop bench over several processes (port of
``examples/multihost_bench.py``).

The closed loop at the production configuration (N=64, 2 SQP iterations,
the reference's recorded-run fig-8, the random-walking true wrench), its
B hypotheses split over ``--procs`` ranks of one process group
(``parallel.make_sharded_sampled_loop``): each rank runs K1 and K2 on its
block, the consensus argmin is a collective, the rest is replicated.  The
carry stays on the device; ``--chunk`` ticks run per call.

    python3 -m indy7_mpc_tpu_torch.multihost_bench --procs 2 --backend gloo
        # two ranks on the card(s) of this machine (one card: gloo, since
        # NCCL refuses two ranks of one group on one device)
    python3 -m indy7_mpc_tpu_torch.multihost_bench --procs 2 --device cpu --backend gloo \\
        --B 16 --N 4 --ticks 1 --sqp-iters 1
        # the CPU rig: the kernels' plain versions, one thread a rank
    python3 -m indy7_mpc_tpu_torch.multihost_bench --worker --coordinator host0:8476 \\
        --procs <ranks> --proc-id <i> --B 32768
        # one copy per rank, by hand

The launcher spawns one worker per rank (a free local port unless
``--port`` names one) and prints the JSON line of rank 0: the
tick time, solves/s, the last chunk's tracking error and winner, and the
consensus collectives alone at the run's shape (``consensus_us_per_tick``,
CUDA events on the card, the host clock on the CPU, with the bytes they
reduce).  ``--efficiency`` also runs one rank and prints the ratio of
their solves/s; ranks that share one card measure the code path, not
scaling.
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]  # the reference sim's pose
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
SEED = 42
CONSENSUS_REPS = 200


def time_consensus(mesh, B: int, N: int):
    """Microseconds of one ``cross_rank_consensus`` (both all-reduces, the
    argmin and the winner's gather) at B lanes and horizon N on this
    rank's device: CUDA events on a card, the host clock on the CPU.
    Returns (us, bytes of the two reduced buffers)."""
    import torch

    from .parallel import cross_rank_consensus
    from .parallel.sharding import consensus_bytes

    b, dev = B // mesh.size, mesh.device
    gen = torch.Generator(device=dev).manual_seed(mesh.rank)
    args = (torch.rand(b, generator=gen, device=dev), torch.zeros((b, N, 12), device=dev),
            torch.zeros((b, N - 1, 6), device=dev), torch.zeros((b, 6), device=dev),
            torch.zeros(b, dtype=torch.int64, device=dev))
    cross_rank_consensus(mesh, *args)  # warm up
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        for _ in range(CONSENSUS_REPS):
            cross_rank_consensus(mesh, *args)
        end.record()
        torch.cuda.synchronize(dev)
        us = start.elapsed_time(end) * 1e3 / CONSENSUS_REPS
    else:
        t0 = time.perf_counter()
        for _ in range(CONSENSUS_REPS):
            cross_rank_consensus(mesh, *args)
        us = (time.perf_counter() - t0) * 1e6 / CONSENSUS_REPS
    return us, consensus_bytes(B, N)


def fig8_reference(ticks: int, N: int, dt: float):
    """The reference's recorded-run fig-8 after 200 rows of padding, long
    enough for ``ticks`` ticks at horizon N (float32)."""
    import numpy as np

    from .mpc import reference

    ref = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=dt,
                            cycles=max(1, (ticks + N) // 1000 + 1))
    return np.asarray(reference.with_padding(ref, 200), np.float32)


def worker(args) -> None:
    import torch

    from .config import CostConfig, MPCConfig, SampleConfig, SQPConfig
    from .models import indy7
    from .mpc.sampled import init_loop_carry
    from .parallel import distributed as dist
    from .parallel import make_sharded_sampled_loop

    if args.device == "cpu":
        torch.set_num_threads(1)
    mesh = dist.initialize(args.coordinator, args.procs, args.proc_id, backend=args.backend,
                           device="cpu" if args.device == "cpu" else None)
    dev = mesh.device
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    B, N, dt = args.B, args.N, 0.01
    model = indy7(torch.float32, dev)
    mpc_cfg = MPCConfig(N=N, dt=dt)
    sample_cfg = SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)
    chunk = max(1, min(args.chunk, args.ticks))
    gen = torch.Generator(device=dev).manual_seed(SEED)
    loop, layout = make_sharded_sampled_loop(
        model, CostConfig(), SQPConfig(max_iters=args.sqp_iters), mpc_cfg, sample_cfg, mesh,
        torch.as_tensor(fig8_reference(args.ticks + chunk, N, dt)), chunk, generator=gen)

    # Cold start: the same seeded carry on every rank, this rank's block
    # of the hypotheses; the carry then stays on the device.
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    carry = dist.global_lanes(mesh, init_loop_carry(model, mpc_cfg, sample_cfg, x0, F_TRUE0,
                                                    gen), layout)

    t0 = time.perf_counter()
    carry, trace = loop(carry)  # first chunk: the kernels' first launches
    sync()
    first_s = time.perf_counter() - t0
    n_chunks = max(1, args.ticks // chunk)
    t0 = time.perf_counter()
    for _ in range(n_chunks):
        carry, trace = loop(carry)
    sync()
    per_tick = (time.perf_counter() - t0) / (n_chunks * chunk)
    consensus_us, consensus_bytes = time_consensus(mesh, B, N)

    if mesh.rank == 0:
        print(json.dumps({
            "procs": args.procs,
            "devices": mesh.size,  # one device a rank (ranks may share a card)
            "device_kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "backend": args.backend,
            "B": B,
            "N": N,
            "sqp_iters": args.sqp_iters,
            "ticks": n_chunks * chunk,
            "chunk": chunk,
            "compile_s": first_s,  # the first chunk (no compile in the port)
            "tick_s": per_tick,
            "solves_per_sec": B / per_tick,
            "tracking_last_chunk_mean_m": float(trace.tracking_error.double().mean()),
            "best_idx": int(trace.best_idx[-1]),
            "u": [float(v) for v in trace.u[-1]],
            "f_est": [float(v) for v in trace.f_est[-1]],
            "consensus_us_per_tick": consensus_us,
            "consensus_bytes_per_tick": consensus_bytes,
        }), flush=True)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def cards(procs: int, device: str) -> int:
    """The cards ``procs`` ranks on ``device`` run on (rank r on
    ``cuda:<r % device count>``; none on the CPU)."""
    if device == "cpu":
        return 0
    from .mpc.lane_mesh import default_device

    return len({default_device(r) for r in range(procs)})


def launch(args) -> list:
    """Spawn the workers on this machine, print rank 0's line (and with
    ``--efficiency`` the efficiency line) and return them."""
    root = Path(__file__).resolve().parents[1]

    def run(procs):
        port = args.port or free_port()
        cmd = [sys.executable, "-m", "indy7_mpc_tpu_torch.multihost_bench", "--worker",
               "--coordinator", f"localhost:{port}", "--procs", str(procs),
               "--device", args.device, "--backend", args.backend,
               "--B", str(args.B), "--N", str(args.N), "--ticks", str(args.ticks),
               "--sqp-iters", str(args.sqp_iters), "--chunk", str(args.chunk)]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [str(root)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        ps = [subprocess.Popen(cmd + ["--proc-id", str(i)], cwd=root, env=env, text=True,
                               stdout=subprocess.PIPE if i == 0 else subprocess.DEVNULL)
              for i in range(procs)]
        try:
            out0, _ = ps[0].communicate(timeout=args.timeout)
            for p in ps[1:]:
                p.wait(timeout=args.timeout)
        finally:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [(i, p.returncode) for i, p in enumerate(ps) if p.returncode != 0]
        if bad:
            raise RuntimeError(f"workers failed (rank, exit code): {bad}")
        return json.loads([line for line in out0.splitlines() if line.startswith("{")][-1])

    multi = run(args.procs)
    print(json.dumps(multi), flush=True)
    if not args.efficiency:
        return [multi]
    single = run(1)
    eff = {
        "metric": "multiproc_scaling_efficiency",
        "procs": args.procs, "devices": args.procs, "cards": cards(args.procs, args.device),
        "device": args.device, "backend": args.backend,
        "B": args.B, "N": args.N, "sqp_iters": args.sqp_iters,
        "ticks": args.ticks, "chunk": args.chunk,
        "value": multi["solves_per_sec"] / single["solves_per_sec"],
        "single_proc_solves_per_sec": single["solves_per_sec"],
        "multi_proc_solves_per_sec": multi["solves_per_sec"],
        "consensus_match": multi["best_idx"] == single["best_idx"],
    }
    print(json.dumps(eff), flush=True)
    return [multi, eff]


def build_parser():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--coordinator", default="localhost:8476")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--proc-id", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default="nccl")
    ap.add_argument("--B", type=int, default=256)
    ap.add_argument("--N", type=int, default=64)
    ap.add_argument("--ticks", type=int, default=500)
    ap.add_argument("--sqp-iters", type=int, default=2)
    ap.add_argument("--chunk", type=int, default=10, help="closed-loop ticks per loop call")
    ap.add_argument("--port", type=int, default=0, help="launcher's port (0: a free one)")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--efficiency", action="store_true",
                    help="also run one rank and print the ratio of solves/s")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.worker:
        worker(args)
    else:
        launch(args)


if __name__ == "__main__":
    main()
