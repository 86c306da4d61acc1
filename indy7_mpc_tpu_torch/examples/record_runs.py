"""Reference-length closed-loop recordings (port of ``examples/record_runs.py``).

Runs the recorded-run protocol (``protocol.py``: figure-8, N=64, 2 SQP
iterations, the true wrench [-60, 20, -40] N walking every 200 steps, B
wrench hypotheses) for each plant and B, records every tick through
``runtime.RunRecorder`` (the reference's six ``.npy`` arrays plus the
``f_est`` / ``f_true`` sidecars, under ``<out>/<tag>/``, with the row's
summary beside them as ``<stem>_row.json``), and writes a summary table
of every row in ``<out>`` beside the TPU package's goldens
(``stats_tpu/<tag>/``).  Tags are the goldens' (``perturbed_b64_device``,
``nominal_b16``, ``perturbed_b64_udp``, ...), with ``_seed<S>`` added for a
seed other than 42, so ``tools/analyze_stats.py`` lines the runs up with
the goldens.

Transports:
  * ``device`` (:func:`run_device_resident`): the whole closed loop
    (``make_loop_tick``'s two-kernel tick: K1, then K2 with consensus,
    plant step and trace FK, on ``mpc.graphed.LoopTickRunner``'s buffers,
    replayed on the card as captured CUDA graphs) in chunks of ``chunk``
    ticks, a sync after each; a tick's ``solve_times`` entry is its
    chunk's host-clock time over the chunk's ticks, ``dts`` is exactly dt;
  * ``inproc`` (:func:`run_one`): ``SampledController`` (K1, K2 as the
    consensus) against ``InProcessPlant`` (K2 at B=1), ticked by
    ``run_control_loop`` without the wall clock; ``solve_times`` is each
    tick's host-clock latency;
  * ``udp`` (:func:`run_one`): the same controller against the native
    ``plant_node`` process (built by ``sim/native.py``) over UDP at the
    plant's pace (``--realtime-scale`` slows the plant's clock).

Usage:
  python3 -m indy7_mpc_tpu_torch.examples.record_runs [--ticks 3500]
      [--batches 1,16,32,64] [--plants nominal,perturbed]
      [--transport inproc|udp|device] [--realtime-scale S] [--mirror PORT]
      [--seed 42] [--out build/stats_torch] [--summary BASELINE_TORCH.md]
      [--no-summary] [--device cuda|cpu]

Nothing it writes by default lands in ``stats_tpu/`` or ``BASELINE_TPU.md``.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..models import indy7
from ..mpc import init_loop_carry, make_loop_tick
from ..mpc.graphed import LoopTickRunner
from ..mpc.sampled import SampledLoopCarry
from ..runtime import (
    InProcessPlant, RunRecorder, SampledController, UdpTransport, run_control_loop,
)
from . import protocol
from .protocol import DT, F_TRUE0, MAX_ITERS, N, PLANTS, REF_ROWS

ROOT = Path(__file__).resolve().parents[2]
DEFAULT_OUT = ROOT / "build" / "stats_torch"
DEFAULT_SUMMARY = ROOT / "BASELINE_TORCH.md"
GOLDEN_DIR = ROOT / "stats_tpu"
UDP_PORTS = (7461, 7460)  # plant, controller: plant_node's defaults
DEFAULT_SEED = 42


def row_tag(plant: str, B: int, transport: str, seed: int = DEFAULT_SEED) -> str:
    tag = f"{plant}_b{B}" + {"udp": "_udp", "device": "_device"}.get(transport, "")
    return tag if seed == DEFAULT_SEED else f"{tag}_seed{seed}"


def plant_node_command(plant_cfg, dt: float = DT, realtime_scale: float = 1.0,
                       ports=UDP_PORTS) -> list:
    """``plant_node``'s command line with the mismatch flags of
    ``plant_cfg`` (the TPU script's ``spawn_plant_node``), on ``ports``
    (plant, controller)."""
    from ..sim import native

    substeps = plant_cfg.substeps if plant_cfg else 1
    cmd = [native.plant_node_path(), str(dt / substeps), str(substeps),
           "--ports", str(ports[0]), str(ports[1])]
    if realtime_scale != 1.0:
        cmd += ["--realtime-scale", str(realtime_scale)]
    if plant_cfg is not None:
        if plant_cfg.param_scale_pct:
            cmd += ["--perturb", str(plant_cfg.param_scale_pct), str(plant_cfg.seed)]
        if plant_cfg.viscous_friction or plant_cfg.coulomb_friction:
            cmd += ["--friction", str(plant_cfg.viscous_friction),
                    str(plant_cfg.coulomb_friction)]
        if plant_cfg.torque_noise_std:
            cmd += ["--noise", str(plant_cfg.torque_noise_std)]
    return cmd


def run_device_resident(B, ticks, plant_cfg, out_dir, tag, chunk=100, mirror_port=None, *,
                        device="cuda", seed=DEFAULT_SEED, N=N, max_iters=MAX_ITERS,
                        dtype=torch.float32, carry0: Optional[SampledLoopCarry] = None,
                        draws=None):
    """Device-loop recording of ``ticks`` ticks; returns (row, final carry).

    The loop runs in chunks of ``chunk`` ticks (the last one shorter when
    ``chunk`` does not divide ``ticks``), with a sync after each; every
    tick's ``solve_times`` entry is its chunk's host-clock µs over its
    ticks.  On the card the row also has ``event_us``, the chunks' CUDA-event
    µs a tick, which the arrays do not hold.  A warm-up chunk first runs
    from the same carry and is thrown away; the generator's state is put
    back after it, so the recording does not depend on it.  ``carry0``
    and ``draws`` (a ``TickDraws`` a tick) replace the cold start and the
    generator's draws, as in ``run_sampled_mpc``.  ``mirror_port`` replays
    each chunk's states in the ``plant_node`` wire format
    (tools/live_view.py).
    """
    dev = protocol.device(device)
    chunk = max(1, min(chunk, ticks))
    cost_cfg, sqp_cfg, mpc_cfg, sample_cfg = protocol.configs(B, N=N, max_iters=max_iters)
    model = indy7(dtype, dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    ref = torch.as_tensor(protocol.fig8_reference(ticks, N=N), dtype=dtype, device=dev)
    tick = make_loop_tick(model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref,
                          f_true_walk=True, plant_cfg=plant_cfg, generator=gen)

    t_init0 = time.perf_counter()
    if carry0 is None:
        carry = init_loop_carry(model, mpc_cfg, sample_cfg, protocol.initial_state(dtype, dev),
                                F_TRUE0, gen)
    else:
        carry = SampledLoopCarry(*(v.to(dev) for v in carry0))
    runner = LoopTickRunner(tick, carry, chunk, with_draws=draws is not None)
    chunk_draws = lambda start, n: None if draws is None else draws[start:start + n]
    # Warm-up: kernel build, first launches and, on the card, the graphs'
    # capture; then the generator and the carry are put back.
    state = gen.get_state()
    runner.run(chunk, chunk_draws(0, chunk))
    protocol.synchronize(dev)
    gen.set_state(state)
    runner.load(carry)
    init_s = time.perf_counter() - t_init0

    mirror = None
    if mirror_port:
        mirror = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    events = None
    if dev.type == "cuda":
        events = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    rec = RunRecorder(out_dir=os.path.join(out_dir, tag), save_interval=1e9)
    event_ms, done, sim_t = 0.0, 0, 0.0
    t0 = time.perf_counter()
    try:
        while done < ticks:
            n = min(chunk, ticks - done)
            tc = time.perf_counter()
            if events:
                events[0].record()
            trace = runner.run(n, chunk_draws(done, n))
            if events:
                events[1].record()
            protocol.synchronize(dev)
            per_tick_us = (time.perf_counter() - tc) / n * 1e6
            if events:
                event_ms += events[0].elapsed_time(events[1])
            rec.record_trace(trace, dts=mpc_cfg.dt, solve_times_us=per_tick_us)
            if mirror is not None:
                xs = trace.x.detach().cpu().numpy().astype("<f8")
                ees = trace.ee_pos.detach().cpu().numpy().astype("<f8")
                for i in range(n):
                    sim_t += mpc_cfg.dt
                    mirror.sendto(bytes([1]) + xs[i].tobytes() + ees[i].tobytes()
                                  + np.asarray([sim_t], "<f8").tobytes(),
                                  ("127.0.0.1", int(mirror_port)))
            done += n
    finally:
        if mirror is not None:
            mirror.close()
    wall = time.perf_counter() - t0
    row = _finish(rec, tag, B, seed, "device", init_s, wall, dev)
    row["chunk"] = chunk
    row["event_us"] = event_ms * 1e3 / ticks if events else None
    _save_row(row)
    return row, runner.carry()


def run_one(B, ticks, plant_cfg, out_dir, tag, transport="inproc", realtime_scale=1.0,
            mirror_port=None, *, device="cuda", seed=DEFAULT_SEED, N=N,
            max_iters=MAX_ITERS, ports=UDP_PORTS):
    """Controller recording of ``ticks`` ticks through ``run_control_loop``;
    returns the row.

    ``transport="inproc"``: against ``InProcessPlant(plant_cfg)`` at
    INIT_Q on ``device``, without the wall clock (``mirror_port`` mirrors
    its states).  ``"udp"``: against ``plant_node`` with ``plant_cfg``'s
    flags on ``ports`` (plant, controller), at 100 / ``realtime_scale``
    Hz of wall clock; its first state is awaited before the loop sends
    the true wrench, and the process is ended however the run ends.
    ``seed`` seeds the controller's generator and the true wrench's walk.
    """
    dev = protocol.device(device)
    cost_cfg, sqp_cfg, mpc_cfg, sample_cfg = protocol.configs(B, N=N, max_iters=max_iters)
    model = indy7(torch.float32)
    t_init0 = time.perf_counter()
    ctl = SampledController(model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg,
                            protocol.fig8_reference(ticks, N=N), seed=seed,
                            f_ext_actual=F_TRUE0[:3], device=dev)
    init_s = time.perf_counter() - t_init0
    rec = RunRecorder(out_dir=os.path.join(out_dir, tag), save_interval=1e9)
    proc = plant = None
    try:
        if transport == "udp":
            proc = subprocess.Popen(plant_node_command(plant_cfg, mpc_cfg.dt, realtime_scale,
                                                       ports),
                                    stdout=subprocess.DEVNULL)
            plant = UdpTransport(plant_addr=("127.0.0.1", ports[0]),
                                 listen_addr=("127.0.0.1", ports[1]))
            # Bound once it sends: the loop's first message, the true
            # wrench, then reaches it.
            plant.wait_for_state(timeout=30.0)
        elif transport == "inproc":
            plant = InProcessPlant(model, protocol.initial_state(torch.float32, dev),
                                   mpc_cfg.dt, plant_cfg=plant_cfg, mirror_port=mirror_port)
        else:
            raise ValueError(f"transport must be 'inproc' or 'udp', got {transport!r}")
        t0 = time.perf_counter()
        rec = run_control_loop(ctl, plant, duration=1e9, rate_hz=100.0 / realtime_scale,
                               recorder=rec, walk_disturbance=True, seed=seed,
                               realtime=(transport == "udp"), max_ticks=ticks)
        wall = time.perf_counter() - t0
        if proc is not None and proc.poll() is not None:
            raise RuntimeError(f"plant_node exited with {proc.returncode} during the run")
    finally:
        if plant is not None:
            plant.close()
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=5)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    row = _finish(rec, tag, B, seed, transport, init_s, wall, dev)
    _save_row(row)
    return row


def estimator_stats(f_est, f_true, walk_period=200, settle_frac=0.25) -> dict:
    """Wrench-estimate error (N) and its re-lock lag (ticks) after each
    walk of the true wrench: ``tools/analyze_stats.py::estimator_stats``,
    kept here so that the package reads its recordings by itself."""
    err = np.linalg.norm(f_est[:, :3] - f_true[:, :3], axis=1)
    out = {"fe_err_mean": float(err.mean()), "fe_err_p50": float(np.percentile(err, 50)),
           "fe_err_p95": float(np.percentile(err, 95))}
    lags = []
    for start in range(0, len(err) - walk_period + 1, walk_period):
        w = err[start:start + walk_period]
        settled = np.percentile(w[walk_period // 2:], 50)
        peak = w[:10].max()
        if peak <= settled:  # the walk did not move the error
            lags.append(0)
            continue
        below = np.nonzero(w <= settled + settle_frac * (peak - settled))[0]
        lags.append(int(below[0]) if len(below) else walk_period)
    if lags:
        out.update(fe_lag_p50=float(np.percentile(lags, 50)),
                   fe_lag_p95=float(np.percentile(lags, 95)), fe_windows=len(lags))
    return out


def recording_stats(arrays: dict) -> dict:
    """Tracking (m), tick time (µs), control period (ms) and wrench
    estimate statistics of one recording's arrays (``RunRecorder`` names)."""
    te, st = np.asarray(arrays["tracking_errors"]), np.asarray(arrays["solve_times"])
    out = {"ticks": int(te.shape[0]),
           "tracking_m": [float(te.mean()), float(np.percentile(te, 50)),
                          float(np.percentile(te, 95))],
           "solve_us": [float(st.mean()), float(np.percentile(st, 50)),
                        float(np.percentile(st, 95)), float(st.max())],
           "first_tick_us": float(st[0]),
           "dt_ms_mean": float(np.mean(arrays["dts"]) * 1e3),
           "finite": bool(all(np.isfinite(np.asarray(a)).all() for a in arrays.values()
                              if a is not None))}
    if arrays.get("f_est") is not None and arrays.get("f_true") is not None:
        out.update(estimator_stats(np.asarray(arrays["f_est"]), np.asarray(arrays["f_true"])))
    return out


def load_recording(stem: str) -> dict:
    """The arrays of the recording at ``stem`` (``<dir>/<HHMMSS>``); a
    sidecar that is missing is None."""
    names = RunRecorder.ARRAYS + RunRecorder.EXTRA_ARRAYS
    return {n: np.load(f"{stem}_{n}.npy") if os.path.exists(f"{stem}_{n}.npy") else None
            for n in names}


def golden_stats(tag: str, golden_dir=GOLDEN_DIR) -> Optional[dict]:
    """``recording_stats`` of the newest golden recording of ``tag``
    (a ``_seed<S>`` suffix dropped), or None without one."""
    base = re.sub(r"_seed\d+$", "", tag)
    stems = sorted(glob.glob(os.path.join(str(golden_dir), base, "*_tracking_errors.npy")))
    if not stems:
        return None
    return recording_stats(load_recording(stems[-1][: -len("_tracking_errors.npy")]))


def _finish(rec, tag, B, seed, transport, init_s, wall, dev) -> dict:
    stem = rec.save()
    stats = recording_stats({n: rec._fetch(n) if rec._data[n] else None
                             for n in rec.ARRAYS + rec.EXTRA_ARRAYS})
    return {"tag": tag, "B": B, "seed": seed, "transport": transport,
            "device": protocol.device_label(dev), "init_s": init_s, "wall_s": wall,
            "stem": stem, **stats}


def _save_row(row: dict) -> None:
    with open(row["stem"] + "_row.json", "w") as f:
        json.dump(row, f)
    print(json.dumps(row), flush=True)


def collect_rows(out_dir) -> list:
    """Every row recorded under ``out_dir`` (its ``*/*_row.json``), by tag
    and time."""
    rows = []
    for path in sorted(glob.glob(os.path.join(str(out_dir), "*", "*_row.json"))):
        with open(path) as f:
            rows.append(json.load(f))
    return sorted(rows, key=lambda r: (r["tag"], r["stem"]))


def _fmt(values, spec):
    """``values`` (a number or a sequence) formatted, "/"-joined; n/a for None."""
    if values is None or (isinstance(values, (list, tuple)) and values[0] is None):
        return "n/a"
    if not isinstance(values, (list, tuple)):
        return format(values, spec)
    return "/".join(format(v, spec) for v in values)


def write_summary(rows, ticks, path=DEFAULT_SUMMARY, golden_dir=GOLDEN_DIR):
    """The table of ``BASELINE_TPU.md``'s layout for ``rows``, each beside
    its golden (``golden_dir/<tag>``) and the reference CUDA solver's row
    of its B, then ``tools/analyze_stats.py``'s table of the rows'
    recordings and the goldens when the repository has that script."""
    cards = sorted({r["device"] for r in rows})
    lines = [
        "# BASELINE_TORCH — recorded closed-loop runs of the PyTorch/CUDA port",
        "",
        "Produced by `python3 -m indy7_mpc_tpu_torch.examples.record_runs` "
        f"(indy7_mpc_tpu_torch/examples/record_runs.py; the last call ran --ticks {ticks}, "
        "each row's count is in the table) on: " + "; ".join(cards) + ".",
        "Every figure below was taken on that card at that power limit; the golden "
        "columns are the TPU package's recordings in `stats_tpu/` (their tick times "
        "are a TPU's and are not compared).",
        "",
        "Protocol (indy7_mpc_tpu_torch/examples/protocol.py): figure-8 (A_x 0.5, A_z "
        "0.55, offset [0, 0.4, 0.45], period 10 s) after 200 rows of padding, N=64, "
        "dt=10 ms, 2 SQP iterations, true wrench [-60, 20, -40] N walking every 200 "
        "steps (clipped to +-20 N), B wrench hypotheses (sigma 20 N, resample sigma "
        "1 N). `perturbed` rows run the plant with PERTURBED_PLANT (seeded ~4% "
        "inertial error, friction, 0.1 N m actuation noise, 5 substeps). `_device` "
        "rows run the whole loop on the card in chunks of 100 ticks (tick µs = the "
        "chunk's host-clock time over its ticks; CUDA-event µs a tick beside it); the "
        "others tick `SampledController` by host dispatch, in process or over UDP "
        "to the native plant, and their tick µs are each tick's host-clock latency.",
        "",
        "| run | seed | B | ticks | tick µs mean/p50/p95/max | CUDA-event µs/tick | "
        "tracking m mean/p50/p95 | golden m | wrench err p50 N | golden N | "
        "re-lock lag p50 | golden lag | period ms | ref CUDA solver µs | ref m |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in rows:
        g = golden_stats(r["tag"], golden_dir) or {}
        ref_st, ref_te = REF_ROWS.get(r["B"], (None, None))
        lines.append(
            f"| {r['tag']} | {r['seed']} | {r['B']} | {r['ticks']} | "
            f"{_fmt(r['solve_us'], ',.1f')} | {_fmt(r.get('event_us'), ',.1f')} | "
            f"{_fmt(r['tracking_m'], '.4f')} | {_fmt(g.get('tracking_m'), '.4f')} | "
            f"{_fmt(r.get('fe_err_p50'), '.2f')} | {_fmt(g.get('fe_err_p50'), '.2f')} | "
            f"{_fmt(r.get('fe_lag_p50'), 'g')} | {_fmt(g.get('fe_lag_p50'), 'g')} | "
            f"{r['dt_ms_mean']:.2f} | {_fmt(ref_st, ',')} | {_fmt(ref_te, '.3f')} |")
    lines += [
        "",
        "Reference columns: the reference CUDA solver's recorded 3,500-tick runs "
        "(BASELINE.md, stats/{single,16,32,64}), measured under MuJoCo model "
        "mismatch; compare them with the `perturbed` rows.",
        "",
    ]
    analyze = ROOT / "tools" / "analyze_stats.py"
    run_dirs = sorted({os.path.abspath(os.path.dirname(r["stem"])) for r in rows})
    goldens = sorted({os.path.abspath(os.path.join(str(golden_dir), g)) for g in
                      (re.sub(r"_seed\d+$", "", r["tag"]) for r in rows)
                      if os.path.isdir(os.path.join(str(golden_dir), g))})
    if analyze.exists() and run_dirs:
        dirs = [os.path.relpath(d, ROOT) if d.startswith(str(ROOT) + os.sep) else d
                for d in run_dirs + goldens]
        out = subprocess.run([sys.executable, str(analyze), *dirs], cwd=ROOT,
                             capture_output=True, text=True, timeout=600)
        lines += ["`python tools/analyze_stats.py " + " ".join(dirs) + "`:", "", "```",
                  out.stdout.rstrip(), "```", ""]
    with open(path, "w") as f:
        f.write("\n".join(lines))
    print(f"wrote {path}", flush=True)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=3500)
    ap.add_argument("--batches", default="1,16,32,64")
    ap.add_argument("--plants", default="nominal,perturbed")
    ap.add_argument("--out", default=str(DEFAULT_OUT),
                    help="recordings go to <out>/<tag>/ (default build/stats_torch)")
    ap.add_argument("--summary", default=str(DEFAULT_SUMMARY),
                    help="the summary of every row under --out (default BASELINE_TORCH.md)")
    ap.add_argument("--transport", default="inproc", choices=("inproc", "udp", "device"),
                    help="inproc: controller and in-process plant by host dispatch; udp: "
                         "the native plant_node process over UDP at the plant's pace; "
                         "device: the whole loop on the device, in chunks")
    ap.add_argument("--realtime-scale", type=float, default=1.0,
                    help="udp: run plant time S times slower than the wall clock "
                         "(plant_node --realtime-scale); the controller advances its "
                         "reference by the plant's own clock")
    ap.add_argument("--mirror", type=int, default=None,
                    help="device and inproc: replay the states onto this live_view "
                         "port (tools/live_view.py)")
    ap.add_argument("--seed", type=int, default=DEFAULT_SEED,
                    help="the controller's generator and the wrench walk (42 is the "
                         "goldens' PRNGKey(42); other seeds tag their rows _seed<S>)")
    ap.add_argument("--ports", type=int, nargs=2, default=list(UDP_PORTS),
                    metavar=("PLANT", "CONTROLLER"), help="udp: the UDP port pair")
    ap.add_argument("--no-summary", action="store_true", help="skip writing --summary")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    dev = protocol.device(args.device)
    for plant in args.plants.split(","):
        if plant not in PLANTS:
            raise SystemExit(f"unknown plant {plant!r}: choose from {sorted(PLANTS)}")
        for B in [int(b) for b in args.batches.split(",")]:
            tag = row_tag(plant, B, args.transport, args.seed)
            if args.transport == "device":
                run_device_resident(B, args.ticks, PLANTS[plant], args.out, tag,
                                    mirror_port=args.mirror, device=dev, seed=args.seed)
            else:
                run_one(B, args.ticks, PLANTS[plant], args.out, tag, transport=args.transport,
                        realtime_scale=args.realtime_scale, mirror_port=args.mirror,
                        device=dev, seed=args.seed, ports=tuple(args.ports))
    if not args.no_summary:
        write_summary(collect_rows(args.out), args.ticks, args.summary)
    return 0


if __name__ == "__main__":
    sys.exit(main())
