#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (indy7_mpc_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py      (from the repository root; needs one card)

Phases, each fatal on failure (exit code 1, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from indy7_mpc_tpu_torch/csrc with nvcc;
  3. SQP kernel (K1, one block of threads per lane, the lane's horizon in
     shared memory; past 174 knots a cluster of blocks per lane) against
     its plain PyTorch version on the card: B=64,
     N=64, 2 SQP iterations, f32 with TF32 off; the line-search alphas
     must be equal on every lane and X, U within 6e-3 after scaling each
     lane by max(1, max |value|); then K1 timed whole and at its
     profiling cut (stages 1, 1-2, 1-3);
  4. tick-epilogue kernel (K2, one block of 512 threads in teams of 8,
     a team per forward-dynamics chain) against its plain version: B=64
     on the perturbed plant (winner equal, err rtol 1e-3 / atol 1e-5,
     x_next atol 2e-3, u and f_est equal to rtol 1e-7, eep atol 1e-5);
     its threads and ptxas line printed;
  5. the main path: run_sampled_mpc on the card at the fig-8 configuration
     (B=64, N=64, 2 SQP iterations, perturbed plant) for 500 ticks, its
     first tick eager and the rest replays of the tick's captured CUDA
     graphs (mpc/graphed.py); the trace must be finite, the mean tracking
     error of the last 100 ticks below 0.2 m, and each kernel launched
     once per tick (each replay adds the launches its graph captured);
     then the graphs against the eager loop (a Python loop over the same
     tick module from the same seed): the main path's first 20 trace rows,
     and a 20-tick run's trace, carry and generator state, bit for bit;
     last, the eager and the graphed loop in turns at B = 64, 256 and
     1,024 in runs of 100 ticks (measure.loop_modes): us a tick by CUDA
     events and by the host clock, host-side launches a tick, device
     kernels and device time a tick (torch.profiler) and the busy share;
     the graphed loop must issue at most 2 host-side launches a tick;
  6. the runtime in process: SampledController and InProcessPlant(
     PERTURBED_PLANT) both on the card, run_control_loop without the wall
     clock, at the recorded host-dispatch configuration (B=64, N=64, 2 SQP
     iterations, fig-8 of 10 cycles after 200 rows of padding, true wrench
     [-60, 20, -40] N) for 500 ticks: K1 once per tick plus the warm-up, K2
     twice per tick (consensus, plant step) plus the warm-up, everything
     recorded finite, last-100 tracking under 0.2 m, wrench-estimate error
     p50 under 50 N; then K2 as the consensus (B=64, the plant step
     skipped: x_next None on both sides) and as the plant step (B=1)
     against its plain version at phase 4's tolerances, and the readable
     plant's make_plant_step(PERTURBED_PLANT) in f32 on the card on that
     plant step's state, control, true wrench and normals against K2's
     x_next at phase 4's x_next atol 2e-3 (no launch); last, the
     controller tick graphed (on_state) and eager (its ControllerTick
     called directly) in turns, 50 ticks each (measure.controller_timing):
     p50/p95 by the host clock, host-side launches and device time;
  7. the runtime over UDP: the native plant built from native/plant by the
     port (sim/native.py), plant_node with the perturbed plant's flags in
     real time (--realtime-scale 1: the controller tick fits the 10 ms
     period), its first state awaited, the same controller at 100 Hz for
     300 ticks: at least 250
     ticks recorded, finite, last-100 tracking under 0.3 m, wrench-estimate
     error p50 under 50 N; the plant process is killed at the end;
  8. point to goal: K1 at B=1 (N=32, 3 SQP iterations) against its plain
     version, then run_mpc for 300 steps with the goal chain of
     examples/point_to_goal.py (its first step eager, the rest replays of
     captured CUDA graphs): K1 once per step plus the warm-up solve,
     K2 (the plant step) once per step, at least one goal switch, alive at
     the end, states finite; then K2 as that plant step (B=1) against its
     plain version at phase 4's tolerances; then run_mpc and
     run_tracking_mpc (fig-8, N=32, 2 SQP iterations) each for 20 steps
     against a Python loop over its tick: trace and final carry bit for
     bit, K1 and K2 once a step; 20 replayed steps of each under
     torch.cuda.set_sync_debug_mode("error") (no host sync); last, each
     eager and graphed in turns in runs of 100 steps (measure.
     single_lane_modes): ms a step by CUDA events, host-side launches a
     step (at most 2 graphed), device kernels and busy share;
  9. the readable layer (solvers/sqp.py, ops/kkt.py, ops/riccati.py,
     mpc/readable_tick.py) on the card, at phase 3's B=64/N=64 inputs:
     the readable batch_solve in f32 against K1 (alphas equal, X and U
     within phase 3's scaled 6e-3 on every lane whose alphas agree; at
     most 2 of 64 lanes may flip an alpha from f32 rounding, each
     printed); the same solve in f64 on the card and on the CPU, within
     1e-9 with equal alphas; then run_sampled_mpc(fused=False) for 20
     ticks (the readable tick, its first tick eager, the rest replays of
     one-tick CUDA graphs) and fused="auto" (K1 + K2) from the same carry
     with the same draws: the readable run launches neither kernel, the
     fused one each once a tick; the first tick's winner equal and its u
     within the scaled 6e-3; both finite; the readable run's mean tracking
     error within 10% of the fused run's; ms per tick (host clock)
     printed for both; three sampled_tick calls with
     formulation="reference": the readable solver (no K1 or K2 launch),
     the fallback warning logged, finite outputs; then the readable loop
     graphed against a Python loop over its tick for 3 ticks: trace,
     carry and generator bit for bit; 2 replayed ticks under sync-debug
     "error"; both timed in turns in runs of 2 ticks (measure.
     readable_loop_modes: ms a tick by CUDA events, device kernels a tick,
     busy share, the graph's capture-and-instantiate seconds and pool
     bytes); last, a SampledController with formulation="reference" (the
     readable tick, captured at warm-up) at B=8, N=16: 5 on_state calls
     against 5 eager calls of its ControllerTick, outputs, state and
     generator bit for bit, 3 replays under sync-debug "error", and at
     B=64, N=64 graphed and eager in turns (measure.controller_timing);
 10. the URDF-controller / MJCF-plant loop: the controller on
     indy7_from_urdf(), the plant on indy7_mjcf() (MJCF inertials, axes
     and ranges, +inf velocity limits, which reach K2's constants
     unchanged) perturbed by PERTURBED_PLANT, run_sampled_mpc at phase 5's
     configuration for 500 ticks through K1 and K2 (each once a tick):
     finite, last-100 tracking under 0.2 m; then K2 with the MJCF plant's
     constants against its plain version on the run's last state;
 11. the readable solver's QP backends (ops/riccati_pscan.py, ops/pcg.py,
     ops/admm.py) on the card, none of which launches K1 or K2: at phase
     3's B=64/N=64 f32 inputs, 2 SQP iterations, each backend's default
     settings, beside the readable Riccati solve: riccati_pscan's X and U
     within phase 3's scaled 6e-3 on every lane whose alphas agree (at
     most 2 flips); admm finite and every lane's merit below its start;
     pcg finite, no lane's merit above its start, its CG counts in (0, 60]
     on every live SQP iteration (60 CG iterations do not converge on
     these QPs, so its merit against Riccati's is printed, not gated);
     then pcg in f64 with a cap of 2,000 CG iterations, every lane's merit
     at most 1.05 times the f64 Riccati lane's plus 1e-6; ms, device
     kernels and host syncs of a call printed for each backend; each
     backend in f64 at B=4/N=16 on the card and on the CPU (alphas and
     inner iterations equal; X, U within 1e-9, pcg and admm within 1e-8
     after scaling each lane by max(1, max |value|)); last, the GATO
     method in the closed loop: run_sampled_mpc(fused=False) with
     qp_backend="pcg" from phase 9's carry with its draws for 10 ticks
     (graphed),
     its mean tracking error within 20% of phase 9's readable Riccati
     tick over the same ticks (see PCG_LOOP_GATE), its ms a tick and the
     winners' agreement printed; then the PCG loop graphed against its
     eager loop and timed as phase 9's readable loop;
 12. the lane-sharded closed loop (indy7_mpc_tpu_torch/parallel/): 2 ranks,
     each a spawned process on cuda:0, over gloo (NCCL refuses two ranks
     of one group on one device); each rank runs K1 once a tick on its
     block, K2 on its block as the consensus and K2 at B=1 as the plant
     step; the consensus is two all-reduces.  (c) make_sharded_batch_solve
     at phase 3's B=64/N=64 inputs against the single-process K1 and K1's
     plain version at phase 3's gates (bits against K1 printed);
     (a) make_sharded_sampled_loop at the bench's configuration (B=256,
     N=64, 2 SQP iterations, perturbed plant, fig-8) for 200 ticks against
     run_sampled_mpc from the same seed in this process: the winner equal
     on every tick, u and the tracking error within the scaled 6e-3
     (same bits printed), both ranks' traces equal bit for bit, K1 200 and
     K2 400 times on each rank with 128 lanes a block; (b) B=32,768
     (16,384 lanes a rank) with tests/test_sharding.py's 32k sampling and
     true wrench for 5 ticks: finite, winners in [0, B), each block
     (16,384, 6) on every tick, max |f_batch| under 60 N.  After each of
     (a) and (b), every rank holds the next tick's K1 and K2 consensus
     calls on its block against their plain versions: K1 on all 128 lanes
     and on 256 lanes spread over the 16,384 at phase 3's gates, K2 on
     every lane at phase 4's with the winner equal (at 16,384 lanes K2
     takes its thread-per-lane path, which no earlier phase runs without
     the plant).  Printed: ms a
     tick of (a) and (b) by CUDA events on each rank and by the host
     clock (the first chunk left out), K1 alone at 128 and 16,384 lanes
     and K2 alone as the consensus at those widths and as the B=1 plant
     step (on the next tick's arguments) with both ranks on the card, and
     the consensus collectives alone (us a tick and their bytes);
 13. the recorded runs: the device rows perturbed_b64_device and
     perturbed_b1024_device of examples/record_runs.py's protocol
     (fig-8 of 10 cycles after 200 rows of padding, N=64, 2 SQP
     iterations, the perturbed plant, true wrench [-60, 20, -40] N with
     its walk), 3,500 ticks each, through the port's
     examples/record_runs.py::run_device_resident (chunks of 100 after a
     warm-up chunk that captures the tick's CUDA graphs; each chunk one
     graph of 10 ticks replayed 10 times): K1 and K2 launched once a tick plus the warm-up
     chunk, all eight recorded arrays finite with 3,500 rows; on the
     next tick of each row K1 (all lanes) and K2 with the plant step
     against their plain versions at phase 3's and phase 4's gates; each
     row's tracking mean and p95 within 1.25x of its golden in stats_tpu/
     and its wrench-estimate error p50 within 1.5x; the tracking mean at
     B=1,024 below B=64's (the ensemble claim).  Printed: each row's
     tracking, wrench error and re-lock lag beside the golden's, its us a
     tick by the host clock and by CUDA events, and the card;
 14. the diagnostic tools (indy7_mpc_tpu_torch/tools/), each through its
     main() on the card at short lengths: latency_decomp --ticks 200,
     profile_kernel_stages 64 64, profile_solve 64 64 --backend cuda
     --trace (as python3 -m, in a process of its own), profile_pscan 64 64
     --chain 5, consensus_collective_bench (2 ranks on cuda:0 over gloo)
     and multihost_eff --procs 2 --ticks 100;
     each JSON line parses and carries the keys (or, for a tool that prints
     a table, the row names) of the TPU package's tool of the same name,
     read from its source with ast (multihost_eff: the committed
     MULTIHOST_EFF.json's keys); in latency_decomp solve_device <=
     solve_block, null_rtt < solve_block, no kernel-library build or load
     and no allocator growth after the loop's first tick, the loop's tick
     p50 under the 10,000 us period, on_state's host-side launches at most
     5 (the input copy, the graph's launch with the generator's two
     fills, the fetch) and its device work between one solve's device
     time and its blocking tick (latency_decomp as python3 -m, in a
     process of its own); one
     K1 solve of the tool's inputs and the K2 call of the controller's
     tick against their plain versions at phase 3's and phase 4's gates
     (the eager ControllerTick on the controller's state after 20 ticks of
     the tool's loop against the perturbed plant); the stage profile's cumulative times
     non-decreasing (5% slack) with stages<=4 within 25% of phase 3's K1
     time; the trace file written and naming K1's kernel; the consensus
     bench's bytes those of consensus_bytes(B, N); the winners of
     multihost_eff's ranks and of its one rank equal;
 15. the solve benchmarks: indy7_mpc_tpu_torch.bench.main() whole (B=64,
     N=32 and 64, three repeats each), then examples/scale_bench.py's
     main at N=32 (B=64-4,096) without and with --mesh (one rank a card
     over NCCL, in a process of its own); the bench's one stdout JSON
     line with bench.py's keys (read with ast), value finite and > 0,
     min <= median <= max; K1 launched exactly 1 + R + 50 + 20R times a
     measurement and K2 never, and each sweep 1 + reps a row; the bench's
     first solve (from zeros) against K1's plain version at phase 3's
     gates, and its last chained solve at the same X/U gate on every lane
     (at the chain's fixed point float32 rounding decides whether a step
     is taken: the lanes whose alphas differ are counted, not gated);
     every sweep row finite with scale_bench.py's keys; on 256 lanes
     spread over the B=4,096 batch, a solve of the sweep's inputs at
     phase 3's gates and the sweep's last solve at the X/U gate; the
     --mesh sweep's final X and U within the same gate of the
     one-process sweep's (bit equality printed).
     Printed: the card, both benches' lines, and the chain by CUDA events
     beside the host clock;
 16. (run after phase 5) K1 past one block's shared memory: at B=64, N=256
     and 512 (clusters of 2 and 3 blocks a lane) against its plain version
     at phase 3's gates, each with its blocks a lane, a block's shared
     bytes and the share of its bound printed, and the ptxas line of the
     cluster kernel; then run_sampled_mpc at B=64, N=256 on the perturbed
     plant, graphed, for 200 ticks under phase 5's gates (finite trace,
     last-100 tracking under 0.2 m, K1 and K2 once a tick), its first 20
     trace rows against the eager loop bit for bit, and the graphed tick
     against the eager one in turns (measure.loop_modes, 100-tick runs):
     us a tick by CUDA events and its share of the 10 ms period.

Each kernel's bound is the larger of its floating-point operations on
the phase's inputs over 67 TFLOP/s and the bytes of its inputs and
outputs over 3.35 TB/s (H100 SXM, 700 W), from
indy7_mpc_tpu_torch/roofline.py: K1's counts the kernel's own arithmetic
(k1_work), K2's the work its function needs (k2_work: the mass matrix
priced at the CRBA).  K2's latency floor, its chain of dependent
forward-dynamics calls, is printed beside it.  Kernel times queue their
launches behind a device sleep, so they time the kernel and not the
host's launch path.  No PyTorch call
computes either kernel's function, so library_ms is null.  There is no
fallback: a kernel that does not build or launch, or a horizon that does
not fit K1's shared memory, fails its phase.

The line before the last is the card's name and power limit, the one
before it the kernels' JSON summary (``launches_by_phase`` has phase 8
as ``run_mpc``, its 300 steps and the 20 held against the eager loop,
and ``run_tracking_mpc``, its 20, phase 11
as ``qp_backends``, with 0 launches of each, phase 12 as ``sharded``,
the launches of (a) and (b) summed over the ranks, and phase 13 as
``recorded_runs``, both rows' launches summed, phase 14 as ``tools``,
the launches of this process: the ranks' are their own, phase 15 as
``bench``, bench.main()'s, and ``scale_bench``, the one-process sweep's,
and phase 16 as ``long_horizon``, its 200 ticks; K1's entry carries
phase 16's K1 rows as ``long_horizon``);
before those the eager and graphed timings of phases 5, 6 and 8
(``graphs:``; phases 9 and 11's are in ``readable:`` and ``qp_backends:``,
phase 16's in ``long_horizon:``);
the last line is {"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

B, N, DT, SQP_ITERS, TICKS = 64, 64, 0.01, 2, 500
# Phase 5: the graphed loop held against the eager one over GRAPH_TICKS
# ticks; both timed at each of GRAPH_LANES in runs of GRAPH_CHUNK ticks.
GRAPH_TICKS, GRAPH_LANES, GRAPH_CHUNK = 20, (64, 256, 1024), 100
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
UDP_TICKS, REALTIME_SCALE, UDP_PORTS = 300, 1, (7611, 7610)  # plant, controller
P2G_N, P2G_ITERS, P2G_STEPS = 32, 3, 300
# Phase 9: the readable loop's graphed run, the ticks held bit for bit
# against the eager loop, and the ticks of each timed run in turns.
READABLE_TICKS, READABLE_CHECK_TICKS, READABLE_MODE_TICKS, MAX_FLIPS = 20, 3, 2, 2
QP_BACKENDS = ("riccati", "riccati_pscan", "pcg", "admm")
PCG_CONVERGED_ITERS, PCG_LOOP_TICKS = 2000, 10
# The PCG loop's mean tracking error against the Riccati tick's over the
# same 10 ticks.  That mean is set by the start's transient, not by the
# solver (indy7_mpc_tpu_torch/qp_gates.py, on the card): capped at 1 CG
# iteration a solve the loop reads +7.3% on this phase's draws, at the
# default 60 it reads +12.8% there and +3.3 to +8.6% on four other sets
# of draws.  20% passes that spread; a NaN or a diverging loop fails.
PCG_LOOP_GATE = 0.2
# f64 card vs CPU: the direct backends absolutely, as phase 9; the
# iterative ones after scaling each lane by max(1, max |value|), at the SQP
# bound of tests/test_torch_{pcg,admm}.py (CG stops at its cap unconverged,
# and ADMM's H has a condition number near 1e13, so the two devices'
# rounding reaches ~2e-9 scaled, as the CPU's against the TPU package's).
F64_TOL = {"riccati": 1e-9, "riccati_pscan": 1e-9, "pcg": 1e-8, "admm": 1e-8}
# Phase 12: the lane-sharded loop on ranks that share the card over gloo
# (NCCL refuses two ranks of one group on one device).  (a) the bench's
# configuration, (b) BASELINE.json config 5's B with the sampling and true
# wrench of tests/test_sharding.py's 32k sweep (its bound on |f_batch|).
SHARDED_RANKS, SHARDED_B, SHARDED_TICKS, SHARDED_CHUNK, SHARDED_SEED = 2, 256, 200, 10, 42
SWEEP_B, SWEEP_TICKS, SWEEP_F_MAX = 32768, 5, 60.0
SWEEP_K1_LANES = 256  # of a rank's 16,384, held against K1's plain version
SWEEP_SAMPLE = {"f_ext_std": 10.0, "f_ext_resample_std": 0.5}
SWEEP_F_TRUE = [8.0, 0.0, -12.0, 0.0, 0.0, 0.0]
# Phase 13: the recorded device rows (examples/record_runs.py --transport
# device) and their gates against the goldens: tracking mean and p95
# within 1.25x, wrench-estimate error p50 within 1.5x.
RECORDED_B, RECORDED_TICKS = (64, 1024), 3500
TRACKING_GATE, WRENCH_GATE = 1.25, 1.5
# Phase 14: the tools' lengths and the stage profile's gates.
TOOLS_TICKS, TOOLS_EFF_TICKS, PSCAN_CHAIN = 200, 100, 5
# The controller tick's host-side launches: the input copy, the graph's
# launch and PyTorch's two fills of the generator's seed and offset, the
# fetch.
CONTROLLER_HOST_LAUNCHES = 5
STAGE_SLACK, STAGE_GATE = 0.05, 0.25
# Phase 15: the sweep's horizon, and the lanes of its largest batch held
# against K1's plain version.
BENCH_SWEEP_N, BENCH_SWEEP_LANES = 32, 256
# Phase 16: K1's horizons past one block, and the long-horizon loop's
# horizon and ticks.
LONG_K1_N, LONG_N, LONG_TICKS, PERIOD_US = (256, 512), 256, 200, 10_000.0


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events).
    The calls queue behind a device sleep of about 55 ms, so a launch whose
    host side takes longer than its kernel is timed by the kernel."""
    import torch

    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_sqp(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
    from indy7_mpc_tpu_torch.roofline import bound_ms, k1_work
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    sm = LR.static_model(indy7(torch.float32, dev))
    args, w = measure.k1_inputs(dev, B, N)
    kw = dict(wrench=w)
    err = check_k1_call("K1", K1.sqp_solve(sm, cost, sqp, DT, *args, **kw),
                        solve_lane_major(sm, cost, sqp, DT, *args, **kw))
    ms = cuda_ms(lambda: K1.sqp_solve(sm, cost, sqp, DT, *args, **kw), 100)
    stage_ms = [cuda_ms(lambda: K1.sqp_solve(sm, cost, sqp, DT, *args, **kw, stages=st), 100)
                for st in (1, 2, 3)] + [ms]
    plain_ms = cuda_ms(lambda: solve_lane_major(sm, cost, sqp, DT, *args, **kw), 2)
    flops, nbytes = k1_work(B, N, cost, sqp, use_wrench=True)
    bound, bound_by = bound_ms(flops, nbytes)
    print(f"K1 sqp_solve B={B} N={N}: kernel {ms * 1e3:.1f} us/solve, "
          f"plain {plain_ms * 1e3:.1f} us/solve, max |X,U err| {err:.3e}, "
          f"alphas equal on all {B} lanes; cumulative by stage (us) "
          + ", ".join(f"1-{i + 1} {t * 1e3:.1f}" for i, t in enumerate(stage_ms))
          + f"; bound {bound * 1e3:.2f} us ({bound_by}, {flops} flop), "
          f"{K1.THREADS} threads, {K1.shared_bytes(N)} bytes of shared memory", flush=True)
    return {"name": "sqp_solve", "route": "cuda",
            "source": "indy7_mpc_tpu_torch/csrc/sqp_kernel.cu",
            "replaces": "indy7_mpc_tpu/ops/pallas/sqp_kernel.py:251",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "threads": K1.THREADS,
            "smem_bytes": K1.shared_bytes(N),
            "stage_ms": stage_ms}


def check_k1_call(label, k, p, converged=False):
    """K1's outputs ``k`` against its plain version's ``p`` on the same
    inputs (``sqp_solve``'s lane-major (X, U, rho, alphas, ...)) at phase
    3's gates: the line-search alphas equal on every lane, X and U finite
    and within 6e-3 after scaling each lane by max(1, max |value|).
    With ``converged`` (a solve at the fixed point of a long warm-started
    chain, where accepting a step or not is decided by float32 rounding:
    the kernel's step norm there is 0) the lanes whose alphas differ are
    counted and printed instead, and X and U are held on every lane all
    the same.  Returns the max abs error."""
    import numpy as np
    import torch

    torch.cuda.synchronize()
    k_alpha, p_alpha = k[3].cpu().numpy(), p[3].cpu().numpy()
    bad = np.nonzero((k_alpha != p_alpha).any(axis=0))[0]
    if converged:
        print(f"{label}: alphas differ on {bad.size} of {k_alpha.shape[1]} lanes at the "
              "chain's fixed point", flush=True)
    else:
        check(bad.size == 0, f"{label} alphas differ on lanes {bad.tolist()}: "
              f"kernel {k_alpha[:, bad].tolist()} plain {p_alpha[:, bad].tolist()}")
    err = 0.0
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        check(bool(torch.isfinite(a).all()), f"{label} output not finite")
        scale = b.abs().amax(dim=(0, 1)).clamp(min=1.0)
        scaled = ((a - b).abs() / scale).max().item()
        check(scaled <= 6e-3, f"{label} X/U scaled error {scaled:.3e} > 6e-3")
        err = max(err, (a - b).abs().max().item())
    return err


def phase_tick(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, SampleConfig
    from indy7_mpc_tpu_torch.measure import ptxas_lines
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import _build
    from indy7_mpc_tpu_torch.ops.kernels import tick_kernel as K2
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import (
        tick_epilogue, tick_epilogue_plain,
    )
    from indy7_mpc_tpu_torch.roofline import bound_ms, k2_work
    from indy7_mpc_tpu_torch.sim.plant import perturb_model

    cfg = PERTURBED_PLANT
    model = indy7(torch.float32, dev)
    smc = LR.static_model(model)
    smp = LR.static_model(perturb_model(model, cfg))
    rng = np.random.default_rng(2)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    x_cur = np.r_[INIT_Q, 0.1 * np.ones(6)]
    f_batch = rng.normal(size=(6, B)) * SampleConfig().f_ext_std
    f_batch[3:] = 0.0
    f_batch[:, 0] = 0.0
    args = (
        f32(x_cur), f32(x_cur + 0.01 * rng.normal(size=12)),
        f32(5.0 * rng.normal(size=6)), f32(f_batch),
        f32(3.0 * rng.normal(size=(6, B))), f32(F_TRUE0),
        f32(cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6))),
    )
    best, err = check_k2_call("K2", smc, smp, cfg, args)
    ms = cuda_ms(lambda: tick_epilogue(smc, smp, cfg, DT, *args), 50)
    plain_ms = cuda_ms(lambda: tick_epilogue_plain(smc, smp, cfg, DT, *args), 3)
    flops, nbytes = k2_work(B, cfg.substeps, bool(cfg.viscous_friction or cfg.coulomb_friction),
                            True, cfg.velocity_saturation)
    bound, bound_by = bound_ms(flops, nbytes)
    chain = 4 * (1 + cfg.substeps)
    ptxas = ptxas_lines(_build.build_log(), "tick_kernel")
    print(f"K2 tick_epilogue B={B}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
          f"max abs err {err:.3e}, winner {best}; bound {bound * 1e3:.3f} us "
          f"({bound_by}, {flops} flop), latency floor a chain of {chain} forward-dynamics "
          f"calls; {K2.THREADS} threads in teams of 8; ptxas: "
          + " | ".join(ptxas), flush=True)
    return {"name": "tick_epilogue", "route": "cuda",
            "source": "indy7_mpc_tpu_torch/csrc/tick_kernel.cu",
            "replaces": "indy7_mpc_tpu/ops/pallas/tick_kernel.py:140",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": None, "threads": K2.THREADS,
            "fd_chain": chain, "ptxas": ptxas}


def check_k2_call(label, smc, smp, cfg, args, plant=True):
    """K2 and its plain version on the same arguments (those after
    ``(smc, smp, cfg, dt)``) at phase 4's tolerances: winner equal, err
    rtol 1e-3 / atol 1e-5, x_next atol 2e-3 (None on both sides with
    ``plant=False``), u and f_est to rtol 1e-7, eep atol 1e-5.  Returns
    (winner, max abs error)."""
    k, err = k2_against_plain(label, smc, smp, cfg, args, plant)
    return int(k.best), err


def k2_against_plain(label, smc, smp, cfg, args, plant=True):
    """:func:`check_k2_call`, returning K2's outputs and the max abs error."""
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import PlantConfig
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import (
        tick_epilogue, tick_epilogue_plain,
    )

    k = tick_epilogue(smc, smp, cfg, DT, *args, plant=plant)
    p = tick_epilogue_plain(smc, smp, cfg or PlantConfig(), DT, *args, plant=plant)
    torch.cuda.synchronize()
    np_ = lambda t: t.cpu().numpy()
    check(int(k.best) == int(p.best), f"{label}: winner {int(k.best)} != plain {int(p.best)}")
    fields = ("err", "x_next", "u", "eep", "f_est") if plant else ("err", "u", "eep", "f_est")
    if not plant:
        check(k.x_next is None and p.x_next is None, f"{label}: x_next without the plant")
    try:
        np.testing.assert_allclose(np_(k.err), np_(p.err), rtol=1e-3, atol=1e-5)
        if plant:
            np.testing.assert_allclose(np_(k.x_next), np_(p.x_next), atol=2e-3)
        np.testing.assert_allclose(np_(k.u), np_(p.u))
        np.testing.assert_allclose(np_(k.f_est), np_(p.f_est))
        np.testing.assert_allclose(np_(k.eep), np_(p.eep), atol=1e-5)
    except AssertionError as e:
        raise SmokeFailure(f"{label}: disagrees with its plain version: {e}")
    for f in fields:
        check(bool(torch.isfinite(getattr(k, f)).all()), f"{label}: {f} not finite")
    err = max((getattr(k, f) - getattr(p, f)).abs().max().item() for f in fields)
    return k, err


def phase_main_path(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import init_loop_carry, make_loop_tick, run_sampled_mpc

    ref, x0 = fig8_reference(), initial_state(dev)
    model = indy7(torch.float32, dev)
    cfgs = (CostConfig(), SQPConfig(max_iters=SQP_ITERS), MPCConfig(N=N, dt=DT),
            SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0))
    run = lambda ticks, gen: run_sampled_mpc(model, *cfgs, x0, ref, ticks, F_TRUE0, gen,
                                             plant_cfg=PERTURBED_PLANT)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, trace = run(TICKS, torch.Generator(device=dev).manual_seed(42))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for name, n in launches.items():
        check(n == TICKS, f"{name} launched {n} times in {TICKS} ticks")
    for name, v in trace._asdict().items():
        check(v.shape[0] == TICKS, f"trace {name} has {v.shape[0]} rows")
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"trace {name} not finite")
    te = trace.tracking_error.cpu().numpy().astype(np.float64)
    tail = te[-100:].mean()
    print(f"main path run_sampled_mpc B={B} N={N} perturbed plant, {TICKS} ticks (the first "
          f"eager, the rest replayed CUDA graphs): {wall / TICKS * 1e6:.1f} us/tick (host "
          f"clock, first tick and the capture included); tracking error mean {te.mean():.4f} m, "
          f"p50 {np.percentile(te, 50):.4f} m, p95 {np.percentile(te, 95):.4f} m, last-100 mean "
          f"{tail:.4f} m", flush=True)
    check(tail < 0.2, f"last-100 tracking error {tail:.4f} m >= 0.2 m")

    # The graphs against the eager loop over the same tick module: the main
    # path's first GRAPH_TICKS rows, and a run of that length (its carry and
    # the generator after it), bit for bit.
    gen = torch.Generator(device=dev).manual_seed(42)
    tick = make_loop_tick(model, *cfgs, torch.as_tensor(ref, dtype=torch.float32, device=dev),
                          plant_cfg=PERTURBED_PLANT, generator=gen)
    carry, rows = init_loop_carry(model, cfgs[2], cfgs[3], x0, F_TRUE0, gen), []
    for _ in range(GRAPH_TICKS):
        carry, row = tick(carry)
        rows.append(row)
    gen_g = torch.Generator(device=dev).manual_seed(42)
    carry_g, trace_g = run(GRAPH_TICKS, gen_g)
    for name, v in trace._asdict().items():
        want = torch.stack([getattr(r, name) for r in rows])
        check(torch.equal(v[:GRAPH_TICKS], want) and torch.equal(getattr(trace_g, name), want),
              f"graphed trace {name} differs from the eager loop's in {GRAPH_TICKS} ticks")
    for name, a, b in zip(carry._fields, carry_g, carry):
        check(torch.equal(a, b), f"graphed carry {name} differs from the eager loop's")
    check(torch.equal(gen_g.get_state(), gen.get_state()),
          "the generator after the graphed ticks differs from the eager loop's")
    print(f"graphed vs eager loop: trace, carry and generator state equal bit for bit over "
          f"{GRAPH_TICKS} ticks", flush=True)

    timing = {}
    for lanes in GRAPH_LANES:
        timing[lanes] = modes = measure.loop_modes(dev, lanes, GRAPH_CHUNK)
        host = modes["graphed"]["host_launches_per_tick"]
        check(0 < host <= 2, f"B={lanes}: the graphed loop issues {host:.2f} host-side launches "
              f"a tick over {GRAPH_CHUNK} ticks, want (0, 2]")
    print(f"device loop, eager against graphed: {card_line()}", flush=True)
    return launches, timing


def phase_long_horizon(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import init_loop_carry, make_loop_tick, run_sampled_mpc
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import _build
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
    from indy7_mpc_tpu_torch.roofline import bound_ms, k1_work
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    sm = LR.static_model(indy7(torch.float32, dev))
    ptxas = measure.ptxas_lines(_build.build_log(), "sqp_kernelILb1")
    check(bool(ptxas), "no ptxas line for the cluster kernel sqp_kernel<true>")
    print("K1 cluster kernel ptxas: " + " | ".join(ptxas), flush=True)
    rows = []
    for horizon in LONG_K1_N:
        cluster, smem = K1.check_horizon(horizon, sqp.num_alphas)
        check(cluster > 1, f"N={horizon} should take a cluster, got {cluster} block")
        args, w = measure.k1_inputs(dev, B, horizon)
        kw = dict(wrench=w)
        err = check_k1_call(f"K1 N={horizon}", K1.sqp_solve(sm, cost, sqp, DT, *args, **kw),
                            solve_lane_major(sm, cost, sqp, DT, *args, **kw))
        ms = cuda_ms(lambda: K1.sqp_solve(sm, cost, sqp, DT, *args, **kw), 20)
        plain_ms = cuda_ms(lambda: solve_lane_major(sm, cost, sqp, DT, *args, **kw), 1)
        flops, nbytes = k1_work(B, horizon, cost, sqp, use_wrench=True)
        bound, bound_by = bound_ms(flops, nbytes)
        rows.append({"N": horizon, "B": B, "cluster": cluster, "smem_bytes": smem, "ms": ms,
                     "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                     "share_of_bound": bound / ms, "max_abs_err": err})
        print(f"K1 sqp_solve B={B} N={horizon}: {cluster} blocks a lane of {smem} bytes of shared "
              f"memory; kernel {ms * 1e3:.1f} us/solve, plain {plain_ms * 1e3:.1f} us/solve, max "
              f"|X,U err| {err:.3e}, alphas equal on all {B} lanes; bound {bound * 1e3:.2f} us "
              f"({bound_by}), {100 * bound / ms:.3f}% of it", flush=True)

    ref, x0 = fig8_reference(), initial_state(dev)
    model = indy7(torch.float32, dev)
    cfgs = (cost, sqp, MPCConfig(N=LONG_N, dt=DT),
            SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0))
    run = lambda ticks, gen: run_sampled_mpc(model, *cfgs, x0, ref, ticks, F_TRUE0, gen,
                                             plant_cfg=PERTURBED_PLANT)
    reset_counts()
    torch.cuda.synchronize()
    _, trace = run(LONG_TICKS, torch.Generator(device=dev).manual_seed(42))
    torch.cuda.synchronize()
    launches = read_counts()
    for name, n in launches.items():
        check(n == LONG_TICKS, f"N={LONG_N}: {name} launched {n} times in {LONG_TICKS} ticks")
    for name, v in trace._asdict().items():
        check(v.shape[0] == LONG_TICKS, f"N={LONG_N}: trace {name} has {v.shape[0]} rows")
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"N={LONG_N}: trace {name} not finite")
    te = trace.tracking_error.cpu().numpy().astype(np.float64)
    tail = te[-100:].mean()
    check(tail < 0.2, f"N={LONG_N}: last-100 tracking error {tail:.4f} m >= 0.2 m")
    gen = torch.Generator(device=dev).manual_seed(42)
    tick = make_loop_tick(model, *cfgs, torch.as_tensor(ref, dtype=torch.float32, device=dev),
                          plant_cfg=PERTURBED_PLANT, generator=gen)
    carry, rows_e = init_loop_carry(model, cfgs[2], cfgs[3], x0, F_TRUE0, gen), []
    for _ in range(GRAPH_TICKS):
        carry, row = tick(carry)
        rows_e.append(row)
    for name, v in trace._asdict().items():
        want = torch.stack([getattr(r, name) for r in rows_e])
        check(torch.equal(v[:GRAPH_TICKS], want),
              f"N={LONG_N}: graphed trace {name} differs from the eager loop's")
    modes = measure.loop_modes(dev, B, GRAPH_CHUNK, N=LONG_N)
    us = modes["graphed"]["us_per_tick"]
    print(f"run_sampled_mpc B={B} N={LONG_N} perturbed plant, {LONG_TICKS} ticks graphed: "
          f"tracking error mean {te.mean():.4f} m, last-100 mean {tail:.4f} m; K1 and K2 "
          f"once a tick; the first {GRAPH_TICKS} rows equal the eager loop's bit for bit; "
          f"graphed {us:.1f} us a tick ({100 * us / PERIOD_US:.1f}% of the 10 ms period), eager "
          f"{modes['eager']['us_per_tick']:.1f}; {card_line()}", flush=True)
    return launches, {"k1": rows, "ptxas": ptxas, "loop": modes,
                      "tracking_last100_m": float(tail)}


def reset_counts():
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue

    sqp_solve.launches = 0
    tick_epilogue.launches = 0


def read_counts():
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue

    return {"sqp_solve": sqp_solve.launches, "tick_epilogue": tick_epilogue.launches}


def check_recording(rec, name, ticks_min, tail_max, f_err_p50_max=50.0):
    """Every recorded array finite, enough ticks, the last-100 tracking
    under ``tail_max`` and the wrench-estimate error's p50 under
    ``f_err_p50_max`` N (a plant that never got the [-60, 20, -40] N wrench
    shows about its 74.8 N); prints the tick times, tracking and wrench
    error."""
    import numpy as np

    arrays = {k: rec._fetch(k) for k in rec.ARRAYS + rec.EXTRA_ARRAYS}
    te, st = arrays["tracking_errors"], arrays["solve_times"]
    check(te.shape[0] >= ticks_min, f"{name}: {te.shape[0]} ticks recorded, want {ticks_min}")
    for k, a in arrays.items():
        check(a.shape[0] == te.shape[0], f"{name}: {k} has {a.shape[0]} rows")
        check(bool(np.isfinite(a).all()), f"{name}: recorded {k} not finite")
    tail = te[-100:].mean()
    f_err = np.linalg.norm(arrays["f_est"][:, :3] - arrays["f_true"][:, :3], axis=1)
    print(f"{name}: {te.shape[0]} ticks; controller tick (host clock, us) "
          f"p50 {np.percentile(st, 50):.1f}, p95 {np.percentile(st, 95):.1f}, "
          f"max {st.max():.1f}; tracking error mean {te.mean():.4f} m, "
          f"p50 {np.percentile(te, 50):.4f} m, p95 {np.percentile(te, 95):.4f} m, "
          f"last-100 mean {tail:.4f} m; wrench estimate error p50 "
          f"{np.percentile(f_err, 50):.2f} N, p95 {np.percentile(f_err, 95):.2f} N",
          flush=True)
    check(tail < tail_max, f"{name}: last-100 tracking error {tail:.4f} m >= {tail_max} m")
    f_p50 = np.percentile(f_err, 50)
    check(f_p50 < f_err_p50_max,
          f"{name}: wrench estimate error p50 {f_p50:.2f} N >= {f_err_p50_max} N")


def phase_runtime_inprocess(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc.fused_tick import consensus_args
    from indy7_mpc_tpu_torch.runtime import InProcessPlant, RunRecorder, run_control_loop
    from indy7_mpc_tpu_torch.sim.kernel_plant import kernel_plant_args
    from indy7_mpc_tpu_torch.sim.readable_plant import make_plant_step

    reset_counts()
    t0 = time.perf_counter()
    ctl = measure.runtime_controller(dev)
    init_s = time.perf_counter() - t0
    x0 = initial_state(dev)
    # The plant lives on the card too: one K2 launch per command.
    plant = InProcessPlant(indy7(torch.float32), x0, DT, plant_cfg=PERTURBED_PLANT)
    rec = RunRecorder(save_interval=1e9)  # kept in memory, never saved
    t0 = time.perf_counter()
    rec = run_control_loop(ctl, plant, duration=1e9, rate_hz=100.0, recorder=rec,
                           walk_disturbance=True, realtime=False, max_ticks=TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    print(f"runtime in process: controller built (warm-up tick) in {init_s:.1f} s; "
          f"{TICKS} ticks in {wall:.1f} s with the plant on the card; "
          f"launches {launches}", flush=True)
    want = {"sqp_solve": TICKS + 1, "tick_epilogue": 2 * TICKS + 1}
    check(launches == want, f"runtime in process: launches {launches} in {TICKS} ticks "
          f"+ warm-up, want {want} (K2 is the consensus and the plant step)")
    check_recording(rec, "runtime in process", TICKS, 0.2)

    # K2's two calls of this phase against the plain version, on the run's
    # last state: the controller's consensus (B=64, its own model, no plant
    # config, zero true wrench, the plant step skipped) and the plant's
    # step (B=1, the perturbed plant with its wrench and actuation noise).
    (smc,) = ctl._tick.sampled.static_models(torch.float32)
    gen = torch.Generator(device=dev).manual_seed(3)
    U0_T = 3.0 * torch.randn((6, ctl.f_batch.shape[0]), generator=gen, device=dev)
    best, c_err = check_k2_call("K2 as the consensus", smc, smc, None, consensus_args(
        plant.x, ctl.x_last, ctl.u_last, ctl.f_batch.T.contiguous(), U0_T), plant=False)
    normals = torch.randn((PERTURBED_PLANT.substeps, 6), generator=gen, device=dev)
    k2, p_err = k2_against_plain("K2 as the plant step", plant._sm_nominal, plant._sm,
                                 PERTURBED_PLANT, kernel_plant_args(
                                     plant.x, ctl.u_last, plant.wrench,
                                     PERTURBED_PLANT.torque_noise_std * normals))
    # The readable plant's public step on the same tick, against K2's.
    _, step_fn = make_plant_step(indy7(torch.float32, dev), PERTURBED_PLANT)
    x_next = step_fn(plant.x, ctl.u_last, plant.wrench, normals, DT)
    check(bool(torch.isfinite(x_next).all()), "make_plant_step: x_next not finite")
    mps_err = (x_next - k2.x_next.reshape(x_next.shape)).abs().max().item()
    check(mps_err <= 2e-3, f"make_plant_step vs K2's plant step: max abs err {mps_err:.3e} "
          f"> 2e-3")
    print(f"K2 as the consensus B={U0_T.shape[1]}: winner {best}, max abs err {c_err:.3e}; "
          f"as the perturbed plant's step B=1: max abs err {p_err:.3e}; "
          f"make_plant_step(PERTURBED_PLANT) f32 vs K2's x_next: max abs err {mps_err:.3e}",
          flush=True)
    # The controller tick eager (its ControllerTick called directly) and
    # graphed (on_state), in turns on a fresh controller.
    timing = measure.controller_timing(dev)
    print(f"controller tick, eager against graphed: {card_line()}", flush=True)
    return launches, timing


def phase_runtime_udp(dev):
    import numpy as np

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.runtime import RunRecorder, UdpTransport, run_control_loop
    from indy7_mpc_tpu_torch.sim import native

    t0 = time.perf_counter()
    node = native.plant_node_path()
    print(f"native plant built in {time.perf_counter() - t0:.1f} s: {node}", flush=True)
    reset_counts()
    ctl = measure.runtime_controller(dev)
    plant_port, ctl_port = UDP_PORTS
    # The flags examples/record_runs.py derives from PERTURBED_PLANT.
    proc = subprocess.Popen(
        [node, str(DT / 5), "5", "--perturb", "0.04", "7", "--friction", "0.05", "0.1",
         "--noise", "0.1", "--realtime-scale", str(REALTIME_SCALE),
         "--ports", str(plant_port), str(ctl_port)],
        stdout=subprocess.DEVNULL,
    )
    transport = None
    try:
        transport = UdpTransport(plant_addr=("127.0.0.1", plant_port),
                                 listen_addr=("127.0.0.1", ctl_port))
        # The plant's first state: it is bound, so the loop's first wrench
        # reaches it.
        transport.wait_for_state(timeout=30.0)
        rec = RunRecorder(save_interval=1e9)
        t0 = time.perf_counter()
        rec = run_control_loop(ctl, transport, duration=600, rate_hz=100.0 / REALTIME_SCALE,
                               recorder=rec, walk_disturbance=True, realtime=True,
                               max_ticks=UDP_TICKS)
        wall = time.perf_counter() - t0
        check(proc.poll() is None, f"plant_node exited with {proc.returncode}")
    finally:
        if transport is not None:
            transport.close()
        proc.kill()
        proc.wait()
    launches = read_counts()
    ticks = len(rec._data["dts"])
    for name, n in launches.items():
        check(n == ticks + 1, f"runtime over UDP: {name} launched {n} times in "
              f"{ticks} ticks + warm-up")
    dts = np.asarray(rec._data["dts"])
    print(f"runtime over UDP: {ticks} ticks in {wall:.1f} s of wall clock; control "
          f"period in plant time mean {dts.mean() * 1e3:.2f} ms, p50 "
          f"{np.percentile(dts, 50) * 1e3:.2f} ms, max {dts.max() * 1e3:.2f} ms; "
          f"launches {launches}", flush=True)
    check_recording(rec, "runtime over UDP", 250, 0.3)
    return launches


def phase_point_to_goal(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, PlantConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import run_mpc
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.roofline import bound_ms, k1_work
    from indy7_mpc_tpu_torch.sim.kernel_plant import kernel_plant_args
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    cost, sqp = CostConfig(), SQPConfig(max_iters=P2G_ITERS)
    model = indy7(torch.float32, dev)
    sm = LR.static_model(model)

    # K1 at the single-lane shape against its plain version.
    rng = np.random.default_rng(12)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    args = (f32(np.r_[INIT_Q, np.zeros(6)][:, None]),
            f32(np.tile([[0.3], [0.3], [0.6]], (P2G_N, 1, 1))),
            f32(rng.normal(size=(P2G_N, 12, 1)) * 0.05),
            f32(rng.normal(size=(P2G_N - 1, 6, 1)) * 0.5))
    k = sqp_solve(sm, cost, sqp, DT, *args)
    p = solve_lane_major(sm, cost, sqp, DT, *args)
    check(bool((k[3] == p[3]).all()), f"K1 B=1 alphas {k[3].tolist()} != plain {p[3].tolist()}")
    err = 0.0
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        check(bool(torch.isfinite(a).all()), "K1 B=1 output not finite")
        scaled = ((a - b).abs() / b.abs().max().clamp(min=1.0)).max().item()
        check(scaled <= 6e-3, f"K1 B=1 X/U scaled error {scaled:.3e} > 6e-3")
        err = max(err, (a - b).abs().max().item())
    ms = cuda_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args), 100)
    plain_ms = cuda_ms(lambda: solve_lane_major(sm, cost, sqp, DT, *args), 2)
    bound, bound_by = bound_ms(*k1_work(1, P2G_N, cost, sqp, use_wrench=False))
    print(f"K1 sqp_solve B=1 N={P2G_N} {P2G_ITERS} iterations: kernel {ms * 1e3:.1f} us, "
          f"plain {plain_ms * 1e3:.1f} us, max |X,U err| {err:.3e}; bound "
          f"{bound * 1e3:.3f} us ({bound_by})", flush=True)

    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    ee0 = torch.stack(LR.ee_pos(sm, list(x0[:6]))).cpu().numpy()
    goals = np.stack([ee0 + [0.10, -0.10, -0.10], ee0 + [-0.15, 0.05, -0.20],
                      ee0 + [0.05, 0.15, -0.05]])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, trace = run_mpc(model, cost, sqp, MPCConfig(N=P2G_N, dt=DT), x0, goals, P2G_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    want = {"sqp_solve": P2G_STEPS + 1, "tick_epilogue": P2G_STEPS}
    check(launches == want, f"run_mpc launches {launches}, want {want}")
    for name, v in trace._asdict().items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"run_mpc trace {name} not finite")
    gidx = trace.goal_idx.cpu().numpy()
    switches = int((np.diff(gidx) != 0).sum())
    d = trace.goal_dist.cpu().numpy()
    print(f"run_mpc N={P2G_N} {P2G_ITERS} iterations, {P2G_STEPS} steps: "
          f"{wall / P2G_STEPS * 1e3:.2f} ms/step (host clock); goal distance first "
          f"{d[0]:.4f} m, min {d.min():.4f} m, last {d[-1]:.4f} m; {switches} goal "
          f"switches; alive {bool(final.alive)}; launches {launches}", flush=True)
    check(switches >= 1, "run_mpc: no goal switch")
    check(bool(final.alive), "run_mpc: diverged (alive is false)")

    # K2 as run_mpc's plant step (B=1, the nominal one-substep plant, no
    # wrench) against its plain version, from the run's last state and
    # control.
    cfg = PlantConfig(substeps=MPCConfig(N=P2G_N, dt=DT).sim_substeps)
    _, k2_err = check_k2_call("K2 as run_mpc's plant step", sm, sm, cfg,
                              kernel_plant_args(final.x, trace.u[-1]))
    print(f"K2 as run_mpc's plant step B=1: max abs err {k2_err:.3e}", flush=True)

    # Both single-lane loops graphed against their eager loops, replayed
    # without a host sync, and timed eager and graphed in turns.
    counts, graphs = {}, {}
    for loop in ("run_mpc", "run_tracking_mpc"):
        counts[loop], graphs[loop] = single_lane_graphs(dev, loop)
    counts["run_mpc"] = {k: n + counts["run_mpc"][k] for k, n in launches.items()}
    return counts, {"B": 1, "N": P2G_N, "iters": P2G_ITERS, "max_abs_err": err,
                    "ms": ms, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
                    "share_of_bound": bound / ms}, graphs


def tree_leaves(tree):
    import torch

    if tree is None or isinstance(tree, torch.Tensor):
        return [] if tree is None else [tree]
    return [v for t in tree for v in tree_leaves(t)]


def check_same_bits(label, trace, rows, carry=None, want_carry=None):
    """A graphed run's stacked trace against the eager loop's rows, and its
    final carry against the eager one, bit for bit."""
    import torch

    for f in trace._fields:
        check(torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])),
              f"{label}: graphed trace {f} differs from the eager loop's")
    if carry is not None:
        got, want = tree_leaves(carry), tree_leaves(want_carry)
        check(len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want)),
              f"{label}: graphed final carry differs from the eager loop's")


def replay_without_sync(label, replay):
    """``replay()`` (ticks that replay captured graphs only) under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronizing operation."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    except RuntimeError as e:
        raise SmokeFailure(f"{label}: a replayed tick synchronizes with the host: {e}")
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def single_lane_graphs(dev, loop):
    """``run_mpc`` / ``run_tracking_mpc`` (measure.single_lane_loop's
    configuration) for GRAPH_TICKS ticks, graphed, against a Python loop
    over its tick: trace and final carry bit for bit, K1 and K2 once a tick
    (run_mpc's warm-up solve one K1 more); then GRAPH_TICKS replayed ticks
    of a runner of the same tick under sync-debug "error"; last, the eager
    and the graphed loop in turns, GRAPH_CHUNK ticks a run."""
    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.mpc.graphed import TickRunner

    make, run = measure.single_lane_loop(dev, loop)
    tick, carry = make()
    rows = []
    for _ in range(GRAPH_TICKS):
        carry, row = tick(carry)
        rows.append(row)
    reset_counts()
    final, trace = run(GRAPH_TICKS)
    launches = read_counts()
    warm = int(loop == "run_mpc")
    want = {"sqp_solve": GRAPH_TICKS + warm, "tick_epilogue": GRAPH_TICKS}
    check(launches == want, f"{loop} graphed: launches {launches}, want {want}")
    check_same_bits(f"{loop} graphed", trace, rows, final, carry)
    runner = TickRunner(*make(), GRAPH_TICKS)
    runner.run(2)
    replay_without_sync(f"{loop} graphed", lambda: runner.run(GRAPH_TICKS))
    timing = measure.single_lane_modes(dev, loop, GRAPH_CHUNK)
    host = timing["graphed"]["host_launches_per_tick"]
    check(0 < host <= 2, f"{loop}: the graphed loop issues {host:.2f} host-side launches a "
          f"tick over {GRAPH_CHUNK} ticks, want (0, 2]")
    print(f"{loop} graphed vs eager: trace and final carry equal bit for bit over "
          f"{GRAPH_TICKS} ticks, launches {launches}, {GRAPH_TICKS} replayed ticks without a "
          f"host sync; eager {timing['eager']['us_per_tick'] / 1e3:.4f} ms/step, graphed "
          f"{timing['graphed']['us_per_tick'] / 1e3:.4f} ms/step (CUDA events); "
          f"{card_line()}", flush=True)
    return launches, timing


def fig8_reference():
    from indy7_mpc_tpu_torch.mpc import reference

    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=1), 200)
    check(ref.shape[0] >= TICKS + N, "reference too short")
    return ref


def initial_state(dev):
    import torch

    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    return x0


def phase_readable(dev):
    import logging

    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import draw_tick, init_loop_carry, run_sampled_mpc, sampled_tick
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
    from indy7_mpc_tpu_torch.solvers import sqp as readable

    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    model = indy7(torch.float32, dev)
    sm = LR.static_model(model)
    args, w = measure.k1_inputs(dev, B, N)
    # Lane-major K1 inputs -> the readable solver's B-major ones.
    bmajor = [args[0].T] + [a.permute(2, 0, 1) for a in args[1:]] + [w.T]

    # 1. The readable solve in f32 against K1 on the same inputs.
    k = K1.sqp_solve(sm, cost, sqp, DT, *args, wrench=w)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r = readable.batch_solve(model, cost, sqp, DT, *bmajor[:4], wrench_world_batch=bmajor[4])
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0
    k_alpha, r_alpha = k[3].T.cpu().numpy(), r.stats.alphas.cpu().numpy()
    flips = np.nonzero((k_alpha != r_alpha).any(axis=1))[0]
    for lane in flips:
        print(f"readable vs K1: lane {lane} alphas flip (f32 rounding): readable "
              f"{r_alpha[lane].tolist()}, K1 {k_alpha[lane].tolist()}", flush=True)
    check(flips.size <= MAX_FLIPS, f"readable vs K1: {flips.size} of {B} lanes flip an alpha "
          f"(at most {MAX_FLIPS})")
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(flips, dtype=torch.long, device=dev)] = False
    err = 0.0
    for kt, rt in ((k[0].permute(2, 0, 1), r.X), (k[1].permute(2, 0, 1), r.U)):
        check(bool(torch.isfinite(rt).all()), "readable f32 solve not finite")
        scale = rt.abs().amax(dim=(1, 2)).clamp(min=1.0)
        scaled = ((kt - rt).abs() / scale[:, None, None])[keep].max().item()
        check(scaled <= 6e-3, f"readable vs K1: X/U scaled error {scaled:.3e} > 6e-3")
        err = max(err, (kt - rt)[keep].abs().max().item())

    # 2. The same solve in f64, on the card and on the CPU.
    a64 = [a.double() for a in bmajor]
    t0 = time.perf_counter()
    g64 = readable.batch_solve(indy7(torch.float64, dev), cost, sqp, DT, *a64[:4],
                               wrench_world_batch=a64[4])
    torch.cuda.synchronize()
    solve64_s = time.perf_counter() - t0
    c64 = readable.batch_solve(indy7(torch.float64), cost, sqp, DT, *(a.cpu() for a in a64[:4]),
                               wrench_world_batch=a64[4].cpu())
    check(np.array_equal(g64.stats.alphas.cpu().numpy(), c64.stats.alphas.numpy()),
          "readable f64: alphas differ between the card and the CPU")
    d64 = max((g.cpu() - c).abs().max().item() for g, c in ((g64.X, c64.X), (g64.U, c64.U)))
    check(d64 <= 1e-9, f"readable f64: card vs CPU differ by {d64:.3e} > 1e-9")
    print(f"readable batch_solve B={B} N={N} on the card: f32 {solve_s * 1e3:.1f} ms (host "
          f"clock, one call), max |X,U - K1| {err:.3e} on {int(keep.sum())} lanes, "
          f"{flips.size} lanes flipped; f64 {solve64_s * 1e3:.1f} ms, card vs CPU max "
          f"|X,U diff| {d64:.3e}", flush=True)

    # 3. The readable tick against the two-kernel tick, same carry, same draws.
    mcfg = MPCConfig(N=N, dt=DT)
    scfg = SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)
    gen = torch.Generator(device=dev).manual_seed(7)
    x0 = initial_state(dev)
    carry0 = init_loop_carry(model, mcfg, scfg, x0, F_TRUE0, gen)
    draws = [draw_tick(gen, scfg, PERTURBED_PLANT, dev, torch.float32)
             for _ in range(READABLE_TICKS)]
    ref = fig8_reference()

    def loop(ticks, fused):
        return run_sampled_mpc(model, cost, sqp, mcfg, scfg, x0, ref, ticks, F_TRUE0, None,
                               plant_cfg=PERTURBED_PLANT, carry0=carry0, draws=draws[:ticks],
                               fused=fused)[1]

    T = READABLE_TICKS
    runs = {}
    for name, fused in (("readable", False), ("two-kernel", "auto")):
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trace = loop(T, fused)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / T * 1e3
        counts = read_counts()
        want = 0 if fused is False else T
        check(all(n == want for n in counts.values()),
              f"{name} tick: launches {counts} in {T} ticks, want {want} each")
        for f, v in trace._asdict().items():
            if v.is_floating_point():
                check(bool(torch.isfinite(v).all()), f"{name} tick: trace {f} not finite")
        runs[name] = (trace, ms, counts)
    (tr, r_ms, _), (tf, f_ms, f_counts) = runs["readable"], runs["two-kernel"]
    check(int(tr.best_idx[0]) == int(tf.best_idx[0]),
          f"first tick's winner: readable {int(tr.best_idx[0])}, two-kernel {int(tf.best_idx[0])}")
    du = ((tr.u[0] - tf.u[0]).abs().max() / tf.u[0].abs().max().clamp(min=1.0)).item()
    check(du <= 6e-3, f"first tick's u: scaled difference {du:.3e} > 6e-3")
    te_r = tr.tracking_error.double().mean().item()
    te_f = tf.tracking_error.double().mean().item()
    same = int((tr.best_idx == tf.best_idx).sum())
    print(f"readable tick (fused=False) B={B} N={N} perturbed plant, {T} ticks (the first "
          f"eager, then replays of one-tick graphs): {r_ms:.1f} ms/tick (host clock, the first "
          f"tick and the capture included); two-kernel tick: {f_ms:.3f} ms/tick; first tick u "
          f"scaled diff {du:.3e}; winners equal on {same} of {T} ticks; mean tracking error "
          f"readable {te_r:.4f} m, two-kernel {te_f:.4f} m", flush=True)
    check(abs(te_r - te_f) <= 0.1 * te_f, f"readable mean tracking {te_r:.4f} m not within "
          f"10% of the two-kernel run's {te_f:.4f} m")

    # 4. formulation="reference" is outside K1's coverage: the readable
    # solver, with the fallback warning.
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    log = logging.getLogger("indy7_mpc_tpu_torch.solvers.select")
    log.addHandler(handler)
    reset_counts()
    try:
        x, X_warm, U_warm, f_batch = x0, carry0.X_best, carry0.U_best, carry0.f_batch
        goals = torch.as_tensor(ref[:N], dtype=torch.float32, device=dev)
        for _ in range(3):
            out = sampled_tick(model, CostConfig(formulation="reference"), sqp, scfg, DT, gen,
                               x, x, torch.zeros(6, device=dev), goals, X_warm, U_warm, f_batch)
            for f, v in out._asdict().items():
                if v.is_floating_point():
                    check(bool(torch.isfinite(v).all()), f"reference tick: {f} not finite")
            X_warm, U_warm, f_batch = out.X_best, out.U_best, out.f_batch
    finally:
        log.removeHandler(handler)
    counts = read_counts()
    check(all(n == 0 for n in counts.values()), f"reference tick launched kernels: {counts}")
    check(len(records) == 3 and all("readable solver" in r.getMessage() for r in records),
          f"reference tick: {len(records)} fallback warnings, want 3")
    print(f"sampled_tick formulation='reference': 3 ticks on the readable solver, finite, "
          f"no kernel launch; warning: {records[0].getMessage() if records else None}",
          flush=True)
    # 5. The readable loop graphed against the eager one, its replays
    # without a host sync, both timed in turns; the same for the readable
    # controller tick (outside K1's coverage).
    modes = readable_graphs(dev, "riccati")
    ctl_counts, ctl_modes = readable_controller_graph(dev)
    loop9 = {"trace": tr, "ticks": T, "ms_per_tick": r_ms, "carry0": carry0, "draws": draws,
             "x0": x0, "ref": ref}
    return f_counts, loop9, {"ticks": T, "readable_ms_per_tick": r_ms, "two_kernel_ms_per_tick": f_ms,
                      "readable_modes": modes, "readable_controller_modes": ctl_modes,
                      "readable_controller_launches": ctl_counts,
                      "tracking_readable_m": te_r, "tracking_two_kernel_m": te_f,
                      "alpha_flips": int(flips.size), "solve_f32_ms": solve_s * 1e3,
                      "solve_f64_ms": solve64_s * 1e3, "f64_card_vs_cpu": d64}


def readable_graphs(dev, backend):
    """The readable loop on the QP backend ``backend`` (measure.fig8_loop's
    configuration at B, N, 2 SQP iterations): READABLE_CHECK_TICKS ticks
    graphed (``LoopTickRunner``, one tick a graph, as run_sampled_mpc runs
    it) against a Python loop over the same tick from a generator seeded
    alike: trace, carry and generator bit for bit, neither kernel launched;
    then two replayed ticks under sync-debug "error"; last, the eager and
    the graphed loop in turns, READABLE_MODE_TICKS ticks a run, with the
    graph's capture seconds and pool bytes (measure.readable_loop_modes)."""
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import SQPConfig
    from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner

    sqp = SQPConfig(max_iters=SQP_ITERS, qp_backend=backend)
    tick, carry = measure.fig8_loop(dev, B, N, sqp, fused=False)
    rows = []
    for _ in range(READABLE_CHECK_TICKS):
        carry, row = tick(carry)
        rows.append(row)
    tick_g, carry_g = measure.fig8_loop(dev, B, N, sqp, fused=False)
    runner = LoopTickRunner(tick_g, carry_g, READABLE_CHECK_TICKS, ticks_per_graph=1)
    reset_counts()
    trace = runner.run(READABLE_CHECK_TICKS)
    counts = read_counts()
    check(all(n == 0 for n in counts.values()), f"readable {backend} graphed: launches {counts}")
    check_same_bits(f"readable {backend}", trace, rows, runner.carry(), carry)
    check(torch.equal(tick_g.generator.get_state(), tick.generator.get_state()),
          f"readable {backend}: the generator after the graphed ticks differs from the eager "
          "loop's")
    replay_without_sync(f"readable {backend}", lambda: runner.run(2))
    modes = measure.readable_loop_modes(dev, B, N, READABLE_MODE_TICKS, backend)
    print(f"readable loop ({backend}) graphed vs eager: trace, carry and generator equal bit "
          f"for bit over {READABLE_CHECK_TICKS} ticks, 2 replayed ticks without a host sync; "
          f"eager {modes['eager']['us_per_tick'] / 1e3:.1f} ms/tick, graphed "
          f"{modes['graphed']['us_per_tick'] / 1e3:.1f} ms/tick (CUDA events), "
          f"{modes['graphed']['device_launches_per_tick']:.0f} device kernels a tick, capture "
          f"{modes['graphed']['capture_s']:.2f} s, pool {modes['graphed']['pool_bytes']} bytes; "
          f"{card_line()}", flush=True)
    return modes


def readable_controller_graph(dev):
    """A controller outside K1's coverage (formulation "reference": the
    readable tick) at B=8, N=16 captures its tick at warm-up: 5
    ``on_state`` calls (graph replays) against 5 eager calls of the same
    ``ControllerTick`` from a controller built alike: every output, the
    final state and the generator bit for bit, neither kernel launched;
    then 3 replays under sync-debug "error"; last, the readable controller
    at B=64, N=64 graphed and eager in turns, 5 ticks each
    (measure.controller_timing)."""
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import CostConfig, MPCConfig, SampleConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.runtime import SampledController

    ref = fig8_reference()
    make = lambda: SampledController(
        indy7(torch.float32), CostConfig(formulation="reference"), SQPConfig(max_iters=SQP_ITERS),
        MPCConfig(N=16, dt=DT), SampleConfig(batch_size=8, f_ext_std=20.0, f_ext_resample_std=1.0),
        ref, seed=5, f_ext_actual=F_TRUE0[:3], device=dev)
    ctl, ref_ctl = make(), make()
    check(ctl.runner.graph is not None, "the readable controller did not capture its tick")
    rng = np.random.default_rng(8)
    xs = [(np.r_[INIT_Q, np.zeros(6)] + 0.01 * rng.normal(size=12)).astype(np.float32)
          for _ in range(5)]
    reset_counts()
    got = []
    for x in xs:
        u, info = ctl.on_state(x, DT)
        got.append(np.r_[u, info["best_idx"], info["f_est"], info["ee_ref"], info["ee_pos"],
                         info["tracking_error"]].astype(np.float32))
    counts = read_counts()
    check(all(n == 0 for n in counts.values()), f"readable controller: launches {counts}")
    X, U, f = ref_ctl.X_best.clone(), ref_ctl.U_best.clone(), ref_ctl.f_batch.clone()
    x_last, u_last = None, ref_ctl.u_last.clone()
    for i, (x, g) in enumerate(zip(xs, got)):
        xd = torch.as_tensor(x, device=dev)
        x_last = xd if x_last is None else x_last
        out, host = ref_ctl._tick(i + 1, xd, x_last, u_last, X, U, f)
        check(np.array_equal(g, host.cpu().numpy()),
              f"readable controller: tick {i}'s outputs differ from the eager tick's")
        X, U, f, x_last, u_last = out.X_best, out.U_best, out.f_batch, xd, out.u
    for name, want in (("X_best", X), ("U_best", U), ("f_batch", f), ("x_last", x_last),
                       ("u_last", u_last)):
        check(torch.equal(getattr(ctl, name), want),
              f"readable controller: {name} differs from the eager tick's")
    check(torch.equal(ctl.generator.get_state(), ref_ctl.generator.get_state()),
          "readable controller: the generator differs from the eager tick's")
    replay_without_sync("readable controller",
                        lambda: [ctl.runner.graph.replay() for _ in range(3)])
    timing = measure.controller_timing(dev, warm=1, steady=5,
                                       cost_cfg=CostConfig(formulation="reference"))
    print(f"readable controller (formulation='reference') graphed vs eager: outputs, state and "
          f"generator equal bit for bit over 5 ticks at B=8 N=16, 3 replays without a host sync; "
          f"at B={B} N={N} p50 graphed {timing['graphed']['solve_time_us_p50'] / 1e3:.1f} ms, "
          f"eager {timing['eager']['solve_time_us_p50'] / 1e3:.1f} ms; {card_line()}", flush=True)
    return counts, timing


def phase_mjcf_plant(dev):
    import math

    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7_from_urdf, indy7_mjcf
    from indy7_mpc_tpu_torch.mpc import run_sampled_mpc
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import _abi
    from indy7_mpc_tpu_torch.sim.plant import perturb_model

    controller, plant = indy7_from_urdf(torch.float32, dev), indy7_mjcf(torch.float32, dev)
    smc = LR.static_model(controller)
    smp = LR.static_model(perturb_model(plant, PERTURBED_PLANT))
    consts = _abi.model_consts(smp)
    check(all(math.isinf(v) and v > 0 for v in consts.velocity_limit),
          "MJCF plant: the +inf velocity limits did not reach K2's constants")
    gen = torch.Generator(device=dev).manual_seed(42)
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, trace = run_sampled_mpc(
        controller, CostConfig(), SQPConfig(max_iters=SQP_ITERS), MPCConfig(N=N, dt=DT),
        SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0),
        initial_state(dev), fig8_reference(), TICKS, F_TRUE0, gen,
        plant_cfg=PERTURBED_PLANT, plant_model=plant,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    for name, n in launches.items():
        check(n == TICKS, f"MJCF plant: {name} launched {n} times in {TICKS} ticks")
    for name, v in trace._asdict().items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"MJCF plant: trace {name} not finite")
    te = trace.tracking_error.cpu().numpy().astype(np.float64)
    tail = te[-100:].mean()
    f_err = np.linalg.norm((trace.f_est - trace.f_true)[:, :3].cpu().numpy(), axis=1)
    print(f"URDF controller / MJCF plant run_sampled_mpc B={B} N={N} perturbed, {TICKS} ticks: "
          f"{wall / TICKS * 1e6:.1f} us/tick (host clock, first tick included); tracking "
          f"error mean {te.mean():.4f} m, p50 {np.percentile(te, 50):.4f} m, p95 "
          f"{np.percentile(te, 95):.4f} m, last-100 mean {tail:.4f} m; wrench estimate error "
          f"p50 {np.percentile(f_err, 50):.2f} N", flush=True)
    check(tail < 0.2, f"MJCF plant: last-100 tracking error {tail:.4f} m >= 0.2 m")

    U0_T = 3.0 * torch.randn((6, B), generator=gen, device=dev)
    noise = PERTURBED_PLANT.torque_noise_std * torch.randn(
        (PERTURBED_PLANT.substeps, 6), generator=gen, device=dev)
    best, k2_err = check_k2_call("K2 with the MJCF plant", smc, smp, PERTURBED_PLANT, (
        final.x, final.x_last, final.u_last, final.f_batch.T.contiguous(), U0_T,
        final.f_true, noise))
    print(f"K2 with the MJCF plant's constants B={B}: winner {best}, max abs err {k2_err:.3e}",
          flush=True)
    return launches


def lane_merits(model, cost, cfg, arrs, res=None):
    """Each lane's merit at the solve's result (``res``) or at its start:
    the warm start with the initial state pinned."""
    import torch

    from indy7_mpc_tpu_torch.solvers import sqp as readable

    xs, goals, X, U, w = arrs
    if res is None:
        X = torch.cat([xs[:, None], X[:, 1:]], 1)
    else:
        X, U = res.X, res.U
    return readable.merit(model, cost, cfg.merit_mu, X, U, goals, xs, DT, w)


def check_live_qp_iters(name, res, cap):
    """``pcg_iters`` populated: in (0, cap] on every iteration a lane ran
    while not done (its first ``iterations``), 0 after."""
    import torch

    its = res.stats.pcg_iters
    check(its is not None and its.dtype == torch.int32, f"{name}: pcg_iters missing")
    live = torch.arange(its.shape[1], device=its.device) < res.stats.iterations[:, None]
    check(bool(((its > 0) & (its <= cap))[live].all()),
          f"{name}: pcg_iters outside (0, {cap}] on a live iteration: {its.tolist()}")
    check(bool((its[~live] == 0).all()), f"{name}: pcg_iters not 0 once a lane is done")
    return its[live]


def phase_qp_backends(dev, loop9):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import run_sampled_mpc
    from indy7_mpc_tpu_torch.solvers import sqp as readable

    cost = CostConfig()
    model = indy7(torch.float32, dev)
    args, w = measure.k1_inputs(dev, B, N)
    bmajor = [args[0].T] + [a.permute(2, 0, 1) for a in args[1:]] + [w.T]
    cfgs = {be: SQPConfig(max_iters=SQP_ITERS, qp_backend=be) for be in QP_BACKENDS}
    reset_counts()

    def solve(cfg, arrs, mdl):
        return readable.batch_solve(mdl, cost, cfg, DT, *arrs[:4], wrench_world_batch=arrs[4])

    # 1. Each backend in f32 at its defaults, costed, on phase 3's inputs.
    out, res, merit = {}, {}, {}
    start = lane_merits(model, cost, cfgs["riccati"], bmajor)
    for be, cfg in cfgs.items():
        costs, res[be] = measure.call_costs(lambda: solve(cfg, bmajor, model), reps=1)
        r = res[be]
        check(bool(torch.isfinite(r.X).all() and torch.isfinite(r.U).all()),
              f"{be} f32 solve not finite")
        merit[be] = lane_merits(model, cost, cfg, bmajor, r)
        ratio = (merit[be] / merit["riccati"]).double()
        out[be] = {**costs, "merit_ratio_max": ratio.max().item(),
                   "merit_ratio_p50": ratio.median().item(),
                   "lanes_below_start": int((merit[be] < start).sum())}
        line = (f"{be} batch_solve B={B} N={N} f32: {costs['host_ms']:.1f} ms a call (host "
                f"clock), {costs['event_ms']:.1f} ms (CUDA events), {costs['kernels']:g} device "
                f"kernels, {costs['device_ms']:.2f} ms device time, {costs['syncs']} host syncs; "
                f"merit / Riccati's max {ratio.max().item():.4f}, p50 "
                f"{ratio.median().item():.4f}; {out[be]['lanes_below_start']} of {B} lanes "
                "below their starting merit")
        if r.stats.pcg_iters is not None:
            its = check_live_qp_iters(be, r, cfg.pcg_max_iters if be == "pcg"
                                      else cfg.admm_max_iters)
            out[be]["qp_iters"] = {"min": int(its.min()), "p50": float(its.float().median()),
                                   "max": int(its.max())}
            line += (f"; {'CG' if be == 'pcg' else 'ADMM'} iterations a live SQP iteration "
                     f"min {int(its.min())}, p50 {its.float().median().item():g}, max "
                     f"{int(its.max())}")
        print(line, flush=True)

    ric, ps = res["riccati"], res["riccati_pscan"]
    flips = np.nonzero((ric.stats.alphas != ps.stats.alphas).any(1).cpu().numpy())[0]
    check(flips.size <= MAX_FLIPS, f"riccati_pscan vs riccati: {flips.size} lanes flip an alpha")
    keep = torch.ones(B, dtype=torch.bool, device=dev)
    keep[torch.as_tensor(flips, dtype=torch.long, device=dev)] = False
    for a, b in ((ps.X, ric.X), (ps.U, ric.U)):
        scale = b.abs().amax(dim=(1, 2)).clamp(min=1.0)
        scaled = ((a - b).abs() / scale[:, None, None])[keep].max().item()
        check(scaled <= 6e-3, f"riccati_pscan vs riccati: X/U scaled error {scaled:.3e}")
    out["riccati_pscan"]["alpha_flips"] = int(flips.size)
    # ADMM solves the QP (in f64): every lane improves.  PCG at its default
    # 60 CG iterations does not converge on these QPs, so the line search
    # may reject both steps of a lane: no lane may get worse.
    check(bool((merit["admm"] < start).all()),
          f"admm: lanes {torch.nonzero(merit['admm'] >= start).flatten().tolist()} did not get "
          "below their starting merit")
    check(bool((merit["pcg"] <= start).all()),
          f"pcg: lanes {torch.nonzero(merit['pcg'] > start).flatten().tolist()} got worse")

    # PCG solves the same QP: with CG run to convergence (float64, a cap of
    # PCG_CONVERGED_ITERS) every lane's merit within the JAX test's 5% of
    # the Riccati solve's.
    m64, a64 = indy7(torch.float64, dev), [a.double() for a in bmajor]
    pcg64 = SQPConfig(max_iters=SQP_ITERS, qp_backend="pcg", pcg_max_iters=PCG_CONVERGED_ITERS)
    r64 = lane_merits(m64, cost, cfgs["riccati"], a64, solve(cfgs["riccati"], a64, m64))
    p64 = solve(pcg64, a64, m64)
    its64 = check_live_qp_iters("pcg f64", p64, PCG_CONVERGED_ITERS)
    pm64 = lane_merits(m64, cost, pcg64, a64, p64)
    worst = (pm64 / (1.05 * r64 + 1e-6)).max().item()
    check(worst <= 1.0, f"pcg f64 (cap {PCG_CONVERGED_ITERS}): a lane's merit over 1.05x the "
          f"Riccati lane's + 1e-6 (worst {worst:.4f} of the bound)")
    out["pcg"]["f64_converged"] = {"cap": PCG_CONVERGED_ITERS, "merit_ratio_max":
                                   (pm64 / r64).max().item(), "cg_iters_max": int(its64.max()),
                                   "cg_iters_p50": float(its64.float().median())}
    print(f"pcg f64, cap {PCG_CONVERGED_ITERS}: merit / Riccati's max "
          f"{(pm64 / r64).max().item():.5f}; CG iterations a live SQP iteration p50 "
          f"{its64.float().median().item():g}, max {int(its64.max())}", flush=True)

    # 2. f64 on the card against the CPU, B=4, N=16.
    rng = np.random.default_rng(17)
    wq = rng.normal(size=(4, 6)) * 8
    wq[:, 3:] = 0.0
    host = [torch.as_tensor(rng.normal(size=sh) * sc) for sh, sc in (
        ((4, 12), 0.05), ((4, 16, 3), 0.3), ((4, 16, 12), 0.05), ((4, 15, 6), 0.5))]
    host = [host[0] + torch.as_tensor(INIT_Q + [0.0] * 6)] + host[1:] + [torch.as_tensor(wq)]
    for be, cfg in cfgs.items():
        g = solve(cfg, [a.to(dev) for a in host], m64)
        c = solve(cfg, host, indy7(torch.float64))
        check(torch.equal(g.stats.alphas.cpu(), c.stats.alphas),
              f"{be} f64: alphas differ between the card and the CPU")
        if c.stats.pcg_iters is not None:
            check(torch.equal(g.stats.pcg_iters.cpu(), c.stats.pcg_iters),
                  f"{be} f64: inner iterations differ between the card and the CPU")
        d = max((a.cpu() - b).abs().max().item() for a, b in ((g.X, c.X), (g.U, c.U)))
        tol = F64_TOL[be]
        scaled = max(((a.cpu() - b).abs().amax((1, 2)) / b.abs().amax((1, 2)).clamp(min=1.0))
                     .max().item() for a, b in ((g.X, c.X), (g.U, c.U)))
        check((d if be.startswith("riccati") else scaled) <= tol,
              f"{be} f64: card vs CPU differ by {d:.3e} ({scaled:.3e} scaled) > {tol:g}")
        out[be]["f64_card_vs_cpu"] = {"max_abs": d, "scaled": scaled}
    print("f64 B=4 N=16, card vs CPU max |X,U diff| (scaled by each lane's max(1, |value|)): "
          + ", ".join(f"{be} {out[be]['f64_card_vs_cpu']['max_abs']:.3e} "
                      f"({out[be]['f64_card_vs_cpu']['scaled']:.3e})" for be in cfgs), flush=True)

    # 3. The GATO method in the closed loop: PCG's readable tick on phase
    # 9's carry and draws, against phase 9's readable Riccati tick.
    ticks = PCG_LOOP_TICKS
    mcfg = MPCConfig(N=N, dt=DT)
    scfg = SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)

    def loop(sqp_cfg):
        return run_sampled_mpc(model, cost, sqp_cfg, mcfg, scfg, loop9["x0"], loop9["ref"],
                               ticks, F_TRUE0, None, plant_cfg=PERTURBED_PLANT,
                               carry0=loop9["carry0"], draws=loop9["draws"][:ticks],
                               fused=False)[1]

    ric_trace = loop9["trace"] if loop9["ticks"] >= ticks else loop(cfgs["riccati"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp = loop(cfgs["pcg"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / ticks * 1e3
    for f, v in tp._asdict().items():
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"PCG loop: trace {f} not finite")
    te_p = tp.tracking_error.double().mean().item()
    te_r = ric_trace.tracking_error[:ticks].double().mean().item()
    same = int((tp.best_idx == ric_trace.best_idx[:ticks]).sum())
    print(f"PCG closed loop (fused=False, qp_backend='pcg') B={B} N={N} perturbed plant, "
          f"{ticks} ticks (the first eager, then replays of one-tick graphs): {ms:.1f} ms/tick "
          f"(host clock, the first tick and the capture included); mean tracking error "
          f"{te_p:.4f} m against the readable Riccati tick's {te_r:.4f} m; winners equal on "
          f"{same} of {ticks} ticks", flush=True)
    check(abs(te_p - te_r) <= PCG_LOOP_GATE * te_r, f"PCG loop mean tracking {te_p:.4f} m "
          f"not within {PCG_LOOP_GATE:.0%} of the readable Riccati tick's {te_r:.4f} m")
    out["pcg_loop"] = {"ticks": ticks, "ms_per_tick": ms, "tracking_pcg_m": te_p,
                       "tracking_riccati_m": te_r, "winners_equal": same}
    # The PCG loop graphed against its eager loop, bit for bit, replayed
    # without a host sync, and timed in turns.
    out["pcg_loop"]["modes"] = readable_graphs(dev, "pcg")

    counts = read_counts()
    check(all(n == 0 for n in counts.values()), f"QP backends launched kernels: {counts}")
    return counts, out


def check_block_kernels(label, model, cost, sqp, carry, ref, k1_lanes, plant_cfg=None):
    """The next tick's K1 and K2 calls on this rank's block, from a sharded
    loop's last carry, against their plain versions: K1 on ``k1_lanes``
    lanes spread over the block (its lanes are independent) at phase 3's
    gates, and K2 as the block's consensus (its plant step skipped) on
    every lane at phase 4's, the winner equal.  With ``plant_cfg`` (a
    one-process device loop's carry) K2 is instead the loop's call: the
    consensus with the plant step of ``plant_cfg`` under the carry's true
    wrench and seeded actuation noise.  Returns the max abs errors of K1
    and K2 with K2's winner in the block, and K2's arguments."""
    import torch

    from indy7_mpc_tpu_torch.mpc.fused_tick import (
        broadcast_solve, consensus_args, reference_window,
    )
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.sim.plant import perturb_model
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    smc = LR.static_model(model)
    x, fb_T = carry.x, carry.f_batch.T.contiguous()
    goals = reference_window(torch.as_tensor(ref, dtype=torch.float32, device=x.device),
                             carry.ref_offset, N)
    k = broadcast_solve(smc, cost, sqp, DT, x, goals, carry.X_best, carry.U_best, fb_T)
    sel = torch.linspace(0, fb_T.shape[1] - 1, k1_lanes, device=x.device).round().long()
    X0 = carry.X_best.clone()
    X0[0] = x
    lanes = lambda t: t[..., None].expand(t.shape + (k1_lanes,)).contiguous()
    p = solve_lane_major(smc, cost, sqp, DT, lanes(x), lanes(goals), lanes(X0),
                         lanes(carry.U_best), wrench=fb_T.index_select(1, sel))
    k1_err = check_k1_call(f"{label}: K1 at {fb_T.shape[1]} lanes", [
        None if t is None else t.index_select(-1, sel) for t in (k[0], k[1], None, k[3])], p)
    if plant_cfg is None:
        k2_args = consensus_args(x, carry.x_last, carry.u_last, fb_T, k[1][0])
        best, k2_err = check_k2_call(f"{label}: K2's consensus at {fb_T.shape[1]} lanes", smc,
                                     smc, None, k2_args, plant=False)
    else:
        gen = torch.Generator(device=x.device).manual_seed(13)
        noise = plant_cfg.torque_noise_std * torch.randn((plant_cfg.substeps, 6), generator=gen,
                                                         device=x.device)
        k2_args = (x, carry.x_last.contiguous(), carry.u_last.contiguous(), fb_T, k[1][0],
                   carry.f_true.contiguous(), noise)
        best, k2_err = check_k2_call(f"{label}: K2 with the plant at {fb_T.shape[1]} lanes", smc,
                                     LR.static_model(perturb_model(model, plant_cfg)),
                                     plant_cfg, k2_args)
    return {"k1_err": k1_err, "k2_err": k2_err, "k2_best": best}, k2_args


def sharded_rank(mesh):
    """Phase 12 on one rank (a spawned process on the shared card): (c) the
    sharded batch solve, (a) the bench's loop, (b) the 32k sweep, then K1
    alone at both block widths and the consensus collectives alone.  The
    launch counts are set to 0 just before each loop and read just
    after."""
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import init_loop_carry
    from indy7_mpc_tpu_torch.multihost_bench import time_consensus
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue
    from indy7_mpc_tpu_torch.parallel import (
        make_sharded_batch_solve, make_sharded_sampled_loop, shard_lanes,
    )
    from indy7_mpc_tpu_torch.sim.kernel_plant import kernel_plant_step
    from indy7_mpc_tpu_torch.sim.plant import perturb_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = mesh.device
    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    model = indy7(torch.float32, dev)
    np_ = lambda t: t.detach().cpu().numpy()
    out = {"rank": mesh.rank, "device": str(dev)}

    # (c) The batch solve at phase 3's inputs, B-major, over the ranks.
    args, w = measure.k1_inputs(dev, B, N)
    local = shard_lanes(mesh, [args[0].T] + [a.permute(2, 0, 1) for a in args[1:]] + [w.T])
    res = make_sharded_batch_solve(model, cost, sqp, DT, mesh, backend="kernel")(*local)
    out["solve"] = {"lanes": local[0].shape[0], "X": np_(mesh.gather(res.X)),
                    "U": np_(mesh.gather(res.U)), "alphas": np_(mesh.gather(res.stats.alphas))}

    k2_calls, plant_calls = [], []  # the block's consensus, the B=1 plant step

    def loop_run(lanes, ticks, chunk, sample, f_true, k1_lanes):
        mcfg, scfg = MPCConfig(N=N, dt=DT), SampleConfig(batch_size=lanes, **sample)
        gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
        loop, layout = make_sharded_sampled_loop(
            model, cost, sqp, mcfg, scfg, mesh, fig8_reference(), chunk, backend="kernel",
            plant_cfg=PERTURBED_PLANT, generator=gen)
        carry = shard_lanes(mesh, init_loop_carry(model, mcfg, scfg, initial_state(dev), f_true,
                                                  gen), layout)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        traces, blocks, f_max = [], [], []
        reset_counts()
        torch.cuda.synchronize()
        for i in range(ticks // chunk):
            if i == 1:  # the first chunk (first launches in this process) is not timed
                torch.cuda.synchronize()
                start.record()
                t0 = time.perf_counter()
            carry, trace = loop(carry)
            traces.append(trace)
            blocks.append(tuple(carry.f_batch.shape))
            f_max.append(carry.f_batch.abs().max())
        end.record()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        launches = read_counts()
        timed = ticks - chunk
        trace = {f: np_(torch.cat([getattr(t, f) for t in traces])) for f in traces[0]._fields}
        checked, k2_args = check_block_kernels(f"B={lanes} rank {mesh.rank}", model, cost, sqp,
                                               carry, fig8_reference(), k1_lanes)
        k2_calls.append((lanes // mesh.size, k2_args))
        plant_calls.append((carry.x, carry.u_last, carry.f_true))
        return {"trace": trace, "launches": launches, "blocks": blocks, "checked": checked,
                "f_max": [float(v) for v in f_max],
                "carry": {f: np_(v) for f, v in carry._asdict().items() if f != "f_batch"},
                "event_ms_per_tick": start.elapsed_time(end) / timed,
                "host_ms_per_tick": host * 1e3 / timed}

    # (a) The bench's configuration; (b) the 32k sweep.
    out["loop"] = loop_run(SHARDED_B, SHARDED_TICKS, SHARDED_CHUNK,
                           {"f_ext_std": 20.0, "f_ext_resample_std": 1.0}, F_TRUE0,
                           SHARDED_B // mesh.size)
    out["sweep"] = loop_run(SWEEP_B, SWEEP_TICKS, 1, SWEEP_SAMPLE, SWEEP_F_TRUE, SWEEP_K1_LANES)

    # K1 alone at each block width, both ranks on the card at once.
    sm = LR.static_model(model)
    out["k1_ms"] = {}
    for lanes, reps in ((SHARDED_B // mesh.size, 50), (SWEEP_B // mesh.size, 5)):
        k_args, k_w = measure.k1_inputs(dev, lanes, N)
        mesh.all_reduce(torch.zeros(1, device=dev))  # start together
        out["k1_ms"][lanes] = cuda_ms(lambda: sqp_solve(sm, cost, sqp, DT, *k_args, wrench=k_w),
                                      reps)
    # K2 alone in its two calls of the loop, on the arguments of (a)'s and
    # (b)'s next tick: the block's consensus and the B=1 plant step.
    out["k2_ms"] = {}
    for lanes, args in k2_calls:
        mesh.all_reduce(torch.zeros(1, device=dev))
        out["k2_ms"][lanes] = cuda_ms(
            lambda: tick_epilogue(sm, sm, None, DT, *args, plant=False), 20)
    smp = LR.static_model(perturb_model(model, PERTURBED_PLANT))
    noise = PERTURBED_PLANT.torque_noise_std * torch.ones((PERTURBED_PLANT.substeps, 6),
                                                          device=dev)
    x, u, f_true = plant_calls[0]
    mesh.all_reduce(torch.zeros(1, device=dev))
    out["k2_ms"][1] = cuda_ms(
        lambda: kernel_plant_step(sm, smp, PERTURBED_PLANT, DT, x, u, f_true, noise), 50)
    out["consensus_us"], out["consensus_bytes"] = time_consensus(mesh, SHARDED_B, N)
    return out


def phase_sharded(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import run_sampled_mpc
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
    from indy7_mpc_tpu_torch.parallel._worker import spawn
    from indy7_mpc_tpu_torch.roofline import bound_ms, k1_work, k2_work
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    R = SHARDED_RANKS
    t0 = time.perf_counter()
    ranks = spawn(sharded_rank, R, device=str(dev), backend="gloo", timeout=600)
    print(f"sharded: {R} ranks on {dev} over gloo ran in {time.perf_counter() - t0:.1f} s "
          "(process start included)", flush=True)
    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    model = indy7(torch.float32, dev)

    def scaled(a, b):
        return float(np.abs(a - b).max() / max(1.0, np.abs(b).max()))

    # (c) Against the single-process K1 and the plain version, phase 3's gates.
    args, w = measure.k1_inputs(dev, B, N)
    sm = LR.static_model(model)
    single = [t.permute(2, 0, 1).cpu().numpy() for t in K1.sqp_solve(sm, cost, sqp, DT, *args,
                                                                     wrench=w)[:2]]
    plain = solve_lane_major(sm, cost, sqp, DT, *args, wrench=w)
    plain_alphas = plain[3].T.cpu().numpy()
    plain = [t.permute(2, 0, 1).cpu().numpy() for t in plain[:2]]
    for r in ranks:
        s = r["solve"]
        check(s["lanes"] == B // R, f"rank {r['rank']}: {s['lanes']} lanes, want {B // R}")
        check(np.array_equal(s["alphas"], plain_alphas),
              f"rank {r['rank']}: sharded solve's alphas differ from the plain version's")
        for name, ref in (("K1", single), ("plain", plain)):
            for got, want in zip((s["X"], s["U"]), ref):
                lane_scale = np.maximum(np.abs(want).max(axis=(1, 2)), 1.0)[:, None, None]
                err = float((np.abs(got - want) / lane_scale).max())
                check(err <= 6e-3, f"sharded solve vs {name}: X/U scaled error {err:.3e} > 6e-3")
    same_bits = all(np.array_equal(r["solve"][k], v) for r in ranks
                    for k, v in zip(("X", "U"), single))
    print(f"sharded batch solve B={B} N={N} over {R} ranks ({B // R} lanes each): alphas equal "
          f"to the plain version's on all lanes; the same bits as the single-process K1: "
          f"{same_bits}", flush=True)

    # (a) Against run_sampled_mpc from the same seed, in this process.
    gen = torch.Generator(device=dev).manual_seed(SHARDED_SEED)
    _, tr = run_sampled_mpc(
        model, cost, sqp, MPCConfig(N=N, dt=DT),
        SampleConfig(batch_size=SHARDED_B, f_ext_std=20.0, f_ext_resample_std=1.0),
        initial_state(dev), fig8_reference(), SHARDED_TICKS, F_TRUE0, gen,
        plant_cfg=PERTURBED_PLANT)
    single = {f: v.cpu().numpy() for f, v in tr._asdict().items()}
    a0 = ranks[0]["loop"]
    for r in ranks:
        a = r["loop"]
        want = {"sqp_solve": SHARDED_TICKS, "tick_epilogue": 2 * SHARDED_TICKS}
        check(a["launches"] == want, f"rank {r['rank']}: launches {a['launches']} in "
              f"{SHARDED_TICKS} ticks, want {want} (K2: the block's consensus, the plant step)")
        check(all(b == (SHARDED_B // R, 6) for b in a["blocks"]),
              f"rank {r['rank']}: f_batch blocks {set(a['blocks'])}, want {(SHARDED_B // R, 6)}")
        for f, v in a["trace"].items():
            check(np.array_equal(v, a0["trace"][f], equal_nan=True),
                  f"rank {r['rank']}'s trace {f} differs from rank 0's")
            if v.dtype.kind == "f":
                check(bool(np.isfinite(v).all()), f"sharded loop: trace {f} not finite")
    bad = np.nonzero(a0["trace"]["best_idx"] != single["best_idx"])[0]
    check(bad.size == 0, f"sharded loop: winners differ from run_sampled_mpc on ticks "
          f"{bad[:10].tolist()}")
    du = scaled(a0["trace"]["u"], single["u"])
    dte = scaled(a0["trace"]["tracking_error"], single["tracking_error"])
    check(du <= 6e-3 and dte <= 6e-3, f"sharded loop vs run_sampled_mpc: u scaled diff "
          f"{du:.3e}, tracking error {dte:.3e} (gate 6e-3)")
    bits = {f: bool(np.array_equal(a0["trace"][f], single[f])) for f in ("u", "tracking_error",
                                                                         "x", "f_est")}
    print(f"sharded loop B={SHARDED_B} N={N} perturbed plant, {SHARDED_TICKS} ticks over {R} "
          f"ranks: winners equal to run_sampled_mpc's on all ticks; u scaled diff {du:.3e}, "
          f"tracking error {dte:.3e}; the same bits: {bits}; ranks' traces equal; ms a tick "
          + ", ".join(f"rank {r['rank']} {r['loop']['event_ms_per_tick']:.4f} (CUDA events) "
                      f"{r['loop']['host_ms_per_tick']:.4f} (host)" for r in ranks)
          + f"; tracking mean {single['tracking_error'].astype(np.float64).mean():.4f} m",
          flush=True)

    # (b) The 32k sweep.
    for r in ranks:
        b = r["sweep"]
        want = {"sqp_solve": SWEEP_TICKS, "tick_epilogue": 2 * SWEEP_TICKS}
        check(b["launches"] == want, f"32k sweep rank {r['rank']}: launches {b['launches']}, "
              f"want {want}")
        check(all(blk == (SWEEP_B // R, 6) for blk in b["blocks"]),
              f"32k sweep rank {r['rank']}: f_batch blocks {set(b['blocks'])}")
        for f, v in b["trace"].items():
            if v.dtype.kind == "f":
                check(bool(np.isfinite(v).all()), f"32k sweep: trace {f} not finite")
        best = b["trace"]["best_idx"]
        check(bool(((best >= 0) & (best < SWEEP_B)).all()), f"32k sweep: winners {best}")
        check(max(b["f_max"]) < SWEEP_F_MAX, f"32k sweep: max |f_batch| {max(b['f_max']):.2f} N "
              f">= {SWEEP_F_MAX} N")
        check(np.array_equal(best, ranks[0]["sweep"]["trace"]["best_idx"]),
              "32k sweep: the ranks' winners differ")
    print(f"32k sweep B={SWEEP_B} ({SWEEP_B // R} lanes a rank) N={N}, {SWEEP_TICKS} ticks: "
          f"winners {ranks[0]['sweep']['trace']['best_idx'].tolist()}, max |f_batch| "
          f"{max(max(r['sweep']['f_max']) for r in ranks):.2f} N; ms a tick "
          + ", ".join(f"rank {r['rank']} {r['sweep']['event_ms_per_tick']:.3f} (CUDA events) "
                      f"{r['sweep']['host_ms_per_tick']:.3f} (host)" for r in ranks), flush=True)

    print("each rank's next-tick K1 and K2 consensus on its block against the plain versions "
          "(phase 3's and phase 4's gates): " + "; ".join(
              f"rank {r['rank']} {run} K1 {r[run]['checked']['k1_err']:.3e} on "
              f"{SHARDED_B // R if run == 'loop' else SWEEP_K1_LANES} lanes, K2 "
              f"{r[run]['checked']['k2_err']:.3e}, winner {r[run]['checked']['k2_best']} equal"
              for r in ranks for run in ("loop", "sweep")), flush=True)

    k1 = {}
    for lanes in (SHARDED_B // R, SWEEP_B // R):
        bound, by = bound_ms(*k1_work(lanes, N, cost, sqp, use_wrench=True))
        k1[lanes] = {"ms": [r["k1_ms"][lanes] for r in ranks], "bound_ms": bound, "bound_by": by}
    print("K1 alone, both ranks on the card: " + "; ".join(
        f"{lanes} lanes " + ", ".join(f"{ms:.4f}" for ms in v["ms"])
        + f" ms (bound {v['bound_ms'] * 1e3:.2f} us, {v['bound_by']})" for lanes, v in k1.items())
        + "; consensus collectives alone at B=" + f"{SHARDED_B}: "
        + ", ".join(f"{r['consensus_us']:.1f}" for r in ranks)
        + f" us a tick, {ranks[0]['consensus_bytes']} bytes", flush=True)
    cfg = PERTURBED_PLANT
    k2 = {}
    for lanes in (SHARDED_B // R, SWEEP_B // R, 1):
        work = (k2_work(lanes, 0, False, False) if lanes > 1 else
                k2_work(1, cfg.substeps, bool(cfg.viscous_friction or cfg.coulomb_friction),
                        True, cfg.velocity_saturation))
        bound, by = bound_ms(*work)
        k2[lanes] = {"ms": [r["k2_ms"][lanes] for r in ranks], "bound_ms": bound, "bound_by": by}
    print("K2 alone, both ranks on the card: " + "; ".join(
        (f"consensus at {lanes} lanes " if lanes > 1 else "plant step at B=1 ")
        + ", ".join(f"{ms:.4f}" for ms in v["ms"])
        + f" ms (bound {v['bound_ms'] * 1e3:.3f} us, {v['bound_by']})" for lanes, v in k2.items()),
        flush=True)
    launches = {k: sum(r["loop"]["launches"][k] + r["sweep"]["launches"][k] for r in ranks)
                for k in ("sqp_solve", "tick_epilogue")}
    summary = {"ranks": R, "loop_ms_per_tick": [[r["loop"]["event_ms_per_tick"],
                                                 r["loop"]["host_ms_per_tick"]] for r in ranks],
               "sweep_ms_per_tick": [[r["sweep"]["event_ms_per_tick"],
                                      r["sweep"]["host_ms_per_tick"]] for r in ranks],
               "k1": k1, "k2": k2, "consensus_us": [r["consensus_us"] for r in ranks],
               "consensus_bytes": ranks[0]["consensus_bytes"], "same_bits": bits,
               "solve_same_bits": same_bits,
               "block_checks": [{run: r[run]["checked"] for run in ("loop", "sweep")}
                                for r in ranks]}
    return launches, summary


def phase_recorded_runs(dev):
    """Phase 13: the device rows of examples/record_runs.py's protocol
    through the port's ``record_runs.run_device_resident``, each held
    against its golden in stats_tpu/ and its kernels against their plain
    versions on its next tick."""
    import tempfile

    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, CostConfig, SQPConfig
    from indy7_mpc_tpu_torch.examples import protocol, record_runs
    from indy7_mpc_tpu_torch.models import indy7

    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    model = indy7(torch.float32, dev)
    ref = protocol.fig8_reference(RECORDED_TICKS)
    total = {"sqp_solve": 0, "tick_epilogue": 0}
    rows = {}
    with tempfile.TemporaryDirectory(prefix="indy7_recorded_") as out:
        for lanes in RECORDED_B:
            tag = record_runs.row_tag("perturbed", lanes, "device")
            reset_counts()
            row, carry = record_runs.run_device_resident(lanes, RECORDED_TICKS, PERTURBED_PLANT,
                                                         out, tag, device=dev)
            launches = read_counts()
            want = RECORDED_TICKS + row["chunk"]  # the ticks and the warm-up chunk
            check(launches == {"sqp_solve": want, "tick_epilogue": want},
                  f"{tag}: launches {launches}, want {want} of each (ticks + warm-up chunk)")
            for k in total:
                total[k] += launches[k]
            arrays = record_runs.load_recording(row["stem"])
            for name, a in arrays.items():
                check(a is not None and a.shape[0] == RECORDED_TICKS,
                      f"{tag}: recorded {name} missing or not {RECORDED_TICKS} rows")
                check(bool(np.isfinite(a).all()), f"{tag}: recorded {name} not finite")
            checked, _ = check_block_kernels(tag, model, cost, sqp, carry, ref, lanes,
                                             plant_cfg=PERTURBED_PLANT)
            gold = record_runs.golden_stats(tag)
            check(gold is not None, f"{tag}: no golden in stats_tpu/")
            te, g_te = row["tracking_m"], gold["tracking_m"]
            print(f"{tag}: ticks {row['ticks']}; tracking m mean/p50/p95 "
                  f"{te[0]:.4f}/{te[1]:.4f}/{te[2]:.4f} (golden {g_te[0]:.4f}/{g_te[1]:.4f}/"
                  f"{g_te[2]:.4f}); wrench error p50 {row['fe_err_p50']:.2f} N (golden "
                  f"{gold['fe_err_p50']:.2f}), re-lock lag p50 {row.get('fe_lag_p50')} (golden "
                  f"{gold.get('fe_lag_p50')}); us a tick, host clock mean/p50/p95/max "
                  + "/".join(f"{v:.1f}" for v in row["solve_us"])
                  + f", CUDA events {row['event_us']:.1f}; the next tick's K1 (all {lanes} "
                  f"lanes) max abs err {checked['k1_err']:.3e}, K2 with the plant "
                  f"{checked['k2_err']:.3e} (winner {checked['k2_best']}); launches {launches}; "
                  f"{card_line()}", flush=True)
            for i, name in ((0, "mean"), (2, "p95")):
                check(te[i] <= TRACKING_GATE * g_te[i],
                      f"{tag}: tracking {name} {te[i]:.4f} m above {TRACKING_GATE}x the "
                      f"golden's {g_te[i]:.4f} m")
            check(row["fe_err_p50"] <= WRENCH_GATE * gold["fe_err_p50"],
                  f"{tag}: wrench error p50 {row['fe_err_p50']:.2f} N above {WRENCH_GATE}x the "
                  f"golden's {gold['fe_err_p50']:.2f} N")
            rows[tag] = {k: row.get(k) for k in ("tracking_m", "fe_err_p50", "fe_lag_p50",
                                                  "solve_us", "event_us", "init_s", "wall_s")}
            rows[tag].update(golden={k: gold.get(k) for k in ("tracking_m", "fe_err_p50",
                                                              "fe_lag_p50")},
                             kernels=checked, launches=launches)
    means = [rows[record_runs.row_tag("perturbed", b, "device")]["tracking_m"][0]
             for b in RECORDED_B]
    check(means[1] < means[0], f"tracking mean at B={RECORDED_B[1]} ({means[1]:.4f} m) not "
          f"below B={RECORDED_B[0]}'s ({means[0]:.4f} m): the ensemble claim fails")
    return total, rows


def tpu_tool_keys(name):
    """What the TPU package's ``tools/<name>.py`` reports, read from its
    source with ast: the keys of its JSON line, or for a tool that prints a
    table, its row names (profile_solve's up to their " (backend)"); for
    multihost_eff the committed MULTIHOST_EFF.json's keys by level (its
    rows' "round" names the TPU rig's measurement round and is left out).
    ``bench`` reads bench.py (its JSON line's keys) and ``scale_bench``
    examples/scale_bench.py (by line: "mesh", "row", "final" and
    "final_row", a row in the final line)."""
    import ast

    root = os.path.dirname(os.path.abspath(__file__))
    if name == "multihost_eff":
        with open(os.path.join(root, "MULTIHOST_EFF.json")) as f:
            doc = json.load(f)
        return {"": set(doc), **{k: set(doc[k][0]) - {"round"}
                                 for k in ("results", "collective_accounting")}}
    path = {"bench": "bench.py", "scale_bench": os.path.join("examples", "scale_bench.py")}.get(
        name, os.path.join("tools", f"{name}.py"))
    with open(os.path.join(root, path)) as f:
        tree = ast.parse(f.read())
    nodes = list(ast.walk(tree))
    strings = lambda elts: {e.value for e in elts if isinstance(e, ast.Constant)}
    keyed = lambda key: [strings(n.keys) for n in nodes
                         if isinstance(n, ast.Dict) and key in strings(n.keys)]

    if name == "bench":
        (keys,) = keyed("metric")
        return keys
    if name == "scale_bench":
        (row,) = [{k.arg for k in n.keywords} for n in nodes if isinstance(n, ast.Call)
                  and isinstance(n.func, ast.Name) and n.func.id == "dict"]
        (added,) = [t.slice.value for n in nodes if isinstance(n, ast.Assign)
                    for t in n.targets if isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)]
        (mesh,), (final,) = keyed("mesh_devices"), keyed("sweep")
        return {"mesh": mesh, "row": row, "final": final, "final_row": row | {added}}

    def assigned(var):
        return [n.value for n in nodes if isinstance(n, ast.Assign)
                and any(isinstance(t, ast.Name) and t.id == var for t in n.targets)]

    if name == "latency_decomp":
        (d,) = assigned("report")
        return strings(d.keys)
    if name == "consensus_collective_bench":
        (d,) = [n for n in nodes if isinstance(n, ast.Dict) and "metric" in strings(n.keys)]
        return strings(d.keys)
    if name == "profile_kernel_stages":
        (d,) = assigned("names")
        return strings(d.values)
    if name == "profile_solve":
        (rows,) = assigned("rows")
        first = [t.elts[0] for t in rows.elts]
        return {(e.value if isinstance(e, ast.Constant) else e.values[0].value).split(" (")[0]
                for e in first}
    if name == "profile_pscan":
        return {t.elts[0].value for t in nodes if isinstance(t, ast.Tuple) and len(t.elts) == 2
                and isinstance(t.elts[0], ast.Constant) and isinstance(t.elts[1], ast.Attribute)}
    raise ValueError(name)


def json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


def capture_main(fn, argv):
    """``fn(argv)`` with its stdout captured, then printed; returns (its
    JSON lines, its return value)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(argv)
    print(buf.getvalue(), end="", flush=True)
    return json_lines(buf.getvalue()), out


def run_tool(name, argv, fresh=False):
    """``indy7_mpc_tpu_torch.tools.<name>.main(argv)`` in this process, or
    with ``fresh`` as ``python3 -m`` in a process of its own, its output
    printed; returns (its JSON lines, seconds)."""
    import importlib

    module = f"indy7_mpc_tpu_torch.tools.{name}"
    t0 = time.perf_counter()
    if fresh:
        proc = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True,
                              text=True, timeout=600,
                              cwd=os.path.dirname(os.path.abspath(__file__)))
        check(proc.returncode == 0, f"{name} exited with {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        print(proc.stdout, end="", flush=True)
        lines, rc = json_lines(proc.stdout), 0
    else:
        lines, rc = capture_main(importlib.import_module(module).main, argv)
    seconds = time.perf_counter() - t0
    check(rc == 0, f"{name} returned {rc}")
    check(lines, f"{name}: no JSON line")
    return lines, seconds


def phase_tools(dev, k1_ms):
    """Phase 14: the diagnostic tools through their main() on the card."""
    import tempfile

    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, CostConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import fused_tick
    from indy7_mpc_tpu_torch.runtime import InProcessPlant, run_control_loop
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.parallel.sharding import consensus_bytes
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    seconds, summary = {}, {}

    def keys_hold(name, have, want):
        check(want <= set(have), f"{name}: misses the TPU tool's {sorted(want - set(have))}")

    with tempfile.TemporaryDirectory(prefix="indy7_tools_") as out:
        reset_counts()
        # In a process of its own, as profile_solve below: in this process,
        # after the profiler runs of phases 9-13, torch.profiler records
        # none of K1's and K2's kernels (it once saw 30 of on_state's 50
        # device kernels and copies, 42 us of its ~580 us), and the tick's
        # split needs them.
        (lat,), seconds["latency_decomp"] = run_tool("latency_decomp", [
            "--ticks", str(TOOLS_TICKS), "--out", os.path.join(out, "LATENCY_TORCH.md")],
            fresh=True)
        launches = read_counts()
        keys_hold("latency_decomp", lat, tpu_tool_keys("latency_decomp"))
        block, block_tick = lat["solve_block_us"]["p50"], lat["tick_block_us"]["p50"]
        check(lat["solve_device_us"] <= block,
              f"solve_device {lat['solve_device_us']} us above solve_block {block} us")
        check(lat["null_rtt_us"]["p50"] < block,
              f"null_rtt {lat['null_rtt_us']['p50']} us not below solve_block {block} us")
        for kind in ("library_builds_or_loads", "allocator_segments", "alloc_retries"):
            check(lat[f"{kind}_during_loop"] == 0,
                  f"latency_decomp: {lat[f'{kind}_during_loop']} {kind} after the loop's first tick")
        check(lat["loop_tick_us"]["p50"] < 10_000,
              f"the loop's tick p50 {lat['loop_tick_us']['p50']} us is over the 10 ms period")
        # The tick's split: one input copy, the graph's launch with the
        # generator's two fills, one fetch; the graph's device work inside
        # the blocking tick.
        check(0 < lat["tick_host_launches"] <= CONTROLLER_HOST_LAUNCHES,
              f"on_state issues {lat['tick_host_launches']} host-side launches, want (0, "
              f"{CONTROLLER_HOST_LAUNCHES}]")
        device_us = lat["tick_device_ms"] * 1e3
        check(lat["solve_device_us"] <= device_us <= block_tick,
              f"on_state's device work {device_us:.1f} us not between one solve's "
              f"{lat['solve_device_us']} us and its blocking tick {block_tick:.1f} us")
        summary["latency_decomp"] = {k: lat[k] for k in (
            "null_rtt_us", "fetch_rtt_us", "solve_device_us", "solve_device_host_ahead",
            "solve_pipelined_us", "solve_block_us", "tick_block_us", "host_residual_us",
            "tick_device_launches", "tick_host_launches", "tick_device_ms", "tick_host_us",
            "loop_tick_us", "compiles_during_loop")}

        # K1 on the tool's inputs, and K2 in one on_state, against their
        # plain versions.
        model = indy7(torch.float32, dev)
        cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
        xs, goals, X, U, w = measure.production_inputs(dev, B, N)
        lane = lambda t: t.permute(*range(1, t.dim()), 0).contiguous()
        args = (lane(xs), lane(goals), lane(X), lane(U))
        sm = LR.static_model(model)
        k1_err = check_k1_call("K1 on latency_decomp's inputs",
                               sqp_solve(sm, cost, sqp, DT, *args, wrench=lane(w)),
                               solve_lane_major(sm, cost, sqp, DT, *args, wrench=lane(w)))
        ctl = measure.runtime_controller(dev)
        plant = InProcessPlant(model, initial_state(dev), DT, plant_cfg=PERTURBED_PLANT)
        run_control_loop(ctl, plant, duration=1e9, realtime=False, max_ticks=20)
        # The next tick's K2 call: on_state replays a graph, so the eager
        # ControllerTick runs that tick on the controller's state.
        calls, inner = [], fused_tick.tick_epilogue

        def spy(*a, **kw):
            calls.append((a, kw))
            return inner(*a, **kw)

        fused_tick.tick_epilogue = spy
        try:
            ctl._tick(int(ctl.ref_offset + 1), plant.x, ctl.x_last, ctl.u_last, ctl.X_best,
                      ctl.U_best, ctl.f_batch)
        finally:
            fused_tick.tick_epilogue = inner
        check(len(calls) == 1, f"one controller tick called K2 {len(calls)} times")
        (a, kw), = calls
        k2_best, k2_err = check_k2_call("K2 in one controller tick", a[0], a[1], a[2], a[4:],
                                        plant=kw.get("plant", True))
        print(f"tools: K1 on latency_decomp's inputs max abs err {k1_err:.3e}; K2 in the "
              f"controller's tick after 20 max abs err {k2_err:.3e} (winner {k2_best})",
              flush=True)

        reset_counts()
        (stg,), seconds["profile_kernel_stages"] = run_tool("profile_kernel_stages",
                                                            [str(B), str(N)])
        # The trace in a process of its own, as a user takes it: in this
        # process, after the profiler sessions of phases 9 and 11, a trace
        # once held no kernel event (the same call in a fresh process did).
        (slv,), seconds["profile_solve"] = run_tool("profile_solve", [
            str(B), str(N), "--backend", "cuda", "--trace", os.path.join(out, "trace")],
            fresh=True)
        (psc,), seconds["profile_pscan"] = run_tool("profile_pscan", [
            str(B), str(N), "--chain", str(PSCAN_CHAIN)])
        tools_launches = read_counts()
        launches = {k: launches[k] + tools_launches[k] for k in launches}

        check({r["name"] for r in stg["rows"]} == tpu_tool_keys("profile_kernel_stages"),
              "profile_kernel_stages: rows are not the TPU tool's")
        cum = [r["us"] for r in stg["rows"]]
        check(all(b >= (1 - STAGE_SLACK) * a for a, b in zip(cum, cum[1:])),
              f"profile_kernel_stages: cumulative us decrease: {cum}")
        check(abs(cum[-1] - k1_ms * 1e3) <= STAGE_GATE * k1_ms * 1e3,
              f"stages<=4 {cum[-1]:.1f} us not within {STAGE_GATE:.0%} of phase 3's K1 "
              f"{k1_ms * 1e3:.1f} us")
        check({r["stage"].split(" (")[0] for r in slv["rows"]} == tpu_tool_keys("profile_solve"),
              "profile_solve: rows are not the TPU tool's")
        check(slv["trace"] is not None and os.path.exists(slv["trace"]),
              "profile_solve: no trace file")
        with open(slv["trace"]) as f:
            check("sqp_kernel" in f.read(), "profile_solve: the trace names no sqp_kernel")
        check({r["backend"] for r in psc["rows"]} == tpu_tool_keys("profile_pscan"),
              "profile_pscan: rows are not the TPU tool's")
        outs = [r["out_mean_abs"] for r in psc["rows"]]
        check(np.isfinite(outs).all() and abs(outs[0] - outs[1]) <= 1e-5 * abs(outs[0]),
              f"profile_pscan: the two backends' chains end apart: {outs}")
        summary.update(profile_kernel_stages=cum, profile_solve=slv["rows"],
                       profile_pscan=psc["rows"])

        (cons,), seconds["consensus_collective_bench"] = run_tool(
            "consensus_collective_bench", [])
        keys_hold("consensus_collective_bench", cons, tpu_tool_keys("consensus_collective_bench"))
        check(cons["bytes_per_tick"] == consensus_bytes(cons["B"], cons["N"]),
              f"consensus bench: {cons['bytes_per_tick']} bytes, want "
              f"consensus_bytes = {consensus_bytes(cons['B'], cons['N'])}")
        summary["consensus_collective_bench"] = cons

        eff_path = os.path.join(out, "MULTIHOST_EFF_TORCH.json")
        _, seconds["multihost_eff"] = run_tool("multihost_eff", [
            "--procs", "2", "--ticks", str(TOOLS_EFF_TICKS), "--out", eff_path])
        with open(eff_path) as f:
            eff = json.load(f)
        want = tpu_tool_keys("multihost_eff")
        keys_hold("multihost_eff", eff, want[""])
        for level in ("results", "collective_accounting"):
            for row in eff[level]:
                keys_hold(f"multihost_eff {level}", row, want[level])
        for row in eff["results"]:
            check(row["consensus_match"], f"multihost_eff at {row['procs']} ranks: the "
                  "winner differs from one rank's")
        summary["multihost_eff"] = {k: eff[k] for k in ("results", "weak_scaling", "notes")}
    print(f"tools: seconds {json.dumps(seconds)}; launches in this process {launches}",
          flush=True)
    summary["seconds"] = seconds
    return launches, summary


def phase_bench(dev):
    """Phase 15: the solve benchmarks through their main() on the card."""
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch import bench, measure
    from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig
    from indy7_mpc_tpu_torch.examples import scale_bench
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.solvers import sqp_cuda
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    sm = LR.static_model(indy7(torch.float32, dev))
    cost, sqp = CostConfig(), SQPConfig(max_iters=bench.SQP_ITERS)
    lane = lambda t: t.permute(*range(1, t.dim()), 0).contiguous()  # B-major to lane-major

    def against_plain(label, solved, sel=None, converged=False):
        """A B-major solve (its inputs, its SQPResult) against K1's plain
        version on the same inputs, on the lanes ``sel`` (default all)."""
        args, res = solved
        pick = (lambda t: t) if sel is None else (lambda t: t.index_select(0, sel))
        xs, goals, X, U, w = (lane(pick(t)) for t in args)
        return check_k1_call(label, (lane(pick(res.X)), lane(pick(res.U)), None,
                                     pick(res.stats.alphas).T),
                             solve_lane_major(sm, cost, sqp, DT, xs, goals, X, U, wrench=w),
                             converged)

    summary, launches = {}, {}
    t0 = time.perf_counter()
    reset_counts()
    lines, report = capture_main(bench.main, [])
    launches["bench"] = read_counts()
    seconds = {"bench": time.perf_counter() - t0}
    per = 1 + bench.R + bench.DISPATCH_ITERS + bench.CHAIN_ITERS * bench.R
    want = len(bench.HORIZONS) * bench.REPEATS * per
    check(launches["bench"] == {"sqp_solve": want, "tick_epilogue": 0},
          f"bench: launches {launches['bench']}, want K1 {want} ({per} a measurement), K2 0")
    check(len(lines) == 1, f"bench printed {len(lines)} JSON lines on stdout, want 1")
    (line,) = lines
    check(set(line) == tpu_tool_keys("bench"),
          f"bench: keys {sorted(line)} are not bench.py's {sorted(tpu_tool_keys('bench'))}")
    check(bool(np.isfinite(line["value"])) and line["value"] > 0,
          f"bench: value {line['value']}")
    check(line["min"] <= line["median"] <= line["max"], f"bench: min/median/max {line}")
    m = report["runs"][bench.HORIZONS[-1]][-1]
    bench_err = max(against_plain("K1 in the bench's first solve", m.first),
                    against_plain("K1 in the bench's last chained solve", m.last, converged=True))
    chains = {}
    for n, meas in report["runs"].items():
        chains[n] = [{"host_us": m.chained_s * 1e6, "event_us": m.chain_event_s * 1e6,
                      "host_ahead": m.host_ahead, "blocking_us": m.dispatch_s * 1e6}
                     for m in meas]
        print(f"bench N={n} on {report['device']}: the chain per solve by the host clock / by "
              "CUDA events (host ahead) / blocking: " + "; ".join(
                  f"{c['host_us']:.1f} / {c['event_us']:.1f} ({'yes' if c['host_ahead'] else 'no'})"
                  f" / {c['blocking_us']:.1f} us" for c in chains[n]), flush=True)
    summary["bench"] = {"line": line, "chains": chains, "k1_err": bench_err}

    keys = tpu_tool_keys("scale_bench")
    Bs, n_sweep = scale_bench.BS, str(BENCH_SWEEP_N)
    want = sum(1 + scale_bench.default_reps(b) for b in Bs)
    t0 = time.perf_counter()
    reset_counts()
    lines, (final, outs) = capture_main(scale_bench.main, [n_sweep])
    launches["scale_bench"] = read_counts()
    seconds["scale_bench"] = time.perf_counter() - t0
    check(launches["scale_bench"] == {"sqp_solve": want, "tick_epilogue": 0},
          f"scale_bench: launches {launches['scale_bench']}, want K1 {want}, K2 0")
    check([set(x) for x in lines] == [keys["row"]] * len(Bs) + [keys["final"]],
          f"scale_bench: lines {lines} lack examples/scale_bench.py's keys")
    check(all(r["finite"] for r in final["sweep"]), f"scale_bench: a row not finite: {final}")
    big = Bs[-1]
    sel = torch.linspace(0, big - 1, BENCH_SWEEP_LANES, device=dev).round().long()
    sweep_err = against_plain(f"K1 in the sweep's last solve at B={big}", outs[big], sel,
                              converged=True)
    fresh = measure.production_inputs(dev, big, BENCH_SWEEP_N)
    sweep_err = max(sweep_err, against_plain(
        f"K1 in a solve of the sweep's inputs at B={big}",
        (fresh, sqp_cuda.batch_solve_fn(indy7(torch.float32, dev), cost, sqp, DT)(*fresh)), sel))

    t0 = time.perf_counter()
    lines, (mfinal, ranks) = capture_main(scale_bench.main, [n_sweep, "--mesh"])
    seconds["scale_bench_mesh"] = time.perf_counter() - t0
    cards = torch.cuda.device_count()
    check(lines[0] == {"mesh_devices": cards, "backend": "kernel-nccl"},
          f"scale_bench --mesh: first line {lines[0]}")
    check([set(x) for x in lines[1:]] == [keys["row"]] * len(Bs) + [keys["final"]],
          f"scale_bench --mesh: lines {lines[1:]} lack examples/scale_bench.py's keys")
    check(mfinal["sharded_mesh"] == cards and all(r["finite"] for r in mfinal["sweep"]),
          f"scale_bench --mesh: {mfinal}")
    for r in ranks:
        check(r["launches"] == want, f"scale_bench --mesh rank {r['rank']}: {r['launches']} "
              f"K1 launches, want {want}")
    same_bits, mesh_err = True, 0.0
    for b in Bs:
        _, res = outs[b]
        for name, got in (("X", ranks[0]["X"][b]), ("U", ranks[0]["U"][b])):
            want_np = getattr(res, name).cpu().numpy()
            lane_scale = np.maximum(np.abs(want_np).max(axis=(1, 2)), 1.0)[:, None, None]
            err = float((np.abs(got - want_np) / lane_scale).max())
            check(np.isfinite(got).all() and err <= 6e-3,
                  f"scale_bench --mesh B={b}: {name} scaled error {err:.3e} > 6e-3")
            mesh_err = max(mesh_err, float(np.abs(got - want_np).max()))
            same_bits &= bool(np.array_equal(got, want_np))
    print(f"bench: K1 max abs err against the plain version {bench_err:.3e} (the bench's first "
          f"and last chained solves), {sweep_err:.3e} (a solve of the sweep's inputs and its last "
          f"solve at B={big}, on {BENCH_SWEEP_LANES} lanes); "
          f"the --mesh sweep ({len(ranks)} rank(s), {lines[0]['backend']}) against the one-process sweep: max "
          f"abs err {mesh_err:.3e}, the same bits: {same_bits}; seconds {json.dumps(seconds)}",
          flush=True)
    summary.update(scale_bench=final["sweep"], scale_bench_mesh=mfinal["sweep"],
                   k1_err_sweep=sweep_err, mesh_err=mesh_err, mesh_same_bits=same_bits,
                   seconds=seconds)
    return launches["bench"], launches["scale_bench"], summary


def main():
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from indy7_mpc_tpu_torch.ops.kernels import _build
        from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
    except ImportError as e:
        raise SmokeFailure(f"the indy7_mpc_tpu_torch package is missing ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}", flush=True)

    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernels built and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip(), flush=True)
    print(f"K1: one block of {K1.THREADS} threads per lane, {K1.shared_bytes(N)} bytes of "
          f"dynamic shared memory at N={N} ({K1.shared_bytes(P2G_N)} at N={P2G_N}); past "
          f"N={K1.MAX_SEGMENT} a cluster of blocks per lane (N <= {K1.MAX_N}, the card holding "
          f"clusters of {K1.max_cluster(dev)})", flush=True)

    seconds = {}

    def timed(name, fn, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        print(f"[phase {name}: {seconds[name]:.1f} s]", flush=True)
        return out

    kernels = [timed("sqp", phase_sqp, dev), timed("tick", phase_tick, dev)]
    phases, graphs = {}, {}
    phases["run_sampled_mpc"], graphs["device_loop"] = timed("run_sampled_mpc",
                                                             phase_main_path, dev)
    phases["long_horizon"], long_horizon = timed("long_horizon", phase_long_horizon, dev)
    kernels[0]["long_horizon"] = long_horizon["k1"]
    phases["runtime_in_process"], graphs["controller"] = timed(
        "runtime_in_process", phase_runtime_inprocess, dev)
    phases["runtime_udp"] = timed("runtime_udp", phase_runtime_udp, dev)
    counts8, single_lane, graphs["single_lane"] = timed("run_mpc", phase_point_to_goal, dev)
    phases.update(counts8)
    phases["readable_vs_two_kernel"], loop9, readable = timed(
        "readable_vs_two_kernel", phase_readable, dev)
    phases["mjcf_plant"] = timed("mjcf_plant", phase_mjcf_plant, dev)
    phases["qp_backends"], qp = timed("qp_backends", phase_qp_backends, dev, loop9)
    phases["sharded"], sharded = timed("sharded", phase_sharded, dev)
    phases["recorded_runs"], recorded = timed("recorded_runs", phase_recorded_runs, dev)
    phases["tools"], tools = timed("tools", phase_tools, dev, kernels[0]["ms"])
    phases["bench"], phases["scale_bench"], benches = timed("bench", phase_bench, dev)
    print("phase seconds: " + json.dumps(seconds), flush=True)
    print("graphs: " + json.dumps(graphs), flush=True)
    print("long_horizon: " + json.dumps(long_horizon), flush=True)
    print("bench: " + json.dumps(benches), flush=True)
    print("tools: " + json.dumps(tools), flush=True)
    print("recorded_runs: " + json.dumps(recorded), flush=True)
    print("readable: " + json.dumps(readable), flush=True)
    print("qp_backends: " + json.dumps(qp), flush=True)
    print("sharded: " + json.dumps(sharded), flush=True)
    for k in kernels:
        k["launches"] = phases["run_sampled_mpc"][k["name"]]
        k["launches_by_phase"] = {p: n[k["name"]] for p, n in phases.items()}
    kernels[0]["single_lane"] = single_lane
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
