#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (indy7_mpc_tpu_torch) on one GPU.

Usage: python3 chip_smoke.py      (from the repository root; needs one card)

Phases, each fatal on failure (exit code 1, no result line):
  1. the card (nvidia-smi name and power limit), torch and CUDA versions;
  2. build the CUDA kernels from indy7_mpc_tpu_torch/csrc with nvcc;
  3. SQP kernel (K1) against its plain PyTorch version on the card:
     B=64, N=64, 2 SQP iterations, f32 with TF32 off; the line-search
     alphas must be equal on every lane and X, U within 6e-3 after scaling
     each lane by max(1, max |value|);
  4. tick-epilogue kernel (K2) against its plain version: B=64 on the
     perturbed plant (winner equal, err rtol 1e-3 / atol 1e-5, x_next atol
     2e-3, u and f_est equal to rtol 1e-7, eep atol 1e-5);
  5. the main path: run_sampled_mpc on the card at the fig-8 configuration
     (B=64, N=64, 2 SQP iterations, perturbed plant) for 500 ticks; the
     trace must be finite, the mean tracking error of the last 100 ticks
     below 0.2 m, and each kernel launched once per tick.

The line before the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}.
"""
import json
import os
import subprocess
import sys
import time

B, N, DT, SQP_ITERS, TICKS = 64, 64, 0.01, 2, 500
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean device milliseconds of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch

    fn()  # warm up
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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

    from indy7_mpc_tpu_torch.config import CostConfig, SQPConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

    cost, sqp = CostConfig(), SQPConfig(max_iters=SQP_ITERS)
    sm = LR.static_model(indy7(torch.float32, dev))
    rng = np.random.default_rng(11)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()
    w = rng.normal(size=(6, B)) * 8
    w[3:] = 0.0
    args = (
        f32(rng.normal(size=(12, B)) * 0.05),        # xs
        f32(rng.normal(size=(N, 3, B)) * 0.3),       # goals
        f32(rng.normal(size=(N, 12, B)) * 0.05),     # X
        f32(rng.normal(size=(N - 1, 6, B)) * 0.5),   # U
    )
    kw = dict(wrench=f32(w))
    k = sqp_solve(sm, cost, sqp, DT, *args, **kw)
    p = solve_lane_major(sm, cost, sqp, DT, *args, **kw)
    torch.cuda.synchronize()
    k_alpha, p_alpha = k[3].cpu().numpy(), p[3].cpu().numpy()
    bad = np.nonzero((k_alpha != p_alpha).any(axis=0))[0]
    check(bad.size == 0, f"K1 alphas differ on lanes {bad.tolist()}: "
          f"kernel {k_alpha[:, bad].tolist()} plain {p_alpha[:, bad].tolist()}")
    err = 0.0
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        check(bool(torch.isfinite(a).all()), "K1 output not finite")
        scale = b.abs().amax(dim=(0, 1)).clamp(min=1.0)
        scaled = ((a - b).abs() / scale).max().item()
        check(scaled <= 6e-3, f"K1 X/U scaled error {scaled:.3e} > 6e-3")
        err = max(err, (a - b).abs().max().item())
    ms = cuda_ms(lambda: sqp_solve(sm, cost, sqp, DT, *args, **kw), 20)
    plain_ms = cuda_ms(lambda: solve_lane_major(sm, cost, sqp, DT, *args, **kw), 2)
    print(f"K1 sqp_solve B={B} N={N}: kernel {ms * 1e3:.1f} us/solve, "
          f"plain {plain_ms * 1e3:.1f} us/solve, max |X,U err| {err:.3e}, "
          f"alphas equal on all {B} lanes", flush=True)
    return {"name": "sqp_solve", "route": "cuda",
            "source": "indy7_mpc_tpu_torch/csrc/sqp_kernel.cu",
            "replaces": "indy7_mpc_tpu/ops/pallas/sqp_kernel.py:251",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_tick(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, SampleConfig
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.ops import lane_rbd as LR
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import (
        tick_epilogue, tick_epilogue_plain,
    )
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
    k = tick_epilogue(smc, smp, cfg, DT, *args)
    p = tick_epilogue_plain(smc, smp, cfg, DT, *args)
    torch.cuda.synchronize()
    np_ = lambda t: t.cpu().numpy()
    check(int(k.best) == int(p.best), f"K2 winner {int(k.best)} != plain {int(p.best)}")
    try:
        np.testing.assert_allclose(np_(k.err), np_(p.err), rtol=1e-3, atol=1e-5)
        np.testing.assert_allclose(np_(k.x_next), np_(p.x_next), atol=2e-3)
        np.testing.assert_allclose(np_(k.u), np_(p.u))
        np.testing.assert_allclose(np_(k.f_est), np_(p.f_est))
        np.testing.assert_allclose(np_(k.eep), np_(p.eep), atol=1e-5)
    except AssertionError as e:
        raise SmokeFailure(f"K2 disagrees with its plain version: {e}")
    err = max((a - b).abs().max().item() for a, b in zip(
        (k.err, k.x_next, k.u, k.eep, k.f_est), (p.err, p.x_next, p.u, p.eep, p.f_est)))
    ms = cuda_ms(lambda: tick_epilogue(smc, smp, cfg, DT, *args), 50)
    plain_ms = cuda_ms(lambda: tick_epilogue_plain(smc, smp, cfg, DT, *args), 3)
    print(f"K2 tick_epilogue B={B}: kernel {ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, "
          f"max abs err {err:.3e}, winner {int(k.best)}", flush=True)
    return {"name": "tick_epilogue", "route": "cuda",
            "source": "indy7_mpc_tpu_torch/csrc/tick_kernel.cu",
            "replaces": "indy7_mpc_tpu/ops/pallas/tick_kernel.py:140",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def phase_main_path(dev):
    import numpy as np
    import torch

    from indy7_mpc_tpu_torch.config import (
        PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig,
    )
    from indy7_mpc_tpu_torch.models import indy7
    from indy7_mpc_tpu_torch.mpc import reference, run_sampled_mpc
    from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
    from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue

    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45],
                          period=10, dt=DT, cycles=1), 200)
    check(ref.shape[0] >= TICKS + N, "reference too short")
    x0 = torch.zeros(12, dtype=torch.float32, device=dev)
    x0[:6] = torch.tensor(INIT_Q)
    gen = torch.Generator(device=dev).manual_seed(42)
    sqp_solve.launches = 0
    tick_epilogue.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, trace = run_sampled_mpc(
        indy7(torch.float32, dev), CostConfig(), SQPConfig(max_iters=SQP_ITERS),
        MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B, f_ext_std=20.0,
                                            f_ext_resample_std=1.0),
        x0, ref, TICKS, F_TRUE0, gen, plant_cfg=PERTURBED_PLANT,
    )
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"sqp_solve": sqp_solve.launches, "tick_epilogue": tick_epilogue.launches}
    for name, n in launches.items():
        check(n == TICKS, f"{name} launched {n} times in {TICKS} ticks")
    for name, v in trace._asdict().items():
        check(v.shape[0] == TICKS, f"trace {name} has {v.shape[0]} rows")
        if v.is_floating_point():
            check(bool(torch.isfinite(v).all()), f"trace {name} not finite")
    te = trace.tracking_error.cpu().numpy().astype(np.float64)
    tail = te[-100:].mean()
    print(f"main path run_sampled_mpc B={B} N={N} perturbed plant, {TICKS} ticks: "
          f"{wall / TICKS * 1e6:.1f} us/tick (host clock, first tick included); "
          f"tracking error mean {te.mean():.4f} m, p50 {np.percentile(te, 50):.4f} m, "
          f"p95 {np.percentile(te, 95):.4f} m, last-100 mean {tail:.4f} m", flush=True)
    check(tail < 0.2, f"last-100 tracking error {tail:.4f} m >= 0.2 m")
    return launches


def main():
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: no GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from indy7_mpc_tpu_torch.ops.kernels import _build
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

    kernels = [phase_sqp(dev), phase_tick(dev)]
    launches = phase_main_path(dev)
    for k in kernels:
        k["launches"] = launches[k["name"]]
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
