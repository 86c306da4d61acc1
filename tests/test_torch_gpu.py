"""The port's CUDA kernels on the card against their plain versions (f32),
and the port's runtime on the card.

Every test here needs an NVIDIA GPU with CUDA and nvcc, and skips without
one.  The file imports no JAX, so it runs where JAX is not installed too;
tests/conftest.py imports JAX, so run it without the conftest there:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances are those of the TPU package's own kernel checks: the scaled
6e-3 of tests/test_pallas_kernel.py for the SQP solve, and the epilogue
tolerances of tests/test_fused_tick.py for the tick kernel.
"""
import dataclasses
import hashlib
import subprocess

import numpy as np
import pytest
import torch

from indy7_mpc_tpu_torch.config import (
    PERTURBED_PLANT, CostConfig, MPCConfig, PlantConfig, SampleConfig, SQPConfig,
)
from indy7_mpc_tpu_torch.models import indy7, indy7_mjcf
from indy7_mpc_tpu_torch.models.robot import FIELDS
from indy7_mpc_tpu_torch.mpc import (
    TickDraws, find_best_lane, init_loop_carry, reference, run_sampled_mpc, sampled_tick,
)
from indy7_mpc_tpu_torch.mpc.fused_tick import consensus_args
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import (
    tick_epilogue, tick_epilogue_plain,
)
from indy7_mpc_tpu_torch.runtime import (
    InProcessPlant, RunRecorder, SampledController, UdpTransport, run_control_loop,
)
from indy7_mpc_tpu_torch.sim import native
from indy7_mpc_tpu_torch.sim.kernel_plant import kernel_plant_args
from indy7_mpc_tpu_torch.sim.plant import perturb_model, predict_next_states
from indy7_mpc_tpu_torch.sim.readable_plant import make_plant_step
from indy7_mpc_tpu_torch.solvers import sqp as readable
from indy7_mpc_tpu_torch.solvers.sqp import SolverState
from indy7_mpc_tpu_torch.solvers.sqp_cuda import single_solve_fn
from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major

pytestmark = pytest.mark.gpu

B, N, DT = 8, 8, 0.01
COST, SQP = CostConfig(), SQPConfig(max_iters=2)
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _f32(a, device):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.float32, device=device)


# The benchmark's K1 shapes (lanes, horizon): mpcbench's fig8_b256_n32 and
# fig8_b64_n64, each solved with 2 SQP iterations, 8 alphas and the wrench.
BENCH_SHAPES = {"b256_n32": (256, 32), "b64_n64": (64, 64)}


@pytest.mark.parametrize("case,lanes,horizon", [
    pytest.param("wrench", B, N, id="wrench"),
    pytest.param("no_wrench", B, N, id="no_wrench"),
    pytest.param("barrier", B, N, id="barrier"),
    *(pytest.param("wrench", *shape, id=f"wrench_{name}") for name, shape in BENCH_SHAPES.items()),
])
def test_sqp_kernel_matches_plain(cuda, case, lanes, horizon):
    """K1 against the plain version, with and without the wrench, in the
    joint-range barrier, and at the benchmark's shapes."""
    rng = np.random.default_rng(11)
    sm = LR.static_model(indy7(torch.float32, cuda))
    w = rng.normal(size=(6, lanes)) * 8
    w[3:] = 0.0
    xs, goals, X, U = (
        rng.normal(size=shape) * scale
        for shape, scale in (((12, lanes), 0.05), ((horizon, 3, lanes), 0.3),
                             ((horizon, 12, lanes), 0.05), ((horizon - 1, 6, lanes), 0.5))
    )
    if case == "barrier":  # joint 1 in or past its joint-range barrier band
        X[:, 1] += 2.95 + 0.05 * np.arange(lanes)
        xs = X[0].copy()
    args = [_f32(a, cuda) for a in (xs, goals, X, U)]
    kw = dict(wrench=None if case == "no_wrench" else _f32(w, cuda))
    before = sqp_solve.launches
    k = sqp_solve(sm, COST, SQP, DT, *args, **kw)
    assert sqp_solve.launches == before + 1
    p = solve_lane_major(sm, COST, SQP, DT, *args, **kw)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(k[3].cpu().numpy(), p[3].cpu().numpy())
    np.testing.assert_allclose(k[2].cpu().numpy(), p[2].cpu().numpy(), rtol=1e-6)
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        # Per lane, scaled by max(1, max |value|) as the TPU kernel's check does.
        scale = b.abs().amax(dim=(0, 1)).clamp(min=1.0)
        np.testing.assert_allclose((a / scale).cpu().numpy(), (b / scale).cpu().numpy(), atol=6e-3)


def _k1_inputs(cuda, B, N, seed=11, wrench=True):
    """Random lane-major K1 inputs like tests/test_pallas_kernel.py's."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(6, B)) * 8
    w[3:] = 0.0
    args = [_f32(rng.normal(size=shape) * scale, cuda) for shape, scale in (
        ((12, B), 0.05), ((N, 3, B), 0.3), ((N, 12, B), 0.05), ((N - 1, 6, B), 0.5))]
    return args, dict(wrench=_f32(w, cuda) if wrench else None)


def _k1_against_plain(sm, sqp, args, kw):
    """One K1 launch against the plain version at test_sqp_kernel_matches_plain's
    tolerances: alphas equal, rho to 1e-6, X and U to 6e-3 scaled per lane."""
    before = sqp_solve.launches
    k = sqp_solve(sm, COST, sqp, DT, *args, **kw)
    assert sqp_solve.launches == before + 1
    p = solve_lane_major(sm, COST, sqp, DT, *args, **kw)
    torch.cuda.synchronize()
    _k1_outputs_match(k, p)


def _k1_outputs_match(k, p):
    """K1's outputs ``k`` against the plain version's ``p`` on the same
    lanes: alphas equal, rho to 1e-6, X and U to 6e-3 scaled per lane."""
    np.testing.assert_array_equal(k[3].cpu().numpy(), p[3].cpu().numpy())
    np.testing.assert_allclose(k[2].cpu().numpy(), p[2].cpu().numpy(), rtol=1e-6)
    for a, b in ((k[0], p[0]), (k[1], p[1])):
        assert torch.isfinite(a).all()
        scale = b.abs().amax(dim=(0, 1)).clamp(min=1.0)
        np.testing.assert_allclose((a / scale).cpu().numpy(), (b / scale).cpu().numpy(), atol=6e-3)


# The benchmark's long-horizon K1 shape, fig8_b64_n256: a cluster of 2
# blocks a lane (the cluster-size test runs BENCH_SHAPES at cluster=1,
# which N=256 cannot take).
LONG_SHAPE = {"b64_n256": (64, 256)}


@pytest.mark.parametrize("lanes,horizon,variant", [
    pytest.param(16, 24, {"threads": 32}, id="threads32"),
    pytest.param(16, 24, {"threads": 128}, id="threads128"),
    *(pytest.param(*shape, {"threads": t}, id=f"{name}_threads{t}")
      for name, shape in {**BENCH_SHAPES, **LONG_SHAPE}.items() for t in (64, 128)),
])
def test_sqp_kernel_same_bits_at_any_block_size(cuda, lanes, horizon, variant):
    """Every cooperative loop of K1 strides by the block size between
    barriers and every sum is taken by one thread in a fixed order, so X,
    U, rho, alphas and steps are the same bits at the default block size
    (256 threads), on a second launch of the same inputs, and at
    ``variant`` (32, 64 or 128 threads), also at the benchmark's shapes,
    the cluster kernel's (N=256) among them: a race check that needs no
    sanitizer, for both kernels' warp layouts."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    args, kw = _k1_inputs(cuda, lanes, horizon)
    first = sqp_solve(sm, COST, SQP, DT, *args, **kw)
    again = sqp_solve(sm, COST, SQP, DT, *args, **kw)
    other = sqp_solve(sm, COST, SQP, DT, *args, **kw, **variant)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, other):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b) and torch.equal(a, c)


def k1_digest(device, lanes, horizon):
    """sha256 of K1's outputs (X, U, rho, alphas, steps, in that order, as
    float32 bytes) for ``_k1_inputs``' seeded inputs at (lanes, horizon)."""
    sm = LR.static_model(indy7(torch.float32, device))
    args, kw = _k1_inputs(device, lanes, horizon)
    digest = hashlib.sha256()
    for t in sqp_solve(sm, COST, SQP, DT, *args, **kw):
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


# K1's outputs at the benchmark's three shapes, as the kernel gave them
# before its Riccati knot step was rescheduled (commit f2d140b; NVIDIA H100
# 80GB HBM3, nvcc 12.9): see test_sqp_kernel_outputs_equal_recorded_digest.
K1_DIGESTS = {
    "b256_n32": "8d779c88ba112b7812419b4c4dfcd9de8d7e4f5473280597270b08567da049e7",
    "b64_n64": "9e5e41a2fba60734bdf2b2a67cc1a0073e1353915bbec635b906e51d692ddae5",
    "b64_n256": "beb4c5926556f8ff696bb51f149a5dd9a7131777703055bdda8f0d96547ae7f2",
}


@pytest.mark.parametrize("name", list(K1_DIGESTS))
def test_sqp_kernel_outputs_equal_recorded_digest(cuda, name):
    """K1's X, U, rho, alphas and steps at the benchmark's shapes are the
    bits that the kernel gave before its Riccati knot step was rescheduled:
    the schedule decides which thread computes an entry and when, not how.
    Recorded on the card from that commit's package, with this file:

        mkdir -p build/k1_parent && git archive f2d140b | tar -x -C build/k1_parent
        PYTHONPATH=build/k1_parent python3 tests/test_torch_gpu.py
    """
    lanes, horizon = {**BENCH_SHAPES, **LONG_SHAPE}[name]
    assert k1_digest(cuda, lanes, horizon) == K1_DIGESTS[name]


@pytest.mark.parametrize("lanes,horizon", [(1, 2), (1, 8), (3, 2), (3, 8), (65, 2), (65, 8)])
def test_sqp_kernel_edge_shapes_match_plain(cuda, lanes, horizon):
    """K1 against the plain version at one lane, an odd lane count and one
    over 64, with one running knot (N=2) and with N=8.  At N=2 the first
    iteration solves the one-knot problem, and the second one's merit
    differences (about 1e-11 relative, in float64) lie below float32
    rounding, so its alpha is noise in both versions: N=2 runs one
    iteration."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    sqp = SQPConfig(max_iters=1 if horizon == 2 else 2)
    _k1_against_plain(sm, sqp, *_k1_inputs(cuda, lanes, horizon))


def test_sqp_kernel_full_width_matches_plain(cuda):
    """K1 at the main path's width, B=64 and N=64 with a wrench, 2 SQP
    iterations (the smallest line-search margin there is 7.7e-4 relative
    in float64)."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    _k1_against_plain(sm, SQP, *_k1_inputs(cuda, 64, 64))


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_sqp_kernel_stage_cut(cuda, stages):
    """The profiling cut runs stages 1..``stages`` only: the trajectory is
    returned as it came in (with X[0] = xs), alphas and steps are 0, rho
    is unchanged."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    args, kw = _k1_inputs(cuda, 5, 8)
    X, U, rho, alphas, steps = sqp_solve(sm, COST, SQP, DT, *args, **kw, stages=stages)
    want = args[2].clone()
    want[0] = args[0]
    assert torch.equal(X, want) and torch.equal(U, args[3])
    assert (alphas == 0).all() and (steps == 0).all()
    assert torch.equal(rho, torch.full_like(rho, SQP.rho))


def test_sqp_kernel_horizon_limit(cuda):
    """The longest horizon that fits the shared memory of a cluster this
    card holds (N=1,392 in clusters of 8 blocks where the card holds
    them) runs; one knot more raises before any launch."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    ceiling = K1.max_horizon(clusters=K1.max_cluster(cuda))
    assert ceiling >= 512
    args, kw = _k1_inputs(cuda, 1, ceiling + 1)
    before = sqp_solve.launches
    with pytest.raises(ValueError, match="shared memory"):
        sqp_solve(sm, COST, SQP, DT, *args, **kw)
    assert sqp_solve.launches == before
    args, kw = _k1_inputs(cuda, 1, ceiling)
    out = sqp_solve(sm, COST, SQP, DT, *args, **kw)
    torch.cuda.synchronize()
    assert all(torch.isfinite(t).all() for t in out)


@pytest.mark.parametrize("lanes", [1, 64])
@pytest.mark.parametrize("horizon", [175, 256, 512])
def test_sqp_kernel_past_one_block_matches_plain(cuda, horizon, lanes):
    """K1 with the lane's horizon over a cluster of 2 (N=175, 256) or 3
    (N=512) blocks against the plain version on a fresh solve: alphas
    equal, X and U within the scaled 6e-3."""
    assert K1.cluster_size(horizon) == (2 if horizon < 512 else 3)
    sm = LR.static_model(indy7(torch.float32, cuda))
    _k1_against_plain(sm, SQP, *_k1_inputs(cuda, lanes, horizon))


@pytest.mark.parametrize("lanes,horizon", [(16, 96), *BENCH_SHAPES.values()])
@pytest.mark.parametrize("cluster", [2, 4])
def test_sqp_kernel_same_bits_at_any_cluster_size(cuda, cluster, lanes, horizon):
    """Every sum over knots is taken by one thread in knot order, over the
    cluster's shared memory, so N=96 (and the benchmark's shapes) in one
    block and in clusters of 2 and 4 blocks (the ``cluster=`` override)
    gives the same bits."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    args, kw = _k1_inputs(cuda, lanes, horizon)
    one = sqp_solve(sm, COST, SQP, DT, *args, **kw, cluster=1)
    before = sqp_solve.launches
    many = sqp_solve(sm, COST, SQP, DT, *args, **kw, cluster=cluster)
    assert sqp_solve.launches == before + 1
    torch.cuda.synchronize()
    for a, b in zip(one, many):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.parametrize("num_alphas", [20, 30])
def test_sqp_kernel_more_alphas_match_plain(cuda, num_alphas):
    """Past 16 alphas the merits take a slot an alpha, past 24 the work
    region two floats an alpha: K1 against the plain version, in one
    block (N=96) and in a cluster (N=256)."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    sqp = dataclasses.replace(SQP, num_alphas=num_alphas)
    for horizon in (96, 256):
        _k1_against_plain(sm, sqp, *_k1_inputs(cuda, 16, horizon))


def _rcp_pairs(cuda, chunk, log2n, fast, ref):
    """(rcp_rn(x), 1.f / x) as int32 bits for the 2^log2n bit patterns
    from chunk * 2^log2n on, by the checker entry (csrc/rcp_check.cu)."""
    from indy7_mpc_tpu_torch.ops.kernels import _build

    stream = torch.cuda.current_stream(cuda).cuda_stream
    err = _build.load_library().indy7_rcp_check(chunk, log2n, fast.data_ptr(), ref.data_ptr(),
                                                stream)
    assert err == 0, err
    return fast.view(torch.int32), ref.view(torch.int32)


# Bit patterns at the edges of rcp_rn's fast range (biased exponents 1-252)
# and the special values: +-0, subnormals, 2^-126 and its neighbours, the
# largest fast input, 2^126, the largest float, +-inf, NaNs, and 1.
RCP_EDGES = (0x00000000, 0x80000000, 0x00000001, 0x007FFFFF, 0x80000001, 0x807FFFFF,
             0x00800000, 0x00800001, 0x80800000, 0x7E7FFFFF, 0x7E800000, 0xFE7FFFFF,
             0xFE800000, 0x7F7FFFFF, 0x7F800000, 0xFF800000, 0x7FC00000, 0xFFFFFFFF,
             0x3F800000)


def test_rcp_rn_is_the_ieee_reciprocal_for_every_float(cuda):
    """rbd.cuh's rcp_rn(x), which takes every LDL^T pivot's reciprocal in
    K1, is the same bits as `1.f / x` for all 2^32 bit patterns, or both
    NaN; at the range edges and special values (RCP_EDGES) both equal
    numpy's float32 1 / x too."""
    log2n = 28
    fast = torch.empty(1 << log2n, dtype=torch.float32, device=cuda)
    ref = torch.empty_like(fast)
    for chunk in range(1 << (32 - log2n)):
        a, b = _rcp_pairs(cuda, chunk, log2n, fast, ref)
        bad = torch.nonzero((a != b) & ~(torch.isnan(fast) & torch.isnan(ref)))
        assert bad.numel() == 0, [hex((chunk << log2n) + int(i)) for i in bad[:8, 0]]
    small = torch.empty(1 << 10, dtype=torch.float32, device=cuda)
    small_ref = torch.empty_like(small)
    for bits in RCP_EDGES:
        a, b = _rcp_pairs(cuda, bits >> 10, 10, small, small_ref)
        x = np.array([bits], np.uint32).view(np.float32)
        with np.errstate(divide="ignore", over="ignore", invalid="ignore"):
            want = int((np.float32(1.0) / x).view(np.int32)[0])
        got = [int(a[bits & 1023]), int(b[bits & 1023])]
        if np.isnan(x[0]):
            assert all(np.isnan(np.array([g], np.int32).view(np.float32)[0]) for g in got)
        else:
            assert got == [want, want], (hex(bits), got, want)


# ptxas's figures for K2's entries (registers, stack frame, spill store and
# load bytes; nvcc 12.9, -O3, sm_90a): the thread-per-lane entry runs
# rbd.cuh's rk4_step on 128 registers a thread at 512 threads, the team
# entry rbd_team.cuh's routines with the teams' scratch in shared memory.
K2_PTXAS = {"tick_kernelILb1": (128, 1800, 3020, 6120), "tick_kernelILb0": (85, 32, 0, 0)}


def test_sqp_kernel_has_no_local_memory_frame(cuda):
    """K1's rigid-body items index every per-link array by compile-time
    constants, so the one-block kernel keeps at most 64 bytes of stack frame
    and the cluster kernel 120 (sincosf's slow path, the rollout's du and a
    few words of loop state; per-link arrays indexed at run time would take
    kilobytes).  What ptxas still spills is loop state outside the
    rigid-body code: at most 12 bytes in the one-block kernel, 60 in the
    cluster kernel (with the Riccati sweep's Quu factor inlined around the
    compiler's divisions, 28 and 80; around rcp_rn, 12 and 56).
    K2's entries have the figures of K2_PTXAS."""
    from indy7_mpc_tpu_torch import measure
    from indy7_mpc_tpu_torch.ops.kernels import _build

    _build.load_library()
    log = _build.build_log()
    k1 = measure.ptxas_figures(measure.ptxas_lines(log, "sqp_kernel"))
    entries = {key: [f for n, f in k1.items() if key in n] for key in ("ILb0", "ILb1")}
    assert all(len(f) == 1 for f in entries.values()), k1
    (one,), (cluster,) = entries["ILb0"], entries["ILb1"]
    assert one[1] <= 64 and cluster[1] <= 120, k1
    assert one[2] <= 12 and cluster[2] <= 60, k1
    k2 = measure.ptxas_figures(measure.ptxas_lines(log, "tick_kernel"))
    assert {key: [f for n, f in k2.items() if key in n] for key in K2_PTXAS} == {
        key: [f] for key, f in K2_PTXAS.items()}


TICK_CASES = {
    "nominal": (PlantConfig(), ()),
    "perturbed": (PERTURBED_PLANT, ()),
    "nan_consensus": (PERTURBED_PLANT, (3, 5)),
    "saturated": (dataclasses.replace(PERTURBED_PLANT, velocity_saturation=True), ()),
}


def _tick_case(device, case, lanes):
    """TICK_CASES[case]'s models, plant config and K2 inputs at ``lanes``
    hypotheses, from a seeded generator."""
    cfg, nan_lanes = TICK_CASES[case]
    model = indy7(torch.float32, device)
    smc, smp = LR.static_model(model), LR.static_model(perturb_model(model, cfg))
    rng = np.random.default_rng(4)
    x_cur = np.r_[INIT_Q, 0.1 * np.ones(6)]
    if case == "saturated":  # past the velocity limits, joint 5 near its stop
        x_cur = np.r_[INIT_Q[:5], 3.7, 3.0 * np.ones(6)]
    f_batch = rng.normal(size=(6, lanes)) * 20.0
    f_batch[3:] = 0.0
    f_batch[:, 0] = 0.0
    for lane in nan_lanes:
        f_batch[0, lane] = np.nan
    noise = cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6))
    args = [_f32(a, device) for a in (
        x_cur, x_cur + 0.01 * rng.normal(size=12), 5.0 * rng.normal(size=6), f_batch,
        3.0 * rng.normal(size=(6, lanes)), F_TRUE0,
    )] + [_f32(noise, device) if cfg.torque_noise_std else None]
    return smc, smp, cfg, args


@pytest.mark.parametrize("case", list(TICK_CASES))
def test_tick_kernel_matches_plain(cuda, case):
    best = _k2_against_plain(*_tick_case(cuda, case, B))
    nan_lanes = TICK_CASES[case][1]
    if nan_lanes:  # a NaN consensus error wins, first NaN first
        assert best == nan_lanes[0]


def k2_digest(device, case, lanes):
    """sha256 of K2's outputs (err, best, x_next, u, eep, f_est, in that
    order, as bytes) for TICK_CASES[case] at ``lanes`` hypotheses."""
    smc, smp, cfg, args = _tick_case(device, case, lanes)
    digest = hashlib.sha256()
    for t in tick_epilogue(smc, smp, cfg, DT, *args):
        digest.update(t.cpu().numpy().tobytes())
    return digest.hexdigest()


# K2's outputs for each TICK_CASES case at B=64 and 256 (a team a lane)
# and 1,024 (a thread a lane), recorded on the card (NVIDIA H100 80GB
# HBM3, nvcc 12.9) from commit 59ebd61's package: see
# test_tick_kernel_outputs_equal_recorded_digest.
K2_LANES = (64, 256, 1024)
K2_DIGESTS = {
    "nominal_b64": "c76e610feca4b83d2d72e8d5573026b25e3b439e78d62ec7c87f65c194cb6e79",
    "nominal_b256": "ba22eebdee50a339e37bfc608ad0661c2af62a536dc9bc4a0495e85264feff7a",
    "nominal_b1024": "c92e5c2c1af6935c550797012c1392876e1a1f2daaa97f74d8f0e62bd811f40a",
    "perturbed_b64": "7dc034b376ad0adc3acd7ee58e8ca5cb52967f646d4ff57f09147dbfaeeb54d0",
    "perturbed_b256": "aee36d25fbbf1b6a0df4e7bff6951e65d7dbd554947da2494de566a88a711110",
    "perturbed_b1024": "55c641c3a67510a79474f38b6242edd97530d80a33c8e0e11d2636d0cd964b48",
    "nan_consensus_b64": "595be3fe90036d1a3d2af5b85d95bf4b52a7f914084194ac0b1aa43e95c7f693",
    "nan_consensus_b256": "52f199ccf302a6eeb9ff8ee03a3e7d36638a3f0e991c29bddd575b5161802182",
    "nan_consensus_b1024": "2a4ece02a349053aae892eeca187245a3d61757b78480b62041a7532e52b9e6d",
    "saturated_b64": "aa52da29b95b5f204ec7c5fa29d0ef92d2a62b80dcf035486b62307316978270",
    "saturated_b256": "5e31f2aed1e50c8dabe2e86b4f345ee91741cacce915dc7e2db1e0490cf49230",
    "saturated_b1024": "47d2c9ce3963eaa24eef2ca39a6f8b2e20b44d01fe727bad905d28984c1a30ba",
}


@pytest.mark.parametrize("name", list(K2_DIGESTS))
def test_tick_kernel_outputs_equal_recorded_digest(cuda, name):
    """K2's err, best, x_next, u, eep and f_est on both of its consensus
    paths are the bits recorded from commit 59ebd61, when each rigid-body
    routine had its own copy in the team path and the thread path: one
    copy of each routine changes where values live, not how they are
    computed.  Recorded on the card with this file:

        mkdir -p build/parent && git archive 59ebd61 | tar -x -C build/parent
        PYTHONPATH=build/parent python3 tests/test_torch_gpu.py
    """
    case, lanes = name.rsplit("_b", 1)
    assert k2_digest(cuda, case, int(lanes)) == K2_DIGESTS[name]


def _k2_against_plain(smc, smp, cfg, args, plant=True):
    """One K2 launch against the plain version on ``args``; returns the
    winner."""
    before = tick_epilogue.launches
    k = tick_epilogue(smc, smp, cfg, DT, *args, plant=plant)
    assert tick_epilogue.launches == before + 1
    p = tick_epilogue_plain(smc, smp, cfg or PlantConfig(), DT, *args, plant=plant)
    torch.cuda.synchronize()
    assert int(k.best) == int(p.best)
    np.testing.assert_allclose(k.err.cpu().numpy(), p.err.cpu().numpy(), rtol=1e-3, atol=1e-5)
    if plant:
        np.testing.assert_allclose(k.x_next.cpu().numpy(), p.x_next.cpu().numpy(), atol=2e-3)
    else:
        assert k.x_next is None and p.x_next is None
    np.testing.assert_array_equal(k.u.cpu().numpy(), p.u.cpu().numpy())
    np.testing.assert_array_equal(k.f_est.cpu().numpy(), p.f_est.cpu().numpy())
    np.testing.assert_allclose(k.eep.cpu().numpy(), p.eep.cpu().numpy(), atol=1e-5)
    return int(k.best)


@pytest.mark.parametrize("call", ["consensus", "plant_step", "perturbed_plant_step"])
def test_tick_kernel_runtime_calls_match_plain(cuda, call):
    """K2 as the runtime calls it: the host tick's consensus (B=64, the
    controller model as the plant, no plant config, zero true wrench) and
    the single-state plant step of InProcessPlant / run_mpc /
    run_tracking_mpc (B=1: nominal without a wrench, and perturbed with
    wrench and actuation noise)."""
    model = indy7(torch.float32, cuda)
    smc = LR.static_model(model)
    rng = np.random.default_rng(8)
    t = lambda a: _f32(a, cuda)
    x = t(np.r_[INIT_Q, 0.3 * rng.normal(size=6)])
    u = t(5.0 * rng.normal(size=6))
    if call == "consensus":
        lanes = 64
        f_batch = 20.0 * rng.normal(size=(6, lanes))
        f_batch[3:] = 0.0
        f_batch[:, 0] = 0.0
        x_obs = predict_next_states(smc, x, u, DT, t(f_batch))[:, 9] + t(1e-4 * rng.normal(size=12))
        best = _k2_against_plain(smc, smc, None, consensus_args(
            x_obs, x, u, t(f_batch), t(3.0 * rng.normal(size=(6, lanes)))))
        assert best == 9
    elif call == "plant_step":
        _k2_against_plain(smc, smc, PlantConfig(), kernel_plant_args(x, u))
    else:
        cfg = PERTURBED_PLANT
        noise = t(cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6)))
        smp = LR.static_model(perturb_model(model, cfg))
        _k2_against_plain(smc, smp, cfg, kernel_plant_args(x, u, t(F_TRUE0), noise))


def _k2_args(cuda, lanes, seed=5, cfg=PERTURBED_PLANT):
    """Phase 4's K2 inputs at ``lanes`` hypotheses (the perturbed plant)."""
    rng = np.random.default_rng(seed)
    x_cur = np.r_[INIT_Q, 0.1 * np.ones(6)]
    f_batch = rng.normal(size=(6, lanes)) * 20.0
    f_batch[3:] = 0.0
    f_batch[:, 0] = 0.0
    return [_f32(a, cuda) for a in (
        x_cur, x_cur + 0.01 * rng.normal(size=12), 5.0 * rng.normal(size=6), f_batch,
        3.0 * rng.normal(size=(6, lanes)), F_TRUE0,
        cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6)))]


def _k2_models(cuda, cfg=PERTURBED_PLANT):
    model = indy7(torch.float32, cuda)
    return LR.static_model(model), LR.static_model(perturb_model(model, cfg)), cfg


@pytest.mark.parametrize("lanes", [100, 300])
@pytest.mark.parametrize("threads", [256, 32])
def test_tick_kernel_same_bits_at_any_block_size(cuda, threads, lanes):
    """Each lane's error comes from one team (B <= 256) or one thread
    (B > 256), chosen by B alone, and the argmin is order-free under the
    (err, lane) rule, so K2 gives the same bits at 512 threads, on a
    second launch, and at 256 or 32 threads (a race check that needs no
    sanitizer); B=100 takes two rounds of teams at 512 threads and 25 at
    32, B=300 ten rounds of threads at 32."""
    smc, smp, cfg = _k2_models(cuda)
    args = _k2_args(cuda, lanes)
    first = tick_epilogue(smc, smp, cfg, DT, *args, threads=512)
    again = tick_epilogue(smc, smp, cfg, DT, *args, threads=512)
    other = tick_epilogue(smc, smp, cfg, DT, *args, threads=threads)
    torch.cuda.synchronize()
    for a, b, c in zip(first, again, other):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("lanes", [1, 7, 65, 257, 1024])
def test_tick_kernel_edge_lane_counts_match_plain(cuda, lanes):
    """One lane, an odd count and one past a round of 64 teams (a team per
    lane), one past the teams' 256 lanes and 1,024 (a thread per lane),
    against the plain version at phase 4's tolerances."""
    smc, smp, cfg = _k2_models(cuda)
    _k2_against_plain(smc, smp, cfg, _k2_args(cuda, lanes, seed=lanes))


def test_tick_kernel_consensus_without_plant_matches_plain(cuda):
    """The host tick's consensus with ``plant=False``: the kernel skips its
    plant step; winner, err, u, f_est and eep match the plain version and
    the full call, and ``x_next`` is None."""
    model = indy7(torch.float32, cuda)
    smc = LR.static_model(model)
    rng = np.random.default_rng(8)
    t = lambda a: _f32(a, cuda)
    x, u = t(np.r_[INIT_Q, 0.3 * rng.normal(size=6)]), t(5.0 * rng.normal(size=6))
    f_batch = 20.0 * rng.normal(size=(6, 64))
    f_batch[3:] = 0.0
    f_batch[:, 0] = 0.0
    x_obs = predict_next_states(smc, x, u, DT, t(f_batch))[:, 9] + t(1e-4 * rng.normal(size=12))
    args = consensus_args(x_obs, x, u, t(f_batch), t(3.0 * rng.normal(size=(6, 64))))
    assert _k2_against_plain(smc, smc, None, args, plant=False) == 9
    k = tick_epilogue(smc, smc, None, DT, *args, plant=False)
    full = tick_epilogue(smc, smc, None, DT, *args)
    torch.cuda.synchronize()
    assert k.x_next is None and full.x_next is not None
    for name in ("err", "best", "u", "eep", "f_est"):
        assert torch.equal(getattr(k, name), getattr(full, name))


@pytest.mark.parametrize("lanes", [128, 16384])
def test_kernels_at_sharded_block_widths_match_plain(cuda, lanes):
    """K1 and K2's consensus at a rank's block of the sharded loop (128 and
    16,384 lanes: B=256 and B=32,768 over two ranks).  K1 on every lane,
    held on 128 lanes spread over the block against the plain version on
    those lanes' inputs (K1 solves each lane in its own block) at
    _k1_against_plain's tolerances; K2 with its plant step skipped on every
    lane at phase 4's, the winner equal (past 256 lanes K2 scores a lane
    per thread)."""
    sm = LR.static_model(indy7(torch.float32, cuda))
    args, kw = _k1_inputs(cuda, lanes, 8, seed=lanes)
    k = sqp_solve(sm, COST, SQP, DT, *args, **kw)
    sel = torch.linspace(0, lanes - 1, 128, device=cuda).round().long()
    pick = lambda t: t.index_select(t.dim() - 1, sel).contiguous()
    p = solve_lane_major(sm, COST, SQP, DT, *map(pick, args), wrench=pick(kw["wrench"]))
    torch.cuda.synchronize()
    _k1_outputs_match([pick(t) for t in k], p)
    x_cur, x_last, u_last, f_batch, U0, _, _ = _k2_args(cuda, lanes, seed=lanes)
    _k2_against_plain(sm, sm, None, consensus_args(x_cur, x_last, u_last, f_batch, U0),
                      plant=False)


def test_tick_kernel_refuses_bad_launches(cuda):
    """Block sizes the kernel does not take raise before any launch."""
    smc, smp, cfg = _k2_models(cuda)
    args = _k2_args(cuda, 8)
    before = tick_epilogue.launches
    for threads in (16, 96, 1024):
        with pytest.raises(ValueError, match="threads"):
            tick_epilogue(smc, smp, cfg, DT, *args, threads=threads)
    assert tick_epilogue.launches == before


def test_in_process_plant_on_the_card(cuda):
    """InProcessPlant on a card state steps through K2, one launch per
    command, and follows the same plant on the CPU (plain version, f32;
    the actuation noise off, since the two devices' generators differ)."""
    cfg = dataclasses.replace(PERTURBED_PLANT, torque_noise_std=0.0)
    x0 = np.r_[INIT_Q, np.zeros(6)]
    rng = np.random.default_rng(9)
    us = 10.0 * rng.normal(size=(5, 6))
    xs = {}
    for device in (cuda, torch.device("cpu")):
        plant = InProcessPlant(indy7(torch.float32), torch.as_tensor(x0, dtype=torch.float32,
                                                                     device=device), DT,
                               plant_cfg=cfg)
        plant.send_wrench(F_TRUE0[:3])
        before = tick_epilogue.launches
        for u in us:
            plant.send_command(u)
        assert tick_epilogue.launches - before == (len(us) if device.type == "cuda" else 0)
        assert plant.recv_state().x.device.type == device.type
        xs[device.type] = plant.recv_state().x.cpu().numpy()
    assert np.isfinite(xs["cuda"]).all()
    np.testing.assert_allclose(xs["cuda"], xs["cpu"], atol=2e-3)


def test_make_plant_step_on_the_card_matches_k2(cuda):
    """The readable plant's make_plant_step(PERTURBED_PLANT) in f32 on the
    card against K2's plant step on the same state, control, true wrench
    and normals (x_next at phase 4's atol 2e-3; the step launches no
    kernel), and in f64 on the card against f64 on the CPU."""
    cfg = PERTURBED_PLANT
    rng = np.random.default_rng(12)
    x = np.r_[INIT_Q, 0.3 * rng.normal(size=6)]
    u, normals = 5.0 * rng.normal(size=6), rng.normal(size=(cfg.substeps, 6))
    model = indy7(torch.float32, cuda)
    smc, smp = LR.static_model(model), LR.static_model(perturb_model(model, cfg))
    t = lambda a: _f32(a, cuda)
    before = tick_epilogue.launches
    k2 = tick_epilogue(smc, smp, cfg, DT, *kernel_plant_args(
        t(x), t(u), t(F_TRUE0), t(cfg.torque_noise_std * normals)))
    assert tick_epilogue.launches == before + 1
    _, step_fn = make_plant_step(model, cfg)
    got = step_fn(t(x), t(u), t(F_TRUE0), t(normals), DT)
    assert tick_epilogue.launches == before + 1 and got.device.type == "cuda"
    np.testing.assert_allclose(got.cpu().numpy(), k2.x_next.reshape(12).cpu().numpy(), atol=2e-3)

    f64 = {}
    for device in (cuda, torch.device("cpu")):
        _, step_fn = make_plant_step(indy7(torch.float64, device), cfg)
        d = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)
        f64[device.type] = step_fn(d(x), d(u), d(F_TRUE0), d(normals), DT).cpu().numpy()
    np.testing.assert_allclose(f64["cuda"], f64["cpu"], rtol=0, atol=1e-9)


def test_closed_loop_on_the_card_follows_the_cpu_loop(cuda):
    """run_sampled_mpc on the card (both kernels, f32) against the same
    loop on the CPU (plain versions, f64) with the same draws: one kernel
    launch of each per tick, the same winners, states within f32 reach."""
    ticks = 6
    ref = reference.with_padding(
        reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT,
                          cycles=1), 200)
    rng = np.random.default_rng(0)
    f_batch0 = rng.normal(size=(B, 6)) * 20.0
    f_batch0[:, 3:] = 0.0
    f_batch0[0] = 0.0
    draws = [
        (rng.normal(size=(B, 6)), rng.normal(size=3), rng.normal(size=(PERTURBED_PLANT.substeps, 6)))
        for _ in range(ticks)
    ]
    runs = {}
    for device, dtype in ((cuda, torch.float32), (torch.device("cpu"), torch.float64)):
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        x0 = t(np.r_[INIT_Q, np.zeros(6)])
        gen = torch.Generator(device=device).manual_seed(0)
        carry0 = init_loop_carry(indy7(dtype, device), MPCConfig(N=N, dt=DT),
                                 SampleConfig(batch_size=B), x0, F_TRUE0, gen)._replace(f_batch=t(f_batch0))
        before = (sqp_solve.launches, tick_epilogue.launches)
        _, trace = run_sampled_mpc(
            indy7(dtype, device), COST, SQP, MPCConfig(N=N, dt=DT), SampleConfig(batch_size=B),
            x0, ref, ticks, F_TRUE0, gen, plant_cfg=PERTURBED_PLANT, carry0=carry0,
            draws=[TickDraws(*(t(d) for d in dr)) for dr in draws],
        )
        launched = (sqp_solve.launches - before[0], tick_epilogue.launches - before[1])
        assert launched == ((ticks, ticks) if device.type == "cuda" else (0, 0))
        runs[device.type] = {f: v.cpu().double().numpy() for f, v in trace._asdict().items()}
    gpu, cpu = runs["cuda"], runs["cpu"]
    assert all(np.isfinite(v).all() for v in gpu.values())
    np.testing.assert_array_equal(gpu["best_idx"], cpu["best_idx"])
    np.testing.assert_allclose(gpu["x"], cpu["x"], atol=5e-3)
    np.testing.assert_allclose(gpu["tracking_error"], cpu["tracking_error"], atol=1e-3)


def test_sampled_tick_on_the_card(cuda):
    """The host-driven tick launches K1 and K2 once each; K2's consensus
    winner is the plain predict-and-argmin's on the same inputs."""
    rng = np.random.default_rng(6)
    x_last = np.r_[INIT_Q, 0.2 * rng.normal(size=6)]
    u_last = 5.0 * rng.normal(size=6)
    f_batch = 20.0 * rng.normal(size=(B, 6))
    f_batch[:, 3:] = 0.0
    f_batch[0] = 0.0
    sm = LR.static_model(indy7(torch.float32, cuda))
    t = lambda a: _f32(a, cuda)
    x_obs = predict_next_states(sm, t(x_last), t(u_last), DT, t(f_batch).T)[:, 5]
    x_obs = x_obs + t(1e-4 * rng.normal(size=12))
    goals = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10,
                              dt=DT, cycles=1)[:N]
    args = [t(a) for a in (x_last, u_last, goals, np.tile(x_last, (N, 1)),
                           rng.normal(size=(N - 1, 6)), f_batch)]
    before = (sqp_solve.launches, tick_epilogue.launches)
    out = sampled_tick(indy7(torch.float32), COST, SQP, SampleConfig(batch_size=B), DT,
                       torch.Generator(device=cuda).manual_seed(0), x_obs, *args)
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (1, 1)
    best, _ = find_best_lane(sm, t(x_last), t(u_last), x_obs, DT, t(f_batch))
    assert int(out.best_idx) == int(best) == 5
    assert torch.isfinite(out.X_best).all() and torch.isfinite(out.f_batch).all()
    np.testing.assert_array_equal(out.f_est.cpu().numpy(), f_batch[5].astype(np.float32))


def test_single_solve_fn_matches_plain(cuda):
    """K1 at B = 1 through single_solve_fn, the SolverState carried in and
    out, against the plain version."""
    n, sqp = 32, SQPConfig(max_iters=3)
    rng = np.random.default_rng(13)
    xs, goals = np.r_[INIT_Q, np.zeros(6)], np.tile([0.3, 0.3, 0.6], (n, 1))
    X, U = rng.normal(size=(n, 12)) * 0.05, rng.normal(size=(n - 1, 6)) * 0.5
    state = SolverState(rho=torch.tensor(4e-6, device=cuda))
    before = sqp_solve.launches
    res = single_solve_fn(indy7(torch.float32), COST, sqp, DT)(
        *(_f32(a, cuda) for a in (xs, goals, X, U)), state)
    assert sqp_solve.launches == before + 1
    sm = LR.static_model(indy7(torch.float32, cuda))
    lane = lambda a: _f32(a, cuda)[..., None]
    p = solve_lane_major(sm, COST, sqp, DT, lane(xs), lane(goals), lane(X), lane(U),
                         rho=state.rho.reshape(1))
    np.testing.assert_array_equal(res.stats.alphas.cpu().numpy(), p[3][:, 0].cpu().numpy())
    np.testing.assert_allclose(float(res.state.rho), float(p[2][0]), rtol=1e-6)
    assert res.state.rho.dtype == torch.float32
    for a, b in ((res.X, p[0][..., 0]), (res.U, p[1][..., 0])):
        scale = max(1.0, b.abs().max().item())
        np.testing.assert_allclose((a / scale).cpu().numpy(), (b / scale).cpu().numpy(), atol=6e-3)


def test_native_plant_udp_loop_on_the_card(cuda, tmp_path):
    """The port builds the native plant, and the controller on the card
    runs 20 ticks against it over UDP (ports 7580/7581), K1 and K2 once
    per tick plus the warm-up."""
    node = native.plant_node_path()
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    before = (sqp_solve.launches, tick_epilogue.launches)
    ctl = SampledController(indy7(torch.float32), COST, SQP, MPCConfig(N=N, dt=DT),
                            SampleConfig(batch_size=B), ref, f_ext_actual=F_TRUE0[:3],
                            device=cuda)
    proc = subprocess.Popen([node, "0.002", "5", "--realtime-scale", "4",
                             "--ports", "7581", "7580"], stdout=subprocess.DEVNULL)
    try:
        tr = UdpTransport(plant_addr=("127.0.0.1", 7581), listen_addr=("127.0.0.1", 7580))
        try:
            tr.wait_for_state(timeout=30.0)
            rec = run_control_loop(ctl, tr, duration=120, rate_hz=25,
                                   recorder=RunRecorder(str(tmp_path), save_interval=1e9),
                                   max_ticks=20)
        finally:
            tr.close()
        assert proc.poll() is None
    finally:
        proc.kill()
        proc.wait()
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (21, 21)
    te = rec._fetch("tracking_errors")
    assert te.shape == (20,) and np.isfinite(te).all()
    assert np.isfinite(rec._fetch("joint_positions")).all()


# ---------------------------------------------------------------------------
# The readable layer and the MJCF plant on the card.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("formulation", ["gn", "reference"])
def test_readable_solve_on_the_card_matches_cpu_f64(cuda, formulation):
    """The readable solver in float64 on the card and on the CPU: the same
    line-search choices and iteration counts, X and U to 1e-9."""
    rng = np.random.default_rng(21)
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = 0.0
    host = [torch.as_tensor(rng.normal(size=shape) * scale) for shape, scale in (
        ((B, 12), 0.05), ((B, N, 3), 0.3), ((B, N, 12), 0.05), ((B, N - 1, 6), 0.5))]
    host.append(torch.as_tensor(w))
    cost = CostConfig(formulation=formulation)
    got = readable.batch_solve(indy7(torch.float64, cuda), cost, SQP, DT,
                               *(a.to(cuda) for a in host[:4]), wrench_world_batch=host[4].to(cuda))
    want = readable.batch_solve(indy7(torch.float64), cost, SQP, DT, *host[:4],
                                wrench_world_batch=host[4])
    assert got.X.device.type == "cuda"
    np.testing.assert_array_equal(got.stats.alphas.cpu().numpy(), want.stats.alphas.numpy())
    np.testing.assert_array_equal(got.stats.iterations.cpu().numpy(),
                                  want.stats.iterations.numpy())
    for name in ("X", "U"):
        np.testing.assert_allclose(getattr(got, name).cpu().numpy(),
                                   getattr(want, name).numpy(), rtol=0, atol=1e-9, err_msg=name)


def test_readable_f32_solve_matches_k1_full_width(cuda):
    """B=64, N=64, float32: the readable solver (its derivatives by
    autodiff, its sweep upcast to f64) against K1 (a one-tangent Dual, an
    f32 sweep): at most 2 lanes may flip an alpha from f32 rounding; the
    others have equal alphas and X, U within K1's scaled 6e-3."""
    Bf, Nf = 64, 64
    args, kw = _k1_inputs(cuda, Bf, Nf)
    model = indy7(torch.float32, cuda)
    k = sqp_solve(LR.static_model(model), COST, SQP, DT, *args, **kw)
    r = readable.batch_solve(model, COST, SQP, DT, args[0].T,
                             *(a.permute(2, 0, 1) for a in args[1:]),
                             wrench_world_batch=kw["wrench"].T)
    flips = (k[3].T != r.stats.alphas).any(1)
    assert int(flips.sum()) <= 2
    for kt, rt in ((k[0].permute(2, 0, 1), r.X), (k[1].permute(2, 0, 1), r.U)):
        assert torch.isfinite(rt).all()
        scale = rt.abs().amax(dim=(1, 2)).clamp(min=1.0)
        assert ((kt - rt).abs() / scale[:, None, None])[~flips].max().item() <= 6e-3


@pytest.mark.parametrize("backend", ["pcg", "admm", "riccati_pscan"])
def test_qp_backend_solve_on_the_card_matches_cpu_f64(cuda, backend):
    """The readable solver on each QP backend outside K1's coverage, in
    float64 on the card and on the CPU: the same line-search choices and
    inner-QP iteration counts, X and U after scaling each lane by max(1,
    max |value|) to 1e-9 (riccati_pscan) or to the 1e-8 of the iterative
    backends' SQP tests (CG stops at its cap unconverged; ADMM's H has a
    condition number near 1e13).  No kernel of the package launches."""
    rng = np.random.default_rng(22)
    w = rng.normal(size=(B, 6)) * 8
    w[:, 3:] = 0.0
    host = [torch.as_tensor(rng.normal(size=shape) * scale) for shape, scale in (
        ((B, 12), 0.05), ((B, N, 3), 0.3), ((B, N, 12), 0.05), ((B, N - 1, 6), 0.5))]
    host.append(torch.as_tensor(w))
    sqp = SQPConfig(max_iters=2, qp_backend=backend)
    before = sqp_solve.launches
    got = readable.batch_solve(indy7(torch.float64, cuda), COST, sqp, DT,
                               *(a.to(cuda) for a in host[:4]), wrench_world_batch=host[4].to(cuda))
    assert sqp_solve.launches == before
    want = readable.batch_solve(indy7(torch.float64), COST, sqp, DT, *host[:4],
                                wrench_world_batch=host[4])
    np.testing.assert_array_equal(got.stats.alphas.cpu().numpy(), want.stats.alphas.numpy())
    if backend == "riccati_pscan":
        assert got.stats.pcg_iters is None
    else:
        np.testing.assert_array_equal(got.stats.pcg_iters.cpu().numpy(),
                                      want.stats.pcg_iters.numpy())
    for name in ("X", "U"):
        g, c = getattr(got, name).cpu(), getattr(want, name)
        scale = c.abs().amax(dim=(1, 2), keepdim=True).clamp(min=1.0)
        tol = 1e-9 if backend == "riccati_pscan" else 1e-8
        assert ((g - c).abs() / scale).max().item() <= tol, name


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_riccati_pscan_on_the_card_matches_riccati(cuda, dtype):
    """The parallel-scan Riccati against the sequential sweep on the card,
    both sweeping in float64 (float32 upcast), on well-posed random blocks
    at N=13 (not a power of two): X, U, K, kff to 1e-9 after scaling each
    lane by max(1, max |value|) in float64, to float32 rounding in float32."""
    from indy7_mpc_tpu_torch.measure import qp_blocks
    from indy7_mpc_tpu_torch.ops import riccati, riccati_pscan

    blocks, xs, _ = qp_blocks(cuda, 4, 13, seed=23, dtype=dtype)
    rho = torch.tensor([1e-6, 1e-4, 1e-2, 1.0], dtype=dtype, device=cuda)
    got = riccati_pscan.solve_pscan(blocks, xs, rho)
    want = riccati.solve(blocks, xs, rho)
    tol = 1e-9 if dtype == torch.float64 else 1e-6
    for name, g, c in zip(got._fields, got, want):
        assert g.dtype == dtype and g.device.type == "cuda"
        dims = tuple(range(1, c.dim()))
        scale = c.abs().amax(dim=dims, keepdim=True).clamp(min=1.0)
        assert ((g - c).abs() / scale).max().item() <= tol, name


@pytest.mark.parametrize("saturation", [False, True])
def test_tick_kernel_mjcf_plant_matches_plain(cuda, saturation):
    """K2 with the MJCF plant's constants (perturbed): its +inf velocity
    limits reach the kernel unchanged, so velocity saturation changes no
    bit; against the plain version at the epilogue tolerances."""
    cfg = dataclasses.replace(PERTURBED_PLANT, velocity_saturation=saturation)
    smc = LR.static_model(indy7(torch.float32, cuda))
    smp = LR.static_model(perturb_model(indy7_mjcf(torch.float32, cuda), cfg))
    assert torch.isinf(smp.velocity_limit).all()
    rng = np.random.default_rng(6)
    x_cur = np.r_[INIT_Q[:5], 3.7, 3.0 * np.ones(6)]  # fast, joint 5 near its stop
    f_batch = rng.normal(size=(6, B)) * 20.0
    f_batch[3:] = 0.0
    f_batch[:, 0] = 0.0
    args = [_f32(a, cuda) for a in (
        x_cur, x_cur + 0.01 * rng.normal(size=12), 5.0 * rng.normal(size=6), f_batch,
        3.0 * rng.normal(size=(6, B)), F_TRUE0,
        cfg.torque_noise_std * rng.normal(size=(cfg.substeps, 6)),
    )]
    _k2_against_plain(smc, smp, cfg, args)
    unsaturated = dataclasses.replace(cfg, velocity_saturation=False)
    a = tick_epilogue(smc, smp, cfg, DT, *args)
    b = tick_epilogue(smc, smp, unsaturated, DT, *args)
    torch.cuda.synchronize()
    assert torch.equal(a.x_next, b.x_next)


def test_indy7_mjcf_on_the_card_equals_cpu(cuda):
    for dtype in (torch.float32, torch.float64):
        on_card, on_cpu = indy7_mjcf(dtype, cuda), indy7_mjcf(dtype)
        for f in FIELDS:
            assert getattr(on_card, f).device.type == "cuda"
            assert torch.equal(getattr(on_card, f).cpu(), getattr(on_cpu, f)), f


def test_sharded_batch_solve_on_the_card_matches_k1(cuda):
    """Two gloo ranks sharing the card, each launching K1 once on its 32
    lanes: the gathered solve is the single-process K1's, bit for bit
    (K1 solves each lane in its own block)."""
    from indy7_mpc_tpu_torch.parallel import _worker
    from indy7_mpc_tpu_torch.solvers import sqp_cuda

    rng = np.random.default_rng(31)
    lanes, horizon = 64, 16
    w = rng.normal(size=(lanes, 6)) * 8
    w[:, 3:] = 0.0
    arrays = tuple(np.asarray(a, np.float32) for a in (
        rng.normal(size=(lanes, 12)) * 0.05, rng.normal(size=(lanes, horizon, 3)) * 0.3,
        rng.normal(size=(lanes, horizon, 12)) * 0.05,
        rng.normal(size=(lanes, horizon - 1, 6)) * 0.5, w))
    out = _worker.spawn(_worker.batch_solve_job, 2, COST, SQP, DT, arrays, "kernel",
                        device="cuda:0", backend="gloo", timeout=300)
    single = sqp_cuda.batch_solve(indy7(torch.float32, cuda), COST, SQP, DT,
                                  *(_f32(a, cuda) for a in arrays[:4]),
                                  wrench_world_batch=_f32(arrays[4], cuda))
    for r in out:
        assert (r["lanes"], r["launches"]) == (lanes // 2, 1)
        np.testing.assert_array_equal(r["alphas"], single.stats.alphas.cpu().numpy())
        np.testing.assert_array_equal(r["X"], single.X.cpu().numpy())
        np.testing.assert_array_equal(r["U"], single.U.cpu().numpy())


def test_sharded_closed_loop_on_the_card_matches_single_process(cuda):
    """Two gloo ranks sharing the card run 20 ticks of the sharded loop
    (K1 on 8 lanes each, K2 as the block's consensus and as the B = 1 plant
    step) from the seed of a single-process ``run_sampled_mpc`` on the
    card: the winners equal on every tick, u within the scaled 6e-3, both
    ranks' traces equal, K1 once and K2 twice a tick on each rank."""
    from indy7_mpc_tpu_torch.parallel import _worker

    lanes, horizon, ticks = 16, 16, 20
    mcfg = MPCConfig(N=horizon, dt=DT)
    scfg = SampleConfig(batch_size=lanes, f_ext_std=20.0, f_ext_resample_std=1.0)
    ref = np.asarray(reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[190:],
        np.float32)
    x0 = np.r_[INIT_Q, np.zeros(6)].astype(np.float32)
    job = dict(cost_cfg=COST, sqp_cfg=SQP, mpc_cfg=mcfg, sample_cfg=scfg, ref=ref, ticks=ticks,
               backend="kernel", plant_cfg=PERTURBED_PLANT, x0=x0, f_true0=F_TRUE0, seed=42)
    out = [r[0] for r in _worker.spawn(_worker.run_jobs, 2, [(_worker.loop_job, job)],
                                       device="cuda:0", backend="gloo", timeout=300)]
    _, tr = run_sampled_mpc(indy7(torch.float32, cuda), COST, SQP, mcfg, scfg,
                            _f32(x0, cuda), ref, ticks, F_TRUE0,
                            torch.Generator(device=cuda).manual_seed(42),
                            plant_cfg=PERTURBED_PLANT)
    u = tr.u.cpu().numpy()
    for r in out:
        assert r["launches"] == (ticks, 2 * ticks)
        assert r["f_batch_block"] == (lanes // 2, 6)
        np.testing.assert_array_equal(r["trace"]["best_idx"], tr.best_idx.cpu().numpy())
        scaled = np.abs(r["trace"]["u"] - u).max() / max(1.0, np.abs(u).max())
        assert scaled <= 6e-3, scaled
        for f, v in r["trace"].items():
            np.testing.assert_array_equal(v, out[0]["trace"][f], err_msg=f)


def test_device_recording_on_the_card_equals_run_sampled_mpc(cuda, tmp_path):
    """``record_runs.run_device_resident`` on the card (B=64, N=64, 20
    ticks in chunks of 8, 8 and 4 after a warm-up chunk) against
    ``run_sampled_mpc`` from the same seed on the same reference: the
    recorded arrays and the final carry equal bit for bit, so the entry
    point adds nothing to the loop; K1 and K2 once a tick plus the
    warm-up chunk."""
    from indy7_mpc_tpu_torch.examples import protocol, record_runs

    ticks, lanes = 20, 64
    before = (sqp_solve.launches, tick_epilogue.launches)
    row, carry = record_runs.run_device_resident(lanes, ticks, PERTURBED_PLANT, str(tmp_path),
                                                 "run", chunk=8, device=cuda)
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (28, 28)
    assert row["ticks"] == ticks and row["event_us"] > 0
    rec = record_runs.load_recording(row["stem"])
    cost, sqp, mpc_cfg, sample_cfg = protocol.configs(lanes)
    final, tr = run_sampled_mpc(indy7(torch.float32, cuda), cost, sqp, mpc_cfg, sample_cfg,
                                protocol.initial_state(torch.float32, cuda),
                                protocol.fig8_reference(ticks), ticks, protocol.F_TRUE0,
                                torch.Generator(device=cuda).manual_seed(42),
                                plant_cfg=PERTURBED_PLANT)
    np_ = lambda t: t.cpu().numpy()
    for name, field in (("tracking_errors", "tracking_error"), ("ee_positions", "ee_pos"),
                        ("ee_ref_positions", "ee_ref"), ("joint_positions", "q"),
                        ("f_est", "f_est"), ("f_true", "f_true")):
        want = np_(getattr(tr, field))
        np.testing.assert_array_equal(rec[name], want.astype(rec[name].dtype), err_msg=name)
    np.testing.assert_array_equal(rec["dts"], np.full(ticks, DT))
    for a, b in zip(carry, final):
        assert torch.equal(a, b)


def test_diagnostic_tools_on_the_card(cuda, tmp_path, capsys):
    """``tools.latency_decomp`` and ``tools.profile_kernel_stages`` on the
    card at B=8/N=8: the chained solve no slower than a blocking one, the
    host ahead of it, no kernel-library build and no allocator growth after
    the loop's first tick; the stage cut's four rows, each positive and
    cumulative (5% slack)."""
    import json

    from indy7_mpc_tpu_torch.tools import latency_decomp, profile_kernel_stages

    assert latency_decomp.main(["--B", "8", "--N", "8", "--ticks", "20",
                                "--out", str(tmp_path / "lat.md")]) == 0
    assert profile_kernel_stages.main(["8", "8", "--iters", "20"]) == 0
    lat, stages = [json.loads(line) for line in capsys.readouterr().out.splitlines()
                   if line.startswith("{")]
    assert lat["platform"] == "gpu" and lat["loop_ticks"] == 20
    assert lat["solve_device_us"] <= lat["solve_block_us"]["p50"]
    assert lat["solve_device_host_ahead"] is True
    assert lat["tick_device_launches"] > 0 and lat["tick_device_ms"] > 0
    for kind in ("library_builds_or_loads", "allocator_segments", "alloc_retries"):
        assert lat[f"{kind}_during_loop"] == 0, kind
    assert (tmp_path / "lat.md").read_text().count("\n| ") == 8  # header + 7 rows
    us = [r["us"] for r in stages["rows"]]
    assert [r["stages"] for r in stages["rows"]] == [1, 2, 3, 4] and us[0] > 0
    assert all(b >= 0.95 * a for a, b in zip(us, us[1:])), us


def test_solve_benchmarks_on_the_card(cuda):
    """``bench.measure`` at B=64/N=8 with fewer solves, and
    ``scale_bench.sweep`` at N=8 over B=64 and 256 with 2 timed solves:
    the device figures present, the host ahead of the event-timed chain,
    K1 launched 1 + R + blocking + chains x R and 1 + reps a row, every row
    finite with ``examples/scale_bench.py``'s keys.  Against K1's plain
    version at tests/test_pallas_kernel.py's scaled 6e-3: the bench's
    first solve (from zeros) with the line-search alphas equal, and the
    last solve of the bench's chain and of each sweep row on X and U
    alone (near the chain's fixed point float32 rounding decides whether
    a step is taken)."""
    import chip_smoke
    from indy7_mpc_tpu_torch import bench
    from indy7_mpc_tpu_torch.examples import scale_bench

    sm = LR.static_model(indy7(torch.float32, cuda))
    lane = lambda t: t.permute(*range(1, t.dim()), 0).contiguous()

    def against_plain(args, res, alphas=False):
        xs, goals, X, U, w = (lane(t) for t in args)
        p = solve_lane_major(sm, COST, SQP, DT, xs, goals, X, U, wrench=w)
        if alphas:
            np.testing.assert_array_equal(res.stats.alphas.T.cpu().numpy(), p[3].cpu().numpy())
        for got, want in ((lane(res.X), p[0]), (lane(res.U), p[1])):
            scale = want.abs().amax(dim=(0, 1)).clamp(min=1.0)
            assert ((got - want).abs() / scale).max().item() <= 6e-3

    before = sqp_solve.launches
    m = bench.measure(64, 8, cuda, reps=4, dispatch_iters=5, chain_iters=3)
    assert sqp_solve.launches - before == 1 + 4 + 5 + 3 * 4
    assert m.chained_s > 0 and m.dispatch_s > 0 and m.chain_event_s > 0 and m.host_ahead
    against_plain(*m.first, alphas=True)
    against_plain(*m.last)

    before = sqp_solve.launches
    final, last = scale_bench.sweep(cuda, N=8, Bs=(64, 256), reps=2)
    assert sqp_solve.launches - before == 2 * (1 + 2)
    keys = chip_smoke.tpu_tool_keys("scale_bench")
    assert set(final) == keys["final"] and final["sharded_mesh"] is None
    for row in final["sweep"]:
        assert set(row) == keys["final_row"] and row["finite"] and row["us_per_batch"] > 0
    for args, res in last.values():
        against_plain(args, res)


# ---- The ticks as captured CUDA graphs (mpc/graphed.py, runtime/controller.py) ----

def _fig8_loop(cuda, lanes, horizon, seed=42):
    """The fig-8 two-kernel loop tick on the perturbed plant and its cold
    carry, drawing from a generator seeded ``seed``: (tick, carry, generator,
    the run_sampled_mpc arguments after the model)."""
    from indy7_mpc_tpu_torch.mpc import make_loop_tick

    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    model = indy7(torch.float32, cuda)
    cfgs = (COST, SQP, MPCConfig(N=horizon, dt=DT), SampleConfig(batch_size=lanes))
    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    tick = make_loop_tick(model, *cfgs, _f32(ref, cuda), plant_cfg=PERTURBED_PLANT,
                          generator=gen)
    return tick, init_loop_carry(model, cfgs[2], cfgs[3], x0, F_TRUE0, gen), gen, (cfgs, x0, ref)


def test_graphed_loop_equals_eager_loop(cuda):
    """``run_sampled_mpc`` (its first tick eager, then one 10-tick graph and
    nine 1-tick graphs) against 20 eager calls of the same tick module at
    B=64/N=64 on the perturbed plant: trace, carry and generator state bit
    for bit; K1 and K2 counted once a tick."""
    _graphed_against_eager(cuda, 64, 64)


def test_graphed_loop_past_one_block_equals_eager_loop(cuda):
    """The same at B=8, N=256, K1 in clusters of 2 blocks a lane: the
    cluster launch is captured, and its replays give the eager bits."""
    assert K1.cluster_size(256) == 2
    _graphed_against_eager(cuda, 8, 256)


def _graphed_against_eager(cuda, lanes, horizon, ticks=20):
    tick, carry, gen, (cfgs, x0, ref) = _fig8_loop(cuda, lanes, horizon)
    rows = []
    for _ in range(ticks):
        carry, row = tick(carry)
        rows.append(row)
    gen_g = torch.Generator(device=cuda).manual_seed(42)
    before = (sqp_solve.launches, tick_epilogue.launches)
    final, trace = run_sampled_mpc(indy7(torch.float32, cuda), *cfgs, x0, ref, ticks, F_TRUE0,
                                   gen_g, plant_cfg=PERTURBED_PLANT)
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (ticks, ticks)
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    for f, a, b in zip(carry._fields, final, carry):
        assert torch.equal(a, b), f
    assert torch.equal(gen_g.get_state(), gen.get_state())


def test_graph_replays_count_one_k1_and_k2_a_tick(cuda):
    """A runner's 10-tick graph records 10 launches of each kernel and its
    1-tick graph one; 25 replayed ticks (two 10-tick replays, five 1-tick
    ones) add 25 to each counter, and the captures add none."""
    from indy7_mpc_tpu_torch.mpc.graphed import TICKS_PER_GRAPH, LoopTickRunner

    tick, carry, _, _ = _fig8_loop(cuda, B, N)
    runner = LoopTickRunner(tick, carry, rows=25)
    runner.run(1)  # eager
    before = (sqp_solve.launches, tick_epilogue.launches)
    runner.run(25)
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (25, 25)
    assert [g.ticks for g in runner.graphs] == [TICKS_PER_GRAPH, 1]
    assert [g.launches for g in runner.graphs] == [[TICKS_PER_GRAPH] * 2, [1, 1]]


def test_runner_for_another_lane_count_builds_its_own_graph(cuda):
    """Runners at B=8 and B=16 each capture graphs of their own, the B=16
    one ticks as its eager loop does, and the B=8 runner refuses the B=16
    carry instead of replaying its graph on it."""
    from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner

    runs = {}
    for lanes in (8, 16):
        tick, carry, _, _ = _fig8_loop(cuda, lanes, N, seed=lanes)
        runner = LoopTickRunner(tick, carry, rows=12)
        runs[lanes] = (runner, carry, runner.run(12))
    (r8, _, _), (r16, c16, t16) = runs[8], runs[16]
    assert not {id(g.graph) for g in r8.graphs} & {id(g.graph) for g in r16.graphs}
    assert r16.carry().f_batch.shape == (16, 6)
    tick, carry, _, _ = _fig8_loop(cuda, 16, N, seed=16)
    for t in range(12):
        carry, row = tick(carry)
        assert int(row.best_idx) == int(t16.best_idx[t]) and torch.equal(row.x, t16.x[t])
    with pytest.raises(ValueError):
        r8.load(c16)


def _fig8_controller(cuda, seed=5):
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    return SampledController(
        indy7(torch.float32), COST, SQP, MPCConfig(N=64, dt=DT),
        SampleConfig(batch_size=64, f_ext_std=20.0, f_ext_resample_std=1.0), ref, seed=seed,
        f_ext_actual=F_TRUE0[:3], device=cuda)


def test_graphed_controller_equals_eager_controller_tick(cuda):
    """20 ``on_state`` calls (each one graph replay) against 20 eager calls of
    the same ``ControllerTick`` from a controller built alike, fed the same
    states: every output, the final state and the generator bit for bit; K1
    and K2 counted once an ``on_state``."""
    ticks = 20
    rng = np.random.default_rng(8)
    xs = [np.r_[INIT_Q, np.zeros(6)] + 0.01 * rng.normal(size=12) for _ in range(ticks)]
    ctl, ref_ctl = _fig8_controller(cuda), _fig8_controller(cuda)
    assert ctl.runner.graph is not None  # captured at warm-up
    before = (sqp_solve.launches, tick_epilogue.launches)
    got = []
    for x in xs:
        u, info = ctl.on_state(x.astype(np.float32), DT)
        got.append(np.r_[u, info["best_idx"], info["f_est"], info["ee_ref"], info["ee_pos"],
                         info["tracking_error"]])
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (ticks, ticks)
    X, U, f = ref_ctl.X_best.clone(), ref_ctl.U_best.clone(), ref_ctl.f_batch.clone()
    x_last, u_last, offset = None, ref_ctl.u_last.clone(), 0.0
    for x, g in zip(xs, got):
        xd = _f32(x.astype(np.float32), cuda)
        x_last = xd if x_last is None else x_last
        offset += 1.0
        out, host = ref_ctl._tick(int(offset), xd, x_last, u_last, X, U, f)
        np.testing.assert_array_equal(g.astype(np.float32), host.cpu().numpy())
        X, U, f, x_last, u_last = out.X_best, out.U_best, out.f_batch, xd, out.u
    for name, want in (("X_best", X), ("U_best", U), ("f_batch", f), ("x_last", x_last),
                       ("u_last", u_last)):
        assert torch.equal(getattr(ctl, name), want), name
    assert torch.equal(ctl.generator.get_state(), ref_ctl.generator.get_state())


def test_graphed_controller_checkpoint_resume_bit_identical(cuda, tmp_path):
    """Stop and resume through save_checkpoint/load_checkpoint on the card
    (the resumed controller's graph reads the loaded buffers): the same
    commands as the run without the stop, bit for bit."""

    def ticks(ctl, plant, n, out):
        for _ in range(n):
            u, _ = ctl.on_state(plant.recv_state().x, DT)
            plant.send_command(u)
            out.append(u.copy())

    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    plant = lambda: InProcessPlant(indy7(torch.float32), x0, DT, plant_cfg=PERTURBED_PLANT)
    ua, ub = [], []
    ticks(_fig8_controller(cuda), plant(), 8, ua)
    plant_b, ctl_b = plant(), _fig8_controller(cuda)
    ticks(ctl_b, plant_b, 4, ub)
    ckpt = ctl_b.save_checkpoint(str(tmp_path / "ctl.npz"))
    ctl_c = _fig8_controller(cuda, seed=9)
    ctl_c.load_checkpoint(ckpt)
    ticks(ctl_c, plant_b, 4, ub)
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(ub))


def test_failed_capture_raises(cuda):
    """A tick that reads the host cannot be captured: the capture raises,
    no graph is kept, the launch counters are as before it, and no tick
    runs eagerly in its place."""
    from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner

    tick, carry, _, _ = _fig8_loop(cuda, B, N)

    class HostReadingTick(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.inner, self.generator = tick, tick.generator
            self.sample_cfg, self.plant_cfg = tick.sample_cfg, tick.plant_cfg

        def forward(self, carry, draws=None):
            new, trace = self.inner(carry, draws)
            float(new.x.sum())  # a device -> host read
            return new, trace

    runner = LoopTickRunner(HostReadingTick(), carry, rows=4)
    runner.run(1)  # eager: fine
    torch.cuda.synchronize()
    after_first = runner.carry()
    before = (sqp_solve.launches, tick_epilogue.launches)
    with pytest.raises(RuntimeError):
        runner.run(2)
    torch.cuda.synchronize()
    assert runner.graphs == []
    assert (sqp_solve.launches, tick_epilogue.launches) == before
    for f, a, b in zip(carry._fields, runner.carry(), after_first):
        assert torch.equal(a, b), f


# ---- The other loops as captured CUDA graphs: run_mpc, run_tracking_mpc,
# the readable loop and the readable controller tick ----

P2G_N, P2G_ITERS = 32, 3


def _single_lane(cuda, loop):
    """(make_*_tick's tick and carry, the run_* call) of run_mpc at the
    point-to-goal configuration or run_tracking_mpc on the fig-8, with a
    true wrench on the plant."""
    from indy7_mpc_tpu_torch.mpc import run_mpc, run_tracking_mpc
    from indy7_mpc_tpu_torch.mpc.point_to_goal import make_mpc_tick
    from indy7_mpc_tpu_torch.mpc.tracking import make_tracking_tick

    model = indy7(torch.float32, cuda)
    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    w = _f32(F_TRUE0, cuda) * 0.1
    if loop == "run_mpc":
        sm = LR.static_model(model)
        ee0 = torch.stack(LR.ee_pos(sm, list(x0[:6]))).cpu().numpy()
        goals = np.stack([ee0 + [0.02, 0.0, -0.02], ee0 + [-0.05, 0.05, -0.05]])
        args = (model, COST, SQPConfig(max_iters=P2G_ITERS), MPCConfig(N=P2G_N, dt=DT), x0,
                goals)
        return make_mpc_tick(*args, wrench_world=w), lambda n: run_mpc(*args, n, wrench_world=w)
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)[190:]
    args = (model, COST, SQP, MPCConfig(N=P2G_N, dt=DT), x0, ref)
    return (make_tracking_tick(*args, wrench_world=w, solver_wrench=w),
            lambda n: run_tracking_mpc(*args, n, wrench_world=w, solver_wrench=w))


@pytest.mark.parametrize("loop", ["run_mpc", "run_tracking_mpc"])
def test_graphed_single_lane_loop_equals_eager_loop(cuda, loop):
    """20 steps of ``run_mpc`` / ``run_tracking_mpc`` (the first eager, then
    a 10-tick graph and nine 1-tick ones) against a Python loop over the
    same tick: trace and final carry bit for bit; each replayed tick counts
    one K1 and one K2 (run_mpc's warm-up solve one K1 more)."""
    ticks = 20
    (tick, carry), run = _single_lane(cuda, loop)
    rows = []
    for _ in range(ticks):
        carry, row = tick(carry)
        rows.append(row)
    before = (sqp_solve.launches, tick_epilogue.launches)
    final, trace = run(ticks)
    warm = int(loop == "run_mpc")
    assert (sqp_solve.launches - before[0], tick_epilogue.launches - before[1]) == (
        ticks + warm, ticks)
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    flat = lambda c: [v for v in c if isinstance(v, torch.Tensor)] + (
        [v for v in c.state if v is not None] if hasattr(c, "state") else [])
    for a, b in zip(flat(final), flat(carry)):
        assert torch.equal(a, b)


def _readable_loop(cuda, backend, lanes=8, horizon=16, seed=3):
    from indy7_mpc_tpu_torch.mpc import make_loop_tick

    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    model = indy7(torch.float32, cuda)
    cfgs = (COST, SQPConfig(max_iters=2, qp_backend=backend), MPCConfig(N=horizon, dt=DT),
            SampleConfig(batch_size=lanes))
    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    gen = torch.Generator(device=cuda).manual_seed(seed)
    tick = make_loop_tick(model, *cfgs, _f32(ref, cuda), plant_cfg=PERTURBED_PLANT,
                          generator=gen, fused=False)
    run = lambda n, g: run_sampled_mpc(model, *cfgs, x0, ref, n, F_TRUE0, g,
                                       plant_cfg=PERTURBED_PLANT, fused=False)
    return tick, init_loop_carry(model, cfgs[2], cfgs[3], x0, F_TRUE0, gen), gen, run


@pytest.mark.parametrize("backend", ["riccati", "pcg"])
def test_graphed_readable_loop_equals_eager_loop(cuda, backend):
    """``run_sampled_mpc(fused=False)`` (the readable tick on the runner: the
    first tick eager, then 1-tick graphs) against 4 eager calls of the same
    tick module, B=8/N=16 f32 on the perturbed plant: trace, carry and
    generator state bit for bit; neither kernel launched."""
    ticks = 4
    tick, carry, gen, run = _readable_loop(cuda, backend)
    rows = []
    for _ in range(ticks):
        carry, row = tick(carry)
        rows.append(row)
    gen_g = torch.Generator(device=cuda).manual_seed(3)
    before = (sqp_solve.launches, tick_epilogue.launches)
    final, trace = run(ticks, gen_g)
    assert (sqp_solve.launches, tick_epilogue.launches) == before
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    for f, a, b in zip(carry._fields, final, carry):
        assert torch.equal(a, b), f
    assert torch.equal(gen_g.get_state(), gen.get_state())


def _readable_controller(cuda, seed=5):
    ref = reference.with_padding(reference.figure8(
        A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10, dt=DT, cycles=1), 200)
    return SampledController(
        indy7(torch.float32), CostConfig(formulation="reference"), SQP, MPCConfig(N=16, dt=DT),
        SampleConfig(batch_size=8, f_ext_std=20.0, f_ext_resample_std=1.0), ref, seed=seed,
        f_ext_actual=F_TRUE0[:3], device=cuda)


def test_graphed_readable_controller_equals_eager_controller_tick(cuda):
    """A controller outside K1's coverage (formulation "reference", the
    readable tick) captures its tick at warm-up: 6 ``on_state`` calls
    against 6 eager calls of the same ``ControllerTick`` from a controller
    built alike: every output, the final state and the generator bit for
    bit, no kernel launched."""
    ticks = 6
    rng = np.random.default_rng(8)
    xs = [np.r_[INIT_Q, np.zeros(6)] + 0.01 * rng.normal(size=12) for _ in range(ticks)]
    ctl, ref_ctl = _readable_controller(cuda), _readable_controller(cuda)
    assert ctl.runner.graph is not None
    before = (sqp_solve.launches, tick_epilogue.launches)
    got = []
    for x in xs:
        u, info = ctl.on_state(x.astype(np.float32), DT)
        got.append(np.r_[u, info["best_idx"], info["f_est"], info["ee_ref"], info["ee_pos"],
                         info["tracking_error"]])
    assert (sqp_solve.launches, tick_epilogue.launches) == before
    X, U, f = ref_ctl.X_best.clone(), ref_ctl.U_best.clone(), ref_ctl.f_batch.clone()
    x_last, u_last, offset = None, ref_ctl.u_last.clone(), 0.0
    for x, g in zip(xs, got):
        xd = _f32(x.astype(np.float32), cuda)
        x_last = xd if x_last is None else x_last
        offset += 1.0
        out, host = ref_ctl._tick(int(offset), xd, x_last, u_last, X, U, f)
        np.testing.assert_array_equal(g.astype(np.float32), host.cpu().numpy())
        X, U, f, x_last, u_last = out.X_best, out.U_best, out.f_batch, xd, out.u
    for name, want in (("X_best", X), ("U_best", U), ("f_batch", f), ("x_last", x_last),
                       ("u_last", u_last)):
        assert torch.equal(getattr(ctl, name), want), name
    assert torch.equal(ctl.generator.get_state(), ref_ctl.generator.get_state())


@pytest.mark.parametrize("path", ["run_mpc", "run_tracking_mpc", "readable_pcg",
                                  "readable_admm", "readable_controller"])
def test_captured_ticks_make_no_host_sync(cuda, path):
    """After the eager tick and the capture, the replayed ticks run under
    ``torch.cuda.set_sync_debug_mode("error")``, which raises at any
    synchronizing operation."""
    from indy7_mpc_tpu_torch.mpc.graphed import TICKS_PER_GRAPH, TickRunner

    if path == "readable_controller":
        ctl = _readable_controller(cuda)
        replay = lambda: [ctl.runner.graph.replay() for _ in range(3)]
    else:
        if path.startswith("readable"):
            tick, carry, gen, _ = _readable_loop(cuda, path.split("_")[1], lanes=4, horizon=8)
            runner = TickRunner(tick, carry, 4, generator=gen, ticks_per_graph=1)
        else:
            (tick, carry), _ = _single_lane(cuda, path)
            runner = TickRunner(tick, carry, TICKS_PER_GRAPH + 1)
        runner.run(2)
        replay = lambda: runner.run(runner.rows)
        torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_run_mpc_with_a_host_reading_solver_raises_at_capture(cuda):
    """An injected solve_fn that reads the host: the first step runs
    eagerly, the capture at the second raises naming the solver, as
    ``lax.scan`` refuses an untraceable solver."""
    from indy7_mpc_tpu_torch.mpc import run_mpc

    model = indy7(torch.float32, cuda)
    inner = single_solve_fn(model, COST, SQPConfig(max_iters=P2G_ITERS), DT)

    def host_reading_solver(*a):
        res = inner(*a)
        float(res.X.sum())  # a device -> host read
        return res

    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    with pytest.raises(RuntimeError, match="host_reading_solver"):
        run_mpc(model, COST, SQPConfig(max_iters=P2G_ITERS), MPCConfig(N=P2G_N, dt=DT), x0,
                np.zeros((1, 3)), 3, solve_fn=host_reading_solver)


@pytest.mark.parametrize("cost, sqp", [
    (CostConfig(formulation="reference"), SQPConfig(max_iters=2)),
    (COST, SQPConfig(max_iters=1, qp_backend="admm")),
], ids=["reference", "admm"])
def test_run_mpc_outside_kernel_coverage_is_captured(cuda, cost, sqp):
    """``run_mpc`` on the readable single-lane solver (outside K1's
    coverage; ADMM's iterate carried in ``SolverState``): 12 steps, the
    first eager, then graphs, against a Python loop over the same tick:
    trace and final carry bit for bit; its replays make no host sync."""
    from indy7_mpc_tpu_torch.mpc import run_mpc
    from indy7_mpc_tpu_torch.mpc.graphed import TickRunner
    from indy7_mpc_tpu_torch.mpc.point_to_goal import make_mpc_tick

    ticks, model = 12, indy7(torch.float32, cuda)
    x0 = _f32(np.r_[INIT_Q, np.zeros(6)], cuda)
    ee0 = torch.stack(LR.ee_pos(LR.static_model(model), list(x0[:6]))).cpu().numpy()
    args = (model, cost, sqp, MPCConfig(N=N, dt=DT), x0,
            np.stack([ee0 + [0.02, 0.0, -0.02], ee0 + [-0.05, 0.05, -0.05]]))
    tick, carry = make_mpc_tick(*args)
    rows = []
    for _ in range(ticks):
        carry, row = tick(carry)
        rows.append(row)
    final, trace = run_mpc(*args, ticks)
    for f in trace._fields:
        assert torch.equal(getattr(trace, f), torch.stack([getattr(r, f) for r in rows])), f
    leaves = lambda c: [v for v in (*c[:-1], *c.state) if v is not None]
    for a, b in zip(leaves(final), leaves(carry)):
        assert torch.equal(a, b)
    runner = TickRunner(*make_mpc_tick(*args), ticks)
    runner.run(2)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.run(ticks)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


if __name__ == "__main__":  # K1_DIGESTS and K2_DIGESTS of the package on the path
    for name, shape in {**BENCH_SHAPES, **LONG_SHAPE}.items():
        print(f'    "{name}": "{k1_digest(torch.device("cuda"), *shape)}",')
    for case in TICK_CASES:
        for lanes in K2_LANES:
            print(f'    "{case}_b{lanes}": "{k2_digest(torch.device("cuda"), case, lanes)}",')
