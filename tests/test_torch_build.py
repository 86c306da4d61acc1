"""Building and binding the port's CUDA kernels, checked without a GPU.

There is no nvcc here, so these pin what can be checked on the CPU: the
loader raises instead of falling back, the nvcc command targets sm_90a and
compiles only the package's csrc/ sources, the ctypes mirrors match the C
structs, K1's shared-memory layout matches its source and bounds the
horizon before any launch, and the wrappers refuse devices and options
they have no path for.
"""
import ctypes
import re
from pathlib import Path

import pytest
import torch

from indy7_mpc_tpu_torch.config import CostConfig, PlantConfig, SQPConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels import _abi, _build
from indy7_mpc_tpu_torch.ops.kernels import sqp_kernel as K1
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.roofline import (
    _Dual, _k2_item_flops, bound_ms, count_flops, k1_work, k2_work, tensor_bytes,
)
from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue
from indy7_mpc_tpu_torch.solvers.sqp_lane import solve_lane_major


def test_no_nvcc_raises_instead_of_falling_back(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "CUDA_NVCC", str(tmp_path / "nvcc"))
    _build.load_library.cache_clear()
    try:
        with pytest.raises(_build.KernelBuildError, match="nvcc not found"):
            _build.load_library()
    finally:
        _build.load_library.cache_clear()


def test_nvcc_command_targets_sm90a_and_csrc_only():
    """One compile per source (started together), then one link, all for
    sm_90a and without fast math."""
    compiles, link = _build.nvcc_commands("nvcc", Path("/tmp/out.so"))
    srcs = []
    for cmd in compiles:
        assert cmd[0] == "nvcc" and "-c" in cmd
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
        assert {"-O3", "-std=c++17", "-Xptxas=-v"} <= set(cmd)
        srcs += [Path(c) for c in cmd[1:] if c.endswith((".cu", ".cuh", ".cpp", ".cc", ".c"))]
    assert {p.name for p in srcs} == {"sqp_kernel.cu", "tick_kernel.cu", "rcp_check.cu"}
    assert all(p.parent == _build.CSRC_DIR for p in srcs)
    assert (_build.CSRC_DIR / "rbd.cuh").exists() and (_build.CSRC_DIR / "rbd_team.cuh").exists()
    objs = [cmd[cmd.index("-o") + 1] for cmd in compiles]
    assert link[:3] == ["nvcc", "-gencode", "arch=compute_90a,code=sm_90a"]
    assert "-shared" in link and link[-len(objs):] == objs


@pytest.mark.parametrize(
    "struct,source,fields",
    [
        (_abi.ModelConsts, "rbd.cuh", "ModelConsts"),
        (_abi.SolveParams, "sqp_kernel.cu", "SolveParams"),
        (_abi.PlantParams, "tick_kernel.cu", "PlantParams"),
    ],
)
def test_ctypes_structs_mirror_the_c_structs(struct, source, fields):
    """Field names, order and float counts of each ctypes mirror equal the
    C struct's (every member is 4 bytes, so the layouts then agree)."""
    text = (_build.CSRC_DIR / source).read_text()
    body = re.search(r"struct %s \{(.*?)\};" % fields, text, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    c_fields = []
    for decl in body.split(";"):
        m = re.match(r"\s*(float|int)\s+(.*)", decl, re.S)
        if not m:
            continue
        for name in m.group(2).split(","):
            dims = [int(d) if d.isdigit() else {"NJ": 6}[d] for d in re.findall(r"\[(\w+)\]", name)]
            size = 1
            for d in dims:
                size *= d
            c_fields.append((name.split("[")[0].strip(), m.group(1), size))
    py_fields = []
    for name, ctype in struct._fields_:
        is_array = issubclass(ctype, ctypes.Array)
        base = ctype._type_ if is_array else ctype
        kind = "float" if base is ctypes.c_float else "int"
        py_fields.append((name, kind, ctype._length_ if is_array else 1))
    assert py_fields == c_fields
    assert ctypes.sizeof(struct) == 4 * sum(f[2] for f in c_fields)


def test_c_entries_match_their_argtypes():
    """Each ``extern "C"`` entry's parameters, read from its source, are
    the ctypes argtypes the loader sets: the structs by value, every
    pointer and the stream as c_void_p, the launch options as c_int
    (K1's threads, K2's threads)."""
    by_type = {"indy7::ModelConsts": _abi.ModelConsts, "indy7::SolveParams": _abi.SolveParams,
               "indy7::PlantParams": _abi.PlantParams, "int": ctypes.c_int}
    found = {}
    for src in _build.sources():
        text = src.read_text()
        for name, params in re.findall(r'extern "C" int (\w+)\((.*?)\)\s*\{', text, re.S):
            decls = [" ".join(d.split()) for d in params.split(",")]
            found[name] = [ctypes.c_void_p if "*" in d else by_type[d.rsplit(" ", 1)[0]]
                           for d in decls]
    assert found == _build.ARGTYPES
    assert found["indy7_tick_epilogue"][-2:] == [ctypes.c_int, ctypes.c_void_p]


def test_plant_params_skip_the_plant():
    """``plant=False`` passes 0 substeps, which makes K2 skip its plant
    step; otherwise the config's substeps."""
    cfg = PlantConfig(substeps=5, torque_noise_std=0.1)
    assert _abi.plant_params(cfg, 0.01, 64, True).substeps == 5
    skipped = _abi.plant_params(cfg, 0.01, 64, False, plant=False)
    assert skipped.substeps == 0 and skipped.B == 64 and skipped.noise == 0


def test_wrappers_refuse_other_devices():
    sm = LR.static_model(indy7(torch.float32))
    B, N = 4, 3
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sqp_solve(sm, CostConfig(), SQPConfig(), 0.01, m(12, B), m(N, 3, B), m(N, 12, B), m(N - 1, 6, B))
    with pytest.raises(ValueError, match="unsupported device"):
        tick_epilogue(sm, sm, PlantConfig(), 0.01, m(12), m(12), m(6), m(6, B), m(6, B), m(6))


def test_sqp_shared_memory_layout_mirrors_the_source():
    """The wrapper's per-knot and fixed shared floats, alpha slots, work
    floats, the block limit and the cluster limit are the kernel's
    constants (kKnotFloats, kFixedFloats, kAlphaSlots, kWork, kSmemLimit,
    kMaxCluster)."""
    text = (_build.CSRC_DIR / "sqp_kernel.cu").read_text()
    const = lambda name: int(re.search(r"constexpr int %s = (\d+);" % name, text).group(1))
    assert (K1.KNOT_FLOATS, K1.FIXED_FLOATS, K1.SMEM_LIMIT) == (
        const("kKnotFloats"), const("kFixedFloats"), const("kSmemLimit"))
    assert (K1.ALPHA_SLOTS, K1.WORK_FLOATS, K1.MAX_CLUSTER) == (
        const("kAlphaSlots"), const("kWork"), const("kMaxCluster"))


def test_sqp_clock_slots_end_with_the_handoff():
    """K1's stage-clock accumulator holds ``len(tracing.K1_SLOTS)`` slots:
    the segment hand-off keeps index 8 (``kClkHandoff``), and the count of
    Quu's pivots off rcp_rn's fast path follows it, last
    (``kClkRcpSlow``), so the slots before it keep their indices."""
    from indy7_mpc_tpu_torch import tracing

    text = (_build.CSRC_DIR / "sqp_kernel.cu").read_text()
    const = lambda name: int(re.search(r"\b%s = (\d+)[,;]" % name, text).group(1))
    assert const("kClockSlots") == len(tracing.K1_SLOTS) == 10
    assert tracing.K1_SLOTS[8] == "handoff" and const("kClkHandoff") == 8
    assert tracing.K1_SLOTS[-1] == "rcp_slow" and const("kClkRcpSlow") == const("kClockSlots") - 1


def _device_function(text, signature):
    """The body of the device function that starts with ``signature``."""
    body = text[text.index(signature):]
    return body[:body.index("\n}\n")]


def test_ldl6_takes_its_reciprocals_from_rcp_rn():
    """rbd.cuh's one ldl6 takes each pivot's reciprocal from its ``rcp``,
    rcp_rn by default (K1's Quu factor and forward dynamics), and no
    division is left in it; K2's callers (its teams and rk4_step) pass
    the compiler's ``1.f / x``.  rcp_rn refines MUFU.RCP's approximation and
    leaves the inputs outside its fast range to the compiler's correctly
    rounded reciprocal, out of line."""
    text = (_build.CSRC_DIR / "rbd.cuh").read_text()
    ldl6 = _device_function(text, "DEV void ldl6(")
    assert len(re.findall(r"\brcp\(", ldl6)) == 1 and "/" not in ldl6.split(") {", 1)[1]
    assert re.search(r"template <class Rcp = RcpInline>\nDEV void ldl6\(", text)
    takes = dict(re.findall(r"struct (Rcp\w+) \{.*?operator\(\)\(float x\) const \{ return (.*?); \}",
                            text, re.S))
    assert takes == {"RcpInline": "rcp_rn(x, slow)", "RcpIeee": "1.f / x"}
    team = (_build.CSRC_DIR / "rbd_team.cuh").read_text()
    assert re.findall(r"\bldl6\([^;]*\);", team) == ["ldl6(s.M, L, invD, RcpIeee());"]
    rk4 = _device_function(text, "DEV void rk4_step(")
    assert rk4.count("forward_dynamics(") == rk4.count("RcpIeee());") == 4
    factor = _device_function((_build.CSRC_DIR / "sqp_kernel.cu").read_text(), "DEV void factor_quu(")
    assert "ldl6(M, L, invD, RcpInline{&slow});" in factor
    rcp = _device_function(text, "DEV float rcp_rn(")
    assert "rcp.approx.ftz.f32" in rcp and rcp.count("fmaf(") == 2
    assert "r = rcp_rn_slow(x);" in rcp
    assert "__noinline__ float rcp_rn_slow(float x) { return __frcp_rn(x); }" in text


def _knot_loop(text):
    """The body of sweep_segment's loop over the running knots."""
    body = text[text.index("DEV void sweep_segment("):]
    body = body[:body.index("\n}\n")]
    return body[body.index("for (int k = min(s.hi, Nm1) - 1; k >= s.lo; --k) {"):]


def test_sqp_riccati_knot_step_has_three_barriers_and_one_factor():
    """A running knot of K1's Riccati sweep takes three block barriers, and
    Quu is factored once a knot (one call of factor_quu, its one ldl6), the
    solves reading that factor; S is read as stored (no re-symmetrizing
    reader)."""
    text = (_build.CSRC_DIR / "sqp_kernel.cu").read_text()
    loop = _knot_loop(text)
    assert loop.count("__syncthreads();") == 3
    assert loop.count("factor_quu(") == 1 and not re.findall(r"\bldl6\(", loop)
    factor = text[text.index("void factor_quu("):]
    assert len(re.findall(r"\bldl6\(", factor[:factor.index("\n}\n")])) == 1
    assert len(re.findall(r"\bldl6_solve\(", loop)) >= 1
    assert "sym(" not in text


# Entries of each kind in the knot step's passes A, B and C (their order).
KNOT_PASSES = {"A": {"Quu": 21, "Sc": 12, "SA": 72, "SB": 72},
               "B": {"Factor": 1, "Qxx": 72, "Qxu": 36, "qx": 12, "qu": 6},
               "C": {"S": 78, "s": 12}}


@pytest.mark.parametrize("step", list(KNOT_PASSES))
def test_sqp_riccati_pass_starts_each_kind_on_a_warp(step):
    """At 256 threads each kind of entry of a knot-step pass starts on a warp
    boundary and fits before the next, so no warp runs two kinds; the pass
    ends within the block."""
    text = (_build.CSRC_DIR / "sqp_kernel.cu").read_text()
    const = lambda name: int(re.search(r"\b%s = (\d+)[,;]" % name, text).group(1))
    kinds = KNOT_PASSES[step]
    starts = [const(f"k{step}{kind}") for kind in kinds] + [const(f"k{step}End")]
    assert starts[0] == 0 and all(a % 32 == 0 for a in starts[:-1])
    for (kind, n), a, b in zip(kinds.items(), starts, starts[1:]):
        assert a + n <= b, kind
    assert starts[-1] == starts[-2] + list(kinds.values())[-1] <= const("kMaxThreads")


def test_sqp_horizon_limit():
    """One block holds up to 174 knots (N=64 in 86,960 bytes); past that a
    lane takes the smallest cluster whose blocks' segments fit, up to the
    portable 8 blocks, which hold N=1,392.  One knot more raises
    ValueError before any launch (no global fallback)."""
    assert K1.shared_bytes(64) == 86_960 <= K1.SMEM_LIMIT == 232_448
    assert K1.MAX_SEGMENT == 174 and K1.MAX_N == 8 * 174 == 1392
    assert K1.check_horizon(64) == (1, 86_960)
    assert K1.check_horizon(174) == (1, K1.shared_bytes(174))
    assert K1.check_horizon(175) == (2, K1.shared_bytes(88))
    assert K1.check_horizon(256) == (2, K1.shared_bytes(128))
    assert K1.check_horizon(512) == (3, K1.shared_bytes(171))
    assert K1.check_horizon(K1.MAX_N) == (8, K1.shared_bytes(174))
    assert K1.shared_bytes(K1.MAX_SEGMENT + 1) > K1.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        K1.check_horizon(K1.MAX_N + 1)


@pytest.mark.parametrize("N,cluster,fits", [
    (96, 1, True), (96, 2, True), (96, 4, True), (2, 2, True), (13, 4, True),
    (175, 1, False),  # a segment of 175 knots
    (9, 4, False),    # segments of 3 leave the fourth block without knots
    (96, 9, False),   # past the portable cluster size
    (96, 0, False),
])
def test_sqp_cluster_override(N, cluster, fits):
    """``cluster=`` picks the blocks a lane; a segment past a block's
    shared memory, an empty block or a size out of [1, 8] raises."""
    if fits:
        assert K1.check_horizon(N, cluster=cluster) == (
            cluster, K1.shared_bytes(-(-N // cluster)))
    else:
        with pytest.raises(ValueError):
            K1.check_horizon(N, cluster=cluster)


def test_sqp_alphas_size_the_layout():
    """Up to 24 alphas the stage-4 pairs fit the 48 work floats of a knot
    and only the merits grow (a slot an alpha past 16); past 24 the work
    region takes two floats an alpha.  The horizon limits follow, and a
    card that holds smaller clusters holds a shorter horizon."""
    assert K1.layout(8) == K1.layout(16) == (329, 684)
    assert K1.layout(20) == (329, 688)
    assert K1.layout(30) == (341, 698)
    assert K1.max_segment(20) == 174 and K1.max_segment(30) == (232_448 // 4 - 698) // 341
    assert K1.check_horizon(96, 20) == (1, 4 * (96 * 329 + 688))
    assert K1.max_horizon(8, clusters=4) == 696
    with pytest.raises(ValueError, match="at most 4 blocks"):
        K1.check_horizon(697, clusters=4)


@pytest.mark.parametrize("stages", [1, 2, 3])
def test_sqp_stage_cut_raises_on_the_cpu(stages):
    """The plain version has no profiling cut: stages < 4 raises on CPU."""
    sm = LR.static_model(indy7(torch.float32))
    B, N = 2, 3
    z = lambda *s: torch.zeros(s)
    with pytest.raises(ValueError, match="no stage cut"):
        sqp_solve(sm, CostConfig(), SQPConfig(), 0.01, z(12, B), z(N, 3, B), z(N, 12, B),
                  z(N - 1, 6, B), stages=stages)


def test_solve_params_carry_the_stage_cut():
    p = _abi.solve_params(CostConfig(), SQPConfig(), 0.01, 8, 4, True)
    assert p.stages == 4 and p.use_wrench == 1
    assert _abi.solve_params(CostConfig(), SQPConfig(), 0.01, 8, 4, False, 2).stages == 2
    assert [f for f, _ in _abi.SolveParams._fields_][-1] == "stages"


def test_roofline_counts_and_bound():
    """The operation counter on known work, and the bound's two sides."""
    a, b = torch.ones(3, 4), torch.ones(4, 5)
    assert count_flops(torch.mm, a, b) == 2 * 3 * 4 * 5
    assert count_flops(lambda x: (x * 2.0 + 1.0).sum(), a) == 12 + 12 + 12
    assert count_flops(lambda x: x.clone().reshape(-1)[:2], a) == 0
    assert tensor_bytes([a, None, b.double()]) == 12 * 4 + 20 * 8
    ms, by = bound_ms(67_000_000_000, 1)
    assert by == "operations" and ms == pytest.approx(1.0)
    ms, by = bound_ms(1, 3_350_000_000)
    assert by == "bytes" and ms == pytest.approx(1.0)


def test_k1_work_counts_the_kernels_arithmetic():
    """K1's work is the kernel's own arithmetic: the Dual costs what
    csrc/rbd.cuh's does (two multiplications by a plain operand, three and
    an add by a Dual), the count is linear in lanes and iterations, lower
    than the plain version's (forward AD with zero-tangent constants, the
    alpha = 0 candidate, dense Riccati products) and lower again without
    the wrench; the bytes read the inputs and write the outputs once."""
    c, x, t = torch.tensor(2.0), torch.ones(1), torch.ones(1)
    assert count_flops(lambda: c * _Dual(x, t)) == 2
    assert count_flops(lambda: _Dual(x, t) * _Dual(x, t)) == 4
    assert count_flops(lambda: _Dual(x, t) + c) == 1
    assert count_flops(lambda: torch.sin(_Dual(x, t))) == 3
    N, cost, sqp = 8, CostConfig(), SQPConfig(max_iters=2)
    flops, nbytes = k1_work(1, N, cost, sqp)
    assert k1_work(3, N, cost, SQPConfig(max_iters=4))[0] == 6 * flops
    assert k1_work(1, N, cost, sqp, use_wrench=False)[0] < flops
    assert nbytes == 4 * (12 + 3 * N + 2 * (12 * N + 6 * (N - 1)) + 2 + 2 * 2 + 6)
    gen = torch.Generator().manual_seed(0)
    r = lambda *s: 0.1 * torch.randn(s, generator=gen)
    sm = LR.static_model(indy7(torch.float32))
    plain = count_flops(solve_lane_major, sm, cost, sqp, 0.01, r(12, 1), r(N, 3, 1),
                        r(N, 12, 1), r(N - 1, 6, 1), wrench=r(6, 1))
    assert 0.5 * plain < flops < plain


def test_k2_work_counts_the_functions_work():
    """K2's work is the items its function needs at one lane, pinned: per
    forward dynamics the rotations, the bias RNEA, the mass matrix by the
    CRBA (not the kernel's six unit-acceleration RNEA passes, 6 x 1719
    flops where the CRBA needs 2042) and the LDL^T solve; per RK4 step the
    wrench map and the combinations; per lane the joint clamps and the
    squared error; the plant's friction (four stages a substep), noise
    and clamps; the trace FK.  The consensus is linear in the lanes, the
    plant in its substeps, and the bytes read each input and write each
    output once."""
    it = _k2_item_flops()
    assert it == {"rotations": 486, "bias_rnea": 1719, "crba": 2042, "unit_rnea": 1719,
                  "ldl_solve": 204, "friction": 36, "wrench_map": 357, "trace_fk": 801,
                  "rk4_combinations": 156, "clamp": 12, "squared_error": 36}
    fd = 486 + 1719 + 2042 + 204
    lane = 4 * fd + 357 + 156 + 12 + 36
    assert k2_work(1, 0, False, False)[0] == lane + 12 + 801
    assert k2_work(64, 0, False, False) == (64 * lane + 12 + 801,
                                            4 * (2 * 195 + 30 + 13 * 64 + 17))
    step = 4 * fd + 357 + 156 + 12 + 4 * 36 + 6
    assert k2_work(64, 5, True, True)[0] == 64 * lane + 12 + 801 + 5 * step + 12
    assert k2_work(64, 5, True, True)[1] == 4 * (2 * 195 + 30 + 13 * 64 + 17 + 6 + 30 + 12)
    assert k2_work(64, 5, True, True, saturate=True)[0] == k2_work(64, 5, True, True)[0] + 5 * 12


def test_ptxas_figures_read_each_entry():
    """measure.ptxas_figures reads registers, stack frame and spills per
    entry from ptxas's -v lines, as measure.ptxas_lines keeps them."""
    from indy7_mpc_tpu_torch import measure

    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN5indy710sqp_kernelILb0EEEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5indy710sqp_kernelILb0EEEvv",
        "    40 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 255 registers, used 1 barriers, 40 bytes cumulative stack size",
        "ptxas info    : Function properties for _ZN5indy714update_segmentEv",
        "    8 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Compiling entry function '_ZN5indy710sqp_kernelILb1EEEvv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN5indy710sqp_kernelILb1EEEvv",
        "    96 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads",
        "ptxas info    : Used 254 registers, used 1 barriers, 96 bytes cumulative stack size",
        "ptxas info    : Compiling entry function '_ZN5indy711tick_kernelILb1EEEvv' for 'sm_90a'",
    ])
    figures = measure.ptxas_figures(measure.ptxas_lines(log, "sqp_kernel"))
    assert figures == {"_ZN5indy710sqp_kernelILb0EEEvv": (255, 40, 0, 0),
                       "_ZN5indy710sqp_kernelILb1EEEvv": (254, 96, 4, 8)}


def test_k1_items_run_the_unrolled_rigid_body_routines():
    """K1 and K2 include rbd.cuh, the one header of rigid-body routines
    (rbd_team.cuh builds K2's teams on it), and every loop there is
    unrolled, so that the routines' per-link arrays and the model constants
    need no local memory."""
    csrc = _build.CSRC_DIR
    assert {p.name for p in csrc.glob("*.cuh")} == {"rbd.cuh", "rbd_team.cuh"}
    for name in ("sqp_kernel.cu", "tick_kernel.cu", "rbd_team.cuh"):
        includes = re.findall(r'#include "([^"]+)"', (csrc / name).read_text())
        assert "rbd.cuh" in includes and set(includes) <= {"rbd.cuh", "rbd_team.cuh"}
    src = (csrc / "rbd.cuh").read_text().splitlines()
    loops = [i for i, line in enumerate(src) if re.match(r"\s*for \(", line)]
    assert loops and all(src[i - 1].strip() == "#pragma unroll" for i in loops)


# Each rigid-body routine of the kernels and the names its copies went by.
RIGID_BODY_ROUTINES = {
    "fk_last": ["fk_last"],
    "ldl6": ["ldl6"],
    "ldl6_solve": ["ldl6_solve", "ldl_solve_unrolled"],
    "rnea": ["rnea"],
    "crba": ["crba"],
    "forward_dynamics": ["forward_dynamics"],
    "wrench_to_ee": ["wrench_to_ee", "world_wrench_to_ee", "map_wrench"],
    "joint_limit": ["joint_limit"],
    "apply_joint_limits": ["apply_joint_limits"],
    "ee_pos": [r"ee_pos\w*"],
}


def test_each_rigid_body_routine_is_defined_once():
    """Across csrc/, each rigid-body routine has one device definition
    under one of its names: K1, K2's thread path and K2's teams call that
    one, so a change to the math is made once."""
    sources = [p.read_text() for p in sorted(_build.CSRC_DIR.glob("*.cu*"))]
    counts = {}
    for routine, names in RIGID_BODY_ROUTINES.items():
        define = re.compile(rf"^(?:DEV|__device__)\b[^(;]*?\b(?:{'|'.join(names)})\s*\(", re.M)
        counts[routine] = sum(len(define.findall(src)) for src in sources)
    assert counts == dict.fromkeys(RIGID_BODY_ROUTINES, 1)
