"""Building and binding the port's CUDA kernels, checked without a GPU.

There is no nvcc here, so these pin what can be checked on the CPU: the
loader raises instead of falling back, the nvcc command targets sm_90a and
compiles only the package's csrc/ sources, the ctypes mirrors match the C
structs, and the wrappers refuse devices they have no path for.
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
from indy7_mpc_tpu_torch.ops.kernels.sqp_kernel import sqp_solve
from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import tick_epilogue


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
    cmd = _build.nvcc_command("nvcc", Path("/tmp/out.so"))
    assert cmd[0] == "nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert "--use_fast_math" not in cmd and "-use_fast_math" not in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    srcs = [Path(c) for c in cmd[1:] if c.endswith((".cu", ".cuh", ".cpp", ".cc", ".c"))]
    assert {p.name for p in srcs} == {"sqp_kernel.cu", "tick_kernel.cu"}
    assert all(p.parent == _build.CSRC_DIR for p in srcs)
    assert (_build.CSRC_DIR / "rbd.cuh").exists()


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


def test_wrappers_refuse_other_devices():
    sm = LR.static_model(indy7(torch.float32))
    B, N = 4, 3
    m = lambda *s: torch.empty(s, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sqp_solve(sm, CostConfig(), SQPConfig(), 0.01, m(12, B), m(N, 3, B), m(N, 12, B), m(N - 1, 6, B))
    with pytest.raises(ValueError, match="unsupported device"):
        tick_epilogue(sm, sm, PlantConfig(), 0.01, m(12), m(12), m(6), m(6, B), m(6, B), m(6))
