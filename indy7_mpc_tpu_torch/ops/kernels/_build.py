"""Build and load the CUDA kernels: nvcc into a shared library, ctypes.

The sources in ``indy7_mpc_tpu_torch/csrc/`` (and nothing else) are
compiled for ``sm_90a`` at first use into ``build/indy7_mpc_tpu_torch/``
beside the package, under a file lock, cached by a hash of the sources and
flags: one ``nvcc -c`` per source, all started together, then one link.
The library has a plain C interface: every pointer and the stream pass as
``c_void_p``; each entry returns ``cudaGetLastError()``.
"""
from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Tuple

from . import _abi

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "indy7_mpc_tpu_torch"
CUDA_NVCC = "/usr/local/cuda/bin/nvcc"  # looked for when nvcc is not on PATH
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


# Kernel-library events in this process: nvcc builds and loads of the
# library.  A tick that pays one of them stalls; tracing.counters()
# reports them.
counts = {"builds": 0, "loads": 0}


class KernelBuildError(RuntimeError):
    """The CUDA kernels could not be built or loaded."""


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.access(CUDA_NVCC, os.X_OK):
        nvcc = CUDA_NVCC
    if nvcc is None:
        raise KernelBuildError(
            f"nvcc not found on PATH or at {CUDA_NVCC}: the CUDA kernels of "
            "indy7_mpc_tpu_torch cannot be built"
        )
    return nvcc


def nvcc_commands(nvcc: str, out: Path) -> Tuple[List[List[str]], List[str]]:
    """(one compile command per source, the link command) for ``out``;
    source ``x.cu`` compiles to ``out``'s stem + ``.x.o``."""
    objs = [out.with_name(f"{out.stem}.{src.stem}.o") for src in sources()]
    compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                for src, obj in zip(sources(), objs)]
    return compiles, [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(out), *map(str, objs)]


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernels if the cached library is missing; return it."""
    nvcc = find_nvcc()
    out = BUILD_DIR / f"libindy7_kernels_{_source_hash()}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if out.exists():  # built by another process while we waited
            return out
        counts["builds"] += 1
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        compiles, link = nvcc_commands(nvcc, tmp)
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                  text=True) for cmd in compiles]
        logs = [p.communicate()[0] for p in procs]
        log = "".join(logs)
        for p, text in zip(procs, logs):
            if p.returncode != 0:
                out.with_suffix(".log").write_text(log)
                raise KernelBuildError(f"nvcc failed ({p.returncode}):\n{text[-6000:]}")
        proc = subprocess.run(link, capture_output=True, text=True)
        for cmd in compiles:  # the objects
            Path(cmd[cmd.index("-o") + 1]).unlink(missing_ok=True)
        out.with_suffix(".log").write_text(log + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise KernelBuildError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-6000:]}")
        os.replace(tmp, out)
    return out


_PTR, _INT = ctypes.c_void_p, ctypes.c_int
# The C entries' parameter types: pointers and the stream as c_void_p.
ARGTYPES = {
    # model, params, 11 pointers, the stage clocks' word and cycles, threads,
    # cluster size, stream
    "indy7_sqp_solve": [_abi.ModelConsts, _abi.SolveParams] + [_PTR] * 13 + [_INT, _INT, _PTR],
    # the largest cluster size the device schedules, out
    "indy7_sqp_max_cluster": [_PTR],
    # controller and plant models, plant params, 13 pointers, threads, stream
    "indy7_tick_epilogue": [_abi.ModelConsts, _abi.ModelConsts, _abi.PlantParams]
    + [_PTR] * 13 + [_INT, _PTR],
    # the checker of rbd.cuh's reciprocal: chunk, log2 of its size, two
    # outputs, stream
    "indy7_rcp_check": [_INT, _INT, _PTR, _PTR, _PTR],
}


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    counts["loads"] += 1
    for name, argtypes in ARGTYPES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    """The compiler output of the current build (registers, spills)."""
    path = BUILD_DIR / f"libindy7_kernels_{_source_hash()}.log"
    return path.read_text() if path.exists() else ""
