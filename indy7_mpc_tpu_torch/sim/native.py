"""The native C++ plant (``native/plant/``): build, and ctypes bindings.

Port of ``indy7_mpc_tpu/sim/native.py``.  The C++ plant is the ground-truth
physics process of external-plant mode (``plant_node``, the sim_node.cpp
equivalent) and a shared library whose RBD core the tests hold against
this package's dynamics.

:func:`build` generates the model header ``model_indy7.inc`` from this
package's ``INDY7_PARAMS`` (the layout of ``tools/gen_model_header.py``)
and compiles ``native/plant/{rbd,capi,plant_main}.cpp`` with ``g++`` into
``build/indy7_mpc_tpu_torch/native/<hash>/`` (``libindy7plant.so`` and
``plant_node``), keyed by a hash of the sources, the header and the flags.
It writes nothing into ``native/plant/`` and needs neither ``make`` nor
JAX.  :func:`plant_node_path` and the bindings build on first use; a
failed build raises :class:`NativeBuildError`.
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
from typing import Optional

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
PLANT_SRC = ROOT / "native" / "plant"
BUILD_DIR = ROOT / "build" / "indy7_mpc_tpu_torch" / "native"
CXXFLAGS = ("-O2", "-std=c++17", "-fPIC")
LIB_NAME, NODE_NAME = "libindy7plant.so", "plant_node"


class NativeBuildError(RuntimeError):
    """The native plant could not be built."""


def model_header() -> str:
    """``model_indy7.inc`` for this package's Indy7 parameters: the C++
    ``indy7::indy7_model()`` with every number as ``%.17g`` (exact in
    float64), line for line as ``tools/gen_model_header.py`` writes it."""
    from ..models.robot import indy7

    m = indy7(dtype=torch.float64)
    a = {f: getattr(m, f).numpy() for f in (
        "tree_R", "tree_p", "axis", "mass", "com", "I_com", "gravity",
        "tcp_offset", "q_lower", "q_upper", "velocity_limit",
    )}

    def v3(x):
        return "{%.17g, %.17g, %.17g}" % tuple(x)

    def m3(x):
        return "{{%s, %s, %s}}" % (v3(x[0]), v3(x[1]), v3(x[2]))

    def vj(x):
        return "{%s}" % ", ".join("%.17g" % v for v in x)

    lines = [
        "// Generated by indy7_mpc_tpu_torch/sim/native.py — do not edit.",
        "// Source: indy7_mpc_tpu_torch/models/robot.py INDY7_PARAMS.",
        "#include \"rbd.hpp\"",
        "namespace indy7 {",
        "Model indy7_model() {",
        "  Model m;",
    ]
    for i in range(6):
        lines += [
            f"  m.tree_R[{i}] = {m3(a['tree_R'][i])};",
            f"  m.tree_p[{i}] = {v3(a['tree_p'][i])};",
            f"  m.axis[{i}] = {v3(a['axis'][i])};",
            f"  m.mass[{i}] = {a['mass'][i]:.17g};",
            f"  m.com[{i}] = {v3(a['com'][i])};",
            f"  m.I_com[{i}] = {m3(a['I_com'][i])};",
        ]
    lines += [
        f"  m.gravity = {v3(a['gravity'])};",
        f"  m.tcp_offset = {v3(a['tcp_offset'])};",
        f"  m.q_lower = {vj(a['q_lower'])};",
        f"  m.q_upper = {vj(a['q_upper'])};",
        f"  m.velocity_limit = {vj(a['velocity_limit'])};",
        "  return m;",
        "}",
        "}  // namespace indy7",
        "",
    ]
    return "\n".join(lines)


def _sources():
    return [PLANT_SRC / n for n in ("rbd.hpp", "rbd.cpp", "capi.cpp", "plant_main.cpp")]


def build_dir() -> Path:
    """Where the current sources build to (a hash of sources, header, flags)."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(model_header().encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16]


def available() -> bool:
    """Whether the shared library of the current sources is built (under
    :func:`build_dir`); builds nothing."""
    return (build_dir() / LIB_NAME).exists()


def _run(cmd, cwd):
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise NativeBuildError(
            f"{' '.join(cmd)} failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
        )


def build() -> Path:
    """Build ``libindy7plant.so`` and ``plant_node`` unless the current
    build exists; return its directory."""
    out = build_dir()
    if (out / LIB_NAME).exists() and (out / NODE_NAME).exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise NativeBuildError("no C++ compiler: g++ (or $CXX) is not on PATH")
    out.mkdir(parents=True, exist_ok=True)
    with open(out / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (out / LIB_NAME).exists() and (out / NODE_NAME).exists():
            return out  # built by another process while we waited
        (out / "model_indy7.inc").write_text(model_header())
        (out / "model_unit.cpp").write_text('#include "model_indy7.inc"\n')
        flags = [*CXXFLAGS, f"-I{PLANT_SRC}"]
        for src, obj in ((PLANT_SRC / "rbd.cpp", "rbd.o"),
                         (out / "model_unit.cpp", "model.o"),
                         (PLANT_SRC / "capi.cpp", "capi.o")):
            _run([cxx, *flags, "-c", str(src), "-o", obj], out)
        pid = os.getpid()
        _run([cxx, "-shared", "rbd.o", "model.o", "capi.o", "-o", f"{LIB_NAME}.{pid}"], out)
        _run([cxx, *flags, str(PLANT_SRC / "plant_main.cpp"), "rbd.o", "model.o",
              "-o", f"{NODE_NAME}.{pid}"], out)
        os.replace(out / f"{LIB_NAME}.{pid}", out / LIB_NAME)
        os.replace(out / f"{NODE_NAME}.{pid}", out / NODE_NAME)
    return out


def plant_node_path() -> str:
    """The ``plant_node`` executable, built on first use."""
    return str(build() / NODE_NAME)


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build() / LIB_NAME))
    dp = ctypes.POINTER(ctypes.c_double)
    lib.indy7_ee_position.argtypes = [dp, dp]
    lib.indy7_forward_dynamics.argtypes = [dp, dp, dp, dp]
    lib.indy7_rnea.argtypes = [dp, dp, dp, ctypes.c_int, dp]
    lib.indy7_rk4_step.argtypes = [dp, dp, ctypes.c_double, dp, dp]
    lib.indy7_perturbed_rk4_step.argtypes = [
        dp, dp, ctypes.c_double, dp, ctypes.c_double, ctypes.c_uint64,
        ctypes.c_double, ctypes.c_double, dp,
    ]
    lib.indy7_apply_joint_limits.argtypes = [dp, ctypes.c_int]
    for f in (lib.indy7_ee_position, lib.indy7_forward_dynamics, lib.indy7_rnea,
              lib.indy7_rk4_step, lib.indy7_perturbed_rk4_step,
              lib.indy7_apply_joint_limits):
        f.restype = None
    return lib


def _arr(x, n):
    a = np.ascontiguousarray(np.asarray(x, np.float64).reshape(n))
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _out(n):
    a = np.zeros(n)
    return a, a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _wrench(w):
    return (None, None) if w is None else _arr(w, 6)


def ee_position(q) -> np.ndarray:
    _q, qp = _arr(q, 6)
    out, op = _out(3)
    _load().indy7_ee_position(qp, op)
    return out


def forward_dynamics(x, tau, wrench_world: Optional[np.ndarray] = None):
    _x, xp = _arr(x, 12)
    _t, tp = _arr(tau, 6)
    _w, wp = _wrench(wrench_world)
    out, op = _out(6)
    _load().indy7_forward_dynamics(xp, tp, wp, op)
    return out


def rnea(q, v, a, gravity: bool = True) -> np.ndarray:
    _q, qp = _arr(q, 6)
    _v, vp = _arr(v, 6)
    _a, ap = _arr(a, 6)
    out, op = _out(6)
    _load().indy7_rnea(qp, vp, ap, int(gravity), op)
    return out


def rk4_step(x, u, dt: float, wrench_world: Optional[np.ndarray] = None):
    _x, xp = _arr(x, 12)
    _u, up = _arr(u, 6)
    _w, wp = _wrench(wrench_world)
    out, op = _out(12)
    _load().indy7_rk4_step(xp, up, ctypes.c_double(dt), wp, op)
    return out


def apply_joint_limits(x, velocity_saturation: bool = False) -> np.ndarray:
    """Joint range (and optional velocity-saturation) enforcement — the
    plant-side pass run after every substep; counterpart of
    ``sim/plant.py::apply_joint_limits``.  Returns a new array; ``x`` is
    left as it was."""
    a, xp = _arr(np.array(x, np.float64), 12)
    _load().indy7_apply_joint_limits(xp, int(velocity_saturation))
    return a


def perturbed_rk4_step(
    x, u, dt: float,
    wrench_world: Optional[np.ndarray] = None,
    pct: float = 0.0,
    seed: int = 0,
    kv: float = 0.0,
    kc: float = 0.0,
):
    """One step of the mismatched plant (seeded inertial error + joint
    friction) — counterpart of ``sim/plant.py::perturb_model``."""
    _x, xp = _arr(x, 12)
    _u, up = _arr(u, 6)
    _w, wp = _wrench(wrench_world)
    out, op = _out(12)
    _load().indy7_perturbed_rk4_step(
        xp, up, ctypes.c_double(dt), wp, ctypes.c_double(pct),
        ctypes.c_uint64(seed), ctypes.c_double(kv), ctypes.c_double(kc), op,
    )
    return out
