"""The port's build of the native C++ plant (``sim/native.py``).

Its generated model header against the one ``tools/gen_model_header.py``
writes from the TPU package's parameters (the tool runs unchanged from a
copy, so it writes into a temporary tree), and the library it builds
against the port's own dynamics (``ops/lane_rbd.py``, ``sim/plant.py``) in
float64, at the tolerances of tests/test_native.py.
"""
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from indy7_mpc_tpu_torch.config import PERTURBED_PLANT
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.sim import native
from indy7_mpc_tpu_torch.sim.plant import apply_joint_limits, perturb_model, plant_friction

ROOT = os.path.join(os.path.dirname(__file__), "..")
NUMBER = re.compile(r"-?\d+(?:\.\d+)?(?:e[-+]\d+)?")


@pytest.fixture(scope="module")
def jax_header(tmp_path_factory):
    tree = tmp_path_factory.mktemp("gen")
    (tree / "tools").mkdir()
    (tree / "native" / "plant").mkdir(parents=True)
    shutil.copy(os.path.join(ROOT, "tools", "gen_model_header.py"), tree / "tools")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    subprocess.run([sys.executable, str(tree / "tools" / "gen_model_header.py")],
                   check=True, env=env, capture_output=True, timeout=300)
    return (tree / "native" / "plant" / "model_indy7.inc").read_text()


def test_header_matches_the_jax_generator(jax_header):
    port, ref = native.model_header().splitlines(), jax_header.splitlines()
    assert len(port) == len(ref)
    # The two comment lines name each generator; every other line is the
    # same text, so every number (printed %.17g) is the same float64.
    assert all(p.startswith("//") for p in port[:2] + ref[:2])
    assert port[2:] == ref[2:]
    nums = [np.array([float(v) for v in NUMBER.findall("\n".join(t[2:]))]) for t in (port, ref)]
    assert nums[0].size > 150
    np.testing.assert_allclose(nums[0], nums[1], rtol=1e-15, atol=0)


@pytest.fixture(scope="module")
def sm():
    native.build()
    return LR.static_model(indy7(torch.float64))


def _cols(a):
    return [torch.as_tensor(np.asarray(a)[i:i + 1], dtype=torch.float64) for i in range(len(a))]


def test_build_lands_in_the_build_tree():
    d = native.build()
    assert d.parent == native.BUILD_DIR
    assert os.access(native.plant_node_path(), os.X_OK)
    assert (d / native.LIB_NAME).exists()


def test_library_matches_lane_rbd(sm):
    rng = np.random.default_rng(8)
    for _ in range(5):
        q, v = rng.normal(size=6) * 0.8, rng.normal(size=6)
        tau = rng.normal(size=6) * 10
        x = np.r_[q, v]
        w = np.r_[rng.normal(size=3) * 15, np.zeros(3)]
        ee = np.concatenate(LR.ee_pos(sm, _cols(q)))
        np.testing.assert_allclose(native.ee_position(q), ee, atol=1e-11)
        tq = np.concatenate(LR.rnea(sm, _cols(q), _cols(v), _cols(tau)))
        np.testing.assert_allclose(native.rnea(q, v, tau), tq, atol=1e-10)
        x_t = torch.as_tensor(x)[:, None]
        w_t = torch.as_tensor(w)[:, None]
        for wrench in (None, w):
            want = LR.rk4_step(sm, x_t, torch.as_tensor(tau)[:, None], 0.01,
                               wrench_world=None if wrench is None else w_t)[:, 0]
            np.testing.assert_allclose(native.rk4_step(x, tau, 0.01, wrench), want.numpy(),
                                       atol=1e-10)
        fl = LR.f_ext_from_world(sm, _cols(q), w_t)
        a = np.concatenate(LR.forward_dynamics(sm, _cols(q), _cols(v), _cols(tau), fl)[0])
        np.testing.assert_allclose(native.forward_dynamics(x, tau, w), a, atol=1e-9)


def test_perturbed_step_and_limits_match_the_plant(sm):
    cfg = PERTURBED_PLANT
    smp = LR.static_model(perturb_model(indy7(torch.float64), cfg))
    rng = np.random.default_rng(9)
    x = np.r_[rng.normal(size=6) * 0.5, rng.normal(size=6)]
    u = rng.normal(size=6) * 10
    w = np.r_[rng.normal(size=3) * 15, np.zeros(3)]
    want = LR.rk4_step(smp, torch.as_tensor(x)[:, None], torch.as_tensor(u)[:, None], 0.002,
                       wrench_world=torch.as_tensor(w)[:, None],
                       friction=plant_friction(cfg))[:, 0]
    got = native.perturbed_rk4_step(x, u, 0.002, w, pct=cfg.param_scale_pct, seed=cfg.seed,
                                    kv=cfg.viscous_friction, kc=cfg.coulomb_friction)
    np.testing.assert_allclose(got, want.numpy(), atol=1e-10)
    # Past the stops, moving outward, and past the velocity limits.
    x = np.r_[3.2, -3.2, 0.1, 0.0, 3.9, 0.0, 1.0, -1.0, 5.0, -5.0, 2.0, 0.5]
    for sat in (False, True):
        want = apply_joint_limits(sm, torch.as_tensor(x)[:, None], sat)[:, 0]
        np.testing.assert_array_equal(native.apply_joint_limits(x, sat), want.numpy())
