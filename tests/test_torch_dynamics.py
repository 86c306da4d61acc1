"""The readable dynamics of the PyTorch port (``models/spatial.py``,
``dynamics/``, the URDF and MJCF parsers, ``utils/traj.py``) against the
TPU package's, in float64 on the CPU.

The same seeded numpy inputs (a batch of 2 x 3 states) go through the JAX
function, jitted once per module, and through its port; both are the same
algorithm in f64, so they agree to 1e-10.  The new dynamics are also held
against the port's lane-major engine (``ops/lane_rbd.py``, the plain
version of the kernels' device math) on the same inputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.dynamics as JD
import indy7_mpc_tpu.models as JM
from indy7_mpc_tpu.models import spatial as JS
from indy7_mpc_tpu.utils import traj as jtraj
import indy7_mpc_tpu_torch.dynamics as D
import indy7_mpc_tpu_torch.models as M
from indy7_mpc_tpu_torch.models import spatial as S
from indy7_mpc_tpu_torch.models.robot import FIELDS
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.utils import traj

ATOL = 1e-10
BATCH = (2, 3)
FRICTION = (0.05, 0.1)


@pytest.fixture(scope="module")
def models():
    return M.indy7(torch.float64), JM.indy7(dtype=jnp.float64)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    w = rng.normal(size=BATCH + (6,)) * 10
    w[..., 3:] = rng.normal(size=BATCH + (3,))
    return {
        "q": rng.normal(size=BATCH + (6,)),
        "v": rng.normal(size=BATCH + (6,)),
        "a": rng.normal(size=BATCH + (6,)),
        "tau": rng.normal(size=BATCH + (6,)) * 5,
        "f_ext": rng.normal(size=BATCH + (6, 6)),
        "w": w,
        "x": np.concatenate([rng.normal(size=BATCH + (6,)),
                             rng.normal(size=BATCH + (6,))], -1),
        "R": np.stack([np.linalg.qr(m)[0] for m in rng.normal(size=(6, 3, 3))]).reshape(
            BATCH + (3, 3)),
        "p": rng.normal(size=BATCH + (3,)),
        "m": rng.uniform(1.0, 3.0, size=BATCH),
        "h": rng.normal(size=BATCH + (3,)),
        "I": rng.normal(size=BATCH + (3, 3)),
        "v3": rng.normal(size=BATCH + (3,)),
        "w3": rng.normal(size=BATCH + (3,)),
    }


def _close(got, ref, atol=ATOL, msg=""):
    if isinstance(ref, (tuple, list)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, atol, msg)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=atol, err_msg=msg)


# name -> (args from data, the port function, the JAX function)
SPATIAL = {
    "cross": (("v3", "w3"), S.cross, JS.cross),
    "hat": (("v3",), S.hat, JS.hat),
    "rotz": (("m",), S.rotz, JS.rotz),
    "mv": (("R", "v3"), S.mv, JS.mv),
    "mtv": (("R", "v3"), S.mtv, JS.mtv),
    "motion_to_child": (("R", "p", "v3", "w3"), S.motion_to_child, JS.motion_to_child),
    "motion_to_parent": (("R", "p", "v3", "w3"), S.motion_to_parent, JS.motion_to_parent),
    "force_to_parent": (("R", "p", "v3", "w3"), S.force_to_parent, JS.force_to_parent),
    "force_to_child": (("R", "p", "v3", "w3"), S.force_to_child, JS.force_to_child),
    "cross_motion": (("v3", "w3", "p", "h"), S.cross_motion, JS.cross_motion),
    "cross_force": (("v3", "w3", "p", "h"), S.cross_force, JS.cross_force),
    "inertia_mul": (("m", "h", "I", "v3", "w3"), S.inertia_mul, JS.inertia_mul),
    "inertia_about_origin": (("m", "h", "I"), S.inertia_about_origin,
                             JS.inertia_about_origin),
}


@pytest.mark.parametrize("name", sorted(SPATIAL))
def test_spatial_matches_jax(data, name):
    keys, fn, jfn = SPATIAL[name]
    got = fn(*(torch.as_tensor(data[k]) for k in keys))
    _close(got, jax.jit(jfn)(*(jnp.asarray(data[k]) for k in keys)), msg=name)


def test_rotations_match_jax(data):
    axis = np.array([0.3, -0.4, 0.5]) / np.linalg.norm([0.3, -0.4, 0.5])
    q = data["m"]
    _close(S.rot_axis(torch.as_tensor(axis), torch.as_tensor(q)),
           JS.rot_axis(jnp.asarray(axis), jnp.asarray(q)))
    for rpy in ([0.1, -0.2, 0.3], [1.570796327, 1.570796327, 0.0]):
        _close(S.rpy_matrix(*rpy), JS.rpy_matrix(*rpy))


def _dyn_cases():
    """name -> (port call, JAX call) of (model, data-as-module-arrays)."""
    return {
        "joint_frames": lambda D_, m, d: D_.joint_frames(m, d["q"]),
        "ee_pos": lambda D_, m, d: D_.ee_pos(m, d["q"]),
        "tcp_pos": lambda D_, m, d: D_.tcp_pos(m, d["q"]),
        "ee_pos_jacobian": lambda D_, m, d: D_.ee_pos_jacobian(m, d["q"]),
        "rnea": lambda D_, m, d: D_.rnea(m, d["q"], d["v"], d["a"]),
        "rnea_f_ext": lambda D_, m, d: D_.rnea(m, d["q"], d["v"], d["a"], f_ext=d["f_ext"]),
        "rnea_no_gravity": lambda D_, m, d: D_.rnea(m, d["q"], d["v"], d["a"], gravity=False),
        "crba": lambda D_, m, d: D_.crba(m, d["q"]),
        "bias_forces": lambda D_, m, d: D_.bias_forces(m, d["q"], d["v"], f_ext_ee=d["w"]),
        "forward_dynamics": lambda D_, m, d: D_.forward_dynamics(
            m, d["q"], d["v"], d["tau"], f_ext_ee=d["w"]),
        "aba": lambda D_, m, d: D_.aba(m, d["q"], d["v"], d["tau"], f_ext=d["f_ext"]),
        "forward_dynamics_aba": lambda D_, m, d: D_.forward_dynamics_aba(
            m, d["q"], d["v"], d["tau"], f_ext_ee=d["w"]),
        "world_wrench_to_ee_joint": lambda D_, m, d: D_.world_wrench_to_ee_joint(
            m, d["q"], d["w"]),
        "euler_step": lambda D_, m, d: D_.euler_step(m, d["x"], d["tau"], 0.01,
                                                     f_ext_ee=d["w"]),
        "rk4_step": lambda D_, m, d: D_.rk4_step(m, d["x"], d["tau"], 0.01,
                                                 f_ext_ee=d["w"], friction=FRICTION),
    }


@pytest.mark.parametrize("name", sorted(_dyn_cases()))
def test_dynamics_match_jax(models, data, name):
    model, jmodel = models
    call = _dyn_cases()[name]
    got = call(D, model, {k: torch.as_tensor(v) for k, v in data.items()})
    ref = jax.jit(lambda d: call(JD, jmodel, d))({k: jnp.asarray(v) for k, v in data.items()})
    _close(got, ref, msg=name)


def test_forward_dynamics_inverts_rnea_and_aba_agrees(models, data):
    model, _ = models
    t = {k: torch.as_tensor(v) for k, v in data.items()}
    a = D.forward_dynamics(model, t["q"], t["v"], t["tau"])
    _close(D.rnea(model, t["q"], t["v"], a), data["tau"], atol=1e-9)
    _close(D.aba(model, t["q"], t["v"], t["tau"]), a.numpy())


def _lanes(a):
    """(*BATCH, k) numpy -> a list of k flat (L,) tensors (lane-major)."""
    flat = torch.as_tensor(a.reshape(-1, a.shape[-1]).T)
    return [flat[i] for i in range(flat.shape[0])]


def _flat(t):
    return t.reshape(-1, t.shape[-1]).T


def test_dynamics_match_lane_engine(models, data):
    """The readable dynamics against ``ops/lane_rbd.py`` on the same
    inputs: FK, Jacobian, wrench map, RNEA with an EE wrench, CRBA,
    forward dynamics, Euler and RK4 (with friction) steps."""
    model, _ = models
    sm = LR.static_model(model)
    t = {k: torch.as_tensor(v) for k, v in data.items()}
    q, v, a, tau = (_lanes(data[k]) for k in ("q", "v", "a", "tau"))

    _close(torch.stack(LR.ee_pos(sm, q)), _flat(D.ee_pos(model, t["q"])).numpy())
    p_ee, cols = LR.ee_pos_jacobian(sm, q)
    J = D.ee_pos_jacobian(model, t["q"])[1].reshape(-1, 3, 6)
    _close(torch.stack([torch.stack(c) for c in cols]), J.permute(2, 1, 0).numpy())

    f_l = D.world_wrench_to_ee_joint(model, t["q"], t["w"])
    fe, ne = LR.world_wrench_to_ee(sm, q, _lanes(data["w"]))
    _close(torch.stack(list(fe) + list(ne)), _flat(f_l).numpy())

    tau_l = LR.rnea(sm, q, v, a, f_ext_ee=(fe, ne))
    _close(torch.stack(tau_l), _flat(D.rnea(
        model, t["q"], t["v"], t["a"],
        f_ext=torch.cat([torch.zeros(BATCH + (5, 6), dtype=torch.float64),
                         f_l[..., None, :]], -2))).numpy())
    Ml = LR.crba(sm, q)
    _close(torch.stack([torch.stack(torch.broadcast_tensors(*r)) for r in Ml]),
           D.crba(model, t["q"]).reshape(-1, 6, 6).permute(1, 2, 0).numpy())
    acc, _ = LR.forward_dynamics(sm, q, v, tau, f_ext_ee=(fe, ne))
    _close(torch.stack(acc), _flat(D.forward_dynamics(
        model, t["q"], t["v"], t["tau"], f_ext_ee=f_l)).numpy())

    x, u, w = _flat(t["x"]), _flat(t["tau"]), _flat(t["w"])
    _close(LR.euler_step(sm, x, u, 0.01, wrench_world=w), _flat(D.euler_step(
        model, t["x"], t["tau"], 0.01,
        f_ext_ee=D.world_wrench_to_ee_joint(model, t["x"][..., :6], t["w"]))).numpy())
    _close(LR.rk4_step(sm, x, u, 0.01, wrench_world=w, friction=FRICTION),
           _flat(D.rk4_step(
               model, t["x"], t["tau"], 0.01,
               f_ext_ee=D.world_wrench_to_ee_joint(model, t["x"][..., :6], t["w"]),
               friction=FRICTION)).numpy())


def _assert_model_equal(port, ref, exact=True):
    for f in FIELDS:
        got, want = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert got.dtype == want.dtype, f
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-15, err_msg=f)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_parse_urdf_matches_jax(dtype):
    port = M.parse_urdf(M.INDY7_URDF, dtype=getattr(torch, dtype))
    _assert_model_equal(port, JM.parse_urdf(JM.INDY7_URDF, dtype=getattr(jnp, dtype)))
    with open(M.INDY7_URDF) as f:
        text = f.read()
    _assert_model_equal(M.parse_urdf(text, dtype=getattr(torch, dtype)), port)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_parse_mjcf_matches_jax(dtype):
    port = M.indy7_mjcf(getattr(torch, dtype))
    _assert_model_equal(port, JM.indy7_mjcf(dtype=getattr(jnp, dtype)))
    with open(M.INDY7_MJCF) as f:
        text = f.read()
    _assert_model_equal(M.parse_mjcf(text, dtype=getattr(torch, dtype)), port)
    assert M.mjcf_meta(M.INDY7_MJCF) == JM.mjcf_meta(JM.INDY7_MJCF)
    assert np.isinf(port.velocity_limit.numpy()).all()
    assert not port.tcp_offset.numpy().any()


def test_indy7_from_urdf_matches_embedded():
    """The URDF round-trip of the embedded parameters, as the JAX package
    pins it (tests/test_dynamics.py): every field to 1e-15."""
    _assert_model_equal(M.indy7_from_urdf(torch.float64), M.indy7(torch.float64),
                        exact=False)
    _assert_model_equal(M.indy7_from_urdf(torch.float64),
                        JM.indy7_from_urdf(dtype=jnp.float64))


def test_traj_round_trip_matches_jax():
    rng = np.random.default_rng(3)
    X, U = rng.normal(size=(2, 5, 12)), rng.normal(size=(2, 4, 6))
    flat = traj.pack_xu(torch.as_tensor(X), torch.as_tensor(U))
    _close(flat, jtraj.pack_xu(jnp.asarray(X), jnp.asarray(U)), atol=0)
    _close(traj.unpack_xu(flat, 5, 12, 6), (X, U), atol=0)
    g = rng.normal(size=(2, 6 * 5 + 2))
    _close(traj.goals_from_flat(torch.as_tensor(g), 5),
           jtraj.goals_from_flat(jnp.asarray(g), 5), atol=0)
