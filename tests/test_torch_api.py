"""The port's public names against the TPU package's, and the last of them
held against JAX (float64, on the CPU; each JAX oracle jitted once per
module, inputs from a numpy seed).

The coverage tests read each module of ``indy7_mpc_tpu/`` with ``ast``,
so no Pallas module is imported for them, and look every public top-level
``def``, ``class`` and UPPER_CASE constant up in the port module of the
same path.  A name the port keeps elsewhere is in ``MOVED``, a name it
leaves out by design in ``DO_NOT_PORT`` (ROADMAP.md's list); each entry
gives its reason.  A module or name added to the TPU package without a
counterpart in the port fails here.
"""
import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
import indy7_mpc_tpu.sim as jax_sim
import indy7_mpc_tpu.solvers as jax_solvers
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.sim.plant import make_plant_step as jax_make_plant_step
import indy7_mpc_tpu_torch.config as cfg
import indy7_mpc_tpu_torch.sim as port_sim
import indy7_mpc_tpu_torch.solvers as port_solvers
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.sim import readable_plant
from indy7_mpc_tpu_torch.sim.readable_plant import make_plant_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "indy7_mpc_tpu")
MODULES = sorted(
    os.path.relpath(os.path.join(d, f), JAX_ROOT).replace(os.sep, "/")
    for d, _, files in os.walk(JAX_ROOT) for f in files if f.endswith(".py")
)
PACKAGES = [m for m in MODULES if m.endswith("__init__.py")]

# (JAX module, name) -> (port module, name, reason).
MOVED = {
    ("ops/pallas/sqp_kernel.py", "sqp_solve_pallas"): (
        "ops/kernels/sqp_kernel.py", "sqp_solve", "K1's CUDA wrapper replaces the Pallas call"),
    ("ops/pallas/tick_kernel.py", "TickEpilogue"): (
        "ops/kernels/tick_kernel.py", "TickEpilogue", "K2's outputs, beside its CUDA wrapper"),
    ("ops/pallas/tick_kernel.py", "tick_epilogue"): (
        "ops/kernels/tick_kernel.py", "tick_epilogue", "K2's CUDA wrapper replaces the Pallas call"),
    ("solvers/sqp_pallas.py", "single_solve_fn"): (
        "solvers/sqp_cuda.py", "single_solve_fn", "the solver on K1 in place of the Pallas kernel"),
    ("solvers/sqp_pallas.py", "batch_solve"): (
        "solvers/sqp_cuda.py", "batch_solve", "the solver on K1 in place of the Pallas kernel"),
    ("sim/plant.py", "apply_joint_limits"): (
        "sim/readable_plant.py", "apply_joint_limits",
        "the RobotModel (*b, 12) contract; sim/plant.py's is K2's lane-major plain version"),
    ("sim/plant.py", "plant_step"): (
        "sim/readable_plant.py", "plant_step",
        "the RobotModel (*b, 12) contract; sim/plant.py's is K2's lane-major plain version"),
    ("sim/plant.py", "predict_next_states"): (
        "sim/readable_plant.py", "predict_next_states",
        "the RobotModel (*b, 12) contract; sim/plant.py's is K2's lane-major plain version"),
    ("sim/plant.py", "make_plant_step"): (
        "sim/readable_plant.py", "make_plant_step",
        "steps the readable plant, beside the RobotModel plant functions"),
    ("parallel/sharding.py", "make_lane_mesh"): (
        "mpc/lane_mesh.py", "make_lane_mesh",
        "the mesh sits beside the ticks that take it; parallel/ exports it"),
}

_TPU_MATH = "a TPU workaround: the CUDA kernels call sqrtf and sincosf"
_TRACE_TUPLES = "trace-time tuple helpers of the Pallas body; the port works on tensors"
_SHARDING = ("a JAX NamedSharding placement: a rank holds its block or the whole value as a "
             "plain tensor (shard_lanes, distributed.global_lanes, replicated_global)")
_CACHE = "JAX's compilation cache: ops/kernels/_build.py caches the CUDA builds by source hash"
# (JAX module, name) -> reason.
DO_NOT_PORT = {
    ("ops/lane_rbd.py", "fast_sqrt"): _TPU_MATH,
    ("ops/lane_rbd.py", "sincos"): _TPU_MATH,
    ("ops/lane_rbd.py", "v3"): _TRACE_TUPLES,
    ("ops/lane_rbd.py", "const33"): _TRACE_TUPLES,
    ("ops/lane_rbd.py", "const3"): _TRACE_TUPLES,
    ("utils/cache.py", "DEFAULT_DIR"): _CACHE,
    ("utils/cache.py", "enable_cache"): _CACHE,
    ("solvers/select.py", "is_tpu_device"): "the port has is_cuda_device",
    ("parallel/sharding.py", "lane_sharding"): _SHARDING,
    ("parallel/sharding.py", "replicated"): _SHARDING,
    ("ops/pallas/tick_kernel.py", "TP"): "the TPU's tile width of 128 lanes",
    ("ops/pallas/tick_kernel.py", "PlantOpts"): (
        "the Pallas kernel's static options; K2 takes ops/kernels/_abi.PlantParams"),
}

# JAX modules with no port module of the same path -> reason.
NO_SAME_PATH = {
    "ops/pallas/__init__.py": "the CUDA kernels' package is ops/kernels/",
    "ops/pallas/sqp_kernel.py": "K1 is ops/kernels/sqp_kernel.py",
    "ops/pallas/tick_kernel.py": "K2 is ops/kernels/tick_kernel.py",
    "solvers/sqp_pallas.py": "the solver on K1 is solvers/sqp_cuda.py",
    "utils/cache.py": "JAX's compilation cache, not ported",
}


def _tree(module):
    with open(os.path.join(JAX_ROOT, module)) as f:
        return ast.parse(f.read())


def _public_names(module):
    """The public top-level defs, classes and UPPER_CASE constants."""
    names = []
    for node in _tree(module).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            names += [t.id for t in targets if isinstance(t, ast.Name) and t.id.isupper()]
    return [n for n in names if not n.startswith("_")]


def _jax_all(package):
    for node in _tree(package).body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return []


def _port_module(module):
    parts = module[: -len(".py")].split("/")
    if parts[-1] == "__init__":
        parts.pop()
    return importlib.import_module(".".join(["indy7_mpc_tpu_torch", *parts]))


def test_module_list_is_the_tpu_package():
    """The walk finds the 48 modules of the TPU package, and every pinned
    entry names one of them."""
    assert len(MODULES) == 48, MODULES
    pinned = {m for m, _ in MOVED} | {m for m, _ in DO_NOT_PORT} | set(NO_SAME_PATH)
    assert pinned <= set(MODULES), pinned - set(MODULES)


@pytest.mark.parametrize("module", MODULES)
def test_public_names_are_ported(module):
    """Each public name of the TPU package's module is an attribute of the
    port module of the same path, at its pinned moved place, or on the
    pinned do-not-port list."""
    names = _public_names(module)
    pinned = {n for m, n in (*MOVED, *DO_NOT_PORT) if m == module}
    assert pinned <= set(names), f"stale entries: {sorted(pinned - set(names))}"
    for name in names:
        if (module, name) in MOVED:
            target, new_name, _ = MOVED[module, name]
            assert hasattr(_port_module(target), new_name), f"{name} -> {target}::{new_name}"
    if module in NO_SAME_PATH:
        with pytest.raises(ModuleNotFoundError):
            _port_module(module)
        left = [n for n in names if (module, n) not in MOVED and (module, n) not in DO_NOT_PORT]
        assert not left, f"{module} has no port module, yet {left} are neither moved nor listed"
        return
    port = _port_module(module)
    missing = [n for n in names if (module, n) not in MOVED and (module, n) not in DO_NOT_PORT
               and not hasattr(port, n)]
    assert not missing, f"indy7_mpc_tpu_torch/{module} lacks {missing}"


@pytest.mark.parametrize("package", PACKAGES)
def test_package_exports_cover_the_tpu_package(package):
    """The port package's ``__all__`` covers the TPU package's, less the
    do-not-port names, and every name in it resolves."""
    prefix = package[: -len("__init__.py")]
    skip = {n for m, n in DO_NOT_PORT if m.startswith(prefix)}
    want = [n for n in _jax_all(package) if n not in skip]
    if package in NO_SAME_PATH:
        assert not want, want
        return
    port = _port_module(package)
    have = list(getattr(port, "__all__", []))
    assert not set(want) - set(have), f"__all__ lacks {sorted(set(want) - set(have))}"
    unresolved = [n for n in have if not hasattr(port, n)]
    assert not unresolved, unresolved


DT = 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
# case -> (config, batch): ``None`` is the nominal plant.
PLANT_CASES = {
    "nominal": (None, ()),
    "perturbed": (cfg.PERTURBED_PLANT, ()),
    "perturbed_batched": (cfg.PERTURBED_PLANT, (4,)),
}


@pytest.fixture(scope="module")
def jax_plants():
    """config -> (plant model, step_fn) of the JAX ``make_plant_step``, the
    step jitted over ``(x, u, wrench_world, key)``; ``None`` is the nominal
    plant."""
    model = jax_indy7(dtype=jnp.float64)
    out = {}
    for name, jc in (("nominal", None), ("perturbed", jcfg.PERTURBED_PLANT)):
        pm, step_fn = jax_make_plant_step(model, jc)
        out[name] = pm, step_fn, jax.jit(
            lambda x, u, w, k, step_fn=step_fn: step_fn(x, u, w, k, DT))
    return out


def _plant_inputs(seed, batch):
    """A state near the arm's pose per lane (in a batch, the last one fast
    and past joint 5's stop), torques and world wrenches."""
    rng = np.random.default_rng(seed)
    x = np.r_[INIT_Q, 0.3 * rng.normal(size=6)] + np.zeros(batch + (12,))
    if batch:
        x[..., :6] += 0.05 * rng.normal(size=batch + (6,))
        x[-1] = np.r_[INIT_Q[:5], 3.8, 4.0 * np.ones(6)]
    return x, 30.0 * rng.normal(size=batch + (6,)), 10.0 * rng.normal(size=batch + (6,))


def _jax_normals(key, substeps, shape):
    """The JAX plant step's standard normal draws: its key split chain,
    one draw of the control's shape per substep (sim/plant.py:164-173)."""
    draws, k = [], key
    for _ in range(substeps):
        k, ks = jax.random.split(k)
        draws.append(np.asarray(jax.random.normal(ks, shape, jnp.float64)))
    return np.stack(draws)


@pytest.mark.parametrize("case", list(PLANT_CASES))
def test_make_plant_step_matches_jax(jax_plants, case):
    """The plant model and one tick of ``make_plant_step`` against JAX's,
    the JAX draws injected as ``normals``."""
    port_cfg, batch = PLANT_CASES[case]
    jpm, _, jstep = jax_plants["nominal" if port_cfg is None else "perturbed"]
    pm, step_fn = make_plant_step(indy7(torch.float64), port_cfg)
    for field in ("mass", "I_com"):
        np.testing.assert_allclose(getattr(pm, field).numpy(), np.asarray(getattr(jpm, field)),
                                   rtol=0, atol=1e-12, err_msg=field)
    x, u, w = _plant_inputs(3, batch)
    key = jax.random.PRNGKey(11)
    want = jstep(jnp.asarray(x), jnp.asarray(u), jnp.asarray(w), key)
    substeps = (port_cfg or cfg.PlantConfig()).substeps
    normals = torch.as_tensor(_jax_normals(key, substeps, u.shape))
    t = torch.as_tensor
    got = step_fn(t(x), t(u), t(w), normals, DT)
    assert got.shape == batch + (12,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)


def test_make_plant_step_without_normals_is_noise_free(jax_plants):
    """``normals=None`` is JAX's ``key=None``: the perturbed plant without
    actuation noise, which moves the state."""
    _, jax_step, _ = jax_plants["perturbed"]
    x, u, w = _plant_inputs(3, ())
    want = jax.jit(lambda *a: jax_step(*a, None, DT))(*(jnp.asarray(a) for a in (x, u, w)))
    _, step_fn = make_plant_step(indy7(torch.float64), cfg.PERTURBED_PLANT)
    t = torch.as_tensor
    got = step_fn(t(x), t(u), t(w), None, DT)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-10)
    normals = torch.ones((cfg.PERTURBED_PLANT.substeps, 6), dtype=torch.float64)
    assert (step_fn(t(x), t(u), t(w), normals, DT) - got).abs().max() > 1e-6


def test_sim_exports_take_a_robot_model():
    """``indy7_mpc_tpu_torch.sim``'s exports are the RobotModel plant's and
    match ``indy7_mpc_tpu.sim``'s on (3, 12) states, one past a stop."""
    for name in port_sim.__all__:
        assert getattr(port_sim, name) is getattr(readable_plant, name)
    x, u, w = _plant_inputs(5, (3,))
    jmodel, model = jax_indy7(dtype=jnp.float64), indy7(torch.float64)
    jx, ju, jw = jnp.asarray(x), jnp.asarray(u), jnp.asarray(w)
    t = torch.as_tensor
    friction = (0.05, 0.1)

    def jax_exports(x, u, w):
        return ([jax_sim.apply_joint_limits(jmodel, x, velocity_saturation=s)
                 for s in (False, True)],
                jax_sim.plant_step(jmodel, x, u, DT, wrench_world=w, substeps=2,
                                   friction=friction),
                jax_sim.predict_next_states(jmodel, x[0], u[0], DT, w))

    limits, step, predicted = jax.jit(jax_exports)(jx, ju, jw)
    for saturation, want in zip((False, True), limits):
        got = port_sim.apply_joint_limits(model, t(x), velocity_saturation=saturation)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[2, 5] < x[2, 5], "the last state is not past the stop: test ineffective"
    got = port_sim.plant_step(model, t(x), t(u), DT, wrench_world=t(w), substeps=2,
                              friction=friction)
    np.testing.assert_allclose(got.numpy(), np.asarray(step), rtol=0, atol=1e-10)
    got = port_sim.predict_next_states(model, t(x[0]), t(u[0]), DT, t(w))
    assert got.shape == (3, 12)
    np.testing.assert_allclose(got.numpy(), np.asarray(predicted), rtol=0, atol=1e-10)


def test_solvers_exports_solve_like_jax():
    """``indy7_mpc_tpu_torch.solvers``' exports are the readable solver's and
    the selection's; its ``batch_solve`` and ``solve`` match
    ``indy7_mpc_tpu.solvers.batch_solve`` at N=4, B=2, one SQP iteration.
    The JAX batch solve is its ``solve`` vmapped, so one lane of it is the
    JAX ``solve`` of that lane (one compile instead of two)."""
    from indy7_mpc_tpu_torch.solvers import select, sqp

    for name in port_solvers.__all__:
        assert getattr(port_solvers, name) is getattr(
            sqp if hasattr(sqp, name) else select, name)
    B, N = 2, 4
    rng = np.random.default_rng(6)
    xs = np.r_[INIT_Q, np.zeros(6)] + 0.05 * rng.normal(size=(B, 12))
    goals = 0.3 * rng.normal(size=(B, N, 3))
    X = xs[:, None] + 0.05 * rng.normal(size=(B, N, 12))
    U = 0.5 * rng.normal(size=(B, N - 1, 6))
    w = 8.0 * rng.normal(size=(B, 6))
    jmodel = jax_indy7(dtype=jnp.float64)
    want = jax.jit(lambda *a: jax_solvers.batch_solve(
        jmodel, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=1), DT, *a[:4],
        wrench_world_batch=a[4]))(*(jnp.asarray(a) for a in (xs, goals, X, U, w)))
    want = jax.tree_util.tree_map(np.asarray, want)
    model, t = indy7(torch.float64), torch.as_tensor
    cost, sqp_cfg = cfg.CostConfig(), cfg.SQPConfig(max_iters=1)
    got = port_solvers.batch_solve(model, cost, sqp_cfg, DT, t(xs), t(goals), t(X), t(U),
                                   wrench_world_batch=t(w))
    got_one = port_solvers.solve(model, cost, sqp_cfg, DT, t(xs[0]), t(goals[0]), t(X[0]),
                                 t(U[0]), wrench_world=t(w[0]))
    lane0 = jax.tree_util.tree_map(lambda a: a[0], want)
    for g, wnt in ((got, want), (got_one, lane0)):
        assert isinstance(g, port_solvers.SQPResult)
        assert isinstance(g.state, port_solvers.SolverState)
        assert isinstance(g.stats, port_solvers.SQPStats)
        assert (wnt.stats.alphas > 0).all(), "no step taken: test ineffective"
        np.testing.assert_array_equal(g.stats.alphas.numpy(), wnt.stats.alphas)
        np.testing.assert_array_equal(g.state.rho.numpy(), wnt.state.rho)
        for name in ("X", "U"):
            np.testing.assert_allclose(getattr(g, name).numpy(), getattr(wnt, name),
                                       rtol=0, atol=1e-8, err_msg=name)
