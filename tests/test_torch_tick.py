"""Tick-epilogue kernel K2 of the PyTorch port: its wrapper on the CPU
(the plain version) against the TPU package's readable pieces, float64.

The pattern of tests/test_fused_tick.py: consensus from ``find_best_lane``,
the plant from ``make_plant_step`` with the same pre-drawn actuation noise
(the plant step's own key split chain), the trace FK from ``ee_pos``.  The
JAX side is jitted once per module.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indy7_mpc_tpu.config import PERTURBED_PLANT as JAX_PERTURBED, PlantConfig as JaxPlantConfig
from indy7_mpc_tpu.dynamics.kinematics import ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import find_best_lane
from indy7_mpc_tpu.sim.plant import make_plant_step
from indy7_mpc_tpu_torch.config import PERTURBED_PLANT, PlantConfig
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops.kernels.tick_kernel import first_argmin, tick_epilogue
from indy7_mpc_tpu_torch.sim.plant import perturb_model

B, DT = 8, 0.01
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
PLANTS = {"nominal": (PlantConfig(), JaxPlantConfig()),
          "perturbed": (PERTURBED_PLANT, JAX_PERTURBED)}


@pytest.fixture(scope="module")
def oracles():
    model = jax_indy7(dtype=jnp.float64)
    out = {}
    for name, (_, jcfg) in PLANTS.items():
        _, step_fn = make_plant_step(model, jcfg)

        def run(x_cur, x_last, u_last, f_batch, U0, f_true, key, step_fn=step_fn):
            best, err = find_best_lane(model, x_last, u_last, x_cur, DT, f_batch)
            x_next = step_fn(x_cur, U0[best], f_true, key, DT)
            return best, err, x_next, ee_pos(model, x_cur[:6])

        out[name] = jax.jit(run)
    return out


def _inputs(seed, nan_lanes=()):
    rng = np.random.default_rng(seed)
    x_cur = np.r_[INIT_Q, 0.1 * np.ones(6)]
    f_batch = rng.normal(size=(B, 6)) * 20.0
    f_batch[:, 3:] = 0.0
    f_batch[0] = 0.0
    for lane in nan_lanes:
        f_batch[lane, 0] = np.nan
    return dict(
        x_cur=x_cur,
        x_last=x_cur + 0.01 * rng.normal(size=12),
        u_last=5.0 * rng.normal(size=6),
        f_batch=f_batch,
        U0=3.0 * rng.normal(size=(B, 6)),
        f_true=np.asarray(F_TRUE),
    )


def _noise(cfg, key):
    """The plant step's per-substep actuation noise (its key split chain)."""
    if not cfg.torque_noise_std:
        return None
    draws, k = [], key
    for _ in range(cfg.substeps):
        k, ks = jax.random.split(k)
        draws.append(cfg.torque_noise_std * np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
    return torch.as_tensor(np.stack(draws))


def _port(cfg, inp, noise, plant=True):
    model = indy7(torch.float64)
    smc = LR.static_model(model)
    smp = LR.static_model(perturb_model(model, cfg))
    t = torch.as_tensor
    return tick_epilogue(
        smc, smp, cfg, DT, t(inp["x_cur"]), t(inp["x_last"]), t(inp["u_last"]),
        t(inp["f_batch"].T.copy()), t(inp["U0"].T.copy()), t(inp["f_true"]), noise,
        plant=plant,
    )


@pytest.mark.parametrize("plant", ["nominal", "perturbed"])
def test_tick_epilogue_matches_jax(oracles, plant):
    cfg, _ = PLANTS[plant]
    inp = _inputs(1)
    key = jax.random.PRNGKey(7)
    best, err, x_next, eep = oracles[plant](
        *(jnp.asarray(inp[k]) for k in ("x_cur", "x_last", "u_last", "f_batch", "U0", "f_true")),
        key,
    )
    before = tick_epilogue.launches
    ep = _port(cfg, inp, _noise(cfg, key))
    assert tick_epilogue.launches == before  # CPU tensors: the plain version
    assert int(ep.best) == int(best)
    np.testing.assert_allclose(ep.err.numpy(), np.asarray(err) ** 2, rtol=1e-10)
    np.testing.assert_allclose(ep.x_next.numpy(), np.asarray(x_next), rtol=0, atol=1e-10)
    np.testing.assert_allclose(ep.u.numpy(), inp["U0"][int(best)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ep.f_est.numpy(), inp["f_batch"][int(best)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ep.eep.numpy(), np.asarray(eep), rtol=0, atol=1e-10)


@pytest.mark.parametrize("seed", [1, 2])
def test_consensus_without_plant_matches_jax(oracles, seed):
    """``plant=False``, the host tick's consensus: no plant step
    (``x_next`` is None), and the winner and err of ``find_best_lane``, u,
    f_est and ``ee_pos``'s eep as with the plant."""
    cfg, _ = PLANTS["nominal"]
    inp = _inputs(seed)
    best, err, _, eep = oracles["nominal"](
        *(jnp.asarray(inp[k]) for k in ("x_cur", "x_last", "u_last", "f_batch", "U0", "f_true")),
        jax.random.PRNGKey(7),
    )
    before = tick_epilogue.launches
    ep = _port(cfg, inp, None, plant=False)
    assert tick_epilogue.launches == before
    assert ep.x_next is None
    assert int(ep.best) == int(best)
    np.testing.assert_allclose(ep.err.numpy(), np.asarray(err) ** 2, rtol=1e-10)
    np.testing.assert_allclose(ep.u.numpy(), inp["U0"][int(best)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ep.f_est.numpy(), inp["f_batch"][int(best)], rtol=0, atol=1e-10)
    np.testing.assert_allclose(ep.eep.numpy(), np.asarray(eep), rtol=0, atol=1e-10)


def test_nan_consensus_picks_first_nan(oracles):
    """A NaN consensus error wins, first NaN first, as jnp.argmin does on
    the readable path (the Pallas kernel instead fell through to a padding
    sentinel and gathered zeros)."""
    cfg, _ = PLANTS["perturbed"]
    inp = _inputs(1, nan_lanes=(3, 5))
    key = jax.random.PRNGKey(7)
    best, err, x_next, _ = oracles["perturbed"](
        *(jnp.asarray(inp[k]) for k in ("x_cur", "x_last", "u_last", "f_batch", "U0", "f_true")),
        key,
    )
    assert int(best) == 3
    ep = _port(cfg, inp, _noise(cfg, key))
    assert int(ep.best) == 3
    assert np.isnan(ep.err.numpy()[[3, 5]]).all()
    np.testing.assert_allclose(ep.x_next.numpy(), np.asarray(x_next), rtol=0, atol=1e-10)


def test_first_argmin_tie_break():
    err = torch.tensor([2.0, 1.0, 1.0, 3.0])
    assert int(first_argmin(err)) == 1
    err = torch.tensor([2.0, float("nan"), 0.5, float("nan")])
    assert int(first_argmin(err)) == 1
