"""Model constants, configs and carries of the PyTorch port against the TPU
package, exactly; and the port's import hygiene (no JAX)."""
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jax_config
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import init_loop_carry as jax_init_loop_carry
from indy7_mpc_tpu.ops import lane_rbd as JLR
from indy7_mpc_tpu.sim import plant as jax_plant
import indy7_mpc_tpu_torch.config as config
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import (
    carry_from_numpy, carry_to_numpy, robot_model_from_numpy,
)
from indy7_mpc_tpu_torch.models.robot import FIELDS
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.sim import plant

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_fields_equal(port, ref, fields):
    for f in fields:
        np.testing.assert_array_equal(
            getattr(port, f).numpy(), np.asarray(getattr(ref, f)), err_msg=f
        )


def test_indy7_matches_jax_exactly():
    ref = jax_indy7(dtype=jnp.float64)
    _assert_fields_equal(indy7(torch.float64), ref, FIELDS)
    carried = robot_model_from_numpy({f: np.asarray(getattr(ref, f)) for f in FIELDS})
    _assert_fields_equal(carried, ref, FIELDS)
    assert carried.mass.dtype == torch.float64


def test_static_model_matches_jax_exactly():
    sm = LR.static_model(indy7(torch.float64))
    ref_model = jax_indy7(dtype=jnp.float64)
    ref = JLR.static_model(ref_model)
    shared = [f for f in LR.STATIC_FIELDS if f in ref._fields]
    assert len(shared) == 9 and ref.nj == sm.nj == 6
    _assert_fields_equal(sm, ref, shared)
    _assert_fields_equal(sm, ref_model, ["effort_limit", "velocity_limit"])


def test_perturbation_bit_exact():
    np.testing.assert_array_equal(
        plant.perturbation_scales(7, 12), jax_plant.perturbation_scales(7, 12)
    )
    assert plant._splitmix64(123456789) == jax_plant._splitmix64(123456789)
    port = plant.perturb_model(indy7(torch.float64), config.PERTURBED_PLANT)
    ref = jax_plant.perturb_model(jax_indy7(dtype=jnp.float64), jax_config.PERTURBED_PLANT)
    _assert_fields_equal(port, ref, FIELDS)
    assert not np.array_equal(port.mass.numpy(), indy7(torch.float64).mass.numpy())


@pytest.mark.parametrize(
    "name", ["CostConfig", "SQPConfig", "MPCConfig", "PlantConfig", "SampleConfig"]
)
def test_config_mirrors_jax(name):
    """The port's copy has exactly the original's fields, in its order and
    with its defaults."""
    port, ref = getattr(config, name), getattr(jax_config, name)
    as_list = lambda cls: [(f.name, f.default) for f in dataclasses.fields(cls)]
    assert as_list(port) == as_list(ref)
    assert dataclasses.asdict(config.PERTURBED_PLANT) == dataclasses.asdict(
        jax_config.PERTURBED_PLANT
    )


def test_carry_round_trip():
    x0 = jnp.zeros(12, jnp.float64).at[:6].set(0.3)
    carry = jax_init_loop_carry(
        jax_indy7(dtype=jnp.float64), jax_config.MPCConfig(N=8),
        jax_config.SampleConfig(batch_size=8), x0,
        jnp.asarray([-60.0, 20.0, -40.0, 0, 0, 0]), jax.random.PRNGKey(0),
    )
    arrays = {f: np.asarray(getattr(carry, f)) for f in carry._fields}
    port = carry_from_numpy(arrays)
    assert port.ref_offset.dtype == torch.int64 and port.x.dtype == torch.float64
    back = carry_to_numpy(port)
    assert set(back) == set(arrays) - {"key"}
    for f, a in back.items():
        np.testing.assert_array_equal(a, arrays[f], err_msg=f)


def test_port_imports_no_jax():
    """Every module of the port, and chip_smoke.py, import without JAX or
    the TPU package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import indy7_mpc_tpu_torch as p, chip_smoke\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'indy7_mpc_tpu'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


@pytest.mark.parametrize("name", ["indy7.urdf", "indy7.xml"])
def test_description_files_are_byte_copies(name):
    """The port parses its own copies of the robot description files, byte
    for byte the TPU package's."""
    import indy7_mpc_tpu_torch.models as port_models

    port_dir = os.path.join(REPO, "indy7_mpc_tpu_torch", "description")
    assert os.path.samefile(port_models.DESCRIPTION_DIR, port_dir)
    assert {port_models.INDY7_URDF, port_models.INDY7_MJCF} <= {
        os.path.join(port_models.DESCRIPTION_DIR, n) for n in ("indy7.urdf", "indy7.xml")}
    with open(os.path.join(port_dir, name), "rb") as f:
        port = f.read()
    with open(os.path.join(REPO, "indy7_mpc_tpu", "description", name), "rb") as f:
        assert port == f.read()
