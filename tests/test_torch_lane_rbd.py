"""Lane-major rigid-body engine of the PyTorch port against the TPU
package's ``ops/lane_rbd.py``, eagerly in float64 on the CPU.

The same random lane-major states (numpy, seeded) go through both; the
functions are the same algorithms with exact sin/cos/sqrt on both sides in
f64, so they agree to 1e-12.  The port's tangent pass (forward-mode RNEA
with the wrench map) is also held against ``jax.jacfwd`` of the TPU
package's RNEA, to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.ops import lane_rbd as JLR
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.ops import lane_sqp as LS

L = 9
ATOL = 1e-12


@pytest.fixture(scope="module")
def models():
    return LR.static_model(indy7(torch.float64)), JLR.static_model(
        jax_indy7(dtype=jnp.float64)
    )


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(42)
    w = rng.normal(size=(6, L)) * 10
    w[3:] = 0.0
    return {
        "q": rng.normal(size=(6, L)),
        "v": rng.normal(size=(6, L)),
        "a": rng.normal(size=(6, L)),
        "tau": rng.normal(size=(6, L)) * 5,
        "w": w,
    }


def _t(a):
    return [torch.as_tensor(r) for r in a]


def _j(a):
    return [jnp.asarray(r) for r in a]


def _close(got, ref, atol=ATOL):
    """Nested lists/tuples of tensors vs nested lists/tuples of arrays."""
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            _close(g, r, atol)
        return
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.broadcast_to(np.asarray(ref), got.shape), rtol=0, atol=atol)


def test_fk_and_ee(models, data):
    sm, jsm = models
    q, jq = _t(data["q"]), _j(data["q"])
    _close(LR.fk(sm, q), JLR.fk(jsm, jq))
    _close(LR.ee_pos(sm, q), JLR.ee_pos(jsm, jq))
    _close(LR.ee_pos_jacobian(sm, q), JLR.ee_pos_jacobian(jsm, jq))


def test_world_wrench_to_ee(models, data):
    sm, jsm = models
    _close(
        LR.world_wrench_to_ee(sm, _t(data["q"]), _t(data["w"])),
        JLR.world_wrench_to_ee(jsm, _j(data["q"]), _j(data["w"])),
    )


@pytest.mark.parametrize("wrench", [True, False])
def test_rnea(models, data, wrench):
    sm, jsm = models
    fe = LR.world_wrench_to_ee(sm, _t(data["q"]), _t(data["w"])) if wrench else None
    jfe = JLR.world_wrench_to_ee(jsm, _j(data["q"]), _j(data["w"])) if wrench else None
    _close(
        LR.rnea(sm, _t(data["q"]), _t(data["v"]), _t(data["a"]), f_ext_ee=fe),
        JLR.rnea(jsm, _j(data["q"]), _j(data["v"]), _j(data["a"]), f_ext_ee=jfe),
        atol=ATOL,
    )
    _close(
        LR.rnea(sm, _t(data["q"]), _t(data["v"]), _t(data["a"]), gravity=False),
        JLR.rnea(jsm, _j(data["q"]), _j(data["v"]), _j(data["a"]), gravity=False),
        atol=ATOL,
    )


def test_crba_and_ldl(models, data):
    sm, jsm = models
    M, jM = LR.crba(sm, _t(data["q"])), JLR.crba(jsm, _j(data["q"]))
    _close(M, jM)
    fac, jfac = LR.chol6(M), JLR.chol6(jM)
    Lc, D, invD = fac
    jLc, jD, jinvD = jfac
    for i in range(6):
        for j in range(i):
            _close(Lc[i][j], jLc[i][j])
    _close(D, jD)
    _close(invD, jinvD)
    _close(LR.chol6_solve(fac, _t(data["tau"])), JLR.chol6_solve(jfac, _j(data["tau"])))


def test_forward_dynamics_and_integrators(models, data):
    sm, jsm = models
    fe = LR.world_wrench_to_ee(sm, _t(data["q"]), _t(data["w"]))
    jfe = JLR.world_wrench_to_ee(jsm, _j(data["q"]), _j(data["w"]))
    a, _ = LR.forward_dynamics(sm, _t(data["q"]), _t(data["v"]), _t(data["tau"]), fe)
    ja, _ = JLR.forward_dynamics(jsm, _j(data["q"]), _j(data["v"]), _j(data["tau"]), jfe)
    _close(a, ja)

    x = np.concatenate([data["q"], data["v"]])
    for step in ("euler_step", "rk4_step"):
        got = getattr(LR, step)(
            sm, torch.as_tensor(x), torch.as_tensor(data["tau"]), 0.01,
            wrench_world=torch.as_tensor(data["w"]),
        )
        ref = getattr(JLR, step)(
            jsm, jnp.asarray(x), jnp.asarray(data["tau"]), 0.01,
            wrench_world=jnp.asarray(data["w"]),
        )
        _close(got, ref)


def test_rnea_tangents_match_jacfwd(models, data):
    """The forward-mode tangent pass against jax.jacfwd of RNEA with the
    wrench map at the same state, including the q-dependence of the map."""
    sm, jsm = models
    x = np.concatenate([data["q"], data["v"]])
    got = LS.rnea_tangents(
        sm, torch.as_tensor(x), torch.as_tensor(data["a"]), torch.as_tensor(data["w"])
    ).numpy()  # (6, 12, L)

    def tau_of(x1, a1, w1):  # one lane: (12,) -> (6,)
        q = [x1[i][None] for i in range(6)]
        v = [x1[6 + i][None] for i in range(6)]
        fe = JLR.world_wrench_to_ee(jsm, q, [w1[i][None] for i in range(6)])
        return jnp.concatenate(
            JLR.rnea(jsm, q, v, [a1[i][None] for i in range(6)], f_ext_ee=fe)
        )

    jac = jax.jacfwd(tau_of)
    for lane in range(L):
        ref = np.asarray(
            jac(jnp.asarray(x[:, lane]), jnp.asarray(data["a"][:, lane]),
                jnp.asarray(data["w"][:, lane]))
        )
        np.testing.assert_allclose(got[:, :, lane], ref, rtol=0, atol=1e-10)
    # The wrench map's q-dependence is part of the derivative.
    no_w = LS.rnea_tangents(sm, torch.as_tensor(x), torch.as_tensor(data["a"])).numpy()
    assert np.abs(no_w[:, :6] - got[:, :6]).max() > 1e-3
