"""``indy7_mpc_tpu_torch.graft_entry`` against ``__graft_entry__.py``, on
the CPU: the same example problem and the same batched solve (K1's plain
version against the TPU package's readable solver, f64), and the sharded
dry run on two gloo ranks."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from indy7_mpc_tpu_torch import graft_entry

ROOT = Path(__file__).resolve().parents[1]


def test_graft_entry_matches_jax_entry(monkeypatch):
    """The same example problem, and the same solve: the port's batched
    solve (K1's plain version) and the TPU entry's (its readable solver),
    both on the f64 model, within tests/test_torch_sqp.py's 1e-9."""
    monkeypatch.syspath_prepend(str(ROOT))
    import __graft_entry__ as jge

    flagship = jge._flagship
    monkeypatch.setattr(jge, "_flagship", lambda dtype=None, **kw: flagship(jnp.float64, **kw))
    jfn, jargs = jge.entry()
    fn, args = graft_entry.entry(device="cpu", dtype=torch.float64)
    for a, j in zip(args, jargs):
        assert tuple(a.shape) == j.shape
        np.testing.assert_array_equal(a.numpy().astype(np.float32), np.asarray(j))
    X, U = fn(*args)
    jX, jU = jax.jit(jfn)(*(jnp.asarray(a.numpy()) for a in args))
    np.testing.assert_allclose(X.numpy(), np.asarray(jX), rtol=0, atol=1e-9)
    np.testing.assert_allclose(U.numpy(), np.asarray(jU), rtol=0, atol=1e-9)
    assert all(t.dtype == torch.float32 for t in graft_entry.entry(device="cpu")[1])
    assert np.abs(U.numpy()).max() > 0.1  # the pushed lanes move


def test_graft_dryrun_multichip_on_two_ranks():
    out = graft_entry.dryrun_multichip(2, device="cpu")
    assert len(out) == 2
    np.testing.assert_array_equal(out[0]["tracking_error"], out[1]["tracking_error"])
    assert out[0]["tracking_error"].shape == (6,)
