"""The port's host-driven runtime against the TPU package's.

  * ``sampled_tick`` (plain versions of K1 and of the consensus) against the
    JAX ``sampled_tick`` on its readable solver, float64, with the JAX
    tick's resampling normals replayed: winner equal, the rest to 1e-8;
  * ``SampledController`` against the JAX controller, float32, each on its
    package's nominal in-process plant, from the same controller state;
  * ``InProcessPlant`` against the JAX one on the perturbed plant;
  * checkpoint/resume, the recorder's files, the UDP wire bytes, the
    watchdog, and the UDP loop against the native ``plant_node``.

Small problems (N <= 8, B = 4, one SQP iteration) keep the JAX compiles
short; each JAX program is compiled once.  UDP ports 7560-7569 belong to
this file.
"""
import os
import socket
import subprocess
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
import indy7_mpc_tpu.runtime as jrt
from indy7_mpc_tpu.dynamics import ee_pos as jax_ee_pos
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import sampled_tick as jax_sampled_tick
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import controller_state_from_npz
from indy7_mpc_tpu_torch.mpc import reference, sampled_tick
from indy7_mpc_tpu_torch.ops import lane_rbd as LR
from indy7_mpc_tpu_torch.runtime import (
    InProcessPlant, RunRecorder, SampledController, UdpTransport, run_control_loop,
)
from indy7_mpc_tpu_torch.runtime import controller as ctl_mod
from indy7_mpc_tpu_torch.sim.plant import predict_next_states

PLANT_BIN = os.path.join(os.path.dirname(__file__), "..", "native", "plant", "plant_node")
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
B, DT = 4, 0.01
# Controller tests (the configuration of tests/test_runtime.py).
MPC = dict(N=6, dt=DT)
SQP = dict(max_iters=1)
SAMPLE = dict(batch_size=B, f_ext_std=5.0, f_ext_resample_std=0.5)
F_EXT = [3.0, 0.0, -5.0]
REALTIME_SCALE = 30


def _hold_ref(q0, ticks):
    sm = LR.static_model(indy7(torch.float64))
    ee = torch.stack(LR.ee_pos(sm, list(torch.as_tensor(q0, dtype=torch.float64)))).numpy()
    return np.tile(ee, (ticks, 1)).astype(np.float32)


def _controller(ref, **sample):
    return SampledController(
        indy7(torch.float32), cfg.CostConfig(), cfg.SQPConfig(**SQP),
        cfg.MPCConfig(**MPC), cfg.SampleConfig(**{**SAMPLE, **sample}), ref,
        f_ext_actual=F_EXT, device="cpu",
    )


def test_sampled_tick_matches_jax():
    N = 8
    rng = np.random.default_rng(3)
    x_last = np.r_[INIT_Q, 0.2 * rng.normal(size=6)]
    u_last = 5.0 * rng.normal(size=6)
    f_batch = 20.0 * rng.normal(size=(B, 6))
    f_batch[:, 3:] = 0.0
    f_batch[0] = 0.0
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64)
    # Observed: the prediction under lane 2's wrench, slightly off.
    sm = LR.static_model(indy7(torch.float64))
    x_obs = predict_next_states(sm, t64(x_last), t64(u_last), DT, t64(f_batch).T)[:, 2].numpy()
    x_obs = x_obs + 1e-4 * rng.normal(size=12)
    goals = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10,
                              dt=DT, cycles=1)[:N]
    X_warm = np.tile(x_last, (N, 1)) + 0.01 * rng.normal(size=(N, 12))
    U_warm = 2.0 * rng.normal(size=(N - 1, 6))
    args = (x_obs, x_last, u_last, goals, X_warm, U_warm, f_batch)
    sample = dict(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)

    key = jax.random.PRNGKey(7)
    model = jax_indy7(dtype=jnp.float64)
    want = jax.jit(lambda key, *a: jax_sampled_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=1), jcfg.SampleConfig(**sample),
        DT, key, *a, batch_solve_fn=None,
    ))(key, *map(jnp.asarray, args))
    key_r, _ = jax.random.split(key)  # the resampling key (sampled.py:155)
    normals = t64(np.array(jax.random.normal(key_r, (B, 6), jnp.float64)))

    got = sampled_tick(
        indy7(torch.float64), cfg.CostConfig(), cfg.SQPConfig(max_iters=1),
        cfg.SampleConfig(**sample), DT, None, *map(t64, args), normals=normals,
    )
    assert int(got.best_idx) == int(want.best_idx) == 2
    for f in ("u", "X_best", "U_best", "f_batch", "f_est"):
        np.testing.assert_allclose(
            getattr(got, f).numpy(), np.asarray(getattr(want, f)), rtol=0, atol=1e-8, err_msg=f
        )
    assert int(got.sqp_iters) <= int(want.sqp_iters)  # accepted steps vs steps run


@pytest.fixture(scope="module")
def jax_controller_run(tmp_path_factory):
    """The JAX controller on its nominal in-process plant for 6 ticks
    (f_ext_resample_std = 0), with its state saved before the first tick."""
    ckpt = str(tmp_path_factory.mktemp("jax_ctl") / "ctl.npz")
    model = jax_indy7(dtype=jnp.float32)
    x0 = np.zeros(12)
    ref = _hold_ref(x0[:6], 400)
    ctl = jrt.SampledController(
        model, jcfg.CostConfig(), jcfg.SQPConfig(**SQP), jcfg.MPCConfig(**MPC),
        jcfg.SampleConfig(**{**SAMPLE, "f_ext_resample_std": 0.0}), ref, f_ext_actual=F_EXT,
    )
    ctl.save_checkpoint(ckpt)
    return ckpt, ref, _drive(ctl, jrt.InProcessPlant(model, x0, DT), 6)


def _drive(ctl, plant, ticks):
    plant.send_wrench(ctl.f_ext_actual)
    us, best, terr = [], [], []
    for _ in range(ticks):
        u, info = ctl.on_state(plant.recv_state().x, DT)
        plant.send_command(u)
        us.append(np.array(u))
        best.append(info["best_idx"])
        terr.append(info["tracking_error"])
    return np.asarray(us), np.asarray(best), np.asarray(terr)


def test_controller_follows_jax_controller(jax_controller_run):
    """Winner sequence equal; u within 1e-4 N m (|u| reaches 3.5 N m; the
    two differed by 1.4e-5 when this was written): both run float32, the
    JAX side through its readable solver and the port through the plain
    K1, whose sums run in another order."""
    ckpt, ref, (ju, jbest, jterr) = jax_controller_run
    ctl = _controller(ref, f_ext_resample_std=0.0)
    ctl.load_state(controller_state_from_npz(ckpt))
    pu, pbest, pterr = _drive(ctl, InProcessPlant(indy7(torch.float32), np.zeros(12), DT,
                                                 device="cpu"), 6)
    np.testing.assert_array_equal(pbest, jbest)
    np.testing.assert_allclose(pu, ju, rtol=0, atol=1e-4)
    np.testing.assert_allclose(pterr, jterr, atol=1e-5)


def test_controller_state_from_jax_checkpoint(jax_controller_run):
    ckpt = jax_controller_run[0]
    state = controller_state_from_npz(ckpt)
    with np.load(ckpt) as z:
        for name in ("f_batch", "X_best", "U_best", "u_last"):
            np.testing.assert_array_equal(state[name].numpy(), z[name])
            assert state[name].dtype == torch.float32
        np.testing.assert_array_equal(state["f_ext_actual"], z["f_ext_actual"])
        assert state["ref_offset"] == float(z["ref_offset"])
    assert state["x_last"] is None  # no state seen before the first tick
    assert "key" not in state


def test_in_process_plant_matches_jax():
    """The port's InProcessPlant (the plain version of the K2 plant step)
    against the JAX one on the perturbed plant under a wrench, float32;
    actuation noise off, since the two packages draw it differently."""
    import dataclasses

    x0 = np.r_[INIT_Q, np.zeros(6)]
    us = 20.0 * np.random.default_rng(10).normal(size=(5, 6))
    plants = (
        InProcessPlant(indy7(torch.float32), x0, DT, plant_cfg=dataclasses.replace(
            cfg.PERTURBED_PLANT, torque_noise_std=0.0), device="cpu"),
        jrt.InProcessPlant(jax_indy7(dtype=jnp.float32), x0, DT, plant_cfg=dataclasses.replace(
            jcfg.PERTURBED_PLANT, torque_noise_std=0.0)),
    )
    xs = []
    for plant in plants:
        plant.send_wrench(F_EXT)
        for u in us:
            plant.send_command(u.astype(np.float32))
        xs.append(np.asarray(plant.recv_state().x))
    assert not np.allclose(xs[0], x0)
    np.testing.assert_allclose(xs[0], xs[1], rtol=0, atol=1e-4)


def test_checkpoint_resume_bit_identical(tmp_path):
    """Stop/resume via save_checkpoint reproduces the uninterrupted run
    exactly (tests/test_runtime.py's check, on the port)."""
    x0 = np.zeros(12)
    ref = _hold_ref(x0[:6], 400)
    model = indy7(torch.float32)

    def ticks(ctl, plant, n, out):
        for _ in range(n):
            u, _ = ctl.on_state(plant.recv_state().x, DT)
            plant.send_command(u)
            out.append(u.copy())

    ua, ub = [], []
    ticks(_controller(ref), InProcessPlant(model, x0, DT, device="cpu"), 8, ua)
    plant_b, ctl_b = InProcessPlant(model, x0, DT, device="cpu"), _controller(ref)
    ticks(ctl_b, plant_b, 4, ub)
    ckpt = ctl_b.save_checkpoint(str(tmp_path / "ctl.npz"))
    ctl_c = _controller(ref)
    ctl_c.load_checkpoint(ckpt)
    ticks(ctl_c, plant_b, 4, ub)
    np.testing.assert_array_equal(np.asarray(ua), np.asarray(ub))


def test_recorder_files_match_jax_recorder(tmp_path):
    """The same ticks recorded by both packages (device values as tensors
    and as JAX arrays) give the same .npy files, byte for byte."""
    rng = np.random.default_rng(5)
    port = RunRecorder(out_dir=str(tmp_path / "port"), save_interval=1e9)
    ref = jrt.RunRecorder(out_dir=str(tmp_path / "jax"), save_interval=1e9)
    for _ in range(7):
        x = rng.normal(size=12).astype(np.float32)
        f_est = rng.normal(size=6).astype(np.float32)
        ee, ee_ref, f_true = rng.normal(size=3), rng.normal(size=3), rng.normal(size=6)
        common = (float(rng.uniform(0.009, 0.011)), float(rng.uniform(0, 0.1)), ee, ee_ref)
        port.record(*common, torch.from_numpy(x), 123.4, f_est=torch.from_numpy(f_est),
                    f_true=f_true)
        ref.record(*common, jnp.asarray(x), 123.4, f_est=jnp.asarray(f_est), f_true=f_true)
    stems = port.save(), ref.save()
    names = [sorted(os.path.basename(p)[len(os.path.basename(s)):]
                    for p in map(str, (tmp_path / d).iterdir()))
             for s, d in zip(stems, ("port", "jax"))]
    assert names[0] == names[1] == sorted(
        f"_{n}.npy" for n in RunRecorder.ARRAYS + RunRecorder.EXTRA_ARRAYS
    )
    for name in RunRecorder.ARRAYS + RunRecorder.EXTRA_ARRAYS:
        a, b = (open(f"{s}_{name}.npy", "rb").read() for s in stems)
        assert a == b, name
    assert port.summary() == ref.summary()


def test_recorder_holds_a_bounded_number_of_tensors(tmp_path):
    """Over more ticks than FLUSH_EVERY the recorder holds fewer than
    FLUSH_EVERY tensors at any time, and its files equal the JAX
    recorder's byte for byte."""
    rng = np.random.default_rng(6)
    port = RunRecorder(out_dir=str(tmp_path / "port"), save_interval=1e9)
    ref = jrt.RunRecorder(out_dir=str(tmp_path / "jax"), save_interval=1e9)
    held = lambda: sum(isinstance(v, torch.Tensor) for vals in port._data.values() for v in vals)
    most = 0
    for i in range(2 * RunRecorder.FLUSH_EVERY + 9):
        x = rng.normal(size=12).astype(np.float32)
        f_est = rng.normal(size=6).astype(np.float32)
        common = (0.01, float(rng.uniform(0, 0.1)), rng.normal(size=3), rng.normal(size=3))
        port.record(*common, torch.from_numpy(x), 100.0 + i, f_est=torch.from_numpy(f_est))
        ref.record(*common, jnp.asarray(x), 100.0 + i, f_est=jnp.asarray(f_est))
        most = max(most, held())
    assert 0 < most < RunRecorder.FLUSH_EVERY
    stems = port.save(), ref.save()
    for name in RunRecorder.ARRAYS + ("f_est",):
        a, b = (open(f"{s}_{name}.npy", "rb").read() for s in stems)
        assert a == b, name


def test_wire_bytes_match_jax_transport():
    sink = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sink.bind(("127.0.0.1", 7562))
    sink.settimeout(2.0)
    port = UdpTransport(plant_addr=("127.0.0.1", 7562), listen_addr=("127.0.0.1", 7563))
    ref = jrt.UdpTransport(plant_addr=("127.0.0.1", 7562), listen_addr=("127.0.0.1", 7564))
    try:
        sent = []
        for tr in (port, ref):
            tr.send_command(np.array([1.5, -2.0, 3.25, 0.0, 1e-3, -7.0], np.float32))
            tr.send_wrench([-60.0, 20.0, -40.0])
            tr.send_reset()
            sent.append([sink.recvfrom(512)[0] for _ in range(3)])
        assert sent[0] == sent[1]
        assert [p[0] for p in sent[0]] == [2, 3, 4] and len(sent[0][0]) == 1 + 6 * 8
        # A protocol-v2 state packet parses the same on both sides.
        pkt = bytes([1]) + np.arange(16, dtype="<f8").tobytes()
        for addr in (7563, 7564):
            sink.sendto(pkt, ("127.0.0.1", addr))
        time.sleep(0.1)
        a, b = port.recv_state(), ref.recv_state()
        np.testing.assert_array_equal(a.x, b.x)
        np.testing.assert_array_equal(a.ee_pos, b.ee_pos)
        assert a.sim_time == b.sim_time == 15.0
    finally:
        for s in (sink, port, ref):
            s.close()


def test_watchdog_fires_on_blackout():
    """Nothing bound on the state port: the loop raises within about
    JOINT_STATE_TIMEOUT instead of waiting forever."""
    tr = UdpTransport(plant_addr=("127.0.0.1", 7566), listen_addr=("127.0.0.1", 7567),
                      recv_timeout=0.05)
    old = ctl_mod.JOINT_STATE_TIMEOUT
    ctl_mod.JOINT_STATE_TIMEOUT = 1.0

    class _Ctl:
        f_ext_actual = np.zeros(3)

        def on_state(self, x, elapsed):  # pragma: no cover
            raise AssertionError("no state should ever arrive")

    try:
        t0 = time.time()
        with pytest.raises(TimeoutError):
            run_control_loop(_Ctl(), tr, duration=30, rate_hz=100, walk_disturbance=False)
        assert time.time() - t0 < 5.0
    finally:
        ctl_mod.JOINT_STATE_TIMEOUT = old
        tr.close()


def test_udp_loop_against_native_plant(native_build, tmp_path):
    """The controller against plant_node over UDP.  The plant runs its
    physics REALTIME_SCALE times slower than the wall clock, so that one
    10 ms control period of plant time covers a CPU tick of the plain
    solver (the ``--realtime-scale`` of the recorded UDP run), and stamps
    its sim time, by which the controller advances its reference."""
    proc = subprocess.Popen(
        [PLANT_BIN, "0.002", "5", "--ports", "7561", "7560",
         "--realtime-scale", str(REALTIME_SCALE)],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    try:
        transport = UdpTransport(plant_addr=("127.0.0.1", 7561),
                                 listen_addr=("127.0.0.1", 7560))
        ctl = _controller(_hold_ref(INIT_Q, 1000))  # plant_node's start pose
        rec = RunRecorder(out_dir=str(tmp_path), save_interval=1e9)
        try:
            # The plant is bound once it sends: the loop's first wrench lands.
            first = transport.wait_for_state(timeout=30.0)
            np.testing.assert_allclose(first.x[:6], INIT_Q, atol=1e-3)
            rec = run_control_loop(ctl, transport, duration=600,
                                   rate_hz=100 / REALTIME_SCALE, recorder=rec,
                                   walk_disturbance=True, max_ticks=15)
        finally:
            transport.close()
        te = np.asarray(rec._data["tracking_errors"])
        assert len(te) == 15  # states flowed over UDP
        assert np.all(np.isfinite(te))
        assert rec.summary()["tracking_error_mean"] < 0.6
        # Elapsed plant time per tick, in whole 10 ms state periods.
        dts = np.asarray(rec._data["dts"])
        np.testing.assert_allclose(dts / DT, np.round(dts / DT), atol=1e-6)
        assert np.median(dts) < 3 * DT
    finally:
        proc.kill()
        proc.wait()
