"""The port's entry points (``indy7_mpc_tpu_torch/examples`` and
``tools``) against the repository's scripts, on the CPU at small sizes.

  * the device recording (``record_runs.run_device_resident``) on the plain
    versions in f64, with the JAX readable loop tick's draws replayed
    (as tests/test_torch_slice.py does), against the JAX ``RunRecorder``'s
    arrays of the JAX trace, on both plants; chunking changes no bit, and
    the recording is ``run_sampled_mpc``'s from the same seed;
  * the in-process and UDP rows (``run_one``): the goldens' file set,
    read by ``tools/analyze_stats.py``;
  * the other examples' ``main(argv)`` print the TPU scripts' keys;
  * the replay's page equals ``tools/replay_html.py``'s on one recording.

``graft_entry`` has its own file (tests/test_torch_graft_entry.py), so
that its JAX compile runs beside this file's.  Each JAX oracle is jitted
once.  UDP ports 7570/7571 belong to this file.
"""
import importlib.util
import json
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import indy7_mpc_tpu.config as jcfg
import indy7_mpc_tpu.runtime as jrt
from indy7_mpc_tpu.models import indy7 as jax_indy7
from indy7_mpc_tpu.mpc.sampled import SampledTrace as JaxSampledTrace
from indy7_mpc_tpu.mpc.sampled import init_loop_carry as jax_init_loop_carry
from indy7_mpc_tpu.mpc.sampled import make_loop_tick as jax_make_loop_tick
import indy7_mpc_tpu_torch.config as cfg
from indy7_mpc_tpu_torch import graft_entry
from indy7_mpc_tpu_torch.examples import (
    baseline_table, fig8_closed_loop, point_to_goal, protocol, record_runs,
)
from indy7_mpc_tpu_torch.models import indy7
from indy7_mpc_tpu_torch.models.convert import carry_from_numpy
from indy7_mpc_tpu_torch.mpc import TickDraws, run_sampled_mpc
from indy7_mpc_tpu_torch.runtime import RunRecorder
from indy7_mpc_tpu_torch.tools import replay_html

ROOT = Path(__file__).resolve().parents[1]
B, N, TICKS, DT = 8, 8, 5, 0.01
ATOL = 1e-8
ARRAYS = RunRecorder.ARRAYS + RunRecorder.EXTRA_ARRAYS
PLANTS = {"nominal": (None, None), "perturbed": (cfg.PERTURBED_PLANT, jcfg.PERTURBED_PLANT)}
UDP_PORTS = (7571, 7570)  # plant, controller


def _stem(run_dir):
    (f,) = Path(run_dir).glob("*_tracking_errors.npy")
    return str(f)[: -len("_tracking_errors.npy")]


def _replay_draws(key, plant_cfg):
    """One tick's draws, exactly as the JAX readable tick consumes its key
    (tests/test_torch_slice.py)."""
    _, k_tick, k_walk, k_plant = jax.random.split(key, 4)
    key_r, _ = jax.random.split(k_tick)
    plant = None
    if plant_cfg is not None and plant_cfg.torque_noise_std:
        draws, k = [], k_plant
        for _ in range(plant_cfg.substeps):
            k, ks = jax.random.split(k)
            draws.append(np.asarray(jax.random.normal(ks, (6,), jnp.float64)))
        plant = torch.as_tensor(np.stack(draws))
    return TickDraws(
        resample=torch.tensor(np.asarray(jax.random.normal(key_r, (B, 6), jnp.float64))),
        walk=torch.tensor(np.asarray(jax.random.normal(k_walk, (3,), jnp.float64))),
        plant=plant,
    )


@pytest.mark.parametrize("plant", ["nominal", "perturbed"])
def test_device_recording_matches_jax_recorder(plant, tmp_path):
    """The JAX readable loop tick (``fused=False``) at the protocol's
    configuration shrunk to N=8, B=8, stepped 5 ticks and recorded by the
    JAX ``RunRecorder``; the port's device recording from the JAX carry
    with the JAX draws, in chunks of 2 (the last one of 1) after a warm-up
    chunk.  Every array but ``solve_times`` agrees to 1e-8 in f64."""
    port_plant, jax_plant = PLANTS[plant]
    ref = protocol.fig8_reference(TICKS, N=N)
    model = jax_indy7(dtype=jnp.float64)
    mpc_cfg, sample_cfg = jcfg.MPCConfig(N=N, dt=DT), jcfg.SampleConfig(
        batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0)
    tick = jax.jit(jax_make_loop_tick(
        model, jcfg.CostConfig(), jcfg.SQPConfig(max_iters=2), mpc_cfg, sample_cfg,
        jnp.asarray(ref), plant_cfg=jax_plant, fused=False,
    ))
    carry = jax_init_loop_carry(model, mpc_cfg, sample_cfg,
                                jnp.asarray(np.r_[protocol.INIT_Q, np.zeros(6)]),
                                jnp.asarray(protocol.F_TRUE0), jax.random.PRNGKey(42))
    carry0 = carry_from_numpy({f: np.asarray(getattr(carry, f)) for f in carry._fields})
    draws, traces = [], []
    for _ in range(TICKS):
        draws.append(_replay_draws(carry.key, jax_plant))
        carry, trace = tick(carry, None)
        traces.append(trace)
    jrec = jrt.RunRecorder(out_dir=str(tmp_path / "jax"), save_interval=1e9)
    jrec.record_trace(JaxSampledTrace(*(np.stack([np.asarray(getattr(t, f)) for t in traces])
                                        for f in JaxSampledTrace._fields)),
                      dts=DT, solve_times_us=0.0)
    jstem = jrec.save()

    row, final = record_runs.run_device_resident(
        B, TICKS, port_plant, str(tmp_path), "port", chunk=2, device="cpu", N=N,
        dtype=torch.float64, carry0=carry0, draws=draws)
    assert row["ticks"] == TICKS and row["finite"] and row["event_us"] is None
    for name in ARRAYS:
        got, want = (np.load(f"{s}_{name}.npy") for s in (row["stem"], jstem))
        assert got.shape == want.shape and got.dtype == want.dtype, name
        if name != "solve_times":
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
    np.testing.assert_allclose(final.x.numpy(), np.asarray(carry.x), rtol=0, atol=ATOL)
    assert int(final.ref_offset) == TICKS


@pytest.fixture(scope="module")
def device_baseline(tmp_path_factory):
    """A 6-tick device recording on the generator's draws (B=4, N=8, f32,
    perturbed plant): chunks of 3 after a warm-up chunk."""
    return _device_row(tmp_path_factory.mktemp("device"), chunk=3)


def _device_row(out, **kw):
    row, carry = record_runs.run_device_resident(4, 6, cfg.PERTURBED_PLANT, str(out), "run",
                                                 device="cpu", N=N, **kw)
    return {n: np.load(f"{row['stem']}_{n}.npy") for n in ARRAYS}, carry


def test_device_recording_independent_of_chunking(device_baseline, tmp_path):
    """Chunks of 1 instead of 3 give the same bits."""
    base, base_carry = device_baseline
    got, carry = _device_row(tmp_path, chunk=1)
    for name in ARRAYS:
        if name != "solve_times":
            np.testing.assert_array_equal(got[name], base[name], err_msg=name)
    for a, b in zip(carry, base_carry):
        assert torch.equal(a, b)


def test_device_recording_equals_run_sampled_mpc(device_baseline):
    """The warm-up chunk gives the generator's draws back: the recording
    and its final carry are ``run_sampled_mpc``'s from the same seed, bit
    for bit (the entry point adds nothing to the loop)."""
    base, base_carry = device_baseline
    cost, sqp, mpc_cfg, sample_cfg = protocol.configs(4, N=N)
    final, tr = run_sampled_mpc(indy7(torch.float32), cost, sqp, mpc_cfg, sample_cfg,
                                protocol.initial_state(), protocol.fig8_reference(6, N=N), 6,
                                protocol.F_TRUE0, torch.Generator().manual_seed(42),
                                plant_cfg=cfg.PERTURBED_PLANT)
    for name, field in (("tracking_errors", "tracking_error"), ("ee_positions", "ee_pos"),
                        ("ee_ref_positions", "ee_ref"), ("joint_positions", "q"),
                        ("f_est", "f_est"), ("f_true", "f_true")):
        want = getattr(tr, field).numpy()
        np.testing.assert_array_equal(base[name], want.astype(base[name].dtype), err_msg=name)
    for a, b in zip(base_carry, final):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def inproc_row(tmp_path_factory):
    """A 6-tick in-process row (B=4, N=8, one SQP iteration, perturbed)."""
    out = tmp_path_factory.mktemp("inproc")
    row = record_runs.run_one(4, 6, cfg.PERTURBED_PLANT, str(out), "perturbed_b4",
                              device="cpu", N=N, max_iters=1)
    return out, row


def test_inproc_row_writes_the_goldens_file_set(inproc_row):
    """The .npy files of the JAX ``RunRecorder`` as the goldens hold them
    (stats_tpu/perturbed_b64 was written by the TPU script's ``run_one``):
    the same names, dtypes and trailing shapes."""
    out, row = inproc_row
    got = {p.name[len(Path(row["stem"]).name):]: np.load(p)
           for p in Path(out, "perturbed_b4").glob("*.npy")}
    golden = _stem(ROOT / "stats_tpu" / "perturbed_b64")
    want = {p.name[len(Path(golden).name):]: np.load(p)
            for p in Path(golden).parent.glob(Path(golden).name + "_*.npy")}
    assert sorted(got) == sorted(want) == sorted(f"_{n}.npy" for n in ARRAYS)
    for name, a in got.items():
        assert a.dtype == want[name].dtype and a.shape[1:] == want[name].shape[1:], name
        assert a.shape[0] == 6 and np.isfinite(a).all(), name
    assert row["ticks"] == 6 and row["transport"] == "inproc"
    assert Path(row["stem"] + "_row.json").exists()


def _analyze_stats():
    spec = importlib.util.spec_from_file_location("analyze_stats",
                                                  ROOT / "tools" / "analyze_stats.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_analyze_stats_reads_the_port_recording(inproc_row):
    """``tools/analyze_stats.py``, unchanged, finds and loads the row, and
    its statistics equal those the port keeps a copy of."""
    out, row = inproc_row
    tool = _analyze_stats()
    (stem,) = tool.find_runs(str(out))
    assert stem == row["stem"]
    data = tool.load(stem)
    assert all(data[n] is not None for n in ARRAYS)
    want = tool.estimator_stats(data["f_est"], data["f_true"], walk_period=2)
    assert record_runs.estimator_stats(data["f_est"], data["f_true"], walk_period=2) == want
    assert want["fe_windows"] == 3
    desc = tool.describe(stem, data)
    assert desc["te_mean"] == row["tracking_m"][0]
    assert desc["fe_err_p50"] == row["fe_err_p50"]


def test_write_summary_pairs_rows_with_goldens(inproc_row, tmp_path):
    out, row = inproc_row
    path = tmp_path / "SUMMARY.md"
    rows = record_runs.collect_rows(out)
    assert [r["stem"] for r in rows] == [row["stem"]]
    record_runs.write_summary(rows, 6, str(path), golden_dir=ROOT / "stats_tpu")
    text = path.read_text()
    assert "| perturbed_b4 | 42 | 4 | 6 |" in text
    assert "tools/analyze_stats.py" in text and row["stem"].split(os.sep)[-1] in text


def test_udp_row_against_the_native_plant(tmp_path):
    """20 ticks against plant_node over UDP: the plant runs 30 times slower
    than the wall clock so that a CPU tick fits its 10 ms period, and the
    process is ended with the run (its port is free again)."""
    row = record_runs.run_one(4, 20, cfg.PERTURBED_PLANT, str(tmp_path), "perturbed_b4_udp",
                              transport="udp", realtime_scale=30, device="cpu", N=N,
                              max_iters=1, ports=UDP_PORTS)
    assert row["ticks"] == 20 and row["finite"] and row["transport"] == "udp"
    dts = np.load(row["stem"] + "_dts.npy")
    np.testing.assert_allclose(dts / DT, np.round(dts / DT), atol=1e-6)  # plant time
    with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
        s.bind(("127.0.0.1", UDP_PORTS[0]))


def test_defaults_stay_off_the_goldens():
    args = record_runs.build_parser().parse_args([])
    out, summary = Path(args.out).resolve(), Path(args.summary).resolve()
    golden = (ROOT / "stats_tpu").resolve()
    assert out != golden and golden not in out.parents
    assert summary != (ROOT / "BASELINE_TPU.md").resolve()
    assert summary.name == "BASELINE_TORCH.md" and args.device == "cuda" and args.seed == 42
    assert record_runs.row_tag("perturbed", 64, "device") == "perturbed_b64_device"
    assert record_runs.row_tag("nominal", 16, "inproc") == "nominal_b16"
    assert record_runs.row_tag("perturbed", 64, "udp", 43) == "perturbed_b64_udp_seed43"


@pytest.mark.parametrize("module", [record_runs, fig8_closed_loop, point_to_goal,
                                    baseline_table, replay_html, graft_entry],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_points_default_to_the_card(module):
    """Without ``--device`` each entry point runs on CUDA; where CUDA is
    missing it raises instead of running on the CPU."""
    argv = ["stats_tpu/perturbed_b64"] if module is replay_html else []
    if torch.cuda.is_available():
        assert protocol.device("cuda").type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        module.main(argv)


def _json_objects(text):
    dec, objs, i = json.JSONDecoder(), [], 0
    while True:
        i = text.find("{", i)
        if i < 0:
            return objs
        obj, i = dec.raw_decode(text, i)
        objs.append(obj)


# The keys of the TPU scripts' JSON output (examples/fig8_closed_loop.py:88-109,
# examples/point_to_goal.py:58-99, examples/baseline_table.py:121-136).
FIG8_KEYS = {"config", "tracking_error_mean", "tracking_error_p50", "tracking_error_p95",
             "tracking_error_mean_after_warmup", "per_tick_us_incl_plant", "realtime_ok",
             "stats_stem", "reference_tracking_error_mean"}
P2G_KEYS = {"mode", "steps", "initial_dist", "final_dist", "min_dist", "goal_switches",
            "wall_s"}
COMPARE_KEYS = {"mode", "f_true", "batch1", "batch64"}
BATCH_KEYS = {"tracking_error_mean", "tracking_error_tail", "f_est_final"}
TABLE_KEYS = {"B", "solve_us_mean", "solve_us_worst_chunk", "closed_loop_tick_us",
              "ref_solve_us_mean", "ref_solve_us_p95", "te_mean", "te_p50", "te_p95",
              "ref_te_mean", "ref_te_p50", "ref_te_p95", "solves_per_sec", "ref_solves_per_sec"}


def test_fig8_closed_loop_main(capsys, tmp_path):
    assert fig8_closed_loop.main(["2", "3", "--perturbed", "--device", "cpu",
                                  "--out", str(tmp_path)]) == 0
    (out,) = _json_objects(capsys.readouterr().out)
    assert FIG8_KEYS <= set(out) and out["config"] == "B=2 N=64 dt=0.01 ticks=3"
    assert np.isfinite(out["tracking_error_mean"]) and out["device"].startswith("cpu")
    assert out["reference_tracking_error_mean"]["batch64"] == 0.125
    assert np.load(out["stats_stem"] + "_tracking_errors.npy").shape == (3,)


def test_point_to_goal_compare_main(capsys):
    assert point_to_goal.main(["--steps", "2", "--compare", "--device", "cpu"]) == 0
    goal, compare = _json_objects(capsys.readouterr().out)
    assert P2G_KEYS <= set(goal) and goal["mode"] == "point_to_goal" and goal["steps"] == 2
    assert COMPARE_KEYS <= set(compare) and compare["f_true"] == [5.0, 0.0, 15.0]
    for b in ("batch1", "batch64"):
        assert set(compare[b]) == BATCH_KEYS and len(compare[b]["f_est_final"]) == 3
    assert compare["batch1"]["f_est_final"] == [0.0, 0.0, 0.0]  # B=1 holds a zero wrench


def test_baseline_table_main(capsys, tmp_path):
    path = tmp_path / "table.json"
    assert baseline_table.main(["2", "--solve-iters", "4", "--batches", "1,2", "--device",
                                "cpu", "--json", str(path)]) == 0
    assert "solves/s" in capsys.readouterr().out
    rows = json.loads(path.read_text())
    assert [r["B"] for r in rows] == [1, 2]
    for r in rows:
        assert TABLE_KEYS <= set(r) and np.isfinite(r["solve_us_mean"])
    assert rows[0]["ref_solve_us_mean"] == 5261 and rows[1]["ref_solve_us_mean"] is None


def _page(path):
    html = Path(path).read_text()
    m = re.search(r"^const DATA = (.*);$", html, re.M)
    return json.loads(m.group(1)), html[: m.start()] + html[m.end():]


def test_replay_page_matches_the_jax_tool(inproc_row, tmp_path):
    """The port's replay and ``tools/replay_html.py`` (JAX forward
    kinematics, in a subprocess) on the same recording: the same page, and
    the same data within 2e-4 (both round to 4 places)."""
    out, _ = inproc_row
    run_dir = str(Path(out, "perturbed_b4"))
    assert replay_html.main([run_dir, "--every", "2", "--out", str(tmp_path / "port.html"),
                             "--device", "cpu"]) == 0
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(ROOT / "tools" / "replay_html.py"), run_dir,
                    "--every", "2", "--out", str(tmp_path / "jax.html")],
                   check=True, cwd=ROOT, env=env, capture_output=True, timeout=300)
    (got, page), (want, jax_page) = _page(tmp_path / "port.html"), _page(tmp_path / "jax.html")
    assert page == jax_page
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]), rtol=0, atol=2e-4,
                                   err_msg=k)
    assert np.asarray(got["links"]).shape == (3, 7, 3)
