"""The harness finds every configuration, mix, driver, reader and limit by
name; a new cell, mix or metric is files and entries only; the metric
arithmetic on synthetic timings and traces; ``BENCHMARK.json`` within the
benchmark's contract."""
import json
import math
import re
import shutil
import statistics
from pathlib import Path

import pytest

from mpcbench import harness, profiling, timing, traffic

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_is_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.config["name"] == c.config_name
    assert c.mix["name"] == c.traffic
    harness.load_driver(c.mix)
    for m in c.per_layer:
        assert callable(harness.load_reader(m["name"]))
    assert set(c.limits) >= {"consensus_gap", "solve_gap", "plant_gap", "hypothesis_gap",
                             "trace_gap"}
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer


def test_a_new_cell_mix_and_metric_are_files_only(tmp_path):
    """A configuration, a mix and a reader added as files, with entries in
    BENCHMARK.json, make a cell that the harness runs unedited."""
    shutil.copytree(ROOT / "mpcbench", tmp_path / "mpcbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = json.loads((ROOT / "mpcbench/configs/fig8_b64_n64.json").read_text())
    cfg.update(name="fig8_b128_n48", batch_size=128, horizon=48)
    (tmp_path / "mpcbench/configs/fig8_b128_n48.json").write_text(json.dumps(cfg))
    mix = json.loads((ROOT / "mpcbench/mixes/loop.json").read_text())
    mix.update(name="loop_long", chunk_ticks=1000)
    (tmp_path / "mpcbench/mixes/loop_long.json").write_text(json.dumps(mix))
    (tmp_path / "mpcbench/metrics/ticks_traced.loop.py").write_text(
        "def read(run, cell):\n    return None if run.trace is None else run.trace.ticks\n")
    (tmp_path / "mpcbench/limits/fig8_b128_n48.loop_long.json").write_text(
        (ROOT / "mpcbench/limits/fig8_b64_n64.loop.json").read_text())
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "fig8_b128_n48", "source": "https://example.org/x",
                             "file": "mpcbench/configs/fig8_b128_n48.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "fig8_b128_n48.loop_long", "config": "fig8_b128_n48",
                               "traffic": "loop_long", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "ticks_traced.loop", "unit": "ticks", "better": "higher",
                               "source": "device_trace", "layer": "Device",
                               "moves": "loop_tick_us",
                               "workloads": ["fig8_b128_n48.loop_long"]})
    for m in bench["end_to_end"]:
        if m["name"] == "loop_tick_us":
            m["workloads"].append("fig8_b128_n48.loop_long")
    cell = harness.load_cell("fig8_b128_n48.loop_long", bench, root=tmp_path)
    assert (cell.config["batch_size"], cell.mix["chunk_ticks"]) == (128, 1000)
    assert [m["name"] for m in cell.per_layer] == ["ticks_traced.loop"]
    assert {m["name"] for m in cell.end_to_end} == {"loop_tick_us", "setup_s"}
    read = harness.load_reader("ticks_traced.loop", root=tmp_path / "mpcbench")
    run = harness.Run(1, 0, {}, {}, 0, trace=profiling.Trace([], [], (0.0, 1.0), 7))
    assert read(run, cell) == 7
    assert harness.load_driver(cell.mix).__name__ == "mpcbench.drivers.loop"


def test_a_stall_moves_the_window_rate_and_a_chunk_median_would_not():
    """Chunks of 100 ticks at 700 µs, one of them stalled 50 ms."""
    chunks = [0.07] * 200
    chunks[77] += 0.05
    ticks = 100 * len(chunks)
    whole = timing.per_tick_us(sum(chunks), ticks)
    assert whole == pytest.approx(700.0 + 0.05e6 / ticks)
    assert whole > 702.0
    assert statistics.median(c / 100 * 1e6 for c in chunks) == pytest.approx(700.0)


def test_a_stall_moves_the_latency_tail_from_the_due_time():
    """Ticks due every 10 ms take 0.7 ms; one takes 300 ms, and the 29
    ticks due meanwhile start late.  Timed from the due time the tail holds the
    wait; timed from each call's start, as a chunk median of calls, not."""
    period, work = 0.010, 0.0007
    due = [k * period for k in range(400)]
    done, start, free = [], [], 0.0
    for k, d in enumerate(due):
        s = max(d, free)
        t = s + (0.300 if k == 100 else work)
        start.append(s)
        done.append(t)
        free = t
    lat = timing.latencies_us(due, done)
    call = timing.latencies_us(start, done)
    assert timing.percentile(lat, 95) > 10_000.0
    assert timing.percentile(call, 95) == pytest.approx(700.0)
    chunk_p95 = [timing.percentile(call[i:i + 100], 95) for i in range(0, 400, 100)]
    assert statistics.median(chunk_p95) == pytest.approx(700.0)
    assert timing.percentile(lat, 50) == pytest.approx(700.0)


def test_spread_is_the_quartile_distance_over_the_median():
    assert timing.spread([1.0, 2.0, 3.0, 4.0, 5.0]) == pytest.approx(
        (4.5 - 1.5) / 3.0)


def _trace():
    ops = [("void sqp_kernel<false>(...)", 0.0, 500.0), ("tick_kernel(...)", 500.0, 90.0),
           ("Memcpy DtoD", 590.0, 10.0),
           ("void sqp_kernel<false>(...)", 700.0, 520.0), ("tick_kernel(...)", 1220.0, 90.0),
           ("Memcpy DtoD", 1310.0, 10.0)]
    spans = [(profiling.WINDOW, 0.0, 1400.0), ("run", 0.0, 650.0), ("sync", 600.0, 700.0),
             ("run", 700.0, 1330.0), ("sync", 1320.0, 1400.0)]
    return profiling.Trace(ops, spans, (0.0, 1400.0), 2)


def test_trace_arithmetic():
    tr = _trace()
    assert tr.busy_s() == pytest.approx(1220e-6)
    assert tr.window_s == pytest.approx(1400e-6)
    assert tr.op_seconds("sqp_kernel") == (pytest.approx(1020e-6), 2)
    assert tr.idle_gaps() == [["sync", pytest.approx(180e-6)]]
    assert tr.device_ops()[0] == ["void sqp_kernel<false>(...)", pytest.approx(1020e-6)]


def _cell(name):
    return harness.load_cell(name)


def test_loop_readers_on_a_synthetic_trace():
    run = harness.Run(20, 0, {}, {}, 0, trace=_trace())
    cell = _cell("fig8_b64_n64.loop")
    read = lambda m: harness.load_reader(m)(run, cell)
    assert read("k1_roofline.loop") == pytest.approx(100 * 19.2293e-6 / 510e-6, rel=1e-4)
    assert 0 < read("k2_roofline.loop") < 1
    assert read("graph_other_us.loop") == pytest.approx(10.0)
    assert read("device_idle_pct.loop") == pytest.approx(100 * 180 / 1400)
    empty = harness.Run(20, 0, {}, {}, 0, trace=profiling.Trace([], [], (0.0, 1.0), 1))
    for m in ("k1_roofline.loop", "k2_roofline.loop", "graph_other_us.loop",
              "device_idle_pct.loop"):
        assert harness.load_reader(m)(empty, cell) is None
        assert harness.load_reader(m)(harness.Run(1, 0, {}, {}, 0), cell) is None


def test_controller_readers_on_a_synthetic_trace():
    ops = [("sqp_kernel", 110.0, 500.0), ("tick_kernel", 620.0, 80.0),
           ("tick_kernel", 900.0, 60.0),  # the plant's step, after on_state
           ("sqp_kernel", 10110.0, 540.0), ("tick_kernel", 10660.0, 80.0)]
    spans = [(profiling.WINDOW, 0.0, 20000.0), ("on_state", 100.0, 760.0),
             ("send_command", 770.0, 800.0), ("on_state", 10100.0, 10790.0)]
    tr = profiling.Trace(ops, spans, (0.0, 20000.0), 2)
    window = [1000.0, 1100.0, 1300.0]  # the untraced window's latencies
    run = harness.Run(2, 0, {}, {}, 0, trace=tr, values={"window_latencies_us": window})
    cell = _cell("fig8_b64_n64.ctl100hz")
    assert harness.load_reader("ctl_device_us")(run, cell) == pytest.approx(600.0)
    # the window's p50 less the traced median device time: the two sum to the p50
    assert harness.load_reader("ctl_host_us")(run, cell) == pytest.approx(1100.0 - 600.0)
    assert harness.load_reader("ctl_host_us")(
        harness.Run(2, 0, {}, {}, 0, trace=tr, values={}), cell) is None
    # the tail of every latency of the untraced window: 1100 + 0.9 * 200
    assert harness.load_reader("ctl_tail_p95_us")(run, cell) == pytest.approx(1280.0)
    assert harness.load_reader("ctl_tail_p95_us")(
        harness.Run(2, 0, {}, {}, 0, trace=tr, values={}), cell) is None


def test_the_wrapped_reference_gives_the_same_goals():
    cfg = json.loads((ROOT / "mpcbench/configs/fig8_b64_n64.json").read_text())
    ref = traffic.fig8_reference(cfg, 4)
    N = cfg["horizon"]
    for offset in (0, 199, 1200, 1999, 2345, 3100):
        w = traffic.wrapped_offset(cfg, offset)
        assert w % 200 == offset % 200 and w < 1200
        assert (ref[w:w + N] == ref[offset:offset + N]).all()


def test_benchmark_json_keeps_the_contract():
    b = BENCH
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert b["command"][1].startswith(b["paths"][0] + "/")
    assert 1 <= b["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 seconds.
    assert 2 + 14 * 24 * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            assert m["moves"] in {e["name"] for e in b["end_to_end"]
                                  if harness.applies(e, cell)}
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for c in b["configs"]:
        assert (ROOT / c["file"]).exists() and c["reduced"] == []
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    assert len(json.dumps(b)) < 64 * 1024
    assert all(math.isfinite(m["bound"]) for m in b["end_to_end"])
