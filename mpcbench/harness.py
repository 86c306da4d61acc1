"""The benchmark's harness: finds a cell's configuration, traffic mix,
driver, per-layer readers and limits by name, runs the cell on one card,
and prints its result line.

    python3 mpcbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, mix or metric is a file of
its own: ``configs/<config>.json`` (named by ``BENCHMARK.json``),
``mixes/<traffic>.json`` (naming its driver, ``drivers/<driver>.py``),
``metrics/<metric>.py`` (a ``read(run, cell)`` that returns the metric or
None) and ``limits/<cell>.json`` (the limit of each number compared).  A
cell, a mix or a metric is added by adding files and entries.

The last line of standard output is the result: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared, each with its limit, come last, under
``checks``, and as the last lines of standard error.  The run fails, and
prints no result, without a CUDA card, with fewer cards than the cell
asks for, or when a module of JAX or of the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import os
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

PACKAGE = Path(__file__).resolve().parent
ROOT = PACKAGE.parent
# Top-level module names that no run may load: JAX and the JAX package
# that the program under test was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "indy7_mpc_tpu")


class HarnessError(RuntimeError):
    """A cell that cannot run here; the run prints no result."""


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json``, with its files read."""

    name: str
    config_name: str
    config: dict
    traffic: str
    mix: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: Dict[str, float]


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object          # torch.device
    t0: float               # perf_counter at the process's start
    say: Callable[[str], None] = print


@dataclass
class Run:
    """What a driver hands back."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    gaps: Dict[str, float]
    memory_peak_bytes: int
    trace: object = None    # profiling.Trace of the traced window
    values: Dict[str, object] = field(default_factory=dict)  # for the readers


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` (or of ``bench``), its files
    found under ``root``."""
    bench = read_json(root / "BENCHMARK.json") if bench is None else bench
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise HarnessError(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    configs = {c["name"]: c for c in bench["configs"]}
    pkg = root / PACKAGE.name
    limits = pkg / "limits" / f"{name}.json"
    return Cell(
        name=name, config_name=w["config"], config=read_json(root / configs[w["config"]]["file"]),
        traffic=w["traffic"], mix=read_json(pkg / "mixes" / f"{w['traffic']}.json"),
        chips=int(w["chips"]),
        end_to_end=[m for m in bench["end_to_end"] if applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if applies(m, name)],
        limits=read_json(limits) if limits.exists() else {},
    )


def load_driver(mix: dict):
    return importlib.import_module(f"{PACKAGE.name}.drivers.{mix['driver']}")


def load_reader(metric: str, root: Path = PACKAGE):
    """``read`` of ``metrics/<metric>.py``."""
    path = root / "metrics" / f"{metric}.py"
    if not path.exists():
        raise HarnessError(f"no reader {path} for the per-layer metric {metric!r}")
    spec = importlib.util.spec_from_file_location(
        f"{PACKAGE.name}_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in (name.split(".")[0] for name in list(sys.modules))
                   if m in FORBIDDEN})


def use_checkout_caches() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program builds its kernels under ``build/`` beside its package)."""
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("CUDA_CACHE_PATH", str(build / "cuda_cache"))


def card_state() -> str:
    """The card's name, power limit and draw, clocks and temperature from
    ``nvidia-smi`` (a few tens of ms), or why there are none."""
    import subprocess

    q = "name,power.limit,power.draw,clocks.sm,clocks.mem,clocks.max.sm,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() \
        else f"nvidia-smi: exit {out.returncode}"


def execute(ctx: Context) -> dict:
    """Run ``ctx.cell`` and return its result object (the checks last)."""
    from . import compare

    import torch

    cell = ctx.cell
    run: Run = load_driver(cell.mix).run(ctx)
    bad = forbidden_modules()
    if bad:
        raise HarnessError(f"modules of JAX or of the JAX package are loaded: {bad}")
    if ctx.trace:
        metrics = {}
        for m in cell.per_layer:
            value = load_reader(m["name"])(run, cell)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {}
        for m in cell.end_to_end:
            if m["name"] not in run.end_to_end:
                raise HarnessError(f"the driver gave no {m['name']!r} for {cell.name}")
            metrics[m["name"]] = {"value": float(run.end_to_end[m["name"]]), "unit": m["unit"]}
    if not cell.limits:
        raise HarnessError(f"no limits for {cell.name}: limits/{cell.name}.json")
    correct = compare.within(run.gaps, cell.limits)
    dev = ctx.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": cell.chips, "memory_peak_bytes": int(run.memory_peak_bytes)}
    result = {"correct": bool(correct), "attempted": int(run.attempted),
              "failed": int(run.failed), "metrics": metrics, "device": device}
    if ctx.trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s()
        device["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = compare.summary(run.gaps, cell.limits)
    result["_lines"] = compare.lines(run.gaps, cell.limits)
    return result


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, t0: Optional[float] = None) -> int:
    import time

    t0 = time.perf_counter() if t0 is None else t0
    args = parse_args(argv)
    err = lambda s: print(s, file=sys.stderr, flush=True)
    try:
        use_checkout_caches()
        cell = load_cell(args.workload)
        import torch

        if not torch.cuda.is_available():
            raise HarnessError("no CUDA device: this benchmark measures the card and never "
                               "falls back to the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise HarnessError(f"{cell.name} needs {cell.chips} card(s), "
                               f"{torch.cuda.device_count()} found")
        ctx = Context(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                      t0, err)
        result = execute(ctx)
    except HarnessError as e:
        err(f"mpcbench: {e}")
        return 2
    lines = result.pop("_lines")
    for line in lines:
        err(line)
    print(json.dumps(result), flush=True)
    return 0
