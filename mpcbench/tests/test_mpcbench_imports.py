"""What a run loads: nothing of JAX or of the JAX package, compared by
whole top-level module names; the reference loads nothing of the program."""
import subprocess
import sys
from pathlib import Path

from mpcbench import harness

ROOT = Path(__file__).resolve().parents[2]

# Everything a run imports, the program's entry points and every per-layer
# reader included (``harness.load_reader`` loads them from their files).
DRY_RUN = """
import json, sys
sys.path.insert(0, {root!r})
from mpcbench import harness, compare, profiling, program, timing, traffic
from mpcbench.drivers import loop, ctl100hz
from mpcbench.reference import rbd, robot, sqp, tick
from indy7_mpc_tpu_torch.mpc import init_loop_carry, make_loop_tick
from indy7_mpc_tpu_torch.mpc.graphed import LoopTickRunner
from indy7_mpc_tpu_torch.runtime import InProcessPlant, SampledController
from indy7_mpc_tpu_torch.config import CostConfig
from indy7_mpc_tpu_torch.models import indy7
import torch.profiler
bench = json.load(open({bench!r}))
for w in bench["workloads"]:
    cell = harness.load_cell(w["name"])
    harness.load_driver(cell.mix)
    for m in cell.per_layer:
        harness.load_reader(m["name"])
print(json.dumps(sorted(sys.modules)))
"""


def loaded(code: str):
    import json

    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_run_loads_no_jax_and_no_jax_package():
    mods = loaded(DRY_RUN.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json")))
    tops = {m.split(".")[0] for m in mods}
    assert "indy7_mpc_tpu_torch" in tops  # the program itself is loaded
    assert not tops & set(harness.FORBIDDEN), sorted(tops & set(harness.FORBIDDEN))


def test_the_reference_loads_nothing_of_the_program():
    code = (f"import json, sys\nsys.path.insert(0, {str(ROOT)!r})\n"
            "import mpcbench.reference.tick, mpcbench.reference.sqp, mpcbench.compare\n"
            "print(json.dumps(sorted(sys.modules)))")
    tops = {m.split(".")[0] for m in loaded(code)}
    assert "indy7_mpc_tpu_torch" not in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_guard_compares_whole_top_level_names(monkeypatch):
    import types

    for name in ("indy7_mpc_tpu_torch_extra", "jaxlike", "flaxen.sub"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "indy7_mpc_tpu.ops", types.ModuleType("indy7_mpc_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert harness.forbidden_modules() == ["indy7_mpc_tpu", "jax"]
