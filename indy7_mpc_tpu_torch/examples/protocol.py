"""The recorded-run configuration of the repository's examples, in one place.

The TPU package's scripts (``examples/record_runs.py``,
``fig8_closed_loop.py``, ``baseline_table.py``) each repeat it; it is the
reference's recorded-run configuration (gato_controller.py:306-341): a
figure-8 (A_x 0.5, A_z 0.55, offset [0, 0.4, 0.45], period 10 s) after 200
rows of padding, N=64, dt=10 ms, 2 SQP iterations, the true wrench
[-60, 20, -40] N walking every 200 steps, and B wrench hypotheses (sigma
20 N, resample sigma 1 N).  The functions take ``N``, ``max_iters`` and
``dtype`` as keywords so that tests can shrink them.
"""
from __future__ import annotations

import subprocess
from typing import Optional

import numpy as np
import torch

from ..config import PERTURBED_PLANT, CostConfig, MPCConfig, SampleConfig, SQPConfig
from ..mpc import reference

# The reference sim's fixed initial pose (sim_node.cpp:196).
INIT_Q = [1.5799, 0.0631, -1.1807, 1.0927, -0.6255, -0.0190]
F_TRUE0 = [-60.0, 20.0, -40.0, 0.0, 0.0, 0.0]
N, DT, MAX_ITERS, PAD = 64, 0.01, 2, 200
PLANTS = {"nominal": None, "perturbed": PERTURBED_PLANT}

# The reference CUDA solver's recorded 3,500-tick runs (BASELINE.md,
# stats/{single,16,32,64}): solve time mean/p50/p95/max (us) and tracking
# error mean/p50/p95 (m), by B.
REF_ROWS = {
    1: ((5261, 5265, 5868, 6692), (0.192, 0.172, 0.388)),
    16: ((6376, 6313, 7141, 8388), (0.150, 0.134, 0.296)),
    32: ((6755, 6738, 7346, 9407), (0.139, 0.137, 0.242)),
    64: ((8964, 8982, 9681, 15700), (0.125, 0.114, 0.239)),
}


def configs(B: int, *, N: int = N, max_iters: int = MAX_ITERS):
    """(CostConfig, SQPConfig, MPCConfig, SampleConfig) of a B-lane run."""
    return (CostConfig(), SQPConfig(max_iters=max_iters), MPCConfig(N=N, dt=DT),
            SampleConfig(batch_size=B, f_ext_std=20.0, f_ext_resample_std=1.0))


def fig8_reference(ticks: int = 0, *, N: int = N) -> np.ndarray:
    """(T, 3) figure-8 EE reference after PAD rows of its first point, with
    enough 10 s cycles for ``ticks`` + N rows (at least 10, the reference's
    count)."""
    ref = reference.figure8(A_x=0.5, A_z=0.55, offset=[0.0, 0.4, 0.45], period=10,
                            dt=DT, cycles=max(10, (ticks + N) // 1000 + 1))
    return reference.with_padding(ref, PAD)


def initial_state(dtype=torch.float32, device="cpu") -> torch.Tensor:
    """(12,) state at INIT_Q, at rest."""
    x0 = torch.zeros(12, dtype=dtype, device=device)
    x0[:6] = torch.tensor(INIT_Q, dtype=dtype)
    return x0


def device(name: str) -> torch.device:
    """``name`` as a torch device; a CUDA device when CUDA is missing
    raises instead of falling back to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} asked for, but CUDA is not available "
                           "(pass --device cpu to run the plain versions on the CPU)")
    return dev


def synchronize(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def card() -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi --query-gpu=
    name,power.limit --format=csv,noheader`` gives them, or None without
    nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def device_label(dev: torch.device) -> str:
    """What ran the numbers: the card with its power limit, or the CPU."""
    if dev.type == "cuda":
        return card() or torch.cuda.get_device_name(dev)
    return "cpu (plain versions; no device time)"
