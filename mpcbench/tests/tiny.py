"""Cells at a size the CPU holds: the program's plain versions, B=4
hypotheses, N=8 knots, a few ticks; the real cells' limits."""
import json
import time
from typing import Optional

import torch

from mpcbench import harness

SEED = 2**31 + 77


def cell(name: str, B: int = 4, N: int = 8) -> harness.Cell:
    c = harness.load_cell(name)
    c.config = json.loads(json.dumps(c.config))
    c.config.update(batch_size=B, horizon=N)
    c.mix = dict(c.mix)
    if c.mix["driver"] == "loop":
        c.mix.update(chunk_ticks=20, span_ticks=20, warmup_chunks=0, check_spans=1,
                     trace_chunks=1)
    else:
        c.mix.update(rate_hz=2.0, warmup_ticks=2, check_ticks=3, trace_ticks=2)
    return c


def context(c: harness.Cell, seconds: Optional[float], seed: int) -> harness.Context:
    """The harness's look for a card skipped: the CPU, long enough for a
    few compared spans or ticks."""
    if seconds is None:
        seconds = 0.5 if c.mix["driver"] == "loop" else 3.0
    return harness.Context(c, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                           lambda s: None)


def run(c: harness.Cell, seconds: Optional[float] = None, seed: int = SEED) -> harness.Run:
    return harness.load_driver(c.mix).run(context(c, seconds, seed))


def execute(c: harness.Cell, seconds: Optional[float] = None, seed: int = SEED) -> dict:
    return harness.execute(context(c, seconds, seed))
