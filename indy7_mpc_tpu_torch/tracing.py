"""Spans, stall counters and K1's stage clocks: the port's own tracing.

Off by default; :func:`enable` switches it on and off for the process.

* **Spans** mark steps of the host path (``runtime/controller.py``:
  ``ctl.on_state`` around a control tick, and inside it ``ctl.input``,
  ``ctl.replay`` and ``ctl.fetch``).  Off, :func:`span` is one test of a
  flag that returns a shared no-op.  On, each span keeps a
  :class:`SpanRecord` (name, enclosing span, tick id, start and end by
  ``time.perf_counter_ns``) in a bounded list in memory, handed out by
  :func:`records` and emptied by :func:`clear`; past :data:`MAX_RECORDS`
  a record is counted in :func:`dropped` instead.  Nothing is written to
  disk.  While ``torch.profiler`` records, each span is also a
  ``record_function`` named ``"indy7." + name``, so that the profiler
  places it on the device trace's clock; outside a profiler that call,
  several µs a span, is skipped.
* **Counters** (:func:`counters`) are cumulative counts of what can stall
  a tick, always kept at no cost: CUDA graph captures
  (``mpc/graphed.py::TickGraph``), builds and loads of the kernel library
  (``ops/kernels/_build.py``), the CUDA caching allocator's segments and
  allocation retries (on a card) and Python's generation-2 collections.
  A reader takes the difference of two snapshots.
* **K1's stage clocks**: each K1 launch (``ops/kernels/sqp_kernel.py``)
  gets a one-word on/off switch and an accumulator of cycles on its
  card, both allocated at the first launch on that card and kept for the
  process, so that a CUDA graph captures their fixed addresses and
  :func:`enable` switches the counting in graphs captured before it.  When
  the word is set, thread 0 of each block reads ``clock64()`` at the
  barriers that close K1's stages (:data:`K1_SLOTS`) and adds each
  stage's cycles; in the cluster kernel (past 174 knots) it also adds
  the cycles its block waits at the segment hand-offs of the Riccati
  sweep and the rollout (``handoff``, a part of ``riccati`` plus
  ``rollout``; 0 with one block a lane).  The thread that factors the
  sweep's Quu counts its pivots whose reciprocal left the fast path of
  ``rcp_rn`` (``csrc/rbd.cuh``) in ``rcp_slow``, a count and not cycles,
  0 while the fast path engages.  :func:`k1_stage_cycles` reads and
  zeroes the sums.
"""
from __future__ import annotations

import contextlib
import gc
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

PREFIX = "indy7."  # of the spans' names in a torch.profiler trace
MAX_RECORDS = 1 << 16

# K1's accumulator, by slot (kClk* in csrc/sqp_kernel.cu): the cycles of
# the prologue's load, of stage 1 (linearize), 2 (the Riccati sweep), 3
# (the rollout), 4 (the line search and the update) over every SQP
# iteration, of the epilogue's store, of the whole block, each summed over
# the blocks timed, the number of blocks timed, the cycles the blocks
# waited at the cluster barriers between segments in stages 2 and 3, and
# the number of Quu's pivots whose reciprocal took rcp_rn's slow path.
K1_STAGES = ("prologue", "linearize", "riccati", "rollout", "linesearch", "epilogue")
K1_SLOTS = K1_STAGES + ("total", "blocks", "handoff", "rcp_slow")

# Cumulative counts this module keeps; the other counters are read where
# they are kept (see counters()).
counts = {"graph_captures": 0}


class SpanRecord(NamedTuple):
    name: str
    parent: Optional[str]  # the enclosing span's name
    tick: Optional[int]    # the caller's tick id, or the enclosing span's
    t0_ns: int
    t1_ns: int


_on = False
_records: List[SpanRecord] = []
_dropped = 0
_local = threading.local()  # each thread's stack of open spans
_k1: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = {}  # card -> (word, cycles)
_profiling = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()  # the span of tracing switched off


class _Span:
    __slots__ = ("name", "tick", "parent", "t0", "rf")

    def __init__(self, name: str, tick: Optional[int]):
        self.name, self.tick = name, tick

    def __enter__(self):
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.parent = stack[-1] if stack else None
        if self.tick is None and self.parent is not None:
            self.tick = self.parent.tick
        stack.append(self)
        self.rf = torch.profiler.record_function(PREFIX + self.name) if _profiling() else None
        if self.rf is not None:
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global _dropped
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _local.stack.pop()
        if len(_records) < MAX_RECORDS:
            _records.append(SpanRecord(self.name, self.parent and self.parent.name, self.tick,
                                       self.t0, t1))
        else:
            _dropped += 1
        return False


def span(name: str, tick: Optional[int] = None):
    """A context manager that records ``name`` while tracing is on;
    ``tick`` identifies the caller's tick (by default the enclosing
    span's)."""
    if not _on:
        return _NULL
    return _Span(name, tick)


def enable(on: bool = True) -> None:
    """Switch tracing on or off: the spans and the stage-clock word of
    every card K1 has run on.  Call it outside a CUDA graph capture: the
    words are written on each card's current stream."""
    global _on
    _on = bool(on)
    for word, _ in _k1.values():
        word.fill_(int(_on))


def enabled() -> bool:
    return _on


def records() -> List[SpanRecord]:
    """The spans recorded since the last :func:`clear`, each at its end."""
    return list(_records)


def dropped() -> int:
    """Spans not recorded since the last :func:`clear`: the list was full."""
    return _dropped


def clear() -> None:
    global _dropped
    _records.clear()
    _dropped = 0


def counters(device=None) -> Dict[str, int]:
    """A snapshot of the cumulative stall counters.  The allocator's are
    those of ``device`` if it is a card, else of the current card once
    CUDA is initialized, else 0."""
    from .ops.kernels import _build

    c = {"graph_captures": counts["graph_captures"],
         "library_builds": _build.counts["builds"], "library_loads": _build.counts["loads"],
         "allocator_segments": 0, "alloc_retries": 0,
         "gc_gen2": gc.get_stats()[2]["collections"]}
    device = None if device is None else torch.device(device)
    if (device.type == "cuda") if device is not None else torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats(device)
        c["allocator_segments"] = stats.get("segment.all.allocated", 0)
        c["alloc_retries"] = stats.get("num_alloc_retries", 0)
    return c


def _card(device) -> int:
    device = torch.device(device)
    return device.index if device.index is not None else torch.cuda.current_device()


def k1_clocks(device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(on/off word, int32; cycles, int64 by :data:`K1_SLOTS`) of K1 on the
    card ``device``, allocated at the first call for that card, which
    must not be inside a CUDA graph capture."""
    card = _card(device)
    bufs = _k1.get(card)
    if bufs is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "K1's stage clocks are allocated at its first launch on a card, which would be "
                "inside this CUDA graph capture: launch K1 once before capturing it")
        dev = torch.device("cuda", card)
        bufs = _k1[card] = (torch.full((), int(_on), dtype=torch.int32, device=dev),
                            torch.zeros(len(K1_SLOTS), dtype=torch.int64, device=dev))
    return bufs


def k1_stage_cycles(device=None) -> Optional[Dict[str, int]]:
    """K1's cycles by :data:`K1_SLOTS` on the card ``device`` (the current
    one by default) since the last read, and zeroes them (a read waits for
    the card).  None where K1 has not run on that card."""
    if device is None:
        if not torch.cuda.is_initialized():
            return None
        device = "cuda"
    if torch.device(device).type != "cuda":
        return None
    bufs = _k1.get(_card(device))
    if bufs is None:
        return None
    cycles = bufs[1]
    out = dict(zip(K1_SLOTS, cycles.tolist()))
    cycles.zero_()
    return out
