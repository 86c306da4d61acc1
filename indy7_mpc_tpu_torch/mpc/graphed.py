"""The closed loops' ticks written into fixed buffers, and their CUDA graphs.

The TPU package runs each closed loop as one compiled program:
``run_sampled_mpc``, ``run_mpc`` and ``run_tracking_mpc`` are each one
``jax.lax.scan`` over ``jax.jit``'s tick, so a tick costs no host
dispatch.  This module is the port's counterpart.  :class:`TickRunner`
keeps a loop's carry, its per-tick draws and its trace in tensors of its
own and ticks the loop's tick function (unchanged) on them: each tick
reads the carry buffers and copies the new carry back into them.  On CUDA
its first tick runs eagerly (the warm-up: the kernel library's load, K1's
shared-memory attribute, the static models' host constants, the linear
algebra libraries' handles, none of which may happen during a capture);
at the second tick :class:`TickGraph` captures the tick, ``ticks_per_graph``
ticks in a row and once alone, and every tick from there replays those
graphs.  On the CPU every tick runs the same body eagerly.
:class:`LoopTickRunner` is the runner of the sampled loop's ticks
(``FusedLoopTick`` and the readable ``ReadableLoopTick``).

A replay launches what the capture recorded: every kernel's arguments,
the ctypes structs and pointers of K1 and K2 included, are fixed at
capture, which is why every tensor the tick touches is a buffer of the
runner or lives in the graph's private memory pool.  A graph belongs to
its runner, so to its tick's configuration, B, N, dtype and device; a
carry of another shape is refused (:meth:`TickRunner.load`), never
replayed into the old graph.  A failed capture raises: nothing drops back
to the eager tick.
"""
from __future__ import annotations

import time
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

from .. import tracing
from ..ops.kernels.sqp_kernel import sqp_solve
from ..ops.kernels.tick_kernel import tick_epilogue
from .sampled import SampledLoopCarry, TickDraws

# The kernel wrappers whose ``launches`` count kernel launches.
COUNTED = (sqp_solve, tick_epilogue)
# Ticks in a loop's long graph.  A replay of a graph whose body draws from
# a generator is three host-side launches (PyTorch fills the generator's
# seed and offset on the device, then launches the graph), so a graph of
# 10 ticks costs the loop 0.3 host-side launches a tick.
TICKS_PER_GRAPH = 10


class TickGraph:
    """``body`` called ``ticks`` times, captured as one CUDA graph on a side
    stream; ``replay()`` launches it.

    ``generator``, when the body draws from it, is registered with the
    graph: each replay then draws fresh numbers and advances it as the
    eager calls would.  The capture launches no kernel, so the launch
    counters of :data:`COUNTED` are put back after it, and each replay adds
    what the capture recorded (``launches``, one entry a wrapper).  A
    capture that fails raises RuntimeError naming ``what``.  ``seconds``
    is the capture's and the instantiation's host time, ``pool_bytes``
    what the caching allocator reserved for the graph's pool.  A capture
    counts in ``tracing.counters()``' ``graph_captures``.
    """

    def __init__(self, body: Callable[[], None], ticks: int = 1,
                 generator: Optional[torch.Generator] = None, what: str = "the tick"):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = [f.launches for f in COUNTED]
        reserved, t0 = torch.cuda.memory_reserved(), time.perf_counter()
        try:
            with torch.cuda.graph(graph):
                for _ in range(ticks):
                    body()
            self.launches = [f.launches - n for f, n in zip(COUNTED, before)]
        except RuntimeError as e:
            raise RuntimeError(f"{what} cannot be captured as a CUDA graph (a host read or "
                               f"sync inside it?): {e}") from e
        finally:
            for f, n in zip(COUNTED, before):
                f.launches = n
        self.seconds = time.perf_counter() - t0
        tracing.counts["graph_captures"] += 1
        self.pool_bytes = torch.cuda.memory_reserved() - reserved
        self.graph, self.ticks = graph, ticks

    def replay(self) -> None:
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n


# A carry is a NamedTuple of tensors, NamedTuples of them and Nones (the
# solver state's unused fields); these walk it.

def _named(tree, prefix: str = "") -> Iterator[Tuple[str, Optional[torch.Tensor]]]:
    """(dotted name, leaf) of every tensor or None in ``tree``, in order."""
    if tree is None or isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    for name, v in zip(tree._fields, tree):
        yield from _named(v, f"{prefix}.{name}" if prefix else name)


def _map(fn, tree):
    """``tree`` with ``fn`` applied to each tensor; Nones stay."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    return type(tree)(*(_map(fn, v) for v in tree))


def _pairs(bufs, values, what: str, strict: bool = True) -> List[Tuple[torch.Tensor,
                                                                       torch.Tensor]]:
    """(buffer, value) for each tensor of ``bufs``; ValueError where
    ``values`` has another structure (unless ``strict`` is off: a value
    where the runner holds no buffer is then left out)."""
    b, v = list(_named(bufs)), list(_named(values))
    if [n for n, _ in b] != [n for n, _ in v] or any(
            (y is None and x is not None) or (strict and x is None and y is not None)
            for (_, x), (_, y) in zip(b, v)):
        raise ValueError(f"{what}: fields {[n for n, x in v if x is not None]}, the runner "
                         f"holds {[n for n, x in b if x is not None]}")
    return [(x, y) for (_, x), (_, y) in zip(b, v) if x is not None]


def _shares(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _copy_back(pairs: List[Tuple[torch.Tensor, torch.Tensor]]) -> None:
    """``dst.copy_(src)`` for each pair, every buffer written only after
    each pending copy that reads it (a new carry's field may be an old
    buffer: ``x_last`` is the ``x`` buffer), in the pairs' order otherwise."""
    pending = [(d, s) for d, s in pairs if s is not d]
    while pending:
        left = []
        for i, (d, s) in enumerate(pending):
            if any(_shares(s2, d) for _, s2 in left + pending[i + 1:]):
                left.append((d, s))
            else:
                d.copy_(s)
        if len(left) == len(pending):
            raise ValueError("the new carry's fields read each other's buffers in a cycle")
        pending = left


def _check_like(name: str, buf: torch.Tensor, value: torch.Tensor) -> None:
    if (tuple(value.shape), value.dtype, value.device) != (tuple(buf.shape), buf.dtype,
                                                          buf.device):
        raise ValueError(
            f"{name}: the runner holds {tuple(buf.shape)} {buf.dtype} on {buf.device}, got "
            f"{tuple(value.shape)} {value.dtype} on {value.device}; build a runner for it"
        )


class TickRunner:
    """``tick(carry, draws) -> (new carry, trace row)`` on fixed buffers.

    ``carry`` (a NamedTuple of tensors, NamedTuples of them and Nones) is
    copied into the runner's carry buffers; the new carry must have the
    same fields, shapes and dtypes.  ``rows`` is the most ticks one
    :meth:`run` takes (the trace buffers' rows); the trace row is a
    NamedTuple of tensors.  ``draws_like`` (one tick's draws, a NamedTuple
    of tensors and Nones) shapes draw buffers of ``rows`` rows, and every
    :meth:`run` then takes its ticks' draws and copies them in (cast to
    the buffers' dtypes); without it the tick gets ``draws=None`` and
    draws from ``generator`` (or draws nothing), which each graph
    registers.  ``ticks_per_graph`` is the long graph's length;
    ``what`` names the tick in a failed capture's error.
    """

    def __init__(self, tick, carry, rows: int, draws_like=None,
                 generator: Optional[torch.Generator] = None,
                 ticks_per_graph: int = TICKS_PER_GRAPH, what: str = "the tick"):
        if rows < 1:
            raise ValueError(f"rows must be at least 1, got {rows}")
        self.tick, self.rows, self.generator = tick, rows, generator
        self.ticks_per_graph, self.what = ticks_per_graph, what
        self.carry_bufs = _map(lambda v: v.detach().clone(), carry)
        self.device = next(v for _, v in _named(self.carry_bufs) if v is not None).device
        self.row = torch.zeros((), dtype=torch.int64, device=self.device)
        self.draw_bufs = _map(lambda v: torch.empty((rows, *v.shape), dtype=v.dtype,
                                                    device=self.device), draws_like)
        self.trace_bufs = None  # shaped by the first tick
        self.graphs: List[TickGraph] = []

    def buffers(self) -> List[torch.Tensor]:
        """Every tensor the tick reads or writes outside its graph's pool."""
        out = [self.row]
        for group in (self.draw_bufs, self.trace_bufs):
            out += [v for _, v in _named(group) if v is not None]
        return [v for _, v in _named(self.carry_bufs) if v is not None] + out

    def load(self, carry) -> None:
        """Copy ``carry`` into the carry buffers; a field of another shape,
        dtype or device, or another structure, raises ValueError."""
        pairs = _pairs(self.carry_bufs, carry, "load")
        for (name, _), (buf, value) in zip(
                [(n, v) for n, v in _named(self.carry_bufs) if v is not None], pairs):
            _check_like(name, buf, value)
        for buf, value in pairs:
            buf.copy_(value)

    def carry(self):
        """A copy of the current carry."""
        return _map(torch.clone, self.carry_bufs)

    def _body(self) -> None:
        row = self.row.reshape(1)
        draws = _map(lambda b: b.index_select(0, row)[0], self.draw_bufs)
        new, trace = self.tick(self.carry_bufs, draws)
        if self.trace_bufs is None:
            self.trace_bufs = _map(lambda v: torch.empty((self.rows, *v.shape), dtype=v.dtype,
                                                         device=v.device), trace)
        for buf, v in _pairs(self.trace_bufs, trace, "the trace"):
            buf.index_copy_(0, row, v.unsqueeze(0))
        # The new carry, after every read of the old one.
        _copy_back(_pairs(self.carry_bufs, new, "the new carry"))
        self.row.add_(1)

    def _capture(self) -> None:
        tpg = self.ticks_per_graph
        lengths = (tpg, 1) if tpg > 1 and self.rows >= tpg else (1,)
        self.graphs = [TickGraph(self._body, ticks, self.generator, self.what)
                       for ticks in lengths]

    def run(self, n: int, draws: Optional[Sequence] = None):
        """``n`` ticks (1 <= n <= rows) from the current carry; returns their
        trace (copies), stacked over ticks.  ``draws`` (at least n, with
        ``draws_like`` only) are the ticks' draws."""
        if not 1 <= n <= self.rows:
            raise ValueError(f"run takes 1 to {self.rows} ticks, got {n}")
        if (draws is None) != (self.draw_bufs is None):
            raise ValueError("draws are given exactly when the runner holds draw buffers")
        self.row.zero_()
        if draws is not None:
            if len(draws) < n:
                raise ValueError(f"{len(draws)} draws for {n} ticks")
            rows = [_pairs(self.draw_bufs, d, "draws", strict=False) for d in draws[:n]]
            for i, (buf, _) in enumerate(rows[0]):
                buf[:n].copy_(torch.stack([r[i][1] for r in rows]))
        done = 0
        while done < n:
            if self.device.type != "cuda" or self.trace_bufs is None:
                self._body()  # on CUDA the first, the warm-up tick
                done += 1
                continue
            if not self.graphs:
                self._capture()
            graph = next(g for g in self.graphs if g.ticks <= n - done)
            graph.replay()
            done += graph.ticks
        return _map(lambda b: b[:n].clone(), self.trace_bufs)


class LoopTickRunner(TickRunner):
    """The sampled loop's ``tick`` (a :class:`~.fused_tick.FusedLoopTick` or a
    single-rank :class:`~.readable_tick.ReadableLoopTick`) on fixed buffers.

    ``carry`` (a ``SampledLoopCarry``) is copied into the runner's carry
    buffers; ``rows`` is the most ticks one :meth:`run` takes.  With
    ``with_draws`` every :meth:`run` takes its ticks' ``TickDraws`` and
    copies them into draw buffers (cast to the carry's dtype); without, the
    tick draws from ``tick.generator``.
    """

    def __init__(self, tick, carry: SampledLoopCarry, rows: int, with_draws: bool = False,
                 ticks_per_graph: int = TICKS_PER_GRAPH):
        draws_like = None
        if with_draws:
            B, cfg, x = tick.sample_cfg.batch_size, tick.plant_cfg, carry.x
            empty = lambda *shape: torch.empty(shape, dtype=x.dtype, device=x.device)
            draws_like = TickDraws(resample=empty(B, 6), walk=empty(3),
                                   plant=empty(cfg.substeps, 6) if cfg.torque_noise_std else None)
        super().__init__(tick, carry, rows, draws_like,
                         None if with_draws else tick.generator, ticks_per_graph,
                         f"the loop tick {type(tick).__name__}")
