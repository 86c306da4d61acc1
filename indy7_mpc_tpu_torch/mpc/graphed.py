"""The device loop's tick written into fixed buffers, and its CUDA graphs.

The TPU package runs the closed loop as one compiled program:
``run_sampled_mpc`` is one ``jax.lax.scan`` over ``jax.jit``'s tick, so a
tick costs no host dispatch.  This module is the port's counterpart.
:class:`LoopTickRunner` keeps the carry, the per-tick draws and the trace
in tensors of its own and ticks :class:`~.fused_tick.FusedLoopTick` (the
tick function, unchanged) on them: each tick reads the carry buffers and
copies the new carry back into them.  On CUDA its first tick runs eagerly
(the warm-up: the kernel library's load, K1's shared-memory attribute, the
static models' host constants, none of which may happen during a capture);
at the second tick :class:`TickGraph` captures the tick,
:data:`TICKS_PER_GRAPH` ticks in a row and once alone, and every tick from
there replays those graphs.  On the CPU every tick runs the same body
eagerly.

A replay launches what the capture recorded: every kernel's arguments,
the ctypes structs and pointers of K1 and K2 included, are fixed at
capture, which is why every tensor the tick touches is a buffer of the
runner or lives in the graph's private memory pool.  A graph belongs to
its runner, so to its tick's configuration, B, N, dtype and device; a
carry of another shape is refused (:meth:`LoopTickRunner.load`), never
replayed into the old graph.  A failed capture raises: nothing drops back
to the eager tick.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from ..ops.kernels.sqp_kernel import sqp_solve
from ..ops.kernels.tick_kernel import tick_epilogue
from .sampled import SampledLoopCarry, SampledTrace, TickDraws

# The kernel wrappers whose ``launches`` count kernel launches.
COUNTED = (sqp_solve, tick_epilogue)
# Ticks in the device loop's long graph.  A replay of a graph whose body
# draws from a generator is three host-side launches (PyTorch fills the
# generator's seed and offset on the device, then launches the graph), so
# a graph of 10 ticks costs the loop 0.3 host-side launches a tick.
TICKS_PER_GRAPH = 10


class TickGraph:
    """``body`` called ``ticks`` times, captured as one CUDA graph on a side
    stream; ``replay()`` launches it.

    ``generator``, when the body draws from it, is registered with the
    graph: each replay then draws fresh numbers and advances it as the
    eager calls would.  The capture launches no kernel, so the launch
    counters of :data:`COUNTED` are put back after it, and each replay adds
    what the capture recorded (``launches``, one entry a wrapper).
    """

    def __init__(self, body: Callable[[], None], ticks: int = 1,
                 generator: Optional[torch.Generator] = None):
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        before = [f.launches for f in COUNTED]
        try:
            with torch.cuda.graph(graph):
                for _ in range(ticks):
                    body()
            self.launches = [f.launches - n for f, n in zip(COUNTED, before)]
        finally:
            for f, n in zip(COUNTED, before):
                f.launches = n
        self.graph, self.ticks = graph, ticks

    def replay(self) -> None:
        self.graph.replay()
        for f, n in zip(COUNTED, self.launches):
            f.launches += n


def _check_like(name: str, buf: torch.Tensor, value: torch.Tensor) -> None:
    if (tuple(value.shape), value.dtype, value.device) != (tuple(buf.shape), buf.dtype,
                                                          buf.device):
        raise ValueError(
            f"{name}: the runner holds {tuple(buf.shape)} {buf.dtype} on {buf.device}, got "
            f"{tuple(value.shape)} {value.dtype} on {value.device}; build a runner for it"
        )


class LoopTickRunner:
    """``tick`` (a :class:`~.fused_tick.FusedLoopTick`) on fixed buffers.

    ``carry`` (a ``SampledLoopCarry``) is copied into the runner's carry
    buffers; ``rows`` is the most ticks one :meth:`run` takes (the trace
    buffers' rows).  With ``with_draws`` every :meth:`run` takes its
    ticks' ``TickDraws`` and copies them into draw buffers (cast to the
    carry's dtype); without, the tick draws from ``tick.generator``.
    """

    def __init__(self, tick, carry: SampledLoopCarry, rows: int, with_draws: bool = False):
        if rows < 1:
            raise ValueError(f"rows must be at least 1, got {rows}")
        self.tick, self.rows = tick, rows
        self.carry_bufs = SampledLoopCarry(*(v.detach().clone() for v in carry))
        x = self.carry_bufs.x
        self.device = x.device
        self.row = torch.zeros((), dtype=torch.int64, device=self.device)
        self.draw_bufs = None
        if with_draws:
            B, cfg = tick.sample_cfg.batch_size, tick.plant_cfg
            empty = lambda *shape: torch.empty((rows, *shape), dtype=x.dtype, device=self.device)
            self.draw_bufs = TickDraws(
                resample=empty(B, 6), walk=empty(3),
                plant=empty(cfg.substeps, 6) if cfg.torque_noise_std else None,
            )
        self.trace_bufs: Optional[SampledTrace] = None  # shaped by the first tick
        self.graphs: List[TickGraph] = []

    def buffers(self) -> List[torch.Tensor]:
        """Every tensor the tick reads or writes outside its graph's pool."""
        out = [*self.carry_bufs, self.row]
        for group in (self.draw_bufs, self.trace_bufs):
            out += [b for b in group or () if b is not None]
        return out

    def load(self, carry: SampledLoopCarry) -> None:
        """Copy ``carry`` into the carry buffers; a field of another shape,
        dtype or device raises ValueError."""
        for name, buf, value in zip(carry._fields, self.carry_bufs, carry):
            _check_like(name, buf, value)
        for buf, value in zip(self.carry_bufs, carry):
            buf.copy_(value)

    def carry(self) -> SampledLoopCarry:
        """A copy of the current carry."""
        return SampledLoopCarry(*(v.clone() for v in self.carry_bufs))

    def _body(self) -> None:
        c, row = self.carry_bufs, self.row.reshape(1)
        draws = None
        if self.draw_bufs is not None:
            draws = TickDraws(*(None if b is None else b.index_select(0, row)[0]
                                for b in self.draw_bufs))
        new, trace = self.tick(c, draws)
        if self.trace_bufs is None:
            self.trace_bufs = SampledTrace(*(
                torch.empty((self.rows, *v.shape), dtype=v.dtype, device=v.device)
                for v in trace))
        for buf, v in zip(self.trace_bufs, trace):
            buf.index_copy_(0, row, v.unsqueeze(0))
        # The new carry, after every read of the old one: ``new.x_last`` is
        # the x buffer itself, so x_last is written before x.
        for name in ("x_last", "u_last", "X_best", "U_best", "f_batch", "f_true",
                     "ref_offset", "x"):
            getattr(c, name).copy_(getattr(new, name))
        self.row.add_(1)

    def _capture(self) -> None:
        gen = self.tick.generator if self.draw_bufs is None else None
        lengths = (TICKS_PER_GRAPH, 1) if self.rows >= TICKS_PER_GRAPH else (1,)
        self.graphs = [TickGraph(self._body, ticks, gen) for ticks in lengths]

    def run(self, n: int, draws: Optional[Sequence[TickDraws]] = None) -> SampledTrace:
        """``n`` ticks (1 <= n <= rows) from the current carry; returns their
        trace (copies), stacked over ticks.  ``draws`` (at least n, with
        ``with_draws`` only) are the ticks' draws."""
        if not 1 <= n <= self.rows:
            raise ValueError(f"run takes 1 to {self.rows} ticks, got {n}")
        if (draws is None) != (self.draw_bufs is None):
            raise ValueError("draws are given exactly when the runner was built with_draws")
        self.row.zero_()
        if draws is not None:
            if len(draws) < n:
                raise ValueError(f"{len(draws)} draws for {n} ticks")
            for buf, field in zip(self.draw_bufs, zip(*draws[:n])):
                if buf is not None:
                    buf[:n].copy_(torch.stack(field))
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
        return SampledTrace(*(b[:n].clone() for b in self.trace_bufs))
