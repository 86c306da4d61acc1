"""The comparison that decides ``correct`` in a point-to-goal cell: the
program's ticks against the plain reference (``reference/goal_chain.py``),
in float64 on the CPU.

The program's ticks are followed from its own state.  The driver hands
over spans of consecutive ticks from its window: the carry before and
after the span (``state.rho`` as ``rho``) and the trace rows of its ticks.
The reference takes the span's first carry and, tick by tick, the state
and goal index that the trace shows; it keeps its own warm start, rho and
``alive`` from its own solves, and steps the plant from the program's
torque.  Each number is the widest gap over the ticks compared:

- ``solve_gap``: each tick's applied torque, and at the span's end the
  next command of the warm start (the solve's second torque), against the
  reference's solve from the same state and goal, in radians at joints
  1-5: the reach over one period, as ``compare.solve_gap``;
- ``path_gap``: the predicted path at the span's end, the next tick's
  warm start, against the reference's (the angles, and the velocities
  times dt), at joints 1-5;
- ``plant_gap``: each tick's next state against one plant step of the
  reference from the program's state and torque, at joints 1-5;
- ``solve_gap_j6``, ``path_gap_j6`` and ``plant_gap_j6``: the same at
  joint 6, the tool's roll (see ``compare.py``);
- ``trace_gap``: each tick's ``goal_dist`` against the reference's
  distance, in metres;
- ``goal_gap``: a count, not a gap: the ticks whose goal index differs
  from the reference's switch, and at the span's end an ``alive`` flag
  that differs from the reference's.  A switch or a freeze decided by a
  distance within ``margin`` (the ``trace_gap`` limit) of its threshold
  is not counted: there rounding decides it.

The solver's rho is not compared: it rises where no line-search step is
accepted, and near a converged solve float32 rounding decides that (the
program rejects where the reference accepts a step too small to lower
the merit in float32); the solve and path gaps show what it changes.

:func:`goal_control` puts the reference, computed in a lower precision,
in the program's place: its spans go through the same comparison.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import torch

from . import compare
from .reference import goal_chain as rg

NAMES = ("solve_gap", "solve_gap_j6", "path_gap", "path_gap_j6", "plant_gap", "plant_gap_j6",
         "trace_gap", "goal_gap")
CARRY = ("x", "X", "U", "goal_idx", "alive", "rho")
ROWS = ("x", "u", "goal_dist", "goal_idx")


@dataclass
class GoalSpan:
    """Consecutive ticks of the point-to-goal loop: ``pre`` and ``post``
    carries (:data:`CARRY`) and the ticks' trace rows (:data:`ROWS`, each
    with the ticks first)."""

    pre: Dict[str, torch.Tensor]
    post: Dict[str, torch.Tensor]
    rows: Dict[str, torch.Tensor]

    @property
    def ticks(self) -> int:
        return self.rows["x"].shape[0]


def carry_dict(carry) -> Dict[str, torch.Tensor]:
    """The program's ``MPCCarry`` as :data:`CARRY` (a copy)."""
    return {"x": carry.x.clone(), "X": carry.X.clone(), "U": carry.U.clone(),
            "goal_idx": carry.goal_idx.clone(), "alive": carry.alive.clone(),
            "rho": carry.state.rho.clone()}


def _cpu(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Floats to float64, indices and flags as they are, on the CPU."""
    return {k: v.detach().to("cpu", torch.float64) if v.is_floating_point()
            else v.detach().cpu() for k, v in d.items()}


def _stack(items: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([it[k] for it in items]) for k in items[0]}


def _undecided(dist, threshold: float, margin: float):
    """Where ``dist`` lies within ``margin`` of ``threshold``."""
    return (dist - threshold).abs() <= margin


def goal_gaps(m: rg.Models, goals, spans: List[GoalSpan], margin: float) -> Dict[str, float]:
    """The numbers of a point-to-goal cell over ``spans`` (all of one
    length) on the chain ``goals`` (G, 3); with none, every number is
    infinite: nothing was shown correct."""
    if not spans:
        return {n: float("inf") for n in NAMES}
    dep, gaps = m.dep, compare.Gaps({n: 0.0 for n in NAMES})
    goals = torch.as_tensor(goals, dtype=torch.float64)
    pre = _stack([_cpu(s.pre) for s in spans])
    post = _stack([_cpu(s.post) for s in spans])
    rows = _stack([_cpu(s.rows) for s in spans])
    S = rows["x"].shape[1]
    miss = torch.zeros((), dtype=torch.int64)
    near_freeze = torch.zeros(rows["x"].shape[0], dtype=torch.bool)
    X, U, alive, rho = pre["X"], pre["U"], pre["alive"], pre["rho"]
    for t in range(S):
        x = pre["x"] if t == 0 else rows["x"][:, t - 1]
        idx = pre["goal_idx"] if t == 0 else rows["goal_idx"][:, t - 1]
        out = rg.tick(m, rg.Carry(x, X, U, idx, alive, rho), goals, u_plant=rows["u"][:, t])
        c = out.carry
        dist = out.goal_dist
        near_freeze |= _undecided(dist, dep.divergence_dist, margin)
        gaps.add("trace_gap", (rows["goal_dist"][:, t] - dist).abs())
        miss += ((rows["goal_idx"][:, t] != c.goal_idx)
                 & ~_undecided(dist, dep.switch_dist, margin)).sum()
        u = rows["u"][:, t]
        gaps.joints("solve_gap", lambda J: compare._torque_gap(m, x, u, out.u, J))
        gaps.joints("plant_gap", lambda J: compare._state_gap(m, rows["x"][:, t], c.x, J))
        # The next tick's warm start, rho and alive are the reference's own.
        X, U, alive, rho = c.X, c.U, c.alive, c.rho
    gaps.joints("path_gap", lambda J: compare._path_gap(m, post["X"][:, 1:], X[:, 1:], J))
    gaps.joints("solve_gap", lambda J: compare._torque_gap(m, x, post["U"][:, 0], U[:, 0], J))
    miss += ((post["alive"] != alive) & ~near_freeze).sum()
    out = dict(gaps.values)
    out["goal_gap"] = float(miss)
    return out


def goal_control(m: rg.Models, goals, span: GoalSpan) -> GoalSpan:
    """The reference in ``m``'s dtype in the program's place: the span's
    ticks run again from its first carry as a closed loop."""
    dt = m.dtype
    p = {k: v.detach().cpu() for k, v in span.pre.items()}
    f = lambda v: v.to(dt)[None]
    c = rg.Carry(f(p["x"]), f(p["X"]), f(p["U"]), p["goal_idx"][None], p["alive"][None],
                 f(p["rho"]))
    rows = {k: [] for k in ROWS}
    for _ in range(span.ticks):
        out = rg.tick(m, c, torch.as_tensor(goals, dtype=torch.float64))
        c = out.carry
        for k, v in (("x", c.x), ("u", out.u), ("goal_dist", out.goal_dist),
                     ("goal_idx", c.goal_idx)):
            rows[k].append(v[0])
    post = {k: getattr(c, k)[0] for k in CARRY}
    return GoalSpan(span.pre, post, {k: torch.stack(v) for k, v in rows.items()})
