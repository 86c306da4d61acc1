"""The comparison that decides ``correct``: what the timed path produced,
against the plain reference (``reference/``), in float64 on the CPU.

The program's ticks are followed from its own state.  A loop cell hands
over spans of consecutive ticks from its window: the carry before and
after the span, the trace rows of its ticks and the draws of its
generator.  The reference takes the span's first carry and, tick by
tick, the state and the winning lane that the trace shows, and works out
everything else itself: the consensus distances of every hypothesis, the
winner's solve from its own previous solution, the plant step, the
resampled hypotheses and the true wrench's walk.  A controller cell hands
over single ticks, each with the controller's state before and after it
and the plant's next state.

Each number is the widest gap over the ticks compared:

- ``consensus_gap``: how far the program's winning lane lies behind the
  nearest prediction, as a distance between states;
- ``solve_gap``: the winner's first torque, the command the plant gets,
  against the reference's solve, in radians at joints 1-5, joint by
  joint: its reach over one period (half dt squared times the torque's
  difference over the joint's own inertia, the mass matrix's diagonal);
- ``path_gap``: the winner's predicted path over the horizon, the next
  tick's warm start, in radians at joints 1-5: each angle, and each
  velocity times dt;
- ``plant_gap``: the plant's next state from the program's command (and
  the carried previous state), in radians at joints 1-5: each angle, and
  each velocity times dt;
- ``solve_gap_j6``, ``path_gap_j6`` and ``plant_gap_j6``: the same at
  joint 6, the tool's roll, under limits of their own;
- ``hypothesis_gap``: the resampled hypotheses, the winner's hypothesis
  and the true wrench, in newtons;
- ``trace_gap``: the end effector, its goal and the tracking error, in
  metres.

Joint 6 has numbers of its own: the end effector is that joint's origin,
so no cost term sees its angle and the solve fixes it only by small
velocity and torque weights.  Where float32 and float64 take different
branches of the solve, its path parts far more than the other joints'.
The path, the next warm start and not a command, parts most at its far
knots.  In the plant the joint's Coulomb friction, near zero velocity,
amplifies rounding on its small inertia.  Each number's limit is set
from its own readings.

:func:`loop_control` and :func:`ctl_control` put the reference, computed
in a lower precision, in the program's place: their records go through
the same comparison.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from .reference import rbd, sqp
from .reference import tick as rt

NAMES = ("consensus_gap", "solve_gap", "solve_gap_j6", "path_gap", "path_gap_j6",
         "plant_gap", "plant_gap_j6", "hypothesis_gap", "trace_gap")
# The joints of each pair of numbers: joints 1-5, and joint 6 (the roll).
JOINTS = {"": slice(0, 5), "_j6": slice(5, 6)}
CARRY = ("x", "x_last", "u_last", "X_best", "U_best", "f_batch", "f_true", "ref_offset")
ROWS = ("x", "u", "best_idx", "f_est", "f_true", "ee_pos", "ee_ref", "tracking_error")


@dataclass
class LoopSpan:
    """Consecutive ticks of a closed loop: ``pre`` and ``post`` carries
    (:data:`CARRY`), the ticks' trace rows (:data:`ROWS`, each with the
    ticks first) and their standard normal draws (``resample`` (S, B, 6),
    ``walk`` (S, 3), ``plant`` (S, substeps, 6))."""

    pre: Dict[str, torch.Tensor]
    post: Dict[str, torch.Tensor]
    rows: Dict[str, torch.Tensor]
    draws: Dict[str, torch.Tensor]

    @property
    def ticks(self) -> int:
        return self.rows["x"].shape[0]


@dataclass
class CtlTick:
    """One controller tick: the state before (``x_obs``, ``x_last``,
    ``u_last``, ``X_best``, ``U_best``, ``f_batch``, ``offset``), the
    resampling normals, the state after (``X_best``, ``U_best``,
    ``f_batch``, ``x_last``, ``u_last``), the packed host vector [u (6),
    best, f_est (6), ee_ref (3), ee_pos (3), tracking error] and the plant:
    its wrench, noise normals and next state."""

    pre: Dict[str, torch.Tensor]
    normals: torch.Tensor
    post: Dict[str, torch.Tensor]
    host: torch.Tensor
    wrench: torch.Tensor
    plant_normals: torch.Tensor
    x_next: torch.Tensor


@dataclass
class Gaps:
    values: Dict[str, float] = field(default_factory=lambda: {n: 0.0 for n in NAMES})

    def add(self, name: str, gap: torch.Tensor) -> None:
        g = float(gap.max()) if gap.numel() else 0.0
        if g != g:  # NaN: no comparison holds
            g = float("inf")
        self.values[name] = max(self.values[name], g)

    def joints(self, name: str, gap) -> None:
        """``gap(J)``, a gap at the joints J, under ``name`` for joints 1-5
        and ``name_j6`` for joint 6."""
        for suffix, J in JOINTS.items():
            self.add(name + suffix, gap(J))


def _lanes_max(t):
    return t.reshape(t.shape[0], -1).max(1).values


def _path_gap(models: rt.Models, X, X_r, J):
    """Each lane's widest gap between two predicted paths at the joints J
    (rad): the angles, and the velocities times dt."""
    d = (X - X_r).abs()
    return _lanes_max(torch.maximum(d[..., :6][..., J], models.dep.dt * d[..., 6:][..., J]))


def _state_gap(models: rt.Models, x, x_r, J):
    """The gap of two states at the joints J (rad): the angles, and the
    velocities times dt."""
    d = (x - x_r).abs()
    return torch.maximum(d[..., :6][..., J], models.dep.dt * d[..., 6:][..., J])


def _torque_gap(models: rt.Models, x, u, u_r, J):
    """The reach (rad) of a torque's difference over one period from state
    x at the joints J: dt^2 / 2 |u - u_r| over the joint's own inertia."""
    M = rbd.mass_matrix(models.ctl, x[..., :6])
    return 0.5 * models.dep.dt ** 2 * ((u - u_r).abs() / M.diagonal(dim1=-2, dim2=-1))[..., J]


def _f64(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to("cpu", torch.float64) for k, v in d.items()}


def _stack(items: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    return {k: torch.stack([it[k] for it in items]) for k in items[0]}


def _solve(models: rt.Models, x, goals, X, U, wrench):
    """The reference's solves of K lanes."""
    dep = models.dep
    return sqp.solve(models.ctl, dep.solver, dep.dt, x, goals, X, U, wrench)


def _goals(ref: torch.Tensor, offsets, N: int) -> torch.Tensor:
    return torch.stack([rt.goal_window(ref, int(o), N) for o in offsets])


def loop_gaps(models: rt.Models, ref_traj, spans: List[LoopSpan]) -> Dict[str, float]:
    """The numbers of a loop cell over ``spans`` (all of one length); with
    none, every number is infinite: nothing was shown correct."""
    if not spans:
        return {n: float("inf") for n in NAMES}
    dep, gaps = models.dep, Gaps()
    ref = torch.as_tensor(ref_traj, dtype=torch.float64)
    pre = _stack([_f64(s.pre) for s in spans])
    post = _stack([_f64(s.post) for s in spans])
    rows = _stack([_f64(s.rows) for s in spans])
    draws = _stack([_f64(s.draws) for s in spans])
    K, S = rows["x"].shape[:2]
    lanes = torch.arange(K)
    X_w, U_w, f_r = pre["X_best"].clone(), pre["U_best"].clone(), pre["f_batch"].clone()
    for t in range(S):
        x = rows["x"][:, t]
        x_last = pre["x_last"] if t == 0 else rows["x"][:, t - 1]
        u_last = pre["u_last"] if t == 0 else rows["u"][:, t - 1]
        offsets = [int(o) + t for o in pre["ref_offset"]]
        goals = _goals(ref, offsets, dep.N)
        best = rows["best_idx"][:, t].round().long()
        gaps.add("consensus_gap", torch.where((best >= 0) & (best < dep.B), 0.0, float("inf")))
        best = best.clamp(0, dep.B - 1)
        dist = rt.consensus_distances(models, x, x_last, u_last, f_r)
        gaps.add("consensus_gap", dist[lanes, best] - dist.min(1).values)
        gaps.add("hypothesis_gap", (rows["f_est"][:, t] - f_r[lanes, best]).abs())
        X_r, U_r = _solve(models, x, goals, X_w, U_w, f_r[lanes, best])
        u = rows["u"][:, t]
        gaps.joints("solve_gap", lambda J: _torque_gap(models, x, u, U_r[:, 0], J))
        f_true = rows["f_true"][:, t]
        x_next = rt.plant(models, x, rows["u"][:, t], f_true, draws["plant"][:, t])
        f_next = torch.stack([rt.walk(dep, f_true[k], draws["walk"][k, t], offsets[k])
                              for k in range(K)])
        last = t == S - 1
        x_seen = post["x"] if last else rows["x"][:, t + 1]
        gaps.joints("plant_gap", lambda J: _state_gap(models, x_seen, x_next, J))
        gaps.add("hypothesis_gap",
                 ((post["f_true"] if last else rows["f_true"][:, t + 1]) - f_next).abs())
        ee = rbd.ee_position(models.ctl, x[:, :6])
        gaps.add("trace_gap", (rows["ee_pos"][:, t] - ee).abs())
        gaps.add("trace_gap", (rows["ee_ref"][:, t] - goals[:, 0]).abs())
        gaps.add("trace_gap", (rows["tracking_error"][:, t]
                               - torch.linalg.norm(ee - goals[:, 0], dim=-1)).abs())
        f_r = rt.resample(dep, draws["resample"][:, t], f_r, best)
        X_w, U_w = X_r, U_r
    gaps.joints("path_gap", lambda J: _path_gap(models, post["X_best"], X_r, J))
    gaps.joints("solve_gap", lambda J: _torque_gap(models, x, post["U_best"][:, 0], U_r[:, 0], J))
    gaps.joints("solve_gap", lambda J: _torque_gap(models, x, post["u_last"], rows["u"][:, -1],
                                                   J))
    gaps.add("hypothesis_gap", (post["f_batch"] - f_r).abs())
    gaps.joints("plant_gap", lambda J: _state_gap(models, post["x_last"], rows["x"][:, -1], J))
    offset_moved = post["ref_offset"] - pre["ref_offset"] - S
    gaps.add("trace_gap", offset_moved.abs())
    return dict(gaps.values)


def ctl_gaps(models: rt.Models, ref_traj, ticks: List[CtlTick]) -> Dict[str, float]:
    """The numbers of a controller cell over ``ticks`` (none: infinite)."""
    if not ticks:
        return {n: float("inf") for n in NAMES}
    dep, gaps = models.dep, Gaps()
    ref = torch.as_tensor(ref_traj, dtype=torch.float64)
    pre = _stack([_f64(t.pre) for t in ticks])
    post = _stack([_f64(t.post) for t in ticks])
    f = lambda name: torch.stack([getattr(t, name).detach().to("cpu", torch.float64)
                                  for t in ticks])
    normals, host, wrench = f("normals"), f("host"), f("wrench")
    plant_normals, x_next = f("plant_normals"), f("x_next")
    K = len(ticks)
    lanes = torch.arange(K)
    goals = _goals(ref, pre["offset"].tolist(), dep.N)
    best = host[:, 6].round().long()
    gaps.add("consensus_gap", torch.where((best >= 0) & (best < dep.B), 0.0, float("inf")))
    best = best.clamp(0, dep.B - 1)
    dist = rt.consensus_distances(models, pre["x_obs"], pre["x_last"], pre["u_last"],
                                  pre["f_batch"])
    gaps.add("consensus_gap", dist[lanes, best] - dist.min(1).values)
    f_est = pre["f_batch"][lanes, best]
    gaps.add("hypothesis_gap", (host[:, 7:13] - f_est).abs())
    X_r, U_r = _solve(models, pre["x_obs"], goals, pre["X_best"], pre["U_best"], f_est)
    x = pre["x_obs"]
    gaps.joints("path_gap", lambda J: _path_gap(models, post["X_best"], X_r, J))
    for u in (post["U_best"][:, 0], host[:, :6], post["u_last"]):
        gaps.joints("solve_gap", lambda J: _torque_gap(models, x, u, U_r[:, 0], J))
    f_new = rt.resample(dep, normals, pre["f_batch"], best)
    gaps.add("hypothesis_gap", (post["f_batch"] - f_new).abs())
    ee = rbd.ee_position(models.ctl, pre["x_obs"][:, :6])
    gaps.add("trace_gap", (host[:, 16:19] - ee).abs())
    gaps.add("trace_gap", (host[:, 13:16] - goals[:, 0]).abs())
    gaps.add("trace_gap", (host[:, 19] - torch.linalg.norm(ee - goals[:, 0], dim=-1)).abs())
    gaps.joints("plant_gap", lambda J: _state_gap(models, post["x_last"], pre["x_obs"], J))
    x_next_r = rt.plant(models, pre["x_obs"], host[:, :6], wrench, plant_normals)
    gaps.joints("plant_gap", lambda J: _state_gap(models, x_next, x_next_r, J))
    return dict(gaps.values)


def loop_control(models: rt.Models, ref_traj, span: LoopSpan) -> LoopSpan:
    """The reference in ``models``' dtype in the program's place: the
    span's ticks run again from its first carry as a closed loop with the
    same draws, the winner by its own consensus."""
    dep, dt = models.dep, models.dtype
    ref = torch.as_tensor(ref_traj, dtype=dt)
    c = {k: v.detach().to("cpu", dt) for k, v in span.pre.items() if k != "ref_offset"}
    draws = {k: v.detach().to("cpu", dt) for k, v in span.draws.items()}
    offset = int(span.pre["ref_offset"])
    x, x_last, u_last = c["x"], c["x_last"], c["u_last"]
    X_w, U_w, f_b, f_true = c["X_best"], c["U_best"], c["f_batch"], c["f_true"]
    rows = {k: [] for k in ROWS}
    for t in range(span.ticks):
        goals = rt.goal_window(ref, offset + t, dep.N)
        out = rt.controller_tick(models, x, x_last, u_last, goals, X_w, U_w, f_b,
                                 draws["resample"][t])
        u = out.U[0]
        x_next = rt.plant(models, x[None], u[None], f_true[None], draws["plant"][t][None])[0]
        for k, v in (("x", x), ("u", u), ("best_idx", torch.tensor(float(out.best))),
                     ("f_est", out.f_est), ("f_true", f_true), ("ee_pos", out.ee),
                     ("ee_ref", goals[0]),
                     ("tracking_error", torch.linalg.norm(out.ee - goals[0]))):
            rows[k].append(v)
        f_true = rt.walk(dep, f_true, draws["walk"][t], offset + t)
        x_last, u_last, x = x, u, x_next
        X_w, U_w, f_b = out.X, out.U, out.f_batch
    post = dict(x=x, x_last=x_last, u_last=u_last, X_best=X_w, U_best=U_w, f_batch=f_b,
                f_true=f_true, ref_offset=torch.tensor(offset + span.ticks))
    return LoopSpan(span.pre, post, {k: torch.stack(v) for k, v in rows.items()}, span.draws)


def ctl_control(models: rt.Models, ref_traj, tick: CtlTick) -> CtlTick:
    """The reference in ``models``' dtype in the program's place for one
    controller tick and the plant step after it."""
    dep, dt = models.dep, models.dtype
    ref = torch.as_tensor(ref_traj, dtype=dt)
    p = {k: v.detach().to("cpu", dt) for k, v in tick.pre.items() if k != "offset"}
    goals = rt.goal_window(ref, int(tick.pre["offset"]), dep.N)
    out = rt.controller_tick(models, p["x_obs"], p["x_last"], p["u_last"], goals, p["X_best"],
                             p["U_best"], p["f_batch"], tick.normals.to("cpu", dt))
    u = out.U[0]
    host = torch.cat([u, torch.tensor([float(out.best)], dtype=dt), out.f_est, goals[0], out.ee,
                      torch.linalg.norm(out.ee - goals[0]).reshape(1)])
    x_next = rt.plant(models, p["x_obs"][None], u[None], tick.wrench.to("cpu", dt)[None],
                      tick.plant_normals.to("cpu", dt)[None])[0]
    post = dict(X_best=out.X, U_best=out.U, f_batch=out.f_batch, x_last=p["x_obs"], u_last=u)
    return CtlTick(tick.pre, tick.normals, post, host, tick.wrench, tick.plant_normals, x_next)


def start_gaps(models: rt.Models, gaps: Dict[str, float], f_batch, normals) -> Dict[str, float]:
    """``gaps`` with the start of the run compared as well: the program's
    first hypotheses against the reference's from the same (B, 6) normals
    (``hypothesis_gap``).  The ticks compared follow the program from its
    own state; this is the state they all descend from."""
    f0 = rt.initial_hypotheses(models.dep, normals.detach().to("cpu", torch.float64))
    g = float((f_batch.detach().to("cpu", torch.float64) - f0).abs().max())
    out = dict(gaps)
    out["hypothesis_gap"] = max(out["hypothesis_gap"], g if g == g else float("inf"))
    return out


def within(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number of ``limits`` read and at most its limit."""
    return all(name in values and values[name] <= lim for name, lim in limits.items())


def lines(values: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {name} {values.get(name, float('nan'))!r} limit {lim!r}"
            for name, lim in limits.items()]


def summary(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number with its limit; a number that is missing or not finite
    as the string of what it is."""
    def num(v):
        return v if v is not None and math.isfinite(v) else str(v)

    return {name: {"value": num(values.get(name)), "limit": lim}
            for name, lim in limits.items()}


def subsample(n: int, k: int, gen: torch.Generator) -> List[int]:
    """``k`` of ``range(n)`` drawn from ``gen``, in order."""
    if k >= n:
        return list(range(n))
    return sorted(torch.randperm(n, generator=gen)[:k].tolist())
