"""Real-time sampled-MPC controller runtime (external-plant mode; port of
``indy7_mpc_tpu/runtime/controller.py``).

The host-side equivalent of the reference's ROS 2 node
(gato_controller.py:144-351) without the ROS dependency: a 100 Hz loop
over a Transport, per-tick sampled solve (device), watchdog, disturbance
random walk, and reference-schema stats recording.

Tick semantics mirror ``GATO_Controller.joint_callback``
(gato_controller.py:201-256):
  * the reference window advances by elapsed/dt per tick (:214-216);
  * all lanes warm-start from the previous best trajectory with the
    measured state pinned (:217-218, 249);
  * consensus lane selection + hypothesis resampling per tick (:225-226);
  * the true disturbance random-walks every 200 reference steps, clipped
    to +-20 N, and is published to the plant (:236-239);
  * watchdog exit after 10 s without a plant state (:297-303).

The controller's state is float32 on its ``device``, the card unless the
caller passes ``device="cpu"``; on CUDA each tick is one replay of the
tick captured as a CUDA graph at warm-up (:class:`ControllerTickRunner`),
which launches the SQP kernel (K1) once and the tick-epilogue kernel (K2)
once.  With an injected ``batch_solve_fn``, or a configuration outside
K1's coverage, the tick is the readable one (``mpc/readable_tick.py``) on
that solver or on the readable solver, captured alike; an injected
solver that reads the host makes the capture, so the construction, raise.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import tracing
from ..config import CostConfig, MPCConfig, SampleConfig, SQPConfig
from ..models.convert import controller_state_from_npz
from ..models.robot import RobotModel
from ..mpc.fused_tick import reference_window
from ..mpc.sampled import init_wrench_batch, make_sampled_tick
from .stats import RunRecorder

JOINT_STATE_TIMEOUT = 10.0  # gato_controller.py:16-17


class ControllerTick(nn.Module):
    """The whole control tick as one module call: the goal window at the
    reference offset, the sampled tick, and the EE position and tracking
    error of the observed state.

    ``forward(offset, x, x_last, u_last, X, U, f_batch, normals=None) ->
    (SampledTickResult, host)``; ``offset`` is a Python int or a 0-d
    integer tensor (the window is then gathered on the device); ``host``
    (20,) packs what the host loop reads, [u (6), best lane, f_est (6),
    ee_ref (3), ee_pos (3), tracking error], so that one transfer fetches
    it.
    """

    def __init__(self, model, cost_cfg, sqp_cfg, mpc_cfg, sample_cfg, ref_traj,
                 generator, batch_solve_fn=None, device=None):
        super().__init__()
        self.N = mpc_cfg.N
        self.sampled = make_sampled_tick(
            model, cost_cfg, sqp_cfg, sample_cfg, mpc_cfg.dt, generator,
            batch_solve_fn, device,
        )
        self.register_buffer("ref_traj", torch.as_tensor(ref_traj))

    def forward(self, offset, x, x_last, u_last, X, U, f_batch, normals=None):
        goals = reference_window(self.ref_traj, offset, self.N)
        out, eep = self.sampled(x, x_last, u_last, goals, X, U, f_batch, normals)
        terr = torch.linalg.norm(eep - goals[0])
        host = torch.cat([
            out.u, out.best_idx.to(x.dtype).reshape(1), out.f_est, goals[0], eep,
            terr.reshape(1),
        ])
        return out, host


class ControllerTickRunner:
    """:class:`ControllerTick` on fixed buffers: the controller's state
    (``X_best``, ``U_best``, ``f_batch``, ``x_last``, ``u_last``), its input
    ``inp`` (the observed state, then the reference offset's int32 bits)
    and its output ``host`` (the packed vector).

    :meth:`step` loads the input (from a pinned host buffer in one copy,
    or, for an observed state already on the card, that state's device
    copy and the offset's), runs the tick and fetches ``host``: the spans
    ``ctl.input``, ``ctl.replay`` and ``ctl.fetch`` (``tracing``).  On CUDA,
    for the two-kernel tick and the readable one alike, on a one-rank mesh,
    :meth:`capture` records one tick as a CUDA graph
    (``mpc.graphed.TickGraph``, the controller's generator registered), and
    every later step replays it; a step before the capture runs the body
    eagerly and then captures.  Elsewhere (the CPU, a mesh of several
    ranks, whose consensus goes through the host) every step runs the body
    eagerly.
    The graph reads the buffers' addresses, so the controller writes its
    state into them with ``copy_`` and never rebinds them.
    """

    def __init__(self, tick: ControllerTick, f_batch, nx: int, nu: int,
                 generator: Optional[torch.Generator]):
        dev = f_batch.device
        zeros = lambda *shape: torch.zeros(shape, dtype=torch.float32, device=dev)
        self.tick, self.generator = tick, generator
        self.X_best, self.U_best = zeros(tick.N, nx), zeros(tick.N - 1, nu)
        self.f_batch = f_batch.detach().to(torch.float32).clone()
        self.x_last, self.u_last = zeros(nx), zeros(nu)
        self.has_last = False
        self.inp = zeros(nx + 1)
        self.staged = self.inp if dev.type == "cpu" else torch.zeros(
            nx + 1, dtype=torch.float32, pin_memory=True)
        self.host = zeros(nu + 14)
        self.graph = None
        self.graphable = dev.type == "cuda" and tick.sampled.mesh.size == 1

    def buffers(self):
        """Every tensor the tick reads or writes outside its graph's pool."""
        return [self.X_best, self.U_best, self.f_batch, self.x_last, self.u_last,
                self.inp, self.host]

    def _body(self, normals=None) -> None:
        x = self.inp[:-1]
        offset = self.inp[-1:].view(torch.int32)[0].to(torch.int64)
        out, host = self.tick(offset, x, self.x_last, self.u_last, self.X_best,
                              self.U_best, self.f_batch, normals)
        # The new state, after every read of the old one.
        self.X_best.copy_(out.X_best)
        self.U_best.copy_(out.U_best)
        self.f_batch.copy_(out.f_batch)
        self.x_last.copy_(x)
        self.u_last.copy_(out.u)
        self.host.copy_(host)

    def capture(self) -> None:
        """Capture one tick as a CUDA graph (``graphable`` runners only; the
        tick must have run once, eagerly, in this process: see
        ``SampledController``'s warm-up)."""
        from ..mpc.graphed import TickGraph

        self.graph = TickGraph(self._body, 1, self.generator,
                               f"the controller tick {type(self.tick.sampled).__name__}")

    def step(self, x_obs, offset: int, normals=None) -> np.ndarray:
        """One tick on the observed state ``x_obs`` at reference offset
        ``offset``; returns the packed host vector.  ``normals`` (the (B, 6)
        resampling draws, for replaying another random stream) need the
        eager body: a captured tick draws from the generator."""
        if normals is not None and self.graphable:
            raise ValueError("the captured tick draws its normals from the generator")
        with tracing.span("ctl.input"):
            self.staged[-1:].view(torch.int32)[0] = offset
            if isinstance(x_obs, torch.Tensor) and x_obs.device == self.inp.device:
                self.inp[:-1].copy_(x_obs)
                if self.staged is not self.inp:
                    self.inp[-1:].copy_(self.staged[-1:], non_blocking=True)
            else:
                self.staged[:-1].copy_(torch.as_tensor(np.asarray(x_obs)))
                if self.staged is not self.inp:
                    self.inp.copy_(self.staged, non_blocking=True)
            if not self.has_last:
                self.x_last.copy_(self.inp[:-1])
                self.has_last = True
        with tracing.span("ctl.replay"):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._body(normals)
                if self.graphable:
                    self.capture()
        with tracing.span("ctl.fetch"):  # the tick's one blocking transfer
            return self.host.to("cpu", copy=True).numpy()


class _StateBuffer:
    """A controller field held in its tick runner's buffer of the same
    name: reading gives the buffer, assigning copies into it."""

    def __set_name__(self, owner, name):
        self.name = name

    def __get__(self, ctl, owner=None):
        return self if ctl is None else getattr(ctl.runner, self.name)

    def __set__(self, ctl, value):
        getattr(ctl.runner, self.name).copy_(torch.as_tensor(value))


class SampledController:
    """Host-side controller state machine around the device tick.

    The state the tick carries (``X_best``, ``U_best``, ``f_batch``,
    ``x_last``, ``u_last``) lives in the buffers of ``runner``, a
    :class:`ControllerTickRunner`: reading a field gives its buffer, which
    the next tick overwrites, and assigning one copies into it.
    """

    X_best = _StateBuffer()
    U_best = _StateBuffer()
    f_batch = _StateBuffer()
    u_last = _StateBuffer()

    def __init__(
        self,
        model: RobotModel,
        cost_cfg: CostConfig,
        sqp_cfg: SQPConfig,
        mpc_cfg: MPCConfig,
        sample_cfg: SampleConfig,
        ref_traj: np.ndarray,
        seed: int = 42,
        batch_solve_fn: Optional[Callable] = None,
        f_ext_actual=None,
        warmup: bool = True,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.model = model
        self.mpc_cfg = mpc_cfg
        self.sample_cfg = sample_cfg
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

        self.ref_offset = 0.0
        self.tick_count = 0  # on_state calls: the tick id of its spans
        f_batch = init_wrench_batch(self.generator, sample_cfg, torch.float32, self.device)
        self.f_ext_actual = np.zeros(3) if f_ext_actual is None else np.asarray(
            f_ext_actual, float
        )

        # The WHOLE control tick is one module call: goal window at the
        # offset, solve/score/resample, EE and tracking error; its only
        # synchronizing transfer is the packed host vector (the reference
        # pays one pybind call per tick for the same reason,
        # gato_controller.py:224).  On CUDA the runner replays it as one
        # captured graph, the TPU package's one jitted program.
        self._tick = ControllerTick(
            model.to(device=self.device, dtype=torch.float32), cost_cfg,
            sqp_cfg, mpc_cfg, sample_cfg,
            torch.as_tensor(np.asarray(ref_traj), dtype=torch.float32),
            self.generator, batch_solve_fn, self.device,
        ).to(self.device)
        self.runner = ControllerTickRunner(self._tick, f_batch, model.nx, model.nu,
                                           self.generator)
        if warmup:
            # Cold-start throwaway tick from zeros (the reference's
            # init-time warm-up, gato_controller.py:180-184): pays the
            # kernels' build and load and the device's first launches at
            # construction, so the first real control tick runs at steady
            # state.  Its normals are zeros, not draws, and every output is
            # discarded: the controller state and the generator are
            # untouched, so resumed runs stay bit-identical.  On CUDA the
            # tick is then captured (the TPU package's jit compile at
            # warm-up); the capture launches nothing and draws nothing.
            z = self._zeros(model.nx)
            _, host = self._tick(
                0, z, z, self.u_last, self.X_best, self.U_best, self.f_batch,
                normals=torch.zeros_like(self.f_batch),
            )
            host.cpu()
            if self.runner.graphable:
                self.runner.capture()

    @property
    def x_last(self) -> Optional[torch.Tensor]:
        """The last observed state (the runner's buffer), or None before the
        first tick and after :meth:`reset_warm_start`."""
        return self.runner.x_last if self.runner.has_last else None

    @x_last.setter
    def x_last(self, value) -> None:
        if value is not None:
            self.runner.x_last.copy_(torch.as_tensor(value))
        self.runner.has_last = value is not None

    def _zeros(self, *shape) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=self.device)

    def goal_window(self) -> torch.Tensor:
        """The (N, 3) goal window at the current offset ``int(ref_offset)``,
        clamped to the reference's last N rows as the tick clamps it."""
        return reference_window(self._tick.ref_traj, int(self.ref_offset), self.mpc_cfg.N)

    def on_state(self, x_obs, elapsed: float):
        """One control tick; returns (u, info dict).

        The observed state and the reference offset go to the device, the
        tick runs (on CUDA one graph replay), and one blocking
        device->host fetch brings the small outputs (u, best lane, wrench
        estimate, current reference, EE, tracking error); the warm-start
        trajectory and hypothesis batch stay on the device.
        ``solve_time_us`` times all three.  With ``tracing`` on, the tick
        is the span ``ctl.on_state`` (its tick id ``tick_count``) around
        the runner's three.
        """
        with tracing.span("ctl.on_state", self.tick_count):
            self.ref_offset += elapsed / self.mpc_cfg.dt
            t0 = time.perf_counter()
            # The tick's ONLY synchronizing transfer is the fetch at its end.
            host = self.runner.step(x_obs, int(self.ref_offset))
            solve_time_us = (time.perf_counter() - t0) * 1e6
        self.tick_count += 1
        info = {
            "best_idx": int(host[6]),
            "f_est": host[7:13].copy(),
            "solve_time_us": solve_time_us,
            "ee_ref": host[13:16].copy(),
            "ee_pos": host[16:19].copy(),
            "tracking_error": float(host[19]),
        }
        return host[:6].copy(), info

    def reset_warm_start(self) -> None:
        """Controller-side companion to a plant reset (transport
        ``send_reset``): drop the warm-start trajectory and last
        state/control so the next tick cold-starts from the fresh plant
        pose instead of chasing the pre-reset trajectory.  Hypotheses,
        generator, and the reference offset are kept (the reference's 'R'
        reset likewise leaves the controller process running,
        sim_node.cpp:107-130)."""
        for buf in (self.X_best, self.U_best, self.u_last):
            buf.zero_()
        self.x_last = None

    def save_checkpoint(self, path: str) -> str:
        """Persist the controller's full warm-start/estimator state.

        The reference's only "resume" is in-memory warm starting
        (SURVEY.md section 5.4); here the same state — generator state,
        reference window offset, wrench hypotheses, best trajectory, last
        state/control — round-trips through one .npz so a run can stop
        and resume bit-identically.  The file has the TPU package's fields
        with ``generator_state`` in place of its PRNG ``key``.
        """
        np.savez(
            path,
            generator_state=self.generator.get_state().numpy(),
            ref_offset=np.asarray(self.ref_offset),
            f_batch=self.f_batch.cpu().numpy(),
            f_ext_actual=self.f_ext_actual,
            X_best=self.X_best.cpu().numpy(),
            U_best=self.U_best.cpu().numpy(),
            x_last=(
                self.x_last.cpu().numpy()
                if self.x_last is not None
                else np.full(self.model.nx, np.nan, np.float32)
            ),
            u_last=self.u_last.cpu().numpy(),
        )
        return path

    def load_state(self, state: dict) -> None:
        """Take over a controller state: the fields of
        :func:`models.convert.controller_state_from_npz`."""
        for name, value in state.items():
            setattr(self, name, value)

    def load_checkpoint(self, path: str) -> None:
        """Restore state saved by :meth:`save_checkpoint`.  A checkpoint of
        the TPU package's controller carries over too, except its PRNG key:
        the generator then keeps its state."""
        with np.load(path) as z:
            self.load_state(controller_state_from_npz(z, device=self.device))
            if "generator_state" in z:
                self.generator.set_state(torch.from_numpy(z["generator_state"]))

    def maybe_walk_disturbance(self, rng: np.random.Generator):
        """Random-walk the true wrench every 200 ref steps
        (gato_controller.py:236-239); returns it when it changed."""
        if int(self.ref_offset) % 200 == 0:
            noise = rng.normal(0, 1.0, size=3)
            self.f_ext_actual = np.clip(self.f_ext_actual + noise, -20, 20)
            return self.f_ext_actual
        return None


def run_control_loop(
    controller: SampledController,
    transport,
    duration: float,
    rate_hz: float = 100.0,
    recorder: Optional[RunRecorder] = None,
    walk_disturbance: bool = True,
    seed: int = 42,
    realtime: bool = True,
    max_ticks: Optional[int] = None,
):
    """Closed loop against an external (or in-process) plant.

    Stops after ``duration`` seconds of wall clock or ``max_ticks`` control
    ticks, whichever comes first.  Returns the recorder (created if none
    was given).
    """
    recorder = recorder or RunRecorder()
    rng = np.random.default_rng(seed)
    period = 1.0 / rate_hz
    transport.send_wrench(controller.f_ext_actual)

    ticks = 0
    deadline = time.time() + duration
    last_state_time = time.time()
    last_tick = time.time()
    last_sim_time = None
    while time.time() < deadline and (max_ticks is None or ticks < max_ticks):
        state = transport.recv_state()
        now = time.time()
        if state is None:
            if now - last_state_time > JOINT_STATE_TIMEOUT:
                raise TimeoutError(
                    f"no plant state for {JOINT_STATE_TIMEOUT}s (watchdog)"
                )
            continue
        last_state_time = now
        # Advance the reference window by PLANT time when the plant
        # reports its own sim clock (native plant_node protocol v2):
        # exact under --realtime-scale and immune to transport jitter.
        # Wall-clock deltas otherwise (the reference's behavior,
        # gato_controller.py:208-211).
        if state.sim_time is not None:
            elapsed = (
                state.sim_time - last_sim_time
                if last_sim_time is not None else period
            )
            last_sim_time = state.sim_time
        else:
            elapsed = now - last_tick
        last_tick = now

        u, info = controller.on_state(state.x, elapsed if realtime else period)
        transport.send_command(u)

        if walk_disturbance:
            w = controller.maybe_walk_disturbance(rng)
            if w is not None:
                transport.send_wrench(w)

        # Tracking error against the plant-reported EE when the transport
        # provides one (external plants report their own FK, like the
        # reference's effort[0:3] side channel); the in-process plant
        # shares the controller's nominal kinematics, so the tick's
        # device-computed value is identical and costs no extra transfer.
        if state.ee_pos is not None:
            tracking_error = float(
                np.linalg.norm(state.ee_pos - info["ee_ref"])
            )
            ee_rec = state.ee_pos
        else:
            tracking_error = info["tracking_error"]
            ee_rec = info["ee_pos"]
        recorder.record(
            elapsed, tracking_error, ee_rec, info["ee_ref"],
            state.x, info["solve_time_us"],
            # Estimator-accuracy sidecars (RunRecorder.EXTRA_ARRAYS):
            # winning hypothesis vs the wrench actually applied.
            f_est=info["f_est"],
            f_true=np.concatenate(
                [controller.f_ext_actual, np.zeros(3)]
            ),
        )
        recorder.maybe_save()
        ticks += 1

        if realtime:
            sleep = period - (time.time() - now)
            if sleep > 0:
                time.sleep(sleep)
    return recorder
