"""Controller <-> plant transports (the DDS replacement; port of
``indy7_mpc_tpu/runtime/transport.py``, same wire format).

The reference wires its controller and MuJoCo simulator over three ROS 2
DDS topics with queue depth 1 — latest-wins, lossy
(gato_controller.py:163-167, sim_node.cpp:225-237).  Here the same
contract is a small Transport interface with two implementations:

  * :class:`UdpTransport` — datagram pub/sub on localhost, pairing with
    the native C++ plant process (native/plant); latest-wins by design.
    Wire format: little-endian float64 arrays with a 1-byte tag,
    mirroring the three topics (state up; command / wrench down).
  * :class:`InProcessPlant` — the PyTorch plant behind the same
    interface, for tests and single-process deployments; it steps through
    the tick-epilogue kernel on CUDA (``sim/kernel_plant.py``).

The reference's EE-position side channel (smuggled through
JointState.effort[0:3], sim_node.cpp:343-345) becomes an explicit field.
"""
from __future__ import annotations

import socket
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import PlantConfig
from ..ops import lane_rbd as LR
from ..sim.kernel_plant import kernel_plant_step
from ..sim.plant import perturb_model

TAG_STATE = 1      # plant -> controller: q (6), v (6), ee_pos (3)
TAG_COMMAND = 2    # controller -> plant: torque (6)
TAG_WRENCH = 3     # controller -> plant: world wrench force (3)
TAG_RESET = 4      # controller -> plant: reset to the initial pose and
                   # hold for a fresh command (the reference sim's 'R'
                   # key, sim_node.cpp:44-46, 107-130, 288-291)


class PlantState(NamedTuple):
    x: np.ndarray        # (12,) [q, v]
    ee_pos: np.ndarray   # (3,) world EE position from the plant
    stamp: float         # host wall-clock receive time
    # Plant's own simulation time (s), when the plant reports it (native
    # plant_node protocol v2, 16th double).  Lets the controller advance
    # its reference by PLANT time — exact under plant_node
    # --realtime-scale and immune to transport jitter.  None for plants
    # that do not report it (plant time == wall time assumed).
    sim_time: Optional[float] = None


class UdpTransport:
    """Latest-wins datagram link to an external plant process."""

    def __init__(
        self,
        plant_addr=("127.0.0.1", 7461),
        listen_addr=("127.0.0.1", 7460),
        recv_timeout: float = 0.1,
    ):
        self.plant_addr = plant_addr
        self.recv_timeout = recv_timeout
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(listen_addr)
        self.sock.settimeout(recv_timeout)

    @staticmethod
    def _sim_time_of(pkt) -> Optional[float]:
        if len(pkt) >= 1 + 16 * 8:
            return float(
                np.frombuffer(pkt[1 + 15 * 8:1 + 16 * 8], dtype="<f8")[0]
            )
        return None

    def recv_state(self) -> Optional[PlantState]:
        data = None
        best_t = None
        # Drain the queue, keeping the NEWEST state by the plant's own
        # sim-time stamp (protocol v2, 16th double) — the stamp is a
        # monotone sequence number, so datagrams reordered inside the
        # drain window cannot shadow a newer state with an older one.
        # Stampless (v1) packets fall back to arrival order, but never
        # displace a stamped packet: once best_t is set, only a newer
        # stamp wins (otherwise one stray v1 datagram would reset the
        # reorder guard and let an older stamped packet through).
        while True:
            try:
                pkt, _ = self.sock.recvfrom(512)
                if len(pkt) >= 1 + 15 * 8 and pkt[0] == TAG_STATE:
                    t = self._sim_time_of(pkt)
                    if data is None or (
                        t is None and best_t is None
                    ) or (t is not None and (best_t is None or t >= best_t)):
                        data = pkt
                        if t is not None:
                            best_t = t
                self.sock.settimeout(0.0)
            except (socket.timeout, BlockingIOError):
                break
        self.sock.settimeout(self.recv_timeout)
        if data is None:
            return None
        vals = np.frombuffer(data[1:1 + 15 * 8], dtype="<f8")
        return PlantState(
            x=vals[:12].copy(), ee_pos=vals[12:15].copy(),
            stamp=time.time(), sim_time=self._sim_time_of(data),
        )

    def wait_for_state(self, timeout: float = 10.0) -> PlantState:
        """Block until the plant's first state arrives: the plant has then
        bound its port, so a wrench or command sent next is not lost.
        Raises TimeoutError after ``timeout`` seconds without one."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            state = self.recv_state()
            if state is not None:
                return state
        raise TimeoutError(f"no plant state within {timeout} s")

    def send_command(self, u) -> None:
        u = np.asarray(u, "<f8")
        self.sock.sendto(
            bytes([TAG_COMMAND]) + u.tobytes(), self.plant_addr
        )

    def send_wrench(self, force3) -> None:
        f = np.asarray(force3, "<f8")
        self.sock.sendto(bytes([TAG_WRENCH]) + f.tobytes(), self.plant_addr)

    def send_reset(self) -> None:
        """Reset the plant to its initial pose (plant_node kTagReset)."""
        self.sock.sendto(bytes([TAG_RESET]), self.plant_addr)

    def close(self) -> None:
        self.sock.close()


class InProcessPlant:
    """PyTorch plant behind the Transport interface.

    ``plant_cfg`` (config.PlantConfig) builds a deliberately mismatched
    ground-truth plant — seeded inertial error, joint friction, actuation
    noise, finer substeps — so closed-loop validation does not run against
    the controller's own model (the role MuJoCo plays for the reference,
    sim_node.cpp:184-201).  A tensor ``x0`` keeps its device and dtype; any
    other ``x0`` becomes float32 on ``device``, the card unless the caller
    passes ``device="cpu"``.  Each command is
    one plant tick through ``sim.kernel_plant.kernel_plant_step``: one
    launch of the tick-epilogue kernel on CUDA (which needs float32), its
    plain version on the CPU.  The actuation noise comes from a
    ``torch.Generator`` on the state's device seeded with ``noise_seed``.
    """

    def __init__(self, model, x0, dt: float, substeps: int = 1,
                 plant_cfg=None, noise_seed: int = 123,
                 mirror_port: Optional[int] = None, device="cuda"):
        self.dt = dt
        if isinstance(x0, torch.Tensor):
            self._x0 = x0.detach().clone()
        else:
            self._x0 = torch.as_tensor(np.asarray(x0), dtype=torch.float32,
                                       device=device)
        self.x = self._x0
        dtype, device = self._x0.dtype, self._x0.device
        self.wrench = torch.zeros(6, dtype=dtype, device=device)
        self.cfg = plant_cfg or PlantConfig(substeps=substeps)
        model = model.to(device=device, dtype=dtype)
        self._sm = LR.static_model(perturb_model(model, self.cfg))
        # EE is reported from the NOMINAL kinematics (geometry is exact;
        # only inertials are perturbed).
        self._sm_nominal = LR.static_model(model)
        self._gen = torch.Generator(device=device).manual_seed(noise_seed)
        # Live-telemetry tap (tools/live_view.py): duplicate each state
        # onto a local mirror port in the plant_node wire format, so the
        # in-process mode has the same live view as the native plant's
        # --mirror (the reference's GLFW role).
        self._mirror = None
        self._sim_time = 0.0
        if mirror_port:
            self._mirror = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            self._mirror_addr = ("127.0.0.1", int(mirror_port))

    def recv_state(self) -> PlantState:
        # The raw state tensor with ee_pos=None: the controller computes
        # EE/tracking inside its tick, so the loop never fetches from the
        # plant (external transports report their own ee_pos; see
        # run_control_loop).
        return PlantState(x=self.x, ee_pos=None, stamp=time.time())

    def send_command(self, u) -> None:
        x = self.x
        u = torch.as_tensor(np.asarray(u), dtype=x.dtype).to(x.device)
        noise = None
        if self.cfg.torque_noise_std:
            noise = self.cfg.torque_noise_std * torch.randn(
                (self.cfg.substeps, 6), generator=self._gen,
                dtype=x.dtype, device=x.device,
            )
        self.x, _ = kernel_plant_step(
            self._sm_nominal, self._sm, self.cfg, self.dt, x, u, self.wrench, noise
        )
        self._sim_time += self.dt
        if self._mirror is not None:
            self.mirror_state(self.x, self._sim_time)

    def send_wrench(self, force3) -> None:
        w = self.wrench.clone()
        w[:3] = torch.as_tensor(np.asarray(force3), dtype=w.dtype)
        self.wrench = w

    def send_reset(self) -> None:
        """Back to the initial pose, zero velocity (plant_node kTagReset
        / sim_node.cpp 'R' semantics); sim time stays monotone."""
        self.x = self._x0

    def mirror_state(self, x, sim_time: float) -> None:
        """Emit one plant_node-format state packet on the mirror port
        (no-op without ``mirror_port``)."""
        if self._mirror is None:
            return
        xt = torch.as_tensor(np.asarray(x), dtype=self._x0.dtype).to(self._x0.device)
        ee = torch.stack(LR.ee_pos(self._sm_nominal, list(xt[:6])))
        # Wire format (protocol v2): tag, 12 state doubles, 3 EE doubles,
        # sim-time double — identical to plant_node's state packet.
        pkt = (
            bytes([TAG_STATE]) + np.asarray(xt.cpu(), "<f8").tobytes()
            + np.asarray(ee.cpu(), "<f8").tobytes()
            + np.asarray([sim_time], "<f8").tobytes()
        )
        self._mirror.sendto(pkt, self._mirror_addr)

    def close(self) -> None:
        if self._mirror is not None:
            self._mirror.close()
