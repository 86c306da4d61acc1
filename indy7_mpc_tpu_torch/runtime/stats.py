"""Run statistics: collection, printing, and .npy persistence (port of
``indy7_mpc_tpu/runtime/stats.py``; the files it writes are the same).

Reproduces the reference's observability surface:
  * the stats-dict schema ``{name: {values, unit, multiplier}}``
    (gato_controller.py:70-75) and ``print_stats`` (src/utils.py:23-39);
  * the periodic six-array .npy dump {dts, tracking_errors, ee_positions,
    ee_ref_positions, joint_positions, solve_times} with an HHMMSS stem
    (gato_controller.py:270-295) so recorded runs are directly comparable
    with the reference's stats/ directory.
"""
from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Dict, List, Optional

import numpy as np
import torch


def make_stats(names_units=None) -> Dict:
    """Empty stats dict in the reference schema."""
    names_units = names_units or {
        "solve_time": "us",
        "sqp_iters": "",
        "step_size": "",
    }
    return {
        name: {"values": [], "unit": unit, "multiplier": 1}
        for name, unit in names_units.items()
    }


def print_stats(stats: Dict) -> None:
    """avg/min/max per entry (src/utils.py:23-39)."""
    for task, stat in stats.items():
        values = stat["values"]
        if not values:
            continue
        mult = stat["multiplier"]
        unit = stat["unit"]
        print(f"{task}:")
        print(f"  avg: {mult * sum(values) / len(values):.2f} {unit}")
        print(f"  min: {mult * min(values):.2f} {unit}")
        print(f"  max: {mult * max(values):.2f} {unit}")
        print()


class RunRecorder:
    """Per-tick closed-loop recorder with reference-compatible .npy dumps."""

    ARRAYS = (
        "dts",
        "tracking_errors",
        "ee_positions",
        "ee_ref_positions",
        "joint_positions",
        "solve_times",
    )
    # Sidecar arrays BEYOND the reference schema (kept in separate .npy
    # files so the six-array layout above stays byte-compatible): the
    # per-tick winning wrench hypothesis and the true plant wrench — the
    # estimator-accuracy record the reference only ever printed to stdout
    # (gato_controller.py:252-256).  Saved only when ticks provided them.
    EXTRA_ARRAYS = ("f_est", "f_true")
    # Device values held at most: every FLUSH_EVERY recorded tensors are
    # fetched to the host in one transfer.  Holding every tick's tensor
    # until the save grows the caching allocator with the run's length (a
    # new segment after a few hundred ticks: a stall on that tick).
    FLUSH_EVERY = 64

    def __init__(self, out_dir: str = "stats", save_interval: float = 35.0):
        self.out_dir = out_dir
        self.save_interval = save_interval
        self._last_save = time.time()
        self._data: Dict[str, List] = {
            k: [] for k in self.ARRAYS + self.EXTRA_ARRAYS
        }
        self._held = 0  # tensors among the recorded values
        self._fetched = dict.fromkeys(self._data, 0)  # values already on the host

    def record(
        self,
        dt: float,
        tracking_error: float,
        ee_position,
        ee_ref_position,
        joint_position,
        solve_time_us: float,
        f_est=None,
        f_true=None,
    ) -> None:
        """Append one tick.  Array arguments may be tensors on a device:
        they are stored raw and fetched FLUSH_EVERY at a time in one bulk
        transfer, so recording never forces a per-tick device sync and the
        device memory it holds stays bounded."""
        self._data["dts"].append(float(dt))
        self._data["tracking_errors"].append(float(tracking_error))
        self._data["solve_times"].append(float(solve_time_us))
        for name, v in (("ee_positions", ee_position), ("ee_ref_positions", ee_ref_position),
                        ("joint_positions", joint_position), ("f_est", f_est),
                        ("f_true", f_true)):
            if v is not None or name in self.ARRAYS:
                self._data[name].append(v)
                self._held += isinstance(v, torch.Tensor)
        if self._held >= self.FLUSH_EVERY:
            for name, vals in self._data.items():
                start = self._fetched[name]
                vals[start:] = _host_values(vals[start:])
                self._fetched[name] = len(vals)
            self._held = 0

    def record_trace(self, trace, dts, solve_times_us) -> None:
        """Bulk-record a SampledTrace / TrackingTrace from a device run."""
        trace = type(trace)(*(
            None if v is None else _to_numpy(v) for v in trace
        ))
        n = len(trace.tracking_error)
        dts = np.broadcast_to(np.asarray(dts, float), (n,))
        st = np.broadcast_to(np.asarray(solve_times_us, float), (n,))
        f_est = getattr(trace, "f_est", None)
        f_true = getattr(trace, "f_true", None)
        for i in range(n):
            self.record(
                dts[i],
                np.asarray(trace.tracking_error)[i],
                np.asarray(trace.ee_pos)[i],
                np.asarray(trace.ee_ref)[i],
                np.asarray(trace.q)[i],
                st[i],
                f_est=None if f_est is None else np.asarray(f_est)[i],
                f_true=None if f_true is None else np.asarray(f_true)[i],
            )

    def maybe_save(self, force: bool = False) -> Optional[str]:
        """Dump arrays if the save interval elapsed; returns the stem."""
        now = time.time()
        if not force and now - self._last_save < self.save_interval:
            return None
        self._last_save = now
        return self.save()

    def _fetch(self, name) -> np.ndarray:
        """Materialize one array: the tensors among the values (on one
        device) are fetched in a single transfer, then everything is
        stacked.  joint_positions recorded as full states (q, v) are sliced
        to q."""
        arr = np.asarray(_host_values(self._data[name]))
        if name == "joint_positions" and arr.ndim == 2 and arr.shape[1] == 12:
            arr = arr[:, :6]
        return arr

    def save(self) -> str:
        os.makedirs(self.out_dir, exist_ok=True)
        stem = os.path.join(self.out_dir, datetime.now().strftime("%H%M%S"))
        for name in self.ARRAYS:
            np.save(f"{stem}_{name}.npy", self._fetch(name))
        for name in self.EXTRA_ARRAYS:
            if self._data[name]:
                np.save(f"{stem}_{name}.npy", self._fetch(name))
        return stem

    def summary(self) -> Dict[str, float]:
        te = np.asarray(self._data["tracking_errors"])
        st = np.asarray(self._data["solve_times"])
        out = {}
        if te.size:
            out.update(
                tracking_error_mean=float(te.mean()),
                tracking_error_p50=float(np.percentile(te, 50)),
                tracking_error_p95=float(np.percentile(te, 95)),
            )
        if st.size:
            out.update(
                solve_time_us_mean=float(st.mean()),
                solve_time_us_p50=float(np.percentile(st, 50)),
                solve_time_us_p95=float(np.percentile(st, 95)),
                solve_time_us_max=float(st.max()),
            )
        return out


def _host_values(vals: List) -> List:
    """``vals`` with its tensors (on one device) fetched in a single
    transfer."""
    vals = list(vals)
    at = [i for i, v in enumerate(vals) if isinstance(v, torch.Tensor)]
    if at:
        flat = torch.cat([vals[i].detach().reshape(-1) for i in at])
        host = _to_numpy(flat)  # the one transfer
        offset = 0
        for i in at:
            n = vals[i].numel()
            vals[i] = host[offset:offset + n].reshape(tuple(vals[i].shape))
            offset += n
    return vals


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)
