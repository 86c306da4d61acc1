"""Reference trajectory generators (port of ``mpc/reference.py``; numpy).

``figure8`` is the reference controller's fixed 45-degree rotated
figure-8; outputs are (T, 3) EE position arrays.
"""
from __future__ import annotations

import numpy as np


def figure_8(
    x_amplitude: float,
    z_amplitude: float,
    offset,
    timestep: float,
    period: float,
    num_periods: int,
    angle_offset: float = np.pi / 4,
) -> np.ndarray:
    """Rotated figure-8 in the x-z plane, returned as (T, 3) positions."""
    t = np.linspace(0.0, 2 * np.pi, int(period / timestep))
    pts = np.stack(
        [
            offset[0] + x_amplitude * np.sin(t),
            np.full_like(t, offset[1]),
            offset[2] + z_amplitude * np.sin(2 * t) / 2 + z_amplitude / 2,
        ],
        axis=-1,
    )
    c, s = np.cos(angle_offset), np.sin(angle_offset)
    R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    return np.tile(pts @ R.T, (num_periods, 1))


def figure8(A_x, A_z, offset, period, dt, cycles) -> np.ndarray:
    """The reference controller's parameterization (45-degree rotation)."""
    return figure_8(A_x, A_z, offset, dt, period, cycles, np.pi / 4)


def with_padding(ref: np.ndarray, pad_steps: int) -> np.ndarray:
    """Prepend ``pad_steps`` copies of the first point."""
    return np.concatenate([np.tile(ref[:1], (pad_steps, 1)), ref], axis=0)


def flatten6(ref: np.ndarray) -> np.ndarray:
    """(T, 3) -> flat [x, y, z, 0, 0, 0] * T (the reference's wire format)."""
    out = np.zeros((ref.shape[0], 6))
    out[:, :3] = ref
    return out.reshape(-1)


def goal_window(ref: np.ndarray, offset: int, N: int) -> np.ndarray:
    """The N-knot goal window at ``offset``: ``ref[offset : offset + N]``,
    unclamped (shorter past the end)."""
    return ref[offset : offset + N]
