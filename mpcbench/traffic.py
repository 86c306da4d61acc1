"""The traffic every mix shares: the fig-8 end-effector reference of a
configuration, and the arithmetic of its reference offset.

The figure-8 is upstream's (gato_controller.py:313-341): in the x-z plane
at the configuration's amplitudes and offset, rotated about z, one period
sampled at ``period_s / dt`` points of a closed curve, tiled, after
``padding_rows`` copies of its first point.  From row ``padding_rows`` on
it repeats every period, so an offset can be moved back by whole periods
without changing a goal (:func:`wrapped_offset`).
"""
from __future__ import annotations

import math

import numpy as np


def period_rows(cfg: dict) -> int:
    return int(cfg["fig8"]["period_s"] / cfg["dt"])


def fig8_reference(cfg: dict, periods: int) -> np.ndarray:
    """(padding_rows + periods * period_rows, 3) end-effector positions."""
    f = cfg["fig8"]
    t = np.linspace(0.0, 2.0 * math.pi, period_rows(cfg))
    pts = np.stack([f["offset"][0] + f["A_x"] * np.sin(t),
                    np.full_like(t, f["offset"][1]),
                    f["offset"][2] + f["A_z"] * np.sin(2.0 * t) / 2.0 + f["A_z"] / 2.0], -1)
    c, s = math.cos(f["rotation_rad"]), math.sin(f["rotation_rad"])
    rot = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    ref = np.tile(pts @ rot.T, (periods, 1))
    return np.concatenate([np.tile(ref[:1], (f["padding_rows"], 1)), ref])


def periods_needed(cfg: dict, ticks_between_wraps: int) -> int:
    """Periods that hold a wrapped offset (under one period past the
    padding) plus ``ticks_between_wraps`` ticks and a horizon."""
    return 2 + -(-(ticks_between_wraps + cfg["horizon"]) // period_rows(cfg))


def wrapped_offset(cfg: dict, offset: int) -> int:
    """``offset`` moved back by whole periods to under one period past the
    padding; every multiple of the true wrench's walk period stays one,
    since a period holds a whole number of them."""
    pad, period = cfg["fig8"]["padding_rows"], period_rows(cfg)
    if period % cfg["wrench"]["walk_period"]:
        raise ValueError("the fig-8 period must hold a whole number of walk periods")
    if offset < pad + period:
        return offset
    return offset - period * ((offset - pad) // period)
