"""The arithmetic of the end-to-end timings and their spread.

``statistics.quantiles`` with the ``inclusive`` method is the one
percentile used throughout, for the latencies' percentiles and for the
quartiles of a spread."""
from __future__ import annotations

import statistics
from typing import Sequence


def per_tick_us(window_s: float, ticks: int) -> float:
    """A rate over the whole window: every tick and every second of it."""
    return window_s / ticks * 1e6


def latencies_us(due: Sequence[float], done: Sequence[float]):
    """Each tick's latency, from the time it was due to the time it was
    done (seconds in, microseconds out)."""
    return [(b - a) * 1e6 for a, b in zip(due, done)]


def percentile(values: Sequence[float], p: int) -> float:
    """The ``p``-th percentile (1-99) of all ``values``."""
    return statistics.quantiles(values, n=100, method="inclusive")[p - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and third quartiles over the median."""
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2
