"""Synthetic PeMS-4W-like traffic-speed data (the paper's dataset is a
zenodo download; this synthesises a statistically similar stream: daily
periodicity, AM/PM rush-hour congestion, weekly structure, noise, and
occasional incident drops), plus the paper's windowing (length-N sliding
windows, single-step-ahead target, §3).

The port's own copy of ``repro/data/timeseries.py``: numpy only, the same
draws in the same order, so a seed gives the reference's arrays exactly.
Deterministic in (seed); normalised to [0, 1] like [15] so the (4,8)
fixed-point input range is exercised the same way.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

SAMPLES_PER_HOUR = 12  # 5-minute bins, like PeMS


def generate_speeds(n_days: int = 28, seed: int = 0,
                    free_flow_mph: float = 65.0) -> np.ndarray:
    """1-D speed series, 5-min resolution."""
    rng = np.random.default_rng(seed)
    n = n_days * 24 * SAMPLES_PER_HOUR
    t_hour = (np.arange(n) / SAMPLES_PER_HOUR) % 24.0
    day = (np.arange(n) // (24 * SAMPLES_PER_HOUR)) % 7

    speed = np.full(n, free_flow_mph, np.float64)

    def rush(center, width, depth):
        return depth * np.exp(-0.5 * ((t_hour - center) / width) ** 2)

    weekday = (day < 5).astype(np.float64)
    speed -= weekday * (rush(8.0, 1.2, 28.0) + rush(17.5, 1.5, 32.0))
    speed -= (1 - weekday) * rush(14.0, 2.5, 10.0)   # weekend midday
    # slow seasonal drift + AR(1) noise
    speed += 2.0 * np.sin(2 * np.pi * np.arange(n) / (7 * 24 * SAMPLES_PER_HOUR))
    ar = np.zeros(n)
    eps = rng.normal(0, 1.3, n)
    for i in range(1, n):
        ar[i] = 0.9 * ar[i - 1] + eps[i]
    speed += ar
    # incidents: sudden capacity drops with exponential recovery
    n_inc = max(1, n_days // 2)
    for s in rng.integers(0, n - 40, n_inc):
        dur = int(rng.integers(6, 36))
        drop = rng.uniform(15, 35)
        speed[s:s + dur] -= drop * np.exp(-np.arange(dur) / (dur / 3))
    return np.clip(speed, 3.0, 75.0)


def normalize(x: np.ndarray) -> Tuple[np.ndarray, Dict[str, float]]:
    lo, hi = float(x.min()), float(x.max())
    return (x - lo) / (hi - lo + 1e-9), {"lo": lo, "hi": hi}


def make_windows(series: np.ndarray, seq_len: int
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: X (N, seq_len, 1), y (N, 1) = next value (§3)."""
    n = len(series) - seq_len
    idx = np.arange(n)[:, None] + np.arange(seq_len)[None, :]
    x = series[idx][..., None].astype(np.float32)
    y = series[seq_len:][:, None].astype(np.float32)
    return x, y


def pems_like_dataset(seq_len: int = 6, n_days: int = 28, seed: int = 0,
                      test_frac: float = 0.2):
    """Returns dict(train=(x, y), test=(x, y), norm=meta)."""
    speeds = generate_speeds(n_days, seed)
    norm, meta = normalize(speeds)
    x, y = make_windows(norm, seq_len)
    n_test = int(len(x) * test_frac)
    return {
        "train": (x[:-n_test], y[:-n_test]),
        "test": (x[-n_test:], y[-n_test:]),
        "norm": meta,
    }
