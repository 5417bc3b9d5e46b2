"""Traffic: a mix's data file in, windows and arrivals out.

A mix (``perfbench/traffic/<name>.json``) holds parameters only:

* ``arrivals``: the name of the arrival process, a module
  ``perfbench/arrivals/<arrivals>.py`` with ``PARAMS`` (the names of the
  further keys it reads from the mix) and ``schedule(mix, seed,
  seconds)`` (a :class:`Schedule`);
* ``streams``: the number of sensor streams;
* ``batch`` and ``deadline_s``: the server's settings (``StreamServer``;
  every other setting is the server's default);
* the arrival process's ``PARAMS`` (``poisson``: ``rate_per_s``).

Windows are PeMS-like: each stream is a sensor's normalised speed in 5
minute bins (a daily profile with morning and evening rush hours, a
per-sensor phase and depth, and noise), cut into consecutive windows of
``T`` bins.  Window ``k`` of every stream comes from one draw seeded by
``(seed, k)``, so a seed gives the same windows however far a run gets.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

BINS_PER_DAY = 288
SERVER_KEYS = ("arrivals", "streams", "batch", "deadline_s")


def seed64(seed: int) -> int:
    """A run's ``--seed`` (any whole number) as a generator's seed."""
    return int(seed) % (1 << 64)


@dataclasses.dataclass
class Mix:
    """A traffic mix as read from its data file: the server's settings,
    the arrival process's name and its parameters (``params``)."""

    name: str
    arrivals: str
    streams: int
    batch: int
    deadline_s: Optional[float]
    params: Dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_dict(cls, name: str, d: Dict) -> "Mix":
        missing = [k for k in SERVER_KEYS if k not in d]
        if missing:
            raise ValueError(f"traffic {name}: missing keys {missing}")
        params = {k: v for k, v in d.items()
                  if k not in SERVER_KEYS and k != "why"}
        return cls(name=name, params=params,
                   **{k: d[k] for k in SERVER_KEYS})


class Windows:
    """Window ``k`` of each of ``streams`` sensors, (T, M) float32 each,
    drawn per ``k`` from the seed and kept once drawn."""

    def __init__(self, seed: int, streams: int, t: int, m: int):
        self.seed, self.streams, self.t, self.m = seed64(seed), streams, t, m
        rng = np.random.default_rng([self.seed, 0x5EED])
        self.phase = rng.integers(0, BINS_PER_DAY, streams)
        self.depth = rng.uniform(0.3, 0.6, streams)
        self.free = rng.uniform(0.75, 0.95, streams)
        self._rounds: List[np.ndarray] = []

    def round(self, k: int) -> np.ndarray:
        """(streams, T, M) float32: window ``k`` of every stream."""
        while len(self._rounds) <= k:
            j = len(self._rounds)
            rng = np.random.default_rng([self.seed, 0xDA7A, j])
            n = (j * self.t + np.arange(self.t))[None, :] + self.phase[:, None]
            hour = (n % BINS_PER_DAY) / 12.0
            rush = (np.exp(-0.5 * ((hour - 8.0) / 1.2) ** 2)
                    + 1.1 * np.exp(-0.5 * ((hour - 17.5) / 1.5) ** 2))
            v = self.free[:, None] - self.depth[:, None] * rush
            v = v + rng.normal(0.0, 0.05, (self.streams, self.t))
            w = np.clip(v, 0.0, 1.0).astype(np.float32)
            self._rounds.append(np.repeat(w[:, :, None], self.m, axis=2))
        return self._rounds[k]

    def take(self, stream: np.ndarray, k: np.ndarray) -> np.ndarray:
        """(n, T, M) float32: window ``k[j]`` of stream ``stream[j]``."""
        out = np.empty((len(stream), self.t, self.m), np.float32)
        for kk in np.unique(k):
            sel = k == kk
            out[sel] = self.round(int(kk))[stream[sel]]
        return out


@dataclasses.dataclass
class Schedule:
    """Arrivals: window ``j`` is due ``due[j]`` seconds after the window
    opens and is window ``k[j]`` of stream ``stream[j]``.  Each stream's
    windows are numbered 0, 1, 2, ... in the order they are due."""

    due: np.ndarray
    stream: np.ndarray
    k: np.ndarray


def order(seed: int, streams: int) -> np.ndarray:
    """A seeded permutation of the streams, for arrivals to cycle through."""
    return np.random.default_rng([seed64(seed), 0x0DE5]).permutation(streams)


def cycle(due: np.ndarray, seed: int, streams: int) -> Schedule:
    """Arrival times ``due`` given to the streams in turn, in the seeded
    order, so that each stream's windows arrive in order and at the same
    mean rate."""
    j = np.arange(len(due))
    return Schedule(due=due, stream=order(seed, streams)[j % streams],
                    k=j // streams)
