"""``poisson``: an open loop of Poisson arrivals at ``rate_per_s``
windows a second over all streams, given to the streams in a seeded
cycle (``traffic.cycle``)."""

from __future__ import annotations

import numpy as np

from perfbench.traffic import Mix, Schedule, cycle, seed64

PARAMS = ("rate_per_s",)


def schedule(mix: Mix, seed: int, seconds: float) -> Schedule:
    """Arrivals over ``[0, seconds)``."""
    rate = float(mix.params["rate_per_s"])
    rng = np.random.default_rng([seed64(seed), 0xA771])
    want = rate * seconds
    gaps = rng.exponential(1.0 / rate, int(want + 6 * want ** 0.5 + 16))
    due = np.cumsum(gaps)
    while due[-1] < seconds:          # never in practice: six sigma above
        more = rng.exponential(1.0 / rate, len(gaps))
        due = np.concatenate([due, due[-1] + np.cumsum(more)])
    return cycle(due[due < seconds], seed, mix.streams)
