"""``poisson_count``: an open loop of Poisson arrivals at ``rate_per_s``
windows a second over all streams, conditioned on their count: exactly
``round(rate_per_s * seconds)`` arrivals over ``[0, seconds)``, each
uniform in it, which is a Poisson process given its count.  They are
given to the streams in a seeded cycle (``traffic.cycle``).  Every seed
sends the same number of windows over a window of one length; only
their times and their order differ."""

from __future__ import annotations

import numpy as np

from perfbench.traffic import Mix, Schedule, cycle, seed64

PARAMS = ("rate_per_s",)


def schedule(mix: Mix, seed: int, seconds: float) -> Schedule:
    """Arrivals over ``[0, seconds)``."""
    rate = float(mix.params["rate_per_s"])
    rng = np.random.default_rng([seed64(seed), 0xC0A7])
    due = np.sort(rng.uniform(0.0, seconds, int(round(rate * seconds))))
    return cycle(due, seed, mix.streams)
