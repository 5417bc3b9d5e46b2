"""``clock_burst``: windows on a common reporting clock, as detectors that
report a periodic aggregate (PeMS's) send them: every ``period_s`` a
burst of ``rate_per_s * period_s`` windows (rounded), all due at the
tick, from 0 on; exactly ``round(rate_per_s * seconds)`` windows over
``[0, seconds)``, so every seed sends the same work.  They are given to
the streams in the seeded cycle (``traffic.cycle``); only the order of
the streams differs between seeds."""

from __future__ import annotations

import numpy as np

from perfbench.traffic import Mix, Schedule, cycle

PARAMS = ("rate_per_s", "period_s")


def schedule(mix: Mix, seed: int, seconds: float) -> Schedule:
    """Arrivals over ``[0, seconds)``."""
    rate, period = float(mix.params["rate_per_s"]), float(
        mix.params["period_s"])
    burst = max(1, int(round(rate * period)))
    n = int(round(rate * seconds))
    due = (np.arange(n) // burst) * period
    return cycle(due, seed, mix.streams)
