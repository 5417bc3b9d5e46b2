"""``window_p90_ms``: the 90th percentile, over every window due in the
measured window, of the time from its due time to its result being
polled (host clock).  A window never answered, or answered with an
error, has no latency and makes the run fail its comparison."""

import numpy as np


def read(run):
    sel = run.due_in_window() & run.ok
    if not sel.any():
        return None
    return float(np.percentile(run.done[sel] - run.due[sel], 90)) * 1e3
