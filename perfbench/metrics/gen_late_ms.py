"""``gen_late_ms``: the 99th percentile of how late the load generator
called ``submit``, after each window's due time, over the windows due in
the measured window (host clock).  Backpressure that blocks ``submit``
shows here first."""

import numpy as np


def read(run):
    sel = run.due_in_window()
    if not sel.any():
        return None
    return float(np.percentile(run.sub[sel] - run.due[sel], 99)) * 1e3
