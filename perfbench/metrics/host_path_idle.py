"""``host_path_idle``: the share (%) of the traced sub-window's wall in
which the device ran nothing while the server's compute thread was
inside a wave, from the wave's start (``t_exec``) to its last result
put on the results queue (its last ``t_emitted``).  The waves come from
the serving program's own stage record, the device's busy intervals
from the profiler, both on the host clock.  Nothing without a trace in
which a device operation ran, where the program keeps no record, or
where its record lost rows of the measured window."""

import numpy as np

from perfbench import program_record


def busy_within(starts, ends, a, b):
    """Busy seconds of sorted disjoint intervals ``starts``/``ends`` inside
    each ``[a, b]``."""
    if not len(starts):
        return np.zeros_like(a)
    cum = np.r_[0.0, np.cumsum(ends - starts)]

    def upto(t):
        k = np.searchsorted(starts, t, side="right")
        inside = np.where(k > 0, ends[np.maximum(k - 1, 0)] - t, 0.0)
        return cum[k] - np.clip(inside, 0.0, None)

    return upto(b) - upto(a)


def read(run):
    tr = run.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    rec = program_record.record(run)
    if rec is None:
        return None
    wave, t_exec, t_emit = rec["wave"], rec["t_exec"], rec["t_emitted"]
    last = np.r_[wave[1:] != wave[:-1], True]
    a = np.clip(t_exec[last], tr.t_a, tr.t_b)
    b = np.clip(t_emit[last], tr.t_a, tr.t_b)
    keep = ~np.isnan(a) & ~np.isnan(b) & (b > a)
    a, b = a[keep], b[keep]
    busy = np.asarray(tr.busy_intervals, dtype=float).reshape(-1, 2)
    idle = (b - a) - busy_within(busy[:, 0], busy[:, 1], a, b)
    return 100.0 * float(idle.sum()) / tr.window_s
