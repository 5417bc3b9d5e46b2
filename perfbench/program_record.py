"""The serving program's own stage record, joined to the client's rows,
for the readers of the stage metrics (``metrics/<stage>_ms.py``,
``metrics/host_path_idle.py``).

The program keeps one row per window it computed, keyed by ``(stream_id,
seq)``, with the stamps of the window and of its wave on the host clock
(``repro_torch.serving.metrics``: ``current_sinks`` gives each server's
current sink after the server is closed, ``MetricsSink.windows`` its
rows and the stages between the stamps).  A client row's ``seq`` is its
rank within its stream in sending order, as the server numbers a
stream's windows.

The tail is what ``window_p90_ms`` reads: the windows due in the
measured window and answered, whose due-to-polled latency is at or above
its 90th percentile.

There is nothing to read (``None``) where the program keeps no record,
where its record lost rows of the measured window (the ring wrapped), or
where a tail window has no row.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

_CACHE = "_program_record"


def sink(run):
    """The run's server's current sink (the newest server's), or None
    where the program keeps no such record."""
    try:
        from repro_torch.serving import metrics
    except ImportError:
        return None
    read = getattr(metrics, "current_sinks", None)
    if read is None:
        return None
    sinks = read()
    return sinks[max(sinks)] if sinks else None


def tail(run) -> np.ndarray:
    """The client rows ``window_p90_ms`` reads at and above its value."""
    sel = run.due_in_window() & run.ok
    lat = run.done - run.due
    if not sel.any():
        return sel
    return sel & (lat >= np.percentile(lat[sel], 90))


def seq_of(stream: np.ndarray) -> np.ndarray:
    """Each client row's rank within its stream, in sending order."""
    order = np.lexsort((np.arange(len(stream)), stream))
    s = stream[order]
    start = np.r_[0, np.flatnonzero(s[1:] != s[:-1]) + 1]
    rank = np.arange(len(s)) - np.repeat(start, np.diff(np.r_[start, len(s)]))
    out = np.empty(len(stream), np.int64)
    out[order] = rank
    return out


def record(run) -> Optional[Dict[str, np.ndarray]]:
    """The program's columns (``MetricsSink.windows``) of the run's whole
    record, ``"tail"`` the rows of the tail, and ``"found"`` per client
    row the index of its program row (-1 where none); cached on the run.
    None where there is nothing to read."""
    if _CACHE not in run.__dict__:
        run.__dict__[_CACHE] = _read(run)
    return run.__dict__[_CACHE]


def _read(run) -> Optional[Dict[str, np.ndarray]]:
    sk = sink(run)
    if sk is None:
        return None
    cols = sk.windows()
    if not len(cols["seq"]):
        return None
    if (sk.rows_recorded > sk.ring_rows
            and np.nanmin(cols["t_submit"]) >= run.t0):
        return None                   # the ring lost rows of the window
    try:
        p_stream = cols["stream"].astype(np.int64)
    except (TypeError, ValueError):
        return None
    c_seq = seq_of(run.stream)
    span = int(max(c_seq.max(initial=0), cols["seq"].max())) + 1
    p_key = p_stream * span + cols["seq"]
    order = np.argsort(p_key, kind="stable")
    c_key = run.stream * span + c_seq
    at = np.clip(np.searchsorted(p_key[order], c_key), 0, len(order) - 1)
    found = np.where(p_key[order][at] == c_key, order[at], -1)
    rows = tail(run)
    if not rows.any() or (found[rows] < 0).any():
        return None
    cols["tail"] = found[rows]
    cols["found"] = found
    return cols


def tail_stage_ms(run, stage: str) -> Optional[float]:
    """Mean of ``stage`` (ms) over the tail's windows, NaN stamps passed
    over; None where there is nothing to read."""
    rec = record(run)
    if rec is None:
        return None
    v = rec[stage][rec["tail"]]
    v = v[~np.isnan(v)]
    return float(v.mean()) * 1e3 if len(v) else None
