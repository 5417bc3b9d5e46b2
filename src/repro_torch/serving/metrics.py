"""Serving metrics sink — per-wave records and the percentile summary
(a copy of ``repro/serving/metrics.py``, which is pure Python and numpy).

Every computed wave appends one :class:`WaveRecord`; :meth:`MetricsSink.
summary` reduces them to the numbers the paper reports for its real-time
deployment (§6): achieved samples/s, per-wave latency percentiles
(p50/p95/p99), wave occupancy, and how often the deadline forced a partial
flush.  ``StreamServer.metrics_summary`` adds the operation count per
inference; the energy model's GOP/s/W waits for the energy slice.

Latency definitions:

  * ``compute_s``  — device time for the wave (dispatch to results ready).
  * ``latency_s``  — end-to-end for the wave's OLDEST window: submit ->
    results ready.  Queueing + assembly + compute; the quantity the
    deadline bounds, and what p50/p95/p99 are computed over.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
from typing import Deque, Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class WaveRecord:
    """One computed wave, as recorded by the scheduler's compute thread."""

    t_done: float           # perf_counter when results were ready
    compute_s: float        # device compute time for the wave
    latency_s: float        # oldest-window end-to-end latency
    occupancy: int          # real (non-padding) windows in the wave
    batch: int              # static wave size the datapath saw
    deadline_flush: bool    # True when the deadline forced a partial wave


class MetricsSink:
    """Thread-safe accumulator of :class:`WaveRecord` rows.

    ``note_submit`` timestamps the first submission so achieved samples/s
    is measured over the full submit -> last-result wall interval.

    The sink is bounded: a long-lived server records one wave forever, so
    only the most recent ``window`` records are retained for the
    percentile/mean reductions (latency p50/p95/p99 then read as *current*
    behaviour, not lifetime history), while counts — waves, samples,
    deadline flushes, padded slots — and the samples/s wall interval are
    lifetime totals kept as O(1) counters."""

    def __init__(self, window: int = 4096):
        """Create an empty sink retaining the last ``window`` wave records;
        records arrive via :meth:`record_wave`."""
        self._lock = threading.Lock()
        self._recent: Deque[WaveRecord] = collections.deque(maxlen=window)
        self._t_first_submit: Optional[float] = None
        self._t_last_done: Optional[float] = None
        self._n_waves = 0
        self._n_samples = 0
        self._n_deadline_flushes = 0
        self._n_padded_slots = 0
        self._compute_s_total = 0.0
        self._counters: Dict[str, int] = collections.defaultdict(int)

    def count(self, name: str, n: int = 1) -> None:
        """Bump a named event counter (``state_resets``, ``sheds``,
        ``stream_errors``, ... — the reliability layer's events); read
        back with :meth:`counters`."""
        with self._lock:
            self._counters[name] += n

    def counters(self) -> Dict[str, int]:
        """Snapshot of the named event counters."""
        with self._lock:
            return dict(self._counters)

    def note_submit(self, t: float) -> None:
        """Record a submission timestamp (keeps the earliest)."""
        with self._lock:
            if self._t_first_submit is None or t < self._t_first_submit:
                self._t_first_submit = t

    def record_wave(self, record: WaveRecord) -> None:
        """Append one computed wave (rolls the window, bumps the lifetime
        counters)."""
        with self._lock:
            self._recent.append(record)
            if self._t_last_done is None or record.t_done > self._t_last_done:
                self._t_last_done = record.t_done
            self._n_waves += 1
            self._n_samples += record.occupancy
            self._n_deadline_flushes += bool(record.deadline_flush)
            self._n_padded_slots += record.batch - record.occupancy
            self._compute_s_total += record.compute_s

    @property
    def waves(self) -> List[WaveRecord]:
        """A snapshot copy of the retained (most recent ``window``) waves."""
        with self._lock:
            return list(self._recent)

    def _snapshot(self) -> Dict:
        """One consistent copy of every internal accumulator (for
        :meth:`merge` — taken under the lock, so a sink being merged while
        its server still records stays self-consistent)."""
        with self._lock:
            return {
                "recent": list(self._recent),
                "window": self._recent.maxlen,
                "t_first_submit": self._t_first_submit,
                "t_last_done": self._t_last_done,
                "n_waves": self._n_waves,
                "n_samples": self._n_samples,
                "n_deadline_flushes": self._n_deadline_flushes,
                "n_padded_slots": self._n_padded_slots,
                "compute_s_total": self._compute_s_total,
                "counters": dict(self._counters),
            }

    @classmethod
    def merge(cls, sinks: "List[MetricsSink]",
              window: Optional[int] = None) -> "MetricsSink":
        """Cluster aggregation: one sink summarising many replicas' sinks.

        Lifetime counters (waves, samples, deadline flushes, padded slots,
        named event counters) are SUMMED; the wall interval spans the
        earliest first-submit to the latest last-done across all replicas,
        so the merged ``samples_per_s`` is the cluster's aggregate
        throughput over the common measurement window.  The rolling
        percentile window is the union of the replicas' retained
        :class:`WaveRecord` rows ordered by completion time and truncated
        to ``window`` (default: the largest input window), so the merged
        p50/p95/p99 describe *current* cluster-wide wave latency exactly
        as a single server's sink would.  ``merge([])`` is the empty sink;
        empty inputs contribute nothing."""
        sinks = list(sinks)
        if window is None:
            window = max((s._recent.maxlen or 4096 for s in sinks),
                         default=4096)
        out = cls(window=window)
        snaps = [s._snapshot() for s in sinks]
        records = sorted((r for sn in snaps for r in sn["recent"]),
                         key=lambda r: r.t_done)
        out._recent.extend(records)          # deque keeps the most recent
        firsts = [sn["t_first_submit"] for sn in snaps
                  if sn["t_first_submit"] is not None]
        lasts = [sn["t_last_done"] for sn in snaps
                 if sn["t_last_done"] is not None]
        out._t_first_submit = min(firsts) if firsts else None
        out._t_last_done = max(lasts) if lasts else None
        out._n_waves = sum(sn["n_waves"] for sn in snaps)
        out._n_samples = sum(sn["n_samples"] for sn in snaps)
        out._n_deadline_flushes = sum(sn["n_deadline_flushes"]
                                      for sn in snaps)
        out._n_padded_slots = sum(sn["n_padded_slots"] for sn in snaps)
        out._compute_s_total = sum(sn["compute_s_total"] for sn in snaps)
        for sn in snaps:
            for k, v in sn["counters"].items():
                out._counters[k] += v
        return out

    def summary(self) -> Dict:
        """Reduce the records to the serving report's throughput/latency
        block (see the module and class docstrings for the latency
        definitions and the rolling-window vs lifetime split)."""
        with self._lock:
            recent = list(self._recent)
            t0 = self._t_first_submit
            t_end = self._t_last_done
            n_waves = self._n_waves
            n_samples = self._n_samples
            n_flushes = self._n_deadline_flushes
            n_padded = self._n_padded_slots
            compute_total = self._compute_s_total
        if not recent:
            return {"waves": 0, "samples": 0, "samples_per_s": 0.0}
        lat = np.asarray([w.latency_s for w in recent])
        comp = np.asarray([w.compute_s for w in recent])
        wall_s = (t_end - t0) if t0 is not None else compute_total
        p50, p95, p99 = np.percentile(lat, [50, 95, 99])
        return {
            "waves": n_waves,
            "samples": n_samples,
            "wall_s": float(wall_s),
            "samples_per_s": n_samples / wall_s if wall_s > 0 else 0.0,
            "latency_ms": {"p50": float(p50 * 1e3), "p95": float(p95 * 1e3),
                           "p99": float(p99 * 1e3),
                           "mean": float(lat.mean() * 1e3)},
            "compute_ms_mean": float(comp.mean() * 1e3),
            "mean_occupancy": n_samples / n_waves,
            "batch": recent[-1].batch,
            "deadline_flushes": n_flushes,
            "padded_slots": int(n_padded),
        }
