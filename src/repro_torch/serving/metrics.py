"""Serving metrics sink — per-wave records, the per-window stage record and
the percentile summary (grown from ``repro/serving/metrics.py``, which is
pure Python and numpy).

Every computed wave appends one :class:`WaveRecord`; :meth:`MetricsSink.
summary` reduces them to the numbers the paper reports for its real-time
deployment (§6): achieved samples/s, per-window latency percentiles
(p50/p95/p99), wave occupancy, and how often the deadline forced a partial
flush.  ``StreamServer.metrics_summary`` adds the operation count per
inference and the energy model's GOP/s/W (``core/energy.py``).

The stage record.  Every window a wave computes gets a row keyed by its
``(stream_id, seq)``, pointing to its wave's row; all stamps are
``time.perf_counter`` (the clock a profiler trace can be mapped onto):

  * window: ``t_submit`` (``submit`` enqueued it), ``t_emitted`` (its
    result was put on the results queue), ``t_polled`` (``poll`` handed
    it out);
  * wave: ``t_selected`` (the assembler picked the wave), ``t_exec`` (the
    compute thread started it), ``t_launch`` (the fused kernel's launch
    call returned; NaN where the wave launched no kernel, or launched it
    on another thread), ``t_host`` (the outputs were on the host).

:data:`STAGES` are the differences of consecutive stamps (``pending``,
``handoff``, ``prepare``, ``sync``, ``emit``, ``delivery``); they add up
to ``t_polled - t_submit`` for every window.  The rows live in
preallocated numpy columns, a ring of :data:`RING_ROWS` windows (and as
many waves), so recording allocates no object per window.  Shed
windows were never computed and have no row.

Reading it: :meth:`MetricsSink.windows` gives the retained rows as
columns with the stages; :meth:`MetricsSink.snapshot` the lifetime
counters; :func:`current_sinks` each recent server's current sink, also
after the server is closed.  While a ``torch.profiler`` runs, the
compute thread also opens ``serving.wave``, ``serving.prepare``,
``serving.sync`` and ``serving.emit`` ranges; a profiler started on
another thread records them with ``experimental_config=
torch.profiler._ExperimentalConfig(profile_all_threads=True)``.

Latency definitions:

  * ``compute_s``  — host time of the wave from dispatch to results
    ready (``t_exec`` to its :class:`WaveRecord`'s ``t_done``).
  * ``latency_ms`` — per window, submit -> polled (submit -> emitted for
    a window not yet polled), over the retained rows.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
from typing import Deque, Dict, List, Optional, Sequence

import numpy as np

NAN = float("nan")

#: Windows the stage record retains: 2^18 covers a 51 s
#: window at 3,200 windows/s with room to spare, in ~10 MB of host memory
#: (and 40 bytes a wave).
RING_ROWS = 1 << 18

#: The stages of a window, each ``(name, from stamp, to stamp)``.
STAGES = (("pending", "t_submit", "t_selected"),
          ("handoff", "t_selected", "t_exec"),
          ("prepare", "t_exec", "t_launch"),
          ("sync", "t_launch", "t_host"),
          ("emit", "t_host", "t_emitted"),
          ("delivery", "t_emitted", "t_polled"))

_WAVE_STAMPS = ("t_selected", "t_exec", "t_launch", "t_host")

# A record id is the sink's base plus the row's lifetime index, so a
# result polled after ``reset_metrics`` never stamps a row of the new sink.
_ROW_SPAN = 1 << 40
_SINK_BASES = itertools.count(1)


@dataclasses.dataclass(frozen=True)
class WaveRecord:
    """One computed wave, as recorded by the scheduler's compute thread,
    with its stage stamps (NaN where not taken)."""

    t_done: float           # perf_counter when results were ready
    compute_s: float        # host time of the wave, t_exec to t_done
    occupancy: int          # real (non-padding) windows in the wave
    batch: int              # static wave size the datapath saw
    deadline_flush: bool    # True when the deadline forced a partial wave
    t_selected: float = NAN  # the assembler picked the wave
    t_exec: float = NAN      # the compute thread started it
    t_launch: float = NAN    # the kernel's launch call returned
    t_host: float = NAN      # its outputs were on the host


class MetricsSink:
    """Thread-safe accumulator of :class:`WaveRecord` rows and of the
    per-window stage record.

    ``note_submit`` timestamps the first submission so achieved samples/s
    is measured over the full submit -> last-result wall interval.

    The sink is bounded: a long-lived server records one wave forever, so
    only the most recent ``window`` wave records, and the most recent
    ``rows`` window rows, are retained for the percentile/mean reductions
    (latency p50/p95/p99 then read as *current* behaviour, not lifetime
    history), while counts — waves, samples, deadline flushes, padded
    slots — and the samples/s wall interval are lifetime totals kept as
    O(1) counters.

    The stage record is numpy columns, so it holds nothing the garbage
    collector walks (a record of Python objects grows the tracked heap
    and brings full collections, each a pause of the whole process):
    per window ``stream``, ``seq``, ``t_submit`` and (``t_emitted``,
    ``t_polled``) in a ring of ``rows``; per wave with windows its first
    row and its four stamps, in a ring as long (a wave holds at least one
    window, so no retained window loses its wave)."""

    def __init__(self, window: int = 4096, rows: int = RING_ROWS):
        """Create an empty sink retaining the last ``window`` wave records
        and the last ``rows`` windows' stage rows (a power of two);
        records arrive via :meth:`record_wave`."""
        if rows < 1 or rows & (rows - 1):
            raise ValueError(f"rows must be a power of two, got {rows}")
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
        # The stage record; (t_emitted, t_polled) start NaN and are reset
        # only where the ring reuses a row.
        self._mask = rows - 1
        self._base = next(_SINK_BASES) * _ROW_SPAN
        self._n_rows = 0            # window rows ever recorded
        self._n_wave_rows = 0       # wave rows ever recorded
        self._stream = np.empty(rows, object)
        self._seq = np.empty(rows, np.int64)
        self._t_submit = np.empty(rows)
        self._t_out = np.full((rows, 2), NAN)
        self._waves = np.empty((rows, 1 + len(_WAVE_STAMPS)))

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

    def record_wave(self, record: WaveRecord, slots: Sequence = ()) -> int:
        """Append one computed wave (rolls the window, bumps the lifetime
        counters) and, where it has ``slots`` (objects with ``stream_id``,
        ``seq`` and ``t_submit``, in emission order), its stage rows.
        Returns the record id of the first slot's row; slot ``i``'s is
        that plus ``i`` (the id a ``StreamResult`` carries)."""
        n = len(slots)
        with self._lock:
            self._recent.append(record)
            if self._t_last_done is None or record.t_done > self._t_last_done:
                self._t_last_done = record.t_done
            self._n_waves += 1
            self._n_samples += record.occupancy
            self._n_deadline_flushes += bool(record.deadline_flush)
            self._n_padded_slots += record.batch - record.occupancy
            self._compute_s_total += record.compute_s
            i0 = self._n_rows
            if n:
                at = self._ring(i0, n)
                self._stream[at] = [sl.stream_id for sl in slots]
                self._seq[at] = [sl.seq for sl in slots]
                self._t_submit[at] = [sl.t_submit for sl in slots]
                if i0 + n > self._mask + 1:
                    self._t_out[at] = NAN
                self._waves[self._n_wave_rows & self._mask] = (
                    i0, record.t_selected, record.t_exec, record.t_launch,
                    record.t_host)
                self._n_wave_rows += 1
                self._n_rows = i0 + n
        return self._base + i0

    def note_emitted(self, first: int, stamps) -> None:
        """``t_emitted`` of the rows from record id ``first`` on, one stamp
        each (a wave's windows, as their results were put on the queue)."""
        i0 = first - self._base
        with self._lock:
            if i0 >= self._n_rows - self._mask - 1:
                self._t_out[self._ring(i0, len(stamps)), 0] = stamps

    def note_polled(self, results: Sequence, t: float) -> None:
        """Stamp ``t_polled`` = ``t`` on the rows of ``results`` (what one
        ``poll`` handed out, each with its ``record`` id); ids of other
        sinks (-1 for shed windows) and overwritten rows are passed
        over."""
        i0 = results[0].record - self._base
        n = len(results)
        with self._lock:
            lo = max(0, self._n_rows - self._mask - 1)
            if (results[-1].record - self._base - i0 == n - 1
                    and lo <= i0 and i0 + n <= self._n_rows):
                # One poll hands out consecutive rows, as a rule.
                self._t_out[self._ring(i0, n), 1] = t
                return
            ids = np.fromiter((r.record for r in results), np.int64,
                              n) - self._base
            ids = ids[(ids >= lo) & (ids < self._n_rows)]
            self._t_out[ids & self._mask, 1] = t

    def _ring(self, i0: int, n: int):
        """Ring positions of lifetime rows ``i0 .. i0 + n - 1``."""
        a = i0 & self._mask
        if a + n <= self._mask + 1:
            return slice(a, a + n)
        return np.arange(i0, i0 + n) & self._mask

    @property
    def rows_recorded(self) -> int:
        """Window rows recorded over the sink's life (those beyond
        :attr:`ring_rows` overwrote the oldest)."""
        return self._n_rows

    @property
    def ring_rows(self) -> int:
        """How many window rows the sink retains."""
        return self._mask + 1

    def windows(self) -> Dict[str, np.ndarray]:
        """The retained window rows, oldest first: ``stream``, ``seq``,
        ``wave`` (the wave row's number, counting the sink's waves with
        windows), the window's and its wave's stamps, and one column per
        stage of :data:`STAGES` (s; NaN where a stamp is NaN)."""
        with self._lock:
            lo = max(0, self._n_rows - self._mask - 1)
            rows = np.arange(lo, self._n_rows)
            at = rows & self._mask
            w_lo = max(0, self._n_wave_rows - self._mask - 1)
            waves = self._waves[np.arange(w_lo, self._n_wave_rows)
                                & self._mask]
            cols = {"stream": self._stream[at], "seq": self._seq[at],
                    "t_submit": self._t_submit[at],
                    "t_emitted": self._t_out[at, 0],
                    "t_polled": self._t_out[at, 1]}
        k = np.searchsorted(waves[:, 0], rows, side="right") - 1
        cols["wave"] = w_lo + k
        for j, name in enumerate(_WAVE_STAMPS):
            cols[name] = waves[k, 1 + j]
        for name, a, b in STAGES:
            cols[name] = cols[b] - cols[a]
        return cols

    @property
    def waves(self) -> List[WaveRecord]:
        """A snapshot copy of the retained (most recent ``window``) waves."""
        with self._lock:
            return list(self._recent)

    def snapshot(self) -> Dict:
        """One consistent copy of every internal accumulator but the stage
        record (for :meth:`merge` and for readers of the lifetime counters
        — taken under the lock, so a sink read while its server still
        records stays self-consistent)."""
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

    _snapshot = snapshot

    @classmethod
    def merge(cls, sinks: "List[MetricsSink]",
              window: Optional[int] = None,
              rows: Optional[int] = None) -> "MetricsSink":
        """Cluster aggregation: one sink summarising many replicas' sinks.

        Lifetime counters (waves, samples, deadline flushes, padded slots,
        named event counters) are SUMMED; the wall interval spans the
        earliest first-submit to the latest last-done across all replicas,
        so the merged ``samples_per_s`` is the cluster's aggregate
        throughput over the common measurement window.  The rolling
        windows are unions: the replicas' retained :class:`WaveRecord`
        rows ordered by completion time and truncated to ``window``
        (default: the largest input window), and their retained stage rows
        ordered by their wave's ``t_exec`` and truncated to ``rows``
        (default: the largest input ring; the merged ring is sized to what
        it holds), so the merged p50/p95/p99 describe *current*
        cluster-wide window latency exactly as a single server's sink
        would.  ``merge([])`` is the empty sink; empty inputs contribute
        nothing."""
        sinks = list(sinks)
        if window is None:
            window = max((s._recent.maxlen or 4096 for s in sinks),
                         default=4096)
        if rows is None:
            rows = max((s.ring_rows for s in sinks), default=RING_ROWS)
        parts = [s.windows() for s in sinks]
        held = sum(len(p["seq"]) for p in parts)
        out = cls(window=window,
                  rows=min(rows, 1 << max(0, held - 1).bit_length()))
        snaps = [s.snapshot() for s in sinks]
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
        out._load_windows(parts)
        return out

    def _load_windows(self, parts: List[Dict[str, np.ndarray]]) -> None:
        """Fill an empty sink's stage record with the union of ``parts``
        (:meth:`windows` of other sinks): ordered by wave start, the
        newest ``ring_rows`` kept, waves renumbered in that order."""
        src = np.concatenate([np.full(len(p["seq"]), i, np.int64)
                              for i, p in enumerate(parts)] or [[]])
        if not len(src):
            return
        cols = {k: np.concatenate([p[k] for p in parts])
                for k in ("stream", "seq", "wave", "t_submit", "t_emitted",
                          "t_polled", *_WAVE_STAMPS)}
        order = np.lexsort((np.arange(len(src)), cols["wave"], src,
                            cols["t_exec"]))[-(self._mask + 1):]
        src, cols = src[order], {k: v[order] for k, v in cols.items()}
        first = np.r_[True, (src[1:] != src[:-1])
                      | (cols["wave"][1:] != cols["wave"][:-1])]
        n, starts = len(src), np.flatnonzero(first)
        self._stream[:n] = cols["stream"]
        self._seq[:n] = cols["seq"]
        self._t_submit[:n] = cols["t_submit"]
        self._t_out[:n, 0] = cols["t_emitted"]
        self._t_out[:n, 1] = cols["t_polled"]
        self._waves[:len(starts), 0] = starts
        for j, k in enumerate(_WAVE_STAMPS):
            self._waves[:len(starts), 1 + j] = cols[k][starts]
        self._n_rows, self._n_wave_rows = n, len(starts)

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
        with self._lock:
            at = (np.arange(max(0, self._n_rows - self._mask - 1),
                            self._n_rows) & self._mask)
            t_out, t_submit = self._t_out[at], self._t_submit[at]
        t_done = np.where(np.isnan(t_out[:, 1]), t_out[:, 0], t_out[:, 1])
        lat = t_done - t_submit
        lat = lat[~np.isnan(lat)]
        if len(lat):
            p50, p95, p99 = np.percentile(lat, [50, 95, 99])
            mean = lat.mean()
        else:
            p50 = p95 = p99 = mean = NAN
        comp = np.asarray([r.compute_s for r in recent])
        wall_s = (t_end - t0) if t0 is not None else compute_total
        return {
            "waves": n_waves,
            "samples": n_samples,
            "wall_s": float(wall_s),
            "samples_per_s": n_samples / wall_s if wall_s > 0 else 0.0,
            "latency_ms": {"p50": float(p50 * 1e3), "p95": float(p95 * 1e3),
                           "p99": float(p99 * 1e3),
                           "mean": float(mean * 1e3)},
            "compute_ms_mean": float(comp.mean() * 1e3),
            "mean_occupancy": n_samples / n_waves,
            "batch": recent[-1].batch,
            "deadline_flushes": n_flushes,
            "padded_slots": int(n_padded),
        }


# -- the process-wide read ------------------------------------------------

#: Servers whose current sink :func:`current_sinks` keeps (the newest;
#: each kept sink holds what it recorded, at most a full ring).
KEEP_SERVERS = 16

_CURRENT: Dict[int, MetricsSink] = {}
_CURRENT_LOCK = threading.Lock()
_SERVER_IDS = itertools.count()


def new_server_id() -> int:
    """A process-wide number for a new server, increasing with creation."""
    return next(_SERVER_IDS)


def publish(server_id: int, sink: MetricsSink) -> None:
    """Make ``sink`` the current sink of server ``server_id``, replacing
    its previous one; only the :data:`KEEP_SERVERS` newest servers' sinks
    are kept."""
    with _CURRENT_LOCK:
        _CURRENT[server_id] = sink
        while len(_CURRENT) > KEEP_SERVERS:
            del _CURRENT[min(_CURRENT)]


def current_sinks() -> Dict[int, MetricsSink]:
    """Each recent server's current sink, by server number in creation
    order: a server's record stays readable after it is closed and
    dropped (as ``kernels/*.py::LAUNCHES`` stay readable)."""
    with _CURRENT_LOCK:
        return dict(sorted(_CURRENT.items()))
