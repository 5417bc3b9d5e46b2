"""The traced sub-window: device operations from ``torch.profiler``, and
host spans recorded around the server's layers.

The profiler records every device operation in the process (kernels,
copies, fills), whichever thread launched it.  Annotations made on the
client's thread at the sub-window's two ends map the profiler's clock
onto the host's.  Each is bracketed by the host clock, and made again
until a bracket is tight (``MARK_TIGHT_S``): the server's threads hold
the interpreter, and a mark stamped only after its annotation returns
lags it by however long the client waited for the interpreter, which
skews the whole mapping by milliseconds.  While the traced sub-window
runs, :class:`Spans` records the spans the system module's
``instrument`` wraps around its server's layers (``SPANS``: for
``qlstm_server``, the compute thread executing a wave, within it the
guarded datapath, and the assembler building a wave), and when the
client submits and handles polled results; each idle gap of the device
is then put down to what the host was doing at its middle, the system's
spans first in their order, or to ``waiting`` where no span was open
(every thread waiting for a deadline, an arrival or a result).  Nothing
is written to disk.

A trace is read only where it is whole (:meth:`TraceResult.fault`).
For a system that names its datapath span (``DATAPATH``): every
datapath span inside the sub-window overlaps some device operation, and
the spans saw the waves the server counted, so a program that moves
its waves away from what ``instrument`` wraps fails the run.  Where
many threads run datapaths at once (a cluster's replicas), one thread's
span can overlap another's operations, so that check alone passes a
trace that lost operations or misplaced them; a system that names the
kernel each datapath call launches and waits for (``WAVE_KERNEL``) has
instead each datapath span hold the start of a launch of that kernel,
and the sub-window as many launches as spans inside it.  For a system
with no spans: device operations were seen where requests were
answered.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

clock = time.perf_counter

MARK = "perfbench.mark"
# The client's own spans, after the system's in the order an idle gap is
# put down to them.
CLIENT_SPANS = ("client.submit", "client.poll")
# How far a device operation may lie outside a datapath span on the host
# clock (the two clocks are matched at the sub-window's ends only).
SLACK_S = 0.0005
# A mark is made again until the host clock brackets it this tightly, at
# most MARK_TRIES times; the tightest bracket at each end is used.
MARK_TIGHT_S = 0.00005
MARK_TRIES = 20


class Spans:
    """Host spans ``(label, start, end)``, recorded while ``on``."""

    def __init__(self):
        self.on = False
        self.spans: List[Tuple[str, float, float]] = []

    def add(self, label: str, t0: float, t1: float) -> None:
        self.spans.append((label, t0, t1))

    def wrap(self, obj, attr: str, label: str) -> None:
        """Replace ``obj.attr`` by a wrapper that records a span around
        each call while ``on``."""
        orig = getattr(obj, attr)

        def wrapped(*args, **kwargs):
            if not self.on:
                return orig(*args, **kwargs)
            t0 = clock()
            try:
                return orig(*args, **kwargs)
            finally:
                self.spans.append((label, t0, clock()))

        setattr(obj, attr, wrapped)


class TraceResult:
    """What the traced sub-window ``[t_a, t_b]`` (host clock) saw: device
    operations ``(name, start, end)`` on the host clock, their busy
    seconds, and the host spans.  ``datapath``: the label of the system's
    datapath span (None: the system records none); ``labels``: the
    system's span labels, in the order idle gaps are put down to them;
    ``kernel``: a part of the name of the kernel every datapath call
    launches and waits for (None: the system names none)."""

    def __init__(self, t_a: float, t_b: float,
                 ops: List[Tuple[str, float, float]],
                 spans: List[Tuple[str, float, float]], cuda: bool = True,
                 datapath: Optional[str] = None,
                 labels: Tuple[str, ...] = (),
                 kernel: Optional[str] = None):
        self.t_a, self.t_b, self.cuda = t_a, t_b, cuda
        self.datapath, self.kernel = datapath, kernel
        self.gap_order = tuple(labels) + CLIENT_SPANS
        self.ops = sorted(ops, key=lambda o: o[1])
        self.spans = spans
        self.busy_intervals = _union([(s, e) for _, s, e in self.ops],
                                     t_a, t_b)
        self.busy_s = sum(e - s for s, e in self.busy_intervals)

    @property
    def window_s(self) -> float:
        return self.t_b - self.t_a

    def fault(self, waves: int, answered: int = 0) -> Optional[str]:
        """Why this trace cannot be read, or None.  ``waves``: the waves
        the server counted in the sub-window; ``answered``: the requests
        answered in it.  (Without a card no device operation is traced,
        and nothing is read from the device.)"""
        if self.datapath is None:
            if self.cuda and answered and not self.ops:
                return (f"{answered} requests answered in the sub-window, "
                        f"no device operation traced")
            return None
        paths = [(s, e) for lab, s, e in self.spans
                 if lab == self.datapath and s >= self.t_a
                 and e <= self.t_b]
        if waves >= 2 and not paths:
            return (f"the host spans saw none of the {waves} waves the "
                    f"server counted: the program's waves no longer pass "
                    f"through what the system's instrument wraps")
        if not self.cuda:
            return None
        if self.kernel is not None:
            return self._kernel_fault(paths, waves)
        missed = sum(1 for s, e in paths if not _overlaps(
            self.busy_intervals, s - SLACK_S, e + SLACK_S))
        if missed:
            outside = sum(1 for _, s, e in self.ops
                          if e <= self.t_a or s >= self.t_b)
            return (f"{missed} of {len(paths)} datapath spans ({waves} waves "
                    f"counted) overlap no device operation; the trace holds "
                    f"{len(self.ops)} device operations, {outside} of them "
                    f"outside the sub-window")
        return None

    def _kernel_fault(self, paths, waves: int) -> Optional[str]:
        """The check for a system that names its wave's kernel: a call
        launches the kernel after it starts and waits for it before it
        ends, so each datapath span holds the start of a launch, and the
        sub-window holds as many launches as spans inside it."""
        starts = sorted(s for name, s, _ in self.ops if self.kernel in name)
        missed = sum(1 for s, e in paths if not _starts_within(
            starts, s - SLACK_S, e + SLACK_S))
        launched = (bisect.bisect_right(starts, self.t_b + SLACK_S)
                    - bisect.bisect_left(starts, self.t_a - SLACK_S))
        if missed or launched < len(paths):
            return (f"{missed} of {len(paths)} datapath spans ({waves} waves "
                    f"counted) hold no launch of {self.kernel}, and the "
                    f"sub-window {launched} launches: the trace lost device "
                    f"operations or misplaced them on the host clock")
        return None

    def kernel_times(self, symbol: str) -> List[float]:
        """Durations (s) of the device operations whose name holds
        ``symbol``."""
        return [e - s for name, s, e in self.ops if symbol in name]

    def device_ops(self, top: int = 10) -> List[List]:
        """The device operations that took most time, by name."""
        tot: Dict[str, float] = {}
        for name, s, e in self.ops:
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> List[List]:
        """Idle seconds of the device, summed by what the host was doing
        in the middle of each gap."""
        tot: Dict[str, float] = {}
        edges = [self.t_a] + [x for iv in self.busy_intervals for x in iv] \
            + [self.t_b]
        by_label = {lab: sorted((s, e) for l2, s, e in self.spans
                                if l2 == lab) for lab in self.gap_order}
        for g0, g1 in zip(edges[0::2], edges[1::2]):
            if g1 <= g0:
                continue
            mid = 0.5 * (g0 + g1)
            label = next((lab for lab in self.gap_order
                          if _covers(by_label[lab], mid)), "waiting")
            tot[label] = tot.get(label, 0.0) + (g1 - g0)
        return [[n, t] for n, t in
                sorted(tot.items(), key=lambda kv: -kv[1])[:top]]


def _union(intervals, lo: float, hi: float) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _overlaps(intervals: List[Tuple[float, float]], a: float,
              b: float) -> bool:
    """Whether sorted disjoint ``intervals`` meet ``[a, b]``."""
    i = bisect.bisect_left(intervals, (a, a))
    return any(s <= b and e >= a for s, e in intervals[max(0, i - 1):i + 1])


def _starts_within(starts: List[float], a: float, b: float) -> bool:
    """Whether sorted ``starts`` hold one in ``[a, b]``."""
    i = bisect.bisect_left(starts, a)
    return i < len(starts) and starts[i] <= b


def _covers(spans: List[Tuple[float, float]], t: float) -> bool:
    i = bisect.bisect_right(spans, (t, float("inf"))) - 1
    return i >= 0 and spans[i][0] <= t <= spans[i][1]


def host_clock(marks: List[Tuple[float, float]],
               opening: List[Tuple[float, float]],
               closing: List[Tuple[float, float]]):
    """Trace microseconds -> host seconds: the line through the middles
    of the most tightly bracketed annotation at each end.  ``marks``:
    the annotations' ``(start, end)`` in the trace, in the order they
    were made; ``opening``, ``closing``: their brackets on the host
    clock, in the same order."""
    if len(marks) != len(opening) + len(closing):
        raise RuntimeError(f"the profiler holds {len(marks)} of the "
                           f"client's {len(opening) + len(closing)} "
                           f"annotations")

    def tightest(brackets, offset):
        k = min(range(len(brackets)),
                key=lambda i: brackets[i][1] - brackets[i][0])
        s, e = marks[offset + k]
        return 0.5 * (s + e), 0.5 * sum(brackets[k])
    us0, h0 = tightest(opening, 0)
    us1, h1 = tightest(closing, len(opening))
    scale = (h1 - h0) / ((us1 - us0) * 1e-6)
    return lambda us: h0 + (us - us0) * 1e-6 * scale


def _activities(cuda: bool):
    from torch.profiler import ProfilerActivity
    return [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])


class Profiler:
    """``torch.profiler`` over the traced sub-window (device operations
    only where ``cuda``); ``datapath``, ``labels`` and ``kernel`` as
    :class:`TraceResult` takes them."""

    def __init__(self, spans: Spans, cuda: bool = True,
                 datapath: Optional[str] = None,
                 labels: Tuple[str, ...] = (),
                 kernel: Optional[str] = None):
        self.spans, self.cuda = spans, cuda
        self.datapath, self.labels, self.kernel = datapath, labels, kernel
        self._prof = None

    def warm(self) -> None:
        """Start and stop the profiler once, so that its own start-up is
        set-up and not in the traced sub-window."""
        import torch
        from torch.profiler import profile
        with profile(activities=_activities(self.cuda)):
            torch.ones(1, device="cuda" if self.cuda else "cpu").add_(1)
            if self.cuda:
                torch.cuda.synchronize()

    def _marks(self) -> List[Tuple[float, float]]:
        """Annotations made until the host clock brackets one within
        ``MARK_TIGHT_S``: each one's ``(before, after)``."""
        from torch.autograd.profiler import record_function
        made = []
        for _ in range(MARK_TRIES):
            before = clock()
            with record_function(MARK):
                pass
            made.append((before, clock()))
            if made[-1][1] - before <= MARK_TIGHT_S:
                break
        return made

    def start(self) -> float:
        from torch.profiler import profile
        self._prof = profile(activities=_activities(self.cuda))
        self._prof.__enter__()
        self.spans.spans.clear()
        self.spans.on = True
        self._opening = self._marks()
        self._m0 = self._opening[-1][1]
        return self._m0

    def stop(self) -> TraceResult:
        import torch
        closing = self._marks()
        m1 = closing[0][0]
        self.spans.on = False
        if self.cuda:
            torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        ops = [(e.name, e.time_range.start, e.time_range.end)
               for e in events if str(e.device_type).endswith("CUDA")]
        marks = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == MARK)
        to_host = host_clock(marks, self._opening, closing)
        ops = [(name, to_host(s), to_host(e)) for name, s, e in ops]
        return TraceResult(self._m0, m1, ops, list(self.spans.spans),
                           cuda=self.cuda, datapath=self.datapath,
                           labels=self.labels, kernel=self.kernel)
