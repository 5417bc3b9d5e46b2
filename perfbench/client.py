"""The load generator's client loop.

It keeps one row per window submitted: its stream, its number ``k``
within the stream, when it was due, when ``submit`` was called and when
it returned, when its result was polled, and the answer.  A result ``(stream_id, seq)`` is
window ``seq`` of its stream, since the server numbers each stream's
windows from 0 in submission order and the client sends them in order.
The rows are flat arrays of numbers, so the client adds no objects for
the interpreter's garbage collector to scan while the window runs.

:class:`OpenLoop` sends each window of a schedule at its due time,
whether or not earlier ones have been answered, sleeping until the next
is due (at most ``TICK_S``), and a second thread of the client polls: it
waits in ``poll`` for the next results and stamps them as they come.  A
``submit`` that blocks under backpressure makes the sender late; latency
is counted from the due time, so the wait shows, and answers are still
polled while the sender waits.

``run_until(t_stop)`` returns at ``t_stop`` (or as the ``submit`` under
way then returns), whether or not arrivals already due are still unsent:
it looks at the clock before each ``submit``.  Above the server's
capacity ``submit`` blocks and the sender falls behind its schedule; the
arrivals it has not sent by the close are sent by the next ``run_until``
(the traced sub-window) or never, and ``drain`` waits for what was sent.
"""

from __future__ import annotations

import threading
import time
from array import array
from typing import Dict, List

import numpy as np

from perfbench.traffic import Mix, Schedule

clock = time.perf_counter
NAN = float("nan")
# The longest the sender sleeps before looking again.
TICK_S = 0.0005


class OpenLoop:
    """Arrivals of ``schedule``, due ``t0 + schedule.due``: window ``k``
    of stream ``s`` is ``windows.round(k)[s]`` (the system's
    ``payload``), and its answer ``p`` floats."""

    def __init__(self, server, mix: Mix, windows, p: int,
                 schedule: Schedule, spans=None):
        self.server, self.windows, self.p, self.spans = server, windows, p, spans
        self.stream, self.k = array("q"), array("q")
        self.due, self.sub, self.ret = array("d"), array("d"), array("d")
        self.done = array("d")
        self.y = array("f")
        self.err: Dict[int, str] = {}
        self._rows: List[List[int]] = [[] for _ in range(mix.streams)]
        self.answered = 0
        self.sched_due = schedule.due.tolist()
        self.sched_stream = schedule.stream.tolist()
        self.sched_k = schedule.k.tolist()
        self.i = 0
        self.t0 = None
        self._stop = threading.Event()
        self._poller = threading.Thread(target=self._poll_loop,
                                        name="perfbench-poller", daemon=True)

    def _submit(self, s: int, k: int, due: float) -> None:
        j = len(self.stream)
        self.stream.append(s)
        self.k.append(k)
        self.due.append(due)
        self.done.append(NAN)
        self.y.extend((NAN,) * self.p)
        self._rows[s].append(j)
        self.sub.append(clock())
        self.server.submit(s, self.windows.round(k)[s])
        self.ret.append(clock())

    def _poll_loop(self) -> None:
        """The polling thread: stamps and stores every result."""
        p = self.p
        while not self._stop.is_set():
            results = self.server.poll(timeout=0.05)
            now = clock()
            for r in results:
                j = self._rows[r.stream_id][r.seq]
                self.done[j] = now
                if r.error is None:
                    for q in range(p):
                        self.y[j * p + q] = r.y[q]
                else:
                    self.err[j] = r.error
            self.answered += len(results)
            if self.spans is not None and self.spans.on and results:
                self.spans.add("client.poll", now, clock())

    def start(self, t0: float) -> None:
        self.t0 = t0
        self._poller.start()

    def run_until(self, t_stop: float) -> None:
        due, n, t0 = self.sched_due, len(self.sched_due), self.t0
        while True:
            now = clock()
            if now >= t_stop:
                return
            i = self.i
            t_first = now
            while i < n and t0 + due[i] <= now < t_stop:
                self._submit(self.sched_stream[i], self.sched_k[i],
                             t0 + due[i])
                i += 1
                now = clock()
            if self.spans is not None and self.spans.on and i > self.i:
                self.spans.add("client.submit", t_first, now)
            self.i = i
            wake = min(t_stop, now + TICK_S,
                       t0 + due[i] if i < n else t_stop)
            time.sleep(max(0.0, wake - clock()))

    def drain(self, timeout: float) -> None:
        """Wait until every window sent has its result, or ``timeout``;
        then stop the polling thread."""
        end = clock() + timeout
        while self.answered < len(self.stream) and clock() < end:
            time.sleep(0.01)
        self._stop.set()
        self._poller.join(timeout=10)

    def arrays(self):
        """The rows as numpy arrays: stream, k, due, sub, ret, done, y
        (n, P), ok (answered without error)."""
        n = len(self.stream)
        y = np.frombuffer(self.y, np.float32).reshape(n, self.p).copy()
        ok = ~np.isnan(y).any(axis=1)
        ok[list(self.err)] = False
        return (np.frombuffer(self.stream, np.int64).copy(),
                np.frombuffer(self.k, np.int64).copy(),
                np.frombuffer(self.due).copy(), np.frombuffer(self.sub).copy(),
                np.frombuffer(self.ret).copy(), np.frombuffer(self.done).copy(),
                y, ok)
