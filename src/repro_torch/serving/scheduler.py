"""Async double-buffered wave scheduler — host assembly overlapped with
device compute (a copy of ``repro/serving/scheduler.py``, which is pure
Python).

Built on the ``data/pipeline.py`` prefetch-queue pattern: a bounded
``queue.Queue`` of assembled waves decouples two threads,

  * the ASSEMBLER, which groups pending windows into fixed-size waves
    (stacking them into one contiguous ``(batch, T, M)`` array and padding
    partial waves), and
  * the COMPUTE thread, which pops waves and runs the caller's ``execute``
    hook (state gather -> device datapath -> state scatter -> results),

so the host assembles wave *N+1* while the device computes wave *N*.
Backpressure is configurable at both ends: ``max_pending`` bounds
submitted-but-unassembled windows (``submit`` blocks), ``queue_depth``
bounds assembled-but-uncomputed waves (default 2 — classic double
buffering).

Tail latency is bounded by the DEADLINE: a wave normally waits until
``batch`` windows are available (maximum device efficiency), but once the
oldest pending window has waited ``deadline_s`` the scheduler flushes a
partial wave — padded to the static shape, padding dropped — instead of
stalling a slow stream behind a full-wave quorum.  ``deadline_s=None``
waits for full waves (the strict ``Accelerator.serve`` semantics; the
final partial wave still flushes on drain/close).  Independent of the
deadline, a SATURATION flush fires when pending hits ``max_pending`` and
no full wave can be assembled (one-window-per-stream, or ``max_pending``
< ``batch``): submitters are blocked at that point, so waiting for a
quorum that cannot form would deadlock the pipeline.

OVERLOAD behaviour is opt-in via :class:`OverloadPolicy`: admission
control turns the blocking ``submit`` into a bounded-latency reject
(:class:`ServerOverloaded`) once the pending queue is saturated and the
rolling deadline-miss rate says the backlog is not clearing, and
deadline-aware load shedding drops pending windows whose wait already
exceeds ``shed_after_s`` (their deadline is hopeless; computing them
would only delay windows that can still make theirs) through the
``on_shed`` callback instead of computing them.  Both are accounted:
``stats()`` feeds the serving health snapshot.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import (Any, Callable, Deque, Dict, Hashable, List, Optional,
                    Tuple)

import numpy as np

_SENTINEL = object()


class ServerOverloaded(RuntimeError):
    """``submit`` rejected by admission control: the pending queue is
    saturated and the rolling deadline-miss rate shows the backlog is not
    clearing.  The client should back off (or route elsewhere) — blocking
    it would only add latency to a request that will miss its deadline
    anyway."""


@dataclasses.dataclass(frozen=True)
class OverloadPolicy:
    """Admission-control and load-shedding knobs (all opt-in; the default
    scheduler keeps the legacy block-on-backpressure behaviour).

    ``admission``: ``"reject"`` raises :class:`ServerOverloaded` from
    ``submit`` instead of blocking once pending is saturated AND the
    rolling deadline-miss rate is >= ``reject_miss_rate``; ``"block"``
    keeps blocking (shedding can still be on).  ``reject_miss_rate``: the
    miss-rate gate for rejection — 0.0 rejects on queue depth alone; with
    no deadline configured the miss rate is always 0.0, so any positive
    gate disables rejection.  ``shed_after_s``: a pending window that has
    already waited this long is dropped (reported through the scheduler's
    ``on_shed`` callback as an error result) rather than computed —
    deadline-aware shedding, typically a small multiple of ``deadline_s``.
    ``miss_window``: waves in the rolling deadline-miss window."""

    admission: str = "reject"
    reject_miss_rate: float = 0.0
    shed_after_s: Optional[float] = None
    miss_window: int = 64

    def __post_init__(self):
        """Validate the policy's gates and bounds."""
        if self.admission not in ("reject", "block"):
            raise ValueError(f"admission must be 'reject' or 'block', got "
                             f"{self.admission!r}")
        if not 0.0 <= self.reject_miss_rate <= 1.0:
            raise ValueError(f"reject_miss_rate must be in [0, 1], got "
                             f"{self.reject_miss_rate}")
        if self.shed_after_s is not None and self.shed_after_s <= 0:
            raise ValueError(f"shed_after_s must be > 0, got "
                             f"{self.shed_after_s}")
        if self.miss_window < 1:
            raise ValueError(f"miss_window must be >= 1, got "
                             f"{self.miss_window}")


@dataclasses.dataclass(frozen=True)
class Slot:
    """One real (non-padding) row of a wave."""

    stream_id: Hashable
    seq: int          # per-stream sequence number (the submit return value)
    sub_idx: int      # global submission index — strictly increasing across
                      # the scheduler's lifetime, orders windows ACROSS
                      # streams (end_stream tombstones compare against it)
    t_submit: float   # perf_counter when submit enqueued it


@dataclasses.dataclass(frozen=True)
class Wave:
    """One assembled wave, ready for the compute thread."""

    x: Any                                    # (batch, T, M) float32, or
                                              # the scheduler's assemble(rows)
    slots: Tuple[Slot, ...]                   # one per real row
    t_oldest: float                           # submit time of oldest window
    deadline_flush: bool                      # partial wave forced by deadline
    t_selected: float                         # the assembler picked it

    @property
    def occupancy(self) -> int:
        """Number of real (non-padding) rows."""
        return len(self.slots)


@dataclasses.dataclass(frozen=True)
class _Pending:
    stream_id: Hashable
    seq: int
    sub_idx: int
    window: np.ndarray
    t_submit: float


class WaveScheduler:
    """Threaded wave assembly/compute pipeline behind ``StreamServer``.

    ``execute(wave)`` runs on the compute thread and owns everything
    device-side; the scheduler owns grouping, padding, deadlines,
    backpressure, and the drain/close lifecycle.  With
    ``one_per_stream=True`` (stateful serving) a wave carries at most one
    window per stream — window *k+1* of a stream must see the carry
    produced by window *k*, so it waits for the next wave."""

    def __init__(self, batch: int, execute: Callable[[Wave], None], *,
                 one_per_stream: bool, deadline_s: Optional[float] = None,
                 queue_depth: int = 2, max_pending: Optional[int] = None,
                 overload: Optional[OverloadPolicy] = None,
                 on_shed: Optional[Callable[[Slot], None]] = None,
                 assemble: Optional[Callable[[List[Any]], Any]] = None):
        """``batch``: static wave size; ``queue_depth``: assembled waves the
        compute thread may fall behind by; ``max_pending``: bound on
        unassembled windows (None -> 4 * batch); ``overload``: admission/
        shedding policy (None = always block, never shed); ``on_shed``:
        called (assembler thread) once per shed window with its
        :class:`Slot` so the owner can emit an error result;
        ``assemble``: builds a wave's ``x`` from its real windows alone
        (ragged requests: ``SessionServer``'s turns); by default the
        windows are padded to ``batch`` by repeating the last and stacked
        into one ``(batch, T, M)`` array."""
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        if max_pending is not None and max_pending < 1:
            # 0 would block the first submit forever: nothing pending, so
            # the saturation flush can never fire either.
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.batch = batch
        self.deadline_s = deadline_s
        self.max_pending = 4 * batch if max_pending is None else max_pending
        self.overload = overload
        self._on_shed = on_shed
        self._execute = execute
        self._assemble = assemble
        self._one_per_stream = one_per_stream
        self._pending: List[_Pending] = []
        self._cond = threading.Condition()
        self._waveq: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._submitted = 0
        self._completed = 0
        self._draining = 0          # active flush() calls
        self._closing = False       # drain everything, then stop
        self._stop = False          # stop ASAP, abandon pending work
        self._error: Optional[BaseException] = None
        # Rolling deadline-miss window (True = the wave's oldest window
        # exceeded deadline_s end-to-end) — drives admission control.
        self._misses: Deque[bool] = collections.deque(
            maxlen=overload.miss_window if overload else 64)
        self._sheds = 0
        self._rejections = 0
        self._recoveries = 0
        #: Thread names still alive after the last close() — leaked.
        self.leaked_threads: List[str] = []
        self._assembler = threading.Thread(target=self._assemble_loop,
                                           daemon=True,
                                           name="wave-assembler")
        self._compute = threading.Thread(target=self._compute_loop,
                                         daemon=True, name="wave-compute")
        self._assembler.start()
        self._compute.start()

    # -- client side --------------------------------------------------------

    def submit(self, stream_id: Hashable, window: np.ndarray,
               alloc_seq: Callable[[], int]) -> int:
        """Enqueue one window; blocks while ``max_pending`` windows wait
        (backpressure).  Raises if the scheduler is closed or the compute
        thread has failed.

        ``alloc_seq`` is called INSIDE the critical section, immediately
        before the window joins the pending list — so the caller's
        per-stream sequence numbering and the FIFO insertion order cannot
        be reordered between concurrently submitting threads.  Returns the
        allocated sequence number.

        With a reject-mode :class:`OverloadPolicy`, a submit that would
        block on a saturated queue while the rolling deadline-miss rate is
        at or above ``reject_miss_rate`` raises :class:`ServerOverloaded`
        instead — bounded-latency admission control."""
        with self._cond:
            while (not self._closing and self._error is None
                   and len(self._pending) >= self.max_pending):
                if (self.overload is not None
                        and self.overload.admission == "reject"
                        and self._miss_rate_locked()
                        >= self.overload.reject_miss_rate):
                    self._rejections += 1
                    raise ServerOverloaded(
                        f"admission rejected: {len(self._pending)}/"
                        f"{self.max_pending} windows pending, rolling "
                        f"deadline-miss rate "
                        f"{self._miss_rate_locked():.2f} >= "
                        f"{self.overload.reject_miss_rate:.2f}")
                self._cond.wait(timeout=0.1)
            self._raise_if_dead()
            seq = alloc_seq()
            self._pending.append(_Pending(stream_id, seq, self._submitted,
                                          window, time.perf_counter()))
            self._submitted += 1
            self._cond.notify_all()
            return seq

    def submission_watermark(self) -> int:
        """Number of windows ever submitted; a window enqueued strictly
        before this call has ``sub_idx`` < the returned value."""
        with self._cond:
            return self._submitted

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: force partial waves and block until every window
        submitted before the call has been computed."""
        with self._cond:
            self._raise_if_dead()
            target = self._submitted   # every window submitted before now
            self._draining += 1
            self._cond.notify_all()
        deadline = None if timeout is None else time.perf_counter() + timeout
        try:
            with self._cond:
                while self._completed < target and self._error is None:
                    remaining = None if deadline is None \
                        else deadline - time.perf_counter()
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError(
                            f"flush timed out: {self._completed}/{target} "
                            f"windows completed")
                    self._cond.wait(timeout=remaining if remaining is not None
                                    else 0.5)
                if self._error is not None:
                    raise self._error
        finally:
            with self._cond:
                self._draining -= 1
                self._cond.notify_all()

    def close(self, abandon: bool = False,
              timeout: float = 30.0) -> List[str]:
        """Stop the pipeline.  Default: drain pending windows first (every
        submitted window gets computed); ``abandon=True`` stops ASAP and
        discards pending work (the consumer walked away).

        If the drain cannot complete within ``timeout`` — e.g. a bounded
        results queue (``max_results``) wedged by a consumer that stopped
        polling — close escalates to abandon so the worker threads exit
        instead of leaking, and returns in bounded time.  Returns the
        names of any threads STILL alive after the escalated join (also
        kept on :attr:`leaked_threads`) — an empty list is the clean
        shutdown; a non-empty one means a wave is wedged inside the
        datapath and the daemon thread will die with the process."""
        with self._cond:
            if abandon:
                self._stop = True
            self._closing = True
            self._cond.notify_all()
        self._assembler.join(timeout=timeout)
        self._compute.join(timeout=timeout)
        if self._assembler.is_alive() or self._compute.is_alive():
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._assembler.join(timeout=timeout)
            self._compute.join(timeout=timeout)
        self.leaked_threads = [t.name for t in (self._assembler,
                                                self._compute)
                               if t.is_alive()]
        return self.leaked_threads

    @property
    def error(self) -> Optional[BaseException]:
        """The compute thread's MOST RECENT unrecovered failure (re-raised
        by submit/flush and by ``StreamServer.poll``).  Cleared when a
        later wave completes cleanly — a transient fault must not poison
        every subsequent call forever (``stats()["recoveries"]`` counts
        the clears)."""
        return self._error

    def _miss_rate_locked(self) -> float:
        """Rolling deadline-miss rate; caller holds ``_cond``."""
        return (sum(self._misses) / len(self._misses)) if self._misses \
            else 0.0

    def miss_rate(self) -> float:
        """Fraction of the last ``miss_window`` waves whose oldest window
        exceeded ``deadline_s`` end-to-end (0.0 with no deadline)."""
        with self._cond:
            return self._miss_rate_locked()

    def stats(self) -> Dict[str, float]:
        """Overload/recovery counters for the serving health snapshot:
        pending depth, rolling miss rate, lifetime sheds/rejections/
        recoveries, and the error-state flag."""
        with self._cond:
            return {"pending": len(self._pending),
                    "max_pending": self.max_pending,
                    "deadline_miss_rate": self._miss_rate_locked(),
                    "sheds": self._sheds,
                    "rejections": self._rejections,
                    "recoveries": self._recoveries,
                    "dead": self._error is not None}

    @property
    def stopped(self) -> bool:
        """True once ``close(abandon=True)`` was requested — long blocking
        operations on the compute path should give up."""
        return self._stop

    def _raise_if_dead(self):
        if self._error is not None:
            raise self._error
        if self._closing:
            raise RuntimeError("scheduler is closed")

    # -- assembler thread ---------------------------------------------------

    def _select(self):
        """Pick up to ``batch`` pending windows, oldest first, at most one
        per stream when the carry demands it.  Returns (chosen, rest)."""
        chosen: List[_Pending] = []
        rest: List[_Pending] = []
        seen = set()
        for p in self._pending:
            if len(chosen) < self.batch and \
                    (not self._one_per_stream or p.stream_id not in seen):
                chosen.append(p)
                seen.add(p.stream_id)
            else:
                rest.append(p)
        return chosen, rest

    def _assemble_loop(self):
        while True:
            shed = self._shed_expired()
            if shed:
                for p in shed:
                    if self._on_shed is not None:
                        self._on_shed(Slot(p.stream_id, p.seq, p.sub_idx,
                                           p.t_submit))
                with self._cond:
                    # A shed window is accounted as completed (flush must
                    # not wait forever for work that was dropped) only
                    # AFTER its error result was emitted, so drain() sees
                    # the row.
                    self._completed += len(shed)
                    self._sheds += len(shed)
                    self._cond.notify_all()
                continue
            with self._cond:
                if self._stop:
                    break
                chosen, rest = self._select()
                now = time.perf_counter()
                full = len(chosen) == self.batch
                force = self._draining > 0 or self._closing
                deadline_hit = (self.deadline_s is not None and chosen
                                and now - chosen[0].t_submit
                                >= self.deadline_s)
                # Saturation flush: with submitters blocked on max_pending
                # and no full wave assemblable (one window per stream, or
                # max_pending < batch), waiting for quorum would deadlock —
                # ship what is eligible and free pending slots.
                saturated = len(self._pending) >= self.max_pending
                if not chosen or not (full or force or deadline_hit
                                      or saturated):
                    if self._closing and not self._pending:
                        break
                    wait = None
                    if self.deadline_s is not None and chosen:
                        wait = max(0.0, chosen[0].t_submit + self.deadline_s
                                   - now)
                    self._cond.wait(timeout=wait if wait is not None else 0.5)
                    continue
                self._pending = rest
                self._cond.notify_all()   # wake submitters (backpressure)
            wave = self._build_wave(chosen, deadline_flush=not full
                                    and deadline_hit and not force,
                                    t_selected=now)
            if not self._put_wave(wave):
                break
        self._put_wave(_SENTINEL)

    def _shed_expired(self) -> List[_Pending]:
        """Remove and return pending windows whose wait already exceeds
        the policy's ``shed_after_s`` (their deadline is hopeless —
        computing them would only delay windows that can still make
        theirs).  Empty when shedding is off."""
        if self.overload is None or self.overload.shed_after_s is None:
            return []
        with self._cond:
            if self._stop or not self._pending:
                return []
            cutoff = time.perf_counter() - self.overload.shed_after_s
            shed = [p for p in self._pending if p.t_submit <= cutoff]
            if shed:
                self._pending = [p for p in self._pending
                                 if p.t_submit > cutoff]
                self._cond.notify_all()   # wake blocked submitters
            return shed

    def _build_wave(self, chosen: List[_Pending], deadline_flush: bool,
                    t_selected: float) -> Wave:
        rows = [p.window for p in chosen]
        if self._assemble is not None:
            x = self._assemble(rows)
        else:
            # Pad the partial wave to the static shape by repeating the
            # last real window; padded rows are computed and DROPPED —
            # they are never emitted as results and never touch the
            # state store.
            rows.extend([rows[-1]] * (self.batch - len(rows)))
            x = np.stack(rows, axis=0)
        return Wave(x=x,
                    slots=tuple(Slot(p.stream_id, p.seq, p.sub_idx,
                                     p.t_submit) for p in chosen),
                    t_oldest=min(p.t_submit for p in chosen),
                    deadline_flush=deadline_flush, t_selected=t_selected)

    def _put_wave(self, item) -> bool:
        # On abandon (_stop) give up rather than block: the compute loop
        # exits on its own _stop check, so the sentinel is not needed there.
        while True:
            try:
                self._waveq.put(item, timeout=0.1)
                return True
            except queue.Full:
                if self._stop:
                    return False

    # -- compute thread -----------------------------------------------------

    def _compute_loop(self):
        while True:
            try:
                item = self._waveq.get(timeout=0.1)
            except queue.Empty:
                if self._stop:
                    return
                continue
            if item is _SENTINEL:
                return
            if not self._stop:
                # Waves keep executing even while _error is set: one
                # failed wave must not condemn every later one unseen.
                try:
                    self._execute(item)
                    with self._cond:
                        if self._error is not None:
                            # A later wave completed cleanly: the failure
                            # was transient, stop re-raising it forever.
                            self._error = None
                            self._recoveries += 1
                except BaseException as e:  # surfaced to clients
                    with self._cond:
                        self._error = e
            with self._cond:
                if self.deadline_s is not None:
                    self._misses.append(
                        time.perf_counter() - item.t_oldest
                        > self.deadline_s)
                self._completed += item.occupancy
                self._cond.notify_all()
