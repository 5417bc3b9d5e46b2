"""Guarded wave execution — retry, timeout, and backend degradation
(a copy of ``repro/serving/resilience.py``, which is pure Python).

One malformed wave or one transient device error must not take down every
stream of an always-on server.  :class:`ExecutionGuard` is the layer that
makes the compute thread unkillable by ordinary failures:

  * each wave attempt runs under an optional **timeout** (a hung attempt
    is abandoned, not waited on forever);
  * a failed attempt is **retried** with exponential backoff, a bounded
    number of times per engine;
  * when the preferred engine keeps failing, the guard **degrades** down a
    ladder of bit-identical engines — ``pallas -> xla -> ref`` — and keeps
    serving.  Because the int path is verified bit-exact across all three
    (tests/test_api.py), degradation changes *latency only, never
    results*: this is the graceful-degradation lever a single-engine
    design does not have;
  * after ``promote_after`` clean waves at a degraded level, a **recovery
    probe** tries the faster engine again and promotes back on success.

The guard is datapath-agnostic: :meth:`ExecutionGuard.run` takes the
wave's ordered ``(name, callable)`` ladder and returns a
:class:`GuardOutcome` — it never raises for an attempt failure.  Only a
wave that fails on *every* level of the ladder comes back ``ok=False``;
the server then converts it into per-stream error results instead of a
dead compute thread.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class WaveTimeout(RuntimeError):
    """An execute attempt exceeded ``wave_timeout_s`` and was abandoned."""


@dataclasses.dataclass(frozen=True)
class ResiliencePolicy:
    """Knobs of the guarded execute path (docs/SERVING.md §Reliability).

    ``max_retries``: extra attempts per engine per wave (total attempts at
    one level = 1 + max_retries).  ``backoff_base_s`` * ``backoff_factor``
    ^ (attempt-1), capped at ``backoff_max_s``, is slept between attempts.
    ``wave_timeout_s``: per-attempt wall bound (None = no timeout, no
    helper thread).  ``degrade_after``: consecutive waves on which the
    preferred engine failed before the guard degrades to the next ladder
    level.  ``promote_after``: clean waves at a degraded level before a
    recovery probe re-tries the faster engine."""

    max_retries: int = 2
    backoff_base_s: float = 0.001
    backoff_factor: float = 2.0
    backoff_max_s: float = 0.100
    wave_timeout_s: Optional[float] = None
    degrade_after: int = 2
    promote_after: int = 8

    def __post_init__(self):
        """Reject nonsensical retry/backoff/threshold values."""
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got "
                             f"{self.max_retries}")
        if self.backoff_base_s < 0 or self.backoff_max_s < 0:
            raise ValueError("backoff bounds must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(f"backoff_factor must be >= 1, got "
                             f"{self.backoff_factor}")
        if self.wave_timeout_s is not None and self.wave_timeout_s <= 0:
            raise ValueError(f"wave_timeout_s must be > 0, got "
                             f"{self.wave_timeout_s}")
        if self.degrade_after < 1 or self.promote_after < 1:
            raise ValueError("degrade_after and promote_after must be >= 1")

    def backoff_s(self, attempt: int) -> float:
        """Sleep before retry ``attempt`` (1-based): exponential, capped."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** (attempt - 1))


@dataclasses.dataclass(frozen=True)
class GuardOutcome:
    """What one guarded wave execution produced.

    ``ok``: some ladder level succeeded; ``value`` is that level's return
    and ``backend`` its name.  ``ok=False`` means every level failed;
    ``error`` holds the last failure, one entry per failed attempt in
    ``attempt_errors``.  ``retries``/``timeouts`` count this wave's extra
    attempts and abandoned (timed-out) attempts; ``degraded``/``promoted``
    flag ladder moves the wave triggered."""

    ok: bool
    value: Any = None
    backend: Optional[str] = None
    retries: int = 0
    timeouts: int = 0
    degraded: bool = False
    promoted: bool = False
    error: Optional[str] = None
    attempt_errors: Tuple[str, ...] = ()


class ExecutionGuard:
    """Retry/degrade/promote state machine for the compute thread.

    Holds the current ladder level and its failure/clean-streak counters;
    :meth:`run` executes one wave through the ladder the caller passes
    (ordered fastest first — the same order every wave).  The guard never
    raises on attempt failure and is intentionally ignorant of waves,
    streams, and state — it guards *callables*, which keeps it unit-
    testable with plain lambdas."""

    def __init__(self, ladder_names: Sequence[str],
                 policy: Optional[ResiliencePolicy] = None):
        """``ladder_names``: engine names, fastest first (level 0 is the
        preferred engine); ``policy`` defaults to
        :class:`ResiliencePolicy()`."""
        if not ladder_names:
            raise ValueError("the degradation ladder cannot be empty")
        self.ladder = tuple(ladder_names)
        self.policy = policy or ResiliencePolicy()
        self._lock = threading.Lock()
        self._level = 0                 # current preferred ladder index
        self._fail_streak = 0           # consecutive waves level failed on
        self._clean_streak = 0          # consecutive clean waves at level
        self._counts: Dict[str, int] = {
            "waves": 0, "retries": 0, "timeouts": 0, "wave_failures": 0,
            "degradations": 0, "promotions": 0, "probes": 0,
            "abandoned_attempts": 0}
        self._executor: Optional[ThreadPoolExecutor] = None

    # -- introspection -------------------------------------------------------

    @property
    def backend(self) -> str:
        """Name of the engine the next wave will try first."""
        with self._lock:
            return self.ladder[self._level]

    @property
    def degraded(self) -> bool:
        """True while serving below the preferred (level-0) engine."""
        with self._lock:
            return self._level > 0

    def stats(self) -> Dict[str, Any]:
        """Lifetime guard counters plus the current ladder position —
        the ``faults.guard`` block of ``metrics_summary()``."""
        with self._lock:
            return {**self._counts, "backend": self.ladder[self._level],
                    "level": self._level, "ladder": list(self.ladder),
                    "fail_streak": self._fail_streak,
                    "clean_streak": self._clean_streak}

    # -- execution -----------------------------------------------------------

    def run(self, fns: Sequence[Tuple[str, Callable]], *args) -> GuardOutcome:
        """Execute one wave through the ladder.

        ``fns``: ordered ``(name, callable)`` pairs matching the ladder
        this guard was built with (the caller may pass a prefix-compatible
        ladder, e.g. per-session callables; names are matched by the
        guard's current level name, falling back to positional order).
        ``*args`` are passed to the chosen callable.  Never raises for an
        attempt failure — inspect the returned :class:`GuardOutcome`."""
        by_name = dict(fns)
        order = [n for n, _ in fns]
        with self._lock:
            level = self._level
            probe = (level > 0
                     and self._clean_streak >= self.policy.promote_after)
            if probe:
                self._counts["probes"] += 1
            self._counts["waves"] += 1
        start = max(0, level - 1) if probe else level
        start = min(start, len(order) - 1)

        retries = timeouts = 0
        errors: List[str] = []
        preferred_failed = False
        for idx in range(start, len(order)):
            name = order[idx]
            ok, value, att_r, att_t, errs = self._attempt_level(
                by_name[name], name, args)
            retries += att_r
            timeouts += att_t
            errors.extend(errs)
            if ok:
                return self._note_success(idx, level, probe, value, name,
                                          retries, timeouts, errors,
                                          preferred_failed)
            if idx == level:
                preferred_failed = True
        return self._note_total_failure(level, retries, timeouts, errors)

    def _attempt_level(self, fn: Callable, name: str, args):
        """Up to ``1 + max_retries`` attempts of ``fn`` with backoff;
        returns (ok, value, retries, timeouts, error strings)."""
        retries = timeouts = 0
        errors: List[str] = []
        for attempt in range(1 + self.policy.max_retries):
            if attempt > 0:
                retries += 1
                time.sleep(self.policy.backoff_s(attempt))
            try:
                return True, self._call(fn, args), retries, timeouts, errors
            except WaveTimeout as e:
                timeouts += 1
                errors.append(f"{name}: {e}")
            except Exception as e:  # noqa: BLE001 — isolate, don't die
                errors.append(f"{name}: {type(e).__name__}: {e}")
        return False, None, retries, timeouts, errors

    def _call(self, fn: Callable, args):
        """One attempt, under the policy timeout when one is set."""
        if self.policy.wave_timeout_s is None:
            return fn(*args)
        if self._executor is None:
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="wave-guard")
        fut = self._executor.submit(fn, *args)
        try:
            return fut.result(timeout=self.policy.wave_timeout_s)
        except _FutureTimeout:
            # The worker may be stuck inside the attempt: abandon the
            # whole executor (shutdown without wait) and start a fresh
            # one, so the next attempt is not queued behind a zombie.
            stale = self._executor
            self._executor = None
            stale.shutdown(wait=False)
            with self._lock:
                self._counts["abandoned_attempts"] += 1
            raise WaveTimeout(
                f"attempt exceeded wave_timeout_s="
                f"{self.policy.wave_timeout_s}") from None

    def _note_success(self, idx: int, level: int, probe: bool, value,
                      name: str, retries: int, timeouts: int,
                      errors: List[str],
                      preferred_failed: bool) -> GuardOutcome:
        degraded = promoted = False
        with self._lock:
            self._counts["retries"] += retries
            self._counts["timeouts"] += timeouts
            if probe and idx < level:
                # Recovery probe landed: promote back one level.
                self._level = idx
                self._clean_streak = 0
                self._fail_streak = 0
                self._counts["promotions"] += 1
                promoted = True
            elif preferred_failed:
                # The preferred engine failed this wave (a lower level
                # carried it).  Repeated failures degrade the preference.
                self._fail_streak += 1
                self._clean_streak = 0
                if self._fail_streak >= self.policy.degrade_after \
                        and self._level < len(self.ladder) - 1:
                    self._level = min(idx, len(self.ladder) - 1)
                    self._fail_streak = 0
                    self._counts["degradations"] += 1
                    degraded = True
            else:
                self._fail_streak = 0
                # A failed probe (the faster engine raised, the current
                # level carried the wave) resets the streak: wait another
                # promote_after clean waves before probing again.
                self._clean_streak = 0 if probe else self._clean_streak + 1
        return GuardOutcome(ok=True, value=value, backend=name,
                            retries=retries, timeouts=timeouts,
                            degraded=degraded, promoted=promoted,
                            attempt_errors=tuple(errors))

    def _note_total_failure(self, level: int, retries: int, timeouts: int,
                            errors: List[str]) -> GuardOutcome:
        with self._lock:
            self._counts["retries"] += retries
            self._counts["timeouts"] += timeouts
            self._counts["wave_failures"] += 1
            self._fail_streak += 1
            self._clean_streak = 0
        return GuardOutcome(ok=False, retries=retries, timeouts=timeouts,
                            error=errors[-1] if errors else "no attempts",
                            attempt_errors=tuple(errors))

    def close(self) -> None:
        """Release the timeout helper thread, if one was ever started."""
        if self._executor is not None:
            self._executor.shutdown(wait=False)
            self._executor = None
