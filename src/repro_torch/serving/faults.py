"""Deterministic fault injection for the serving tier — the chaos harness
(counterpart of ``repro/serving/faults.py``, which is pure Python and
numpy; the draws and the host store's perturbation are copied as they
are, so one seed injects the reference's schedule).

A seedable :class:`FaultInjector` wraps the two surfaces where production
faults land:

  * the **backend execute path** (:meth:`FaultInjector.wrap_fn`): injected
    compute exceptions (a kernel launch failure, a device error) and
    latency spikes (a descheduled host thread, a contended device);
  * the **state store** (:meth:`FaultInjector.wrap_state_store`,
    :meth:`FaultInjector.wrap_device_state_store`): state *loss* (a carry
    silently dropped, as a crashed replica would) and state *corruption*
    (bit flips in the stored carry codes).

Everything is driven by one ``numpy`` PCG64 generator, drawn under the
injector's lock in a fixed order (spike then fault per attempt, lose
then corrupt per put), so a given ``(seed, rates)`` pair injects the
exact same schedule every run, attempt for attempt and put for put.  The
injector records what it did (:meth:`stats`, :attr:`corrupted_streams`,
:attr:`lost_streams`), so a test can partition streams into *survivors*
(untouched by state faults — these must stay bit-exact with the
concatenated-sequence oracle) and *casualties* (these must be *flagged*,
via ``StreamResult.state_reset`` or an error, never silently wrong).

The injector is inert by default: every rate is 0.0, and a
``StreamServer`` built without one pays no wrapping cost at all.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Hashable, List, Optional, Set

import numpy as np

from repro_torch.serving.state import StateStore, StreamState


class InjectedFault(RuntimeError):
    """The exception :class:`FaultInjector` raises on the execute path.

    A distinct type so the resilience layer (and tests) can tell an
    injected fault from a real defect — real defects must still surface."""


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Per-surface fault rates, all probabilities per *event* in [0, 1].

    ``wave_fault_rate``: chance one execute *attempt* raises
    :class:`InjectedFault` (retries draw independently, so a retried wave
    usually lands).  ``latency_spike_rate`` / ``latency_spike_s``: chance
    an attempt sleeps ``latency_spike_s`` before computing (drives the
    guard's timeout path).  ``state_loss_rate``: chance a ``put`` into the
    state store is silently dropped — the stream's next window starts from
    the reset carry exactly like an LRU eviction.  ``state_corrupt_rate``:
    chance a ``put`` stores bitwise-perturbed carry codes (the stream's
    id is recorded so tests can exclude it from bit-exactness)."""

    wave_fault_rate: float = 0.0
    latency_spike_rate: float = 0.0
    latency_spike_s: float = 0.05
    state_loss_rate: float = 0.0
    state_corrupt_rate: float = 0.0

    def __post_init__(self):
        """Validate every rate is a probability."""
        for f in ("wave_fault_rate", "latency_spike_rate",
                  "state_loss_rate", "state_corrupt_rate"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {v}")
        if self.latency_spike_s < 0:
            raise ValueError(
                f"latency_spike_s must be >= 0, got {self.latency_spike_s}")


class FaultInjector:
    """Seeded chaos source for one ``StreamServer`` run.

    One injector owns one PCG64 stream; draws are serialised under a lock
    (the execute path and the state store live on different threads), so
    the injected schedule is a pure function of ``(seed, config)`` and the
    order of events.  Construct with either a :class:`FaultConfig` or the
    equivalent keyword rates::

        inj = FaultInjector(seed=7, wave_fault_rate=0.2)
        server = StreamServer(sess, batch=8, fault_injector=inj)
    """

    def __init__(self, config: Optional[FaultConfig] = None, *,
                 seed: int = 0, **rates):
        """``config`` or keyword rates (``wave_fault_rate=...``, see
        :class:`FaultConfig`); ``seed`` fixes the injection schedule."""
        if config is not None and rates:
            raise ValueError("pass a FaultConfig or keyword rates, not both")
        self.config = config or FaultConfig(**rates)
        self.seed = seed
        self._rng = np.random.default_rng(seed)
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {
            "attempts": 0, "wave_faults": 0, "latency_spikes": 0,
            "state_losses": 0, "state_corruptions": 0}
        #: Stream ids whose stored carry was bitwise-perturbed — their
        #: outputs are expected to diverge from the oracle.
        self.corrupted_streams: Set[Hashable] = set()
        #: Stream ids that lost a carry — their next window restarts from
        #: the reset state (and must be flagged ``state_reset``).
        self.lost_streams: Set[Hashable] = set()

    def _draw(self, rate: float) -> bool:
        return rate > 0.0 and float(self._rng.random()) < rate

    # -- execute-path surface ------------------------------------------------

    def wrap_fn(self, fn: Callable, label: str = "") -> Callable:
        """Wrap a datapath callable: each call first draws a latency spike
        (sleep), then a compute fault (:class:`InjectedFault`) — in that
        fixed order, so the schedule is deterministic — then delegates.
        ``label`` names the wrapped engine in the raise."""
        cfg = self.config

        def chaotic(*args, **kwargs):
            with self._lock:
                self._counts["attempts"] += 1
                spike = self._draw(cfg.latency_spike_rate)
                fault = self._draw(cfg.wave_fault_rate)
                if spike:
                    self._counts["latency_spikes"] += 1
                if fault:
                    self._counts["wave_faults"] += 1
            if spike:
                time.sleep(cfg.latency_spike_s)
            if fault:
                raise InjectedFault(
                    f"injected compute fault"
                    f"{f' on {label}' if label else ''} "
                    f"(seed={self.seed}, attempt "
                    f"{self._counts['attempts']})")
            return fn(*args, **kwargs)

        return chaotic

    # -- state-store surface -------------------------------------------------

    def wrap_state_store(self, store: StateStore) -> "FaultyStateStore":
        """A delegating view of ``store`` whose ``put`` may drop or corrupt
        carries according to the configured rates."""
        return FaultyStateStore(store, self)

    def wrap_device_state_store(self, store) -> "FaultyDeviceStateStore":
        """The device-residency counterpart of :meth:`wrap_state_store`:
        a delegating view of a ``DeviceStateStore`` whose per-wave
        ``commit`` draws the same lose-then-corrupt schedule per stored
        row (in batch-row order) that the host store draws per ``put`` —
        so a given seed injects one identical schedule whichever side of
        the host/device boundary the carry lives on."""
        return FaultyDeviceStateStore(store, self)

    def draw_put_fault(self, stream_id: Hashable) -> str:
        """One put-side draw for ``stream_id``: ``"lose"`` (the carry is
        dropped — counted and recorded in :attr:`lost_streams`),
        ``"corrupt"`` (the stored codes must be bit-perturbed — counted
        and recorded in :attr:`corrupted_streams`), or ``"none"``.  Both
        store wrappers consume the RNG through this single method, in the
        same lose-then-corrupt order, which is what keeps the host and
        device schedules identical for a given seed."""
        with self._lock:
            lose = self._draw(self.config.state_loss_rate)
            corrupt = (not lose) and self._draw(self.config.state_corrupt_rate)
            if lose:
                self._counts["state_losses"] += 1
                self.lost_streams.add(stream_id)
                return "lose"
            if corrupt:
                self._counts["state_corruptions"] += 1
                self.corrupted_streams.add(stream_id)
                return "corrupt"
            return "none"

    def _mutate_put(self, stream_id: Hashable,
                    state: StreamState) -> Optional[StreamState]:
        """The host-store put-side injection: ``None`` means drop the put
        entirely (state loss); otherwise the possibly-corrupted state to
        store."""
        fault = self.draw_put_fault(stream_id)
        if fault == "lose":
            return None
        if fault != "corrupt":
            return state
        # XOR a low bit of every code: bitwise-plausible corruption that
        # is guaranteed to change the carry.
        return [tuple(np.bitwise_xor(np.asarray(a), 1) for a in layer)
                for layer in state]

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Injection counters (attempts seen, faults/spikes/losses/
        corruptions injected) — the ``faults.injected`` block of
        ``metrics_summary()``."""
        with self._lock:
            return dict(self._counts)


class FaultyStateStore:
    """A :class:`~repro_torch.serving.state.StateStore` view with injected
    ``put`` faults; every other method delegates verbatim.

    Kept API-compatible with ``StateStore`` (``get``/``put``/``pop``/
    ``ids``/``stats``/``__len__``/``__contains__``/``capacity``) so
    ``StreamServer`` and its tests cannot tell the difference — which is
    the point."""

    def __init__(self, store: StateStore, injector: FaultInjector):
        """Wrap ``store`` with the injector's put-side schedule."""
        self._store = store
        self._injector = injector

    @property
    def capacity(self) -> int:
        """The wrapped store's capacity."""
        return self._store.capacity

    def get(self, stream_id: Hashable) -> Optional[StreamState]:
        """Delegates to the wrapped store (reads are never faulted — a
        lost carry is modelled at put time, like a crashed replica)."""
        return self._store.get(stream_id)

    def put(self, stream_id: Hashable,
            state: StreamState) -> List[Hashable]:
        """Store the carry — unless the schedule drops it (the stream's
        existing carry is also popped, so the loss is observable) or
        corrupts it first."""
        mutated = self._injector._mutate_put(stream_id, state)
        if mutated is None:
            self._store.pop(stream_id)
            return []
        return self._store.put(stream_id, mutated)

    def pop(self, stream_id: Hashable) -> Optional[StreamState]:
        """Delegates to the wrapped store."""
        return self._store.pop(stream_id)

    def ids(self) -> List[Hashable]:
        """Delegates to the wrapped store (``reset_streams`` support)."""
        return self._store.ids()

    def stats(self) -> Dict[str, int]:
        """The wrapped store's counters."""
        return self._store.stats()

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._store


class FaultyDeviceStateStore:
    """A ``DeviceStateStore`` view with injected commit-time faults; every
    other method delegates verbatim.

    On the device path the slot kernel has already scattered every row's
    carry into the wave's new table by the time the wave commits, so
    faults land AT COMMIT, once per really-stored row in batch-row order —
    the exact points the host store draws at (one ``put`` per row, same
    order).  A ``lose`` releases the row's slot (the scattered carry
    becomes unreachable — the stream's next window restarts from the ZERO
    row, flagged ``state_reset``, exactly like the host store popping the
    carry); a ``corrupt`` XORs the low bit of every code in the row's
    table slot (``DeviceStateStore.corrupt_slot``, the same perturbation
    ``FaultyStateStore`` stores)."""

    def __init__(self, store, injector: FaultInjector):
        """Wrap ``store`` (a ``DeviceStateStore``) with ``injector``'s
        put-side schedule."""
        self._store = store
        self._injector = injector

    def commit(self, new_table, rows) -> None:
        """Commit the wave's table, then apply one put-fault draw per
        stored row (``rows``: the wave's ``(batch_row, stream_id)``
        scatters, in batch-row order)."""
        self._store.commit(new_table, rows)
        for _, sid in rows:
            fault = self._injector.draw_put_fault(sid)
            if fault == "lose":
                self._store.pop(sid)
            elif fault == "corrupt":
                self._store.corrupt_slot(sid)

    def __getattr__(self, name):
        # lookup/assign/pop/ids/read_state/seed_state/corrupt_slot/stats/
        # table/capacity/zero_slot/trash_slot delegate verbatim.
        return getattr(self._store, name)

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._store
