"""Device-resident per-stream carry — the slot allocator and state table
(counterpart of ``repro/serving/device_state.py``; the table is a torch
int32 tensor on the session's device).

The host-side :class:`~repro_torch.serving.state.StateStore` ships
every stream's carry codes to the device and back on EVERY wave.  Here
the carries live in one persistent ``(max_slots + 2, L, S, H)`` int32
table on the device (``(L, S, H)`` is the cell's
``plan()['state_shape']``; ``S == 2`` (h, c) rows for the LSTM)
(``Accelerator.init_state_table``), and the host keeps only a
:class:`SlotAllocator` — an LRU map ``stream_id -> table row`` with
exactly the hit/miss/eviction accounting of the ``StateStore`` it
replaces.  Per wave the scheduler ships two (B,) int32 slot-id vectors;
the kernel (``kernels/qlstm_cell.qlstm_seq_slot``) gathers each
row's carry at t == 0 and scatters the final state at t == T-1, so no
carry array crosses the host/device boundary on the hot path.

Table row conventions (shared with the kernel and the generic adapter
``backends.common.run_slots_via_state``):

  * rows ``0 .. max_slots-1`` — live stream carries, owned by the
    allocator;
  * row ``max_slots`` (:attr:`DeviceStateStore.zero_slot`) — the RESET
    row: always all-zero, gathered by fresh/evicted/ended streams, never
    written;
  * row ``max_slots + 1`` (:attr:`DeviceStateStore.trash_slot`) — the
    TRASH row: the scatter target for padding rows, tombstoned windows,
    and same-wave eviction victims; never read.

Eviction/reset semantics are IDENTICAL to the host store: an evicted or
brand-new stream gathers the ZERO row and its first window back is
flagged ``state_reset=True``.  The stale codes left in a freed slot are
unreachable — a returning stream misses in the allocator before it could
ever gather them, and the slot's next owner overwrites them at its first
scatter.

The only time a carry crosses back to the host is PLANNED stream
movement: :meth:`DeviceStateStore.read_state` /
:meth:`DeviceStateStore.seed_state` (``serving/cluster.py`` uses them to
hand a draining replica's streams to their new homes warm).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.serving.state import StreamState


class SlotAllocator:
    """LRU map ``stream_id -> slot id`` over ``capacity`` device-table rows.

    The host half of the device-resident state store: it decides WHICH
    table row each stream's carry occupies, with the exact semantics of
    ``StateStore`` — :meth:`lookup` is ``get`` (recency refresh,
    hit/miss counters), :meth:`assign` is ``put`` (insert or refresh,
    LRU eviction when full), :meth:`release` is ``pop``.  Slot ids are
    unique among live streams; released slots are reused (LIFO) before
    the high-water mark grows, so a bursty tenancy pattern touches the
    fewest distinct table rows.

    NOT thread-safe on its own — :class:`DeviceStateStore` serialises
    access under its lock, exactly like ``StateStore`` does internally."""

    def __init__(self, capacity: int = 1024):
        """``capacity``: number of live stream slots (>= 1)."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._slots: "OrderedDict[Hashable, int]" = OrderedDict()
        self._free: List[int] = []      # released slots, reused LIFO
        self._next = 0                  # high-water mark of slots ever used
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def lookup(self, stream_id: Hashable) -> Optional[int]:
        """The stream's slot (refreshing its recency), or ``None`` when
        the stream is new or was evicted — the caller gathers the ZERO
        row.  Mirrors ``StateStore.get``, counters included."""
        slot = self._slots.get(stream_id)
        if slot is None:
            self.misses += 1
            return None
        self._slots.move_to_end(stream_id)
        self.hits += 1
        return slot

    def assign(self, stream_id: Hashable) -> Tuple[int, List[Hashable]]:
        """The slot the stream's next scatter should target, allocating
        one if needed; returns ``(slot, evicted_ids)``.  Mirrors
        ``StateStore.put``: an existing stream keeps its slot (recency
        refreshed); a new stream takes a freed slot, a never-used slot,
        or — when all ``capacity`` slots are live — the LRU victim's
        (the victim is evicted and returned so the caller can release its
        bookkeeping and redirect any same-wave scatter to TRASH)."""
        if stream_id in self._slots:
            self._slots.move_to_end(stream_id)
            return self._slots[stream_id], []
        evicted: List[Hashable] = []
        if self._free:
            slot = self._free.pop()
        elif self._next < self.capacity:
            slot = self._next
            self._next += 1
        else:
            victim, slot = self._slots.popitem(last=False)
            self.evictions += 1
            evicted.append(victim)
        self._slots[stream_id] = slot
        return slot, evicted

    def release(self, stream_id: Hashable) -> Optional[int]:
        """Free a stream's slot (end-of-stream / state loss); returns the
        slot or ``None``.  Mirrors ``StateStore.pop``."""
        slot = self._slots.pop(stream_id, None)
        if slot is not None:
            self._free.append(slot)
        return slot

    def slot_of(self, stream_id: Hashable) -> Optional[int]:
        """Peek at a stream's slot WITHOUT touching recency or counters
        (for state read-back)."""
        return self._slots.get(stream_id)

    @property
    def high_water(self) -> int:
        """Distinct slots ever handed out — the reuse property tests pin
        that this never exceeds the peak number of live streams."""
        return self._next

    def live(self) -> Dict[Hashable, int]:
        """Snapshot of the live ``stream_id -> slot`` map, LRU-first."""
        return dict(self._slots)

    def __len__(self) -> int:
        return len(self._slots)

    def __contains__(self, stream_id: Hashable) -> bool:
        return stream_id in self._slots


class DeviceStateStore:
    """The device-resident replacement for ``StateStore``: a
    :class:`SlotAllocator` plus the accelerator-resident state table.

    API-compatible with ``StateStore`` where the serving layer needs it
    (``pop`` / ``stats`` / ``__len__`` / ``__contains__`` / ``capacity``),
    plus the slot surface the device hot path runs on (:meth:`lookup` /
    :meth:`assign` / :meth:`commit`) and the planned-movement surface
    (:meth:`read_state` / :meth:`seed_state`).  All methods take the
    internal lock; multi-op wave transactions are additionally serialised
    by the server's own lock, like the host store's gather/scatter."""

    def __init__(self, session, capacity: int = 1024):
        """``session``: the (quantised) ``Accelerator`` whose device owns
        the table; ``capacity``: live stream slots (the ``max_streams``
        serving knob)."""
        self.capacity = capacity
        self._alloc = SlotAllocator(capacity)
        self._model = session.model
        #: The persistent (capacity + 2, L, S, H) int32 carry table, at one
        #: address for the store's life: every write (:meth:`commit`,
        #: :meth:`seed_state`, :meth:`corrupt_slot`) is made in place, so
        #: a CUDA graph that reads it stays valid.  It never visits the
        #: host on the hot path.
        self.table = session.init_state_table(capacity)
        self._lock = threading.Lock()

    @property
    def zero_slot(self) -> int:
        """Table row fresh/reset streams gather from (always zero)."""
        return self.capacity

    @property
    def trash_slot(self) -> int:
        """Table row retired/padding rows scatter to (never read)."""
        return self.capacity + 1

    # -- wave surface (serialised by the server's lock) ----------------------

    def lookup(self, stream_id: Hashable) -> Optional[int]:
        """GET-phase slot lookup — ``StateStore.get`` semantics."""
        with self._lock:
            return self._alloc.lookup(stream_id)

    def assign(self, stream_id: Hashable) -> Tuple[int, List[Hashable]]:
        """PUT-phase slot assignment — ``StateStore.put`` semantics."""
        with self._lock:
            return self._alloc.assign(stream_id)

    def commit(self, new_table, rows: List[Tuple[int, Hashable]]) -> None:
        """Copy a successful wave's table into the live table, in place
        (one device-to-device copy of the whole table: a copy of only the
        scattered rows takes an index kernel whose variant depends on the
        row count, and a variant's first use stalled a wave for tens to
        hundreds of milliseconds on an H100).  ``rows`` lists the wave's real
        scatters as ``(batch_row, stream_id)`` — unused here; it is the
        unit a fault-injection wrapper draws per-put faults over."""
        with self._lock:
            self.table.copy_(new_table)

    def pop(self, stream_id: Hashable) -> Optional[int]:
        """Release a stream's slot (end-of-stream, failed wave, shed,
        injected loss).  The freed row's stale codes are unreachable: the
        stream now misses in the allocator, and the slot's next owner
        overwrites them at its first scatter.  Returns the freed slot."""
        with self._lock:
            return self._alloc.release(stream_id)

    def ids(self) -> List[Hashable]:
        """Snapshot of the stream ids currently holding slots, LRU-first —
        the server's ``reset_streams()`` walks it to end every stream."""
        with self._lock:
            return list(self._alloc.live())

    # -- planned movement (cluster drain/rebalance) --------------------------

    def read_state(self, stream_id: Hashable) -> Optional[StreamState]:
        """Read a stream's carry BACK to the host — the one sanctioned
        host/device state transfer, used only on planned stream movement
        (a cluster drain).  Returns per layer a tuple of
        the cell's ``state_arity`` int32 rows (``[(h, c), ...]`` for the
        LSTM), or ``None`` for an unknown stream."""
        with self._lock:
            slot = self._alloc.slot_of(stream_id)
            table = self.table
        if slot is None:
            return None
        row = table[slot].cpu().numpy()            # (L, S, H) — one stream
        return [tuple(row[li, s].copy() for s in range(row.shape[1]))
                for li in range(row.shape[0])]

    def seed_state(self, stream_id: Hashable,
                   state: StreamState) -> List[Hashable]:
        """Plant a host-side carry into the table (the destination half of
        a warm handoff): assigns a slot and writes the row.  Returns any
        ids the assignment evicted."""
        with self._lock:
            slot, evicted = self._alloc.assign(stream_id)
            row = np.stack([np.stack([np.asarray(a) for a in layer])
                            for layer in state]).astype(np.int32)
            self.table[slot] = torch.as_tensor(row, device=self.table.device)
        return evicted

    # -- fault-injection surface ---------------------------------------------

    def corrupt_slot(self, stream_id: Hashable) -> bool:
        """XOR the low bit of every code in the stream's table row — the
        device form of the host store's put-corruption (same perturbation
        as ``FaultInjector._mutate_put``), on the table's device.  Returns
        False for an unknown stream (nothing to corrupt).

        Made in place under the lock, like every write to the live table:
        the slot datapath only reads the table it is handed (every
        attempt, retries and abandoned ones included, writes its own
        output table), and the live table changes only between waves."""
        with self._lock:
            slot = self._alloc.slot_of(stream_id)
            if slot is None:
                return False
            self.table[slot].bitwise_xor_(1)
            return True

    # -- StateStore-compatible reporting ------------------------------------

    def stats(self) -> Dict[str, int]:
        """The ``StateStore`` counter block (live_streams, capacity,
        hits, misses, evictions) plus ``residency``/``slot_high_water``
        — the serving metrics report is schema-compatible either way."""
        with self._lock:
            return {"live_streams": len(self._alloc),
                    "capacity": self.capacity,
                    "hits": self._alloc.hits,
                    "misses": self._alloc.misses,
                    "evictions": self._alloc.evictions,
                    "residency": "device",
                    "slot_high_water": self._alloc.high_water}

    def __len__(self) -> int:
        with self._lock:
            return len(self._alloc)

    def __contains__(self, stream_id: Hashable) -> bool:
        with self._lock:
            return stream_id in self._alloc

    def __getattr__(self, name):
        raise AttributeError(
            f"DeviceStateStore has no attribute {name!r}; host-store-only "
            f"surfaces (get/put of carry arrays) do not exist on the "
            f"device path — pin ServingConfig(state_residency='host') for "
            f"host-store semantics")
