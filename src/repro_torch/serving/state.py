"""Bounded per-stream recurrent carry — the serving layer's state store
(a copy of ``repro/serving/state.py``, which is pure Python and numpy).

Each live client stream owns one accelerator carry: per layer, a tuple
of the cell's ``state_arity`` int32 code vectors after the stream's last
window (the LSTM's (h, c) pair, a single h row for GRU/rGLRU — one batch
row of ``repro_torch.cells.init_state``).  The store itself is shape-agnostic:
it never inspects the arrays, so one store serves every registered cell.
The store is a bounded LRU map: the paper's deployment
target is an embedded device with fixed state memory, and the ROADMAP
scenario is "millions of users" — so the store must evict, not grow.  An
evicted stream restarts from the reset state (all-zero carry) on its next
window, exactly as if it were a new stream — and that restart is REPORTED,
not silent: the window computed from the reset carry comes
back with ``StreamResult.state_reset=True`` and bumps the
``state_resets`` counter in the metrics.  The eviction counter in
:meth:`StateStore.stats` is the capacity-planning signal to raise
``max_streams`` when resets matter.

Thread-safety: all methods take the internal lock — the store is shared
between the scheduler's compute thread (gather/scatter) and client threads
(``end_stream``).
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Dict, Hashable, List, Optional, Tuple

import numpy as np

# Per-stream carry: per layer, a tuple of the cell's ``state_arity``
# (hidden_size,) int32 code vectors (2 for the LSTM's (h, c), 1 for
# GRU/rGLRU).
StreamState = List[Tuple[np.ndarray, ...]]


class StateStore:
    """LRU map ``stream_id -> StreamState`` with a hard capacity.

    ``get`` refreshes recency; ``put`` inserts/updates and evicts the
    least-recently-used stream when over ``capacity``.  Hit/miss/eviction
    counters feed the serving metrics report."""

    def __init__(self, capacity: int = 1024):
        """``capacity``: maximum number of live stream carries (>= 1)."""
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self._states: "OrderedDict[Hashable, StreamState]" = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, stream_id: Hashable) -> Optional[StreamState]:
        """The stream's carry (refreshing its recency), or ``None`` when the
        stream is new or was evicted — the caller starts from zeros."""
        with self._lock:
            state = self._states.get(stream_id)
            if state is None:
                self.misses += 1
                return None
            self._states.move_to_end(stream_id)
            self.hits += 1
            return state

    def put(self, stream_id: Hashable,
            state: StreamState) -> List[Hashable]:
        """Store the carry after a window; evicts the LRU stream(s) if
        full.  Returns the evicted stream ids so the caller can release
        any per-stream bookkeeping of its own."""
        evicted: List[Hashable] = []
        with self._lock:
            self._states[stream_id] = state
            self._states.move_to_end(stream_id)
            while len(self._states) > self.capacity:
                victim, _ = self._states.popitem(last=False)
                self.evictions += 1
                evicted.append(victim)
        return evicted

    def pop(self, stream_id: Hashable) -> Optional[StreamState]:
        """Drop a stream's carry (explicit end-of-stream); returns it."""
        with self._lock:
            return self._states.pop(stream_id, None)

    def ids(self) -> List[Hashable]:
        """Snapshot of the live stream ids, LRU-first — the server's
        ``reset_streams()`` walks it to end every stream."""
        with self._lock:
            return list(self._states)

    def __len__(self) -> int:
        with self._lock:
            return len(self._states)

    def __contains__(self, stream_id: Hashable) -> bool:
        with self._lock:
            return stream_id in self._states

    def stats(self) -> Dict[str, int]:
        """Counters for the metrics report: live streams, capacity,
        hits/misses (carry found vs reset), and evictions."""
        with self._lock:
            return {"live_streams": len(self._states),
                    "capacity": self.capacity, "hits": self.hits,
                    "misses": self.misses, "evictions": self.evictions}
