"""Consistent-hash stream routing — the cluster's placement invariant
(a copy of ``repro/serving/routing.py``, which is pure Python: the same
blake2b points, digest size, byte order and ``bisect_left`` lookup, so a
stream lands on the same replica name in both packages).

The scaling story of ``repro_torch.serving.cluster`` rests on ONE
invariant: every named stream is served by exactly one replica, so its
recurrent carry stays resident in that replica's state store and never
migrates across devices on the hot path (ELSA's state-residency argument,
applied at cluster scale).  This module is the routing function that
provides the invariant.

:class:`HashRing` is classic consistent hashing with virtual nodes: each
replica owns ``vnodes`` pseudo-random points on a 64-bit ring, and a
stream is served by the replica owning the first point clockwise of the
stream's own hash.  Two properties matter to the serving tier:

* **Determinism** — hashes come from ``blake2b`` over ``(seed, key)``,
  never Python's randomised ``hash()``, so the same (seed, replica set)
  routes the same stream to the same replica in every process, forever.
  A router in front of the cluster can compute placements independently.
* **Minimal disruption** — removing a replica moves ONLY the streams it
  owned (~K/N of K streams over N replicas) to their next-clockwise
  owner; adding one steals ~K/(N+1) streams from the others.  Everything
  else keeps its replica, its carry, and its numbering untouched —
  pinned property-style in ``tests/test_torch_cluster.py``.

The ring itself is a plain data structure with no locking; the cluster
layer mutates it only under its own routing lock.
"""

from __future__ import annotations

import bisect
import hashlib
from typing import Dict, FrozenSet, Hashable, Iterable, List, Tuple


class HashRing:
    """Consistent-hash ring mapping stream keys to replica names.

    ``vnodes`` virtual nodes per replica smooth the load split (64 keeps
    the per-replica share within a few percent of uniform for realistic
    replica counts); ``seed`` namespaces the hash so independent rings
    (e.g. a blue/green pair) shuffle differently.  Not thread-safe —
    callers serialise mutation (``ClusterServer`` holds its routing lock).
    """

    def __init__(self, nodes: Iterable[str] = (), *, vnodes: int = 64,
                 seed: int = 0):
        """Build a ring over ``nodes`` (each added as by :meth:`add`)."""
        if vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {vnodes}")
        self.vnodes = vnodes
        self.seed = seed
        self._points: List[Tuple[int, str]] = []   # sorted (hash, node)
        self._nodes: set = set()
        for n in nodes:
            self.add(n)

    def _hash(self, s: str) -> int:
        """Deterministic 64-bit point for ``s`` (seed-namespaced blake2b —
        stable across processes, unlike built-in ``hash``)."""
        digest = hashlib.blake2b(f"{self.seed}:{s}".encode(),
                                 digest_size=8).digest()
        return int.from_bytes(digest, "big")

    def add(self, node: str) -> None:
        """Insert a replica: ``vnodes`` points join the ring, stealing
        ~K/(N+1) streams from the existing replicas."""
        if node in self._nodes:
            raise ValueError(f"replica {node!r} is already on the ring")
        self._nodes.add(node)
        for v in range(self.vnodes):
            bisect.insort(self._points, (self._hash(f"n:{node}#{v}"), node))

    def remove(self, node: str) -> None:
        """Remove a replica: only the streams it owned move (each to its
        next-clockwise owner); every other stream's route is unchanged."""
        if node not in self._nodes:
            raise KeyError(f"replica {node!r} is not on the ring")
        self._nodes.discard(node)
        self._points = [p for p in self._points if p[1] != node]

    def route(self, key: Hashable) -> str:
        """The replica owning ``key``: the first ring point clockwise of
        the key's hash (wrapping).  Raises ``RuntimeError`` on an empty
        ring — the cluster has no healthy replica to serve the stream."""
        if not self._points:
            raise RuntimeError(
                "hash ring is empty: no replica available to route to")
        h = self._hash(f"k:{key}")
        i = bisect.bisect_left(self._points, (h, ""))
        return self._points[i % len(self._points)][1]

    def assignments(self, keys: Iterable[Hashable]) -> Dict[Hashable, str]:
        """Batch :meth:`route` — ``{key: replica}`` for capacity planning
        and the rebalance tests."""
        return {k: self.route(k) for k in keys}

    @property
    def nodes(self) -> FrozenSet[str]:
        """The replica names currently on the ring."""
        return frozenset(self._nodes)

    def __len__(self) -> int:
        """Number of replicas (not virtual nodes) on the ring."""
        return len(self._nodes)

    def __contains__(self, node: str) -> bool:
        """True when ``node`` is on the ring."""
        return node in self._nodes

    def __repr__(self) -> str:
        return (f"HashRing(nodes={sorted(self._nodes)}, "
                f"vnodes={self.vnodes}, seed={self.seed})")
