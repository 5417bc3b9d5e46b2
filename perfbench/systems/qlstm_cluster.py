"""``qlstm_cluster``: the paper's quantised LSTM served by ``replicas``
``StreamServer`` replicas behind ``repro_torch.serving.ClusterServer``'s
consistent-hash router, every replica on the run's one device.

A configuration file that names this system (``"system":
"qlstm_cluster"``) is a ``qlstm_server`` configuration with the number
of ``replicas`` and the ring's ``vnodes`` (virtual nodes a replica) and
``ring_seed`` (its hash namespace).  The session is built and checked
as ``qlstm_server`` builds it; ``Accelerator.replicate`` pins one copy a
replica, and each replica's server takes the mix's batch and deadline
and room for every stream.  The requests, the weights, the answer and
the counts of operations are ``qlstm_server``'s, by import.

The router is run with the ring the configuration states (replicas
``r0``, ``r1``, ...).  The client drives the cluster through
:class:`Routed`, which notes the replica that answered each result;
``checks`` compares that with the replica the stream hashes to on the
same ring, computed here from the ring's published rule
(:func:`ring_homes`), so a window served away from its stream's
replica, where the stream's carry does not live, is counted
(``misrouted``, limit 0).

``counters`` sums the replicas' lifetime counters, ``sink`` merges their
stage records (``MetricsSink.merge``) for ``program_record.py``, and
``instrument`` and ``inject`` wrap every replica as ``qlstm_server``
wraps its one server.
"""

from __future__ import annotations

import bisect
import hashlib
from array import array
from typing import Dict, Iterable, List, Sequence

import numpy as np

from perfbench.systems import qlstm_server as single
from perfbench.systems.qlstm_server import (  # noqa: F401
    DATAPATH, SPANS, WAVE_KERNEL, answer_width, dims, fmt_bits,
    make_weights, ops_per_window, payload)


def names(cfg: Dict) -> List[str]:
    """The replicas' names on the ring."""
    return [f"r{i}" for i in range(int(cfg["replicas"]))]


def ring_homes(replicas: Sequence[str], keys: Iterable, vnodes: int,
               seed: int) -> Dict:
    """``{key: replica}`` by consistent hashing: each replica owns
    ``vnodes`` points ``blake2b("{seed}:n:{replica}#{v}")`` (8 bytes, big
    endian) on a 64-bit ring, and a key goes to the owner of the first
    point at or after ``blake2b("{seed}:k:{key}")``, wrapping."""
    def point(s: str) -> int:
        return int.from_bytes(hashlib.blake2b(f"{seed}:{s}".encode(),
                                              digest_size=8).digest(), "big")
    ring = sorted((point(f"n:{r}#{v}"), r) for r in replicas
                  for v in range(vnodes))
    at = [p for p, _ in ring]
    return {k: ring[bisect.bisect_left(at, point(f"k:{k}")) % len(ring)][1]
            for k in keys}


class Routed:
    """The cluster as the client drives it (``submit``, ``poll``,
    ``close``), noting for each result polled its stream and the index
    in ``replicas`` of the replica that answered it (-1: another).
    ``ring``: the ring's ``(vnodes, seed)``."""

    def __init__(self, cluster, replicas: Sequence[str], ring):
        self.cluster, self.replicas = cluster, list(replicas)
        self.ring = ring
        self._index = {r: i for i, r in enumerate(self.replicas)}
        self.stream, self.replica = array("q"), array("b")

    @property
    def servers(self):
        """The replicas' ``StreamServer``s, in ring-name order."""
        return [self.cluster._servers[r] for r in self.replicas]

    def submit(self, stream, window) -> int:
        return self.cluster.submit(stream, window)

    def poll(self, timeout: float = 0.0):
        results = self.cluster.poll(timeout=timeout)
        for r in results:
            self.stream.append(r.stream_id)
            self.replica.append(self._index.get(r.routed_replica, -1))
        return results

    def close(self, timeout: float = 30.0) -> List[str]:
        return self.cluster.close(timeout=timeout)


def build_server(cfg: Dict, weights: Dict[str, np.ndarray], mix, device):
    """The quantised session and the cluster of its replicas on its
    device, driven through :class:`Routed`; raises when the plan or a
    replica's carry placement is not the one the configuration
    expects."""
    from repro_torch.serving import ClusterServer

    session = single.quantised_session(cfg, weights, device)
    reps = names(cfg)
    ring = (int(cfg["vnodes"]), int(cfg["ring_seed"]))
    cluster = ClusterServer(
        session.replicate(len(reps), devices=[session.device] * len(reps)),
        names=reps, vnodes=ring[0], seed=ring[1], batch=mix.batch,
        deadline_s=mix.deadline_s, max_streams=mix.streams)
    server = Routed(cluster, reps, ring)
    want = cfg["expect_plan"]["state_residency"]
    for name, srv in zip(reps, server.servers):
        if srv.state_residency != want:
            cluster.close(abandon=True)
            raise RuntimeError(f"replica {name} keeps carries on the "
                               f"{srv.state_residency}, the configuration "
                               f"expects {want}")
    return session, server


def warm(server: Routed, mix, cfg: Dict, device) -> None:
    """Each replica warmed in turn as ``qlstm_server`` warms its server
    (a full and a partial wave), then the router's streams and every
    counter reset."""
    for srv in server.servers:
        single.warm(srv, mix, cfg, device)
    server.cluster.reset_streams()
    server.cluster.reset_metrics()


def counters(server: Routed) -> Dict:
    """``qlstm_server``'s counters summed over the replicas."""
    per = [single.counters(srv) for srv in server.servers]
    return {k: sum(c[k] for c in per) for k in per[0]}


def sink(server: Routed):
    """The replicas' stage records merged into one."""
    from repro_torch.serving import MetricsSink
    return MetricsSink.merge([srv.metrics for srv in server.servers])


def checks(server: Routed) -> Dict:
    """``misrouted``: results answered by another replica than the one
    their stream hashes to (limit 0)."""
    stream = np.frombuffer(server.stream, np.int64)
    got = np.frombuffer(server.replica, np.int8)
    ids = np.unique(stream)
    home = ring_homes(server.replicas, ids.tolist(), *server.ring)
    want = np.array([server.replicas.index(home[s]) for s in ids.tolist()],
                    np.int8)
    wrong = got != want[np.searchsorted(ids, stream)]
    return {"misrouted": {"value": int(np.count_nonzero(wrong)), "limit": 0}}


def instrument(spans, server: Routed) -> None:
    """``qlstm_server``'s spans around every replica."""
    for srv in server.servers:
        single.instrument(spans, srv)


def inject(server: Routed, fault) -> None:
    """``qlstm_server``'s fault hook on every replica."""
    for srv in server.servers:
        single.inject(srv, fault)
