"""``ClusterServer`` — multi-replica serving with consistent-hash stream
routing (counterpart of ``repro/serving/cluster.py``; each replica is a
``StreamServer`` over a session pinned to one ``torch.device`` by
``Accelerator.replicate``).

One ``StreamServer`` is one device's worth of throughput (the paper's §6
point: 32 873 samples/s on one FPGA).  The ROADMAP's millions-of-users
scenario scales OUT: N replica servers, each pinned to its own device
(``Accelerator.replicate`` / ``launch.mesh.serving_devices``), each owning
its own scheduler threads, state store, and overload policy — and a
routing layer in front that keeps the one invariant scale-out must not
break: **a stream's (h, c) carry never migrates across replicas on the
hot path**.  ELSA's state-residency argument at cluster scale — recurrent
state stays next to the compute that consumes it.

The invariant comes from :class:`~repro_torch.serving.routing.HashRing`
(consistent hashing with virtual nodes): every named stream hashes to
exactly one replica, so all its windows execute there and its carry stays
in that replica's ``StateStore``.  ``StreamResult.routed_replica`` carries
the replica name out, so the invariant is testable per row.

Deployment shape::

    replicas = acc.replicate(4)               # one session per device
    cluster = ClusterServer(replicas, batch=64, deadline_s=0.005)
    cluster.submit("sensor-17", window)       # routed by consistent hash
    for r in cluster.poll(timeout=0.1):       # r.routed_replica pins it
        route(r.stream_id, r.y)
    cluster.metrics_summary()                 # aggregate + per-replica
    cluster.remove_replica("r3")              # drain: ~K/N streams move
    cluster.close()

The cluster layer COMPOSES the per-replica machinery rather than
reimplementing it: admission control and load shedding run per replica
(``OverloadPolicy``), guarded execution and backend degradation run per
replica (``ExecutionGuard``), and the front door adds only what needs the
global view — routing, failover off a replica whose ``health()`` reports
``failed``, aggregate metrics (``MetricsSink.merge``), and the
drain/rebalance path whose ring-shrink moves only the leaving replica's
~K/N streams (their carries reset with ``state_reset=True`` provenance;
every other stream is untouched).

Re-route semantics (rebalance, failover, or a ring change): a moved
stream RESTARTS on its new replica — sequence numbering from 0 and the
zero reset carry, with its first window flagged ``state_reset=True``
because the history was real.  This mirrors the ``StreamServer`` LRU
eviction semantics exactly: a flagged reset, never a silently wrong
continuation from a stale carry left on the old device.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serving.metrics import MetricsSink
from repro_torch.serving.routing import HashRing
from repro_torch.serving.scheduler import ServerOverloaded
from repro_torch.serving.server import (ServingConfig, StreamResult,
                                        StreamServer, _params_equal)

# faults keys summed across replicas by metrics_summary (deadline_miss_rate
# is taken as the worst replica's instead; backend/degraded summarised).
_FAULT_SUM_KEYS = ("retries", "timeouts", "wave_failures", "degradations",
                   "promotions", "probes", "sheds", "rejections",
                   "recoveries", "state_resets", "stream_errors")


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """Knobs of the cluster tier (per-replica behaviour stays in the
    embedded :class:`ServingConfig` — one config, applied to every
    replica's ``StreamServer``).

    ``serving``: the per-replica streaming config (batch, deadline,
    backpressure, resilience, overload — docs/SERVING.md).  ``vnodes`` /
    ``seed``: the consistent-hash ring's smoothing and hash namespace
    (``routing.HashRing``).  ``failover``: when a replica's ``health()``
    reports ``failed`` at submit time, take it out of the ring and
    re-route the stream to the next replica (flagged ``state_reset``)
    instead of re-raising the replica's error to the client; False
    propagates the error and leaves ring surgery to the operator
    (``mark_unhealthy`` / ``remove_replica``)."""

    serving: ServingConfig = ServingConfig()
    vnodes: int = 64
    seed: int = 0
    failover: bool = True

    def __post_init__(self):
        """Reject nonsense at construction (the ring checks vnodes too,
        but failing here names the config field)."""
        if self.vnodes < 1:
            raise ValueError(f"vnodes must be >= 1, got {self.vnodes}")


class ClusterServer:
    """Consistent-hash front door over N per-device ``StreamServer``
    replicas (see the module docstring for the deployment shape and the
    re-route semantics).

    Each replica runs its OWN scheduler threads — wave assembly and
    device compute proceed in parallel across replicas, which is where
    the aggregate-throughput scaling comes from (the single
    ``StreamServer`` multi-session mode only round-robins one compute
    thread)."""

    def __init__(self, replicas: Sequence, config: Optional[ClusterConfig]
                 = None, *, names: Optional[Sequence[str]] = None,
                 **overrides):
        """``replicas``: ``Accelerator`` sessions of ONE configuration
        sharing one set of weights — typically ``Accelerator.replicate``'s
        output, each pinned to its own device.  ``names`` labels them on
        the ring (default ``r0..rN-1``).  ``config`` or keyword overrides
        set :class:`ClusterConfig`; override keys that are not cluster
        fields fall through to the per-replica :class:`ServingConfig`
        (``batch=``, ``deadline_s=``, ...)."""
        replicas = list(replicas)
        if not replicas:
            raise ValueError("need at least one replica session")
        for s in replicas[1:]:
            if s.model != replicas[0].model:
                raise ValueError(
                    "cluster replicas must share one configuration; got "
                    f"models {s.model} != {replicas[0].model}")
            if not _params_equal(s.params, replicas[0].params):
                raise ValueError(
                    "cluster replicas must share one set of weights; the "
                    "given sessions' params differ")
        cfg = config or ClusterConfig()
        if overrides:
            cluster_keys = {f.name for f in dataclasses.fields(ClusterConfig)}
            own = {k: v for k, v in overrides.items() if k in cluster_keys}
            rest = {k: v for k, v in overrides.items()
                    if k not in cluster_keys}
            if rest:
                own["serving"] = dataclasses.replace(cfg.serving, **rest)
            cfg = dataclasses.replace(cfg, **own)
        self.config = cfg
        if names is None:
            names = [f"r{i}" for i in range(len(replicas))]
        if len(names) != len(replicas) or len(set(names)) != len(names):
            raise ValueError(
                f"names must be unique, one per replica; got {names!r} for "
                f"{len(replicas)} replicas")
        self._servers: Dict[str, StreamServer] = {}
        for name, sess in zip(names, replicas):
            self._servers[name] = StreamServer(sess, cfg.serving)
        self._ring = HashRing(names, vnodes=cfg.vnodes, seed=cfg.seed)
        self._lock = threading.Lock()
        # Routing state, all under _lock:
        #   _route[sid]        -> replica currently serving the stream
        #   _hist[sid]         -> windows ever submitted for the stream
        #   _reset_pending[sid] -> replica whose FIRST result for the
        #                          stream must be flagged state_reset (the
        #                          stream was moved there with history)
        self._route: Dict[Hashable, str] = {}
        self._hist: Dict[Hashable, int] = {}
        self._reset_pending: Dict[Hashable, str] = {}
        self._unhealthy: Dict[str, str] = {}   # name -> reason
        self._stash: List[StreamResult] = []   # results of removed replicas
        self._closed = False

    # -- routing ------------------------------------------------------------

    def replica_for(self, stream_id: Hashable) -> str:
        """The replica the NEXT window of ``stream_id`` will route to —
        what an external load balancer would compute from the same ring."""
        with self._lock:
            return self._ring.route(stream_id)

    @property
    def replicas(self) -> List[str]:
        """Replica names currently serving (on the ring)."""
        with self._lock:
            return sorted(self._ring.nodes)

    def _routed_submit(self, stream_id: Hashable, window) -> int:
        """Route + submit with the move/failover bookkeeping.  The lock is
        NEVER held across the inner (possibly blocking) ``submit`` —
        otherwise a backpressured replica would wedge ``poll`` and
        deadlock the whole cluster."""
        for _ in range(len(self._servers) + 1):
            with self._lock:
                target = self._ring.route(stream_id)
                prev = self._route.get(stream_id)
                hist = self._hist.get(stream_id, 0)
                moved = prev is not None and prev != target
                server = self._servers[target]
                old = self._servers.get(prev) if moved else None
            if moved and old is not None:
                # The old replica's carry is stale the moment the stream
                # moves; end_stream is in-flight-safe (tombstone watermark)
                # so a window still queued there cannot resurrect it.
                old.end_stream(stream_id)
            try:
                seq = server.submit(stream_id, window)
            except ServerOverloaded as e:
                # Per-replica admission control IS the cluster's front
                # door: the stream's replica is saturated, and routing it
                # elsewhere would break the state-locality invariant.
                raise ServerOverloaded(f"replica {target!r}: {e}") from None
            except ValueError:
                raise          # malformed window: the client's bug, not
                               # the replica's health
            except Exception as e:
                with self._lock:
                    gone = target not in self._ring
                    ring_len = len(self._ring)
                if gone and ring_len >= 1:
                    continue   # replica left the ring mid-submit
                               # (remove/mark race): re-route, don't raise
                if (self.config.failover and ring_len > 1
                        and server.health()["status"] == "failed"):
                    self.mark_unhealthy(target, reason=f"{type(e).__name__}:"
                                        f" {e}")
                    continue   # re-route on the shrunk ring
                raise
            with self._lock:
                if moved or (prev is None and hist > 0):
                    # Moved with real history: the first window at the new
                    # home computes from the zero reset carry — flag it.
                    self._reset_pending[stream_id] = target
                self._route[stream_id] = target
                self._hist[stream_id] = hist + 1
            return seq
        raise RuntimeError(
            "no healthy replica accepted the stream after exhausting the "
            f"ring (unhealthy: {sorted(self._unhealthy)})")

    # -- client surface -----------------------------------------------------

    def submit(self, stream_id: Hashable, window) -> int:
        """Enqueue one (T, M) float window for ``stream_id`` on its ring
        replica; returns the stream's sequence number AT THAT REPLICA
        (numbering restarts from 0 when a rebalance moves the stream —
        the flagged-reset semantics in the module docstring).  Raises
        ``ServerOverloaded`` when the stream's replica rejects under its
        ``OverloadPolicy``; with ``failover`` a replica whose ``health()``
        is ``failed`` is removed from the ring and the stream re-routed
        instead of surfacing the replica's error."""
        if self._closed:
            raise RuntimeError("cluster is closed")
        return self._routed_submit(stream_id, window)

    def poll(self, timeout: float = 0.0) -> List[StreamResult]:
        """Completed rows from every replica, each stamped with the
        replica name in ``routed_replica`` (plus anything stashed by
        ``remove_replica``).  With ``timeout`` > 0, waits up to that long
        for the first batch."""
        end = time.perf_counter() + timeout
        while True:
            out: List[StreamResult] = []
            with self._lock:
                out.extend(self._stash)
                self._stash.clear()
                servers = list(self._servers.items())
            for name, srv in servers:
                out.extend(self._translate(name, r) for r in srv.poll())
            if out:
                return out
            remaining = end - time.perf_counter()
            if remaining <= 0:
                return out
            time.sleep(min(remaining, 0.02))

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier across every replica: all windows submitted before the
        call are computed when it returns."""
        with self._lock:
            servers = list(self._servers.values())
        for srv in servers:
            srv.flush(timeout=timeout)

    def drain(self, timeout: Optional[float] = None) -> List[StreamResult]:
        """``flush`` then collect everything outstanding."""
        self.flush(timeout=timeout)
        return self.poll()

    def end_stream(self, stream_id: Hashable) -> None:
        """Forget a stream cluster-wide: its carry on its replica and the
        cluster's routing bookkeeping — the next window under the same id
        is a brand-new stream."""
        with self._lock:
            name = self._route.pop(stream_id, None)
            self._hist.pop(stream_id, None)
            self._reset_pending.pop(stream_id, None)
            server = self._servers.get(name) if name is not None else None
        if server is not None:
            server.end_stream(stream_id)

    def close(self, abandon: bool = False,
              timeout: float = 30.0) -> List[str]:
        """Stop every replica (drain first unless ``abandon``).  Returns
        leaked thread names across all replicas (empty = clean)."""
        self._closed = True
        leaked: List[str] = []
        with self._lock:
            servers = list(self._servers.items())
        for name, srv in servers:
            leaked.extend(f"{name}:{t}"
                          for t in srv.close(abandon=abandon,
                                             timeout=timeout))
        return leaked

    def __enter__(self) -> "ClusterServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(abandon=exc_type is not None)

    # -- membership / rebalance ---------------------------------------------

    def add_replica(self, session, name: Optional[str] = None) -> str:
        """Grow the cluster: ``session`` (a replica of the same weights,
        ideally device-pinned) joins the ring under ``name``.  ~K/(N+1)
        existing streams re-route to it lazily — each moves on its next
        submit, restarting with ``state_reset=True`` provenance; the rest
        never notice."""
        with self._lock:
            ref = next(iter(self._servers.values()), None)
            if name is None:
                i = len(self._servers) + len(self._unhealthy)
                while f"r{i}" in self._servers or f"r{i}" in self._unhealthy:
                    i += 1
                name = f"r{i}"
            if name in self._servers or name in self._unhealthy:
                raise ValueError(f"replica name {name!r} already in use")
        if ref is not None:
            sess0 = ref._sessions[0]
            if session.model != sess0.model \
                    or not _params_equal(session.params, sess0.params):
                raise ValueError(
                    "new replica must share the cluster's configuration "
                    "and weights")
        server = StreamServer(session, self.config.serving)
        with self._lock:
            self._servers[name] = server
            self._ring.add(name)
        return name

    def remove_replica(self, name: str, abandon: bool = False,
                       timeout: Optional[float] = 30.0) -> List[Hashable]:
        """Drain ``name`` out of the cluster: the ring shrinks FIRST (new
        windows re-route), its in-flight windows are flushed and their
        results stashed for the next ``poll``, and the replica's server is
        closed.  Returns the ids of the streams that lose their home —
        only ~K/N of the cluster's streams (the consistent-hash guarantee;
        everything else keeps replica, carry, and numbering).

        What a moved stream keeps depends on where its carry lived.  With
        HOST-resident state it restarts cold: ``state_reset=True``
        provenance on its first window at the new replica.  With
        DEVICE-resident state (``state_residency='device'``/``auto`` on a
        pallas plan) a planned drain performs a WARM HANDOFF: after the
        flush, each moved stream's carry is read back from the draining
        replica's device table (the one sanctioned host/device state
        transfer) and seeded into its new ring home, so its recurrence
        continues bit-exactly — no reset, no flag (its per-replica seq
        still restarts at 0).  ``abandon=True`` skips drain AND handoff
        (replica died; pending windows and device-resident carries are
        lost, and the moved streams restart cold with flagged resets).
        Call with the moved streams quiescent — windows submitted for
        them mid-drain race the handoff, exactly like they race the cold
        path's re-route."""
        with self._lock:
            if name not in self._servers:
                raise KeyError(f"no replica named {name!r}")
            if name in self._ring:
                self._ring.remove(name)
            if len(self._ring) == 0 and not self._closed:
                # Undo: a cluster with work coming must keep one replica.
                self._ring.add(name)
                raise RuntimeError(
                    "cannot remove the last healthy replica; close() the "
                    "cluster instead")
            server = self._servers[name]
        if not abandon:
            server.flush(timeout=timeout)
        stashed = [self._translate(name, r) for r in server.poll()]
        with self._lock:
            moved = [sid for sid, rname in self._route.items()
                     if rname == name]
        handoff: Dict[Hashable, object] = {}
        if not abandon and server.state_residency == "device":
            for sid in moved:
                st = server.read_stream_state(sid)
                if st is not None:
                    handoff[sid] = st
        server.close(abandon=True)
        seeds: List[Tuple[str, Hashable]] = []
        with self._lock:
            self._stash.extend(stashed)
            del self._servers[name]
            self._unhealthy.pop(name, None)
            for sid in moved:
                if sid in handoff:
                    # Re-home the route NOW: the next submit sees
                    # prev == target, so no reset flag — the seeded carry
                    # makes the continuation real, not silent.
                    dest = self._ring.route(sid)
                    self._route[sid] = dest
                    seeds.append((dest, sid))
                else:
                    del self._route[sid]   # next submit re-routes + flags
            dest_servers = {d: self._servers[d] for d, _ in seeds}
        # Seed outside the cluster lock: seed_stream_state takes the
        # destination server's own locks (same ordering rule as
        # mark_unhealthy's end_stream calls).
        for dest, sid in seeds:
            dest_servers[dest].seed_stream_state(sid, handoff[sid])
        return moved

    def mark_unhealthy(self, name: str, reason: str = "operator") -> None:
        """Take ``name`` out of the ring without closing it: its streams
        re-route (flagged resets) while the replica's server stays up so
        in-flight results still drain through ``poll``.  Failover calls
        this when ``health()`` reports ``failed``."""
        with self._lock:
            if name in self._ring:
                if len(self._ring) == 1:
                    raise RuntimeError(
                        "cannot mark the last ring replica unhealthy")
                self._ring.remove(name)
            self._unhealthy[name] = reason
            server = self._servers.get(name)
            moved = [s for s, r in self._route.items() if r == name]
            for sid in moved:
                del self._route[sid]
        # End the moved streams ON the sidelined server (outside the
        # cluster lock — end_stream takes the server's own locks): its
        # stale carries and seq numbering must not survive, or a later
        # restore_replica would resume a moved-away stream from them with
        # a non-zero seq that defeats the state_reset provenance flag.
        if server is not None:
            for sid in moved:
                server.end_stream(sid)

    def restore_replica(self, name: str) -> None:
        """Return a replica marked unhealthy to the ring (it recovered);
        streams that hash to it move back on their next submit, restarting
        with flagged resets like any other move."""
        with self._lock:
            if name not in self._servers:
                raise KeyError(f"no replica named {name!r}")
            self._unhealthy.pop(name, None)
            if name not in self._ring:
                self._ring.add(name)

    # -- results ------------------------------------------------------------

    def _translate(self, name: str, r: StreamResult) -> StreamResult:
        """Stamp a replica's row with its name and apply the cluster's
        move provenance: the first (seq 0) result of a stream that moved
        here WITH history is flagged ``state_reset`` even though the
        replica itself saw a brand-new stream."""
        reset = r.state_reset
        with self._lock:
            if r.seq == 0 and self._reset_pending.get(r.stream_id) == name:
                reset = True
                del self._reset_pending[r.stream_id]
        return dataclasses.replace(r, routed_replica=name,
                                   state_reset=reset)

    # -- metrics ------------------------------------------------------------

    def warmup(self, window) -> None:
        """Compile every replica's datapath outside the measured interval:
        one synthetic window through EACH replica (routing would only
        cover the replicas the warmup ids happen to hash to), then reset
        the metrics."""
        with self._lock:
            servers = list(self._servers.items())
        for name, srv in servers:
            wid = f"__warmup_{name}"
            srv.submit(wid, window)
            srv.drain()
            srv.end_stream(wid)
        self.reset_metrics()

    def reset_metrics(self) -> None:
        """Fresh measurement interval on every replica."""
        with self._lock:
            servers = list(self._servers.values())
        for srv in servers:
            srv.reset_metrics()

    def reset_streams(self) -> None:
        """Forget every stream on every replica AND the router's
        per-stream bookkeeping (route affinity, history, pending reset
        flags) — the cluster form of ``StreamServer.reset_streams``, used
        by the scenario harness's short-run reset.  Replicas, their
        compiled sessions, and the hash ring survive; undelivered results
        of removed replicas (the stash) are NOT dropped.  Call it
        quiescent (between submission rounds), not concurrently with
        ``submit``."""
        with self._lock:
            servers = list(self._servers.values())
        for srv in servers:
            srv.reset_streams()
        with self._lock:
            self._route.clear()
            self._hist.clear()
            self._reset_pending.clear()

    def metrics_summary(self) -> Dict:
        """The cluster report: the aggregate block a single server would
        produce — merged rolling-window percentiles and cluster-wide
        samples/s via :meth:`MetricsSink.merge`, fault counters summed —
        plus ``replicas`` (the per-replica ``metrics_summary()``
        breakdown), ``samples_per_s_sum`` (sum of per-replica rates), and
        the ``ring`` routing block."""
        with self._lock:
            servers = dict(self._servers)
            ring_nodes = sorted(self._ring.nodes)
            unhealthy = dict(self._unhealthy)
            n_routed = len(self._route)
        per = {name: srv.metrics_summary() for name, srv in servers.items()}
        merged = MetricsSink.merge([srv.metrics for srv in servers.values()])
        s = merged.summary()
        s["replicas"] = per
        s["sessions"] = len(servers)
        s["stateful"] = self.config.serving.stateful
        s["samples_per_s_sum"] = float(sum(p.get("samples_per_s", 0.0)
                                           for p in per.values()))
        s["ring"] = {"replicas": ring_nodes, "unhealthy": unhealthy,
                     "vnodes": self.config.vnodes,
                     "streams_routed": n_routed}
        faults = {k: sum((p.get("faults") or {}).get(k, 0)
                         for p in per.values())
                  for k in _FAULT_SUM_KEYS}
        faults["deadline_miss_rate"] = max(
            ((p.get("faults") or {}).get("deadline_miss_rate", 0.0)
             for p in per.values()), default=0.0)
        backends = {(p.get("faults") or {}).get("backend")
                    for p in per.values()} - {None}
        faults["backend"] = ",".join(sorted(backends)) or None
        faults["degraded"] = any((p.get("faults") or {}).get("degraded")
                                 for p in per.values())
        faults["injected"] = None
        s["faults"] = faults
        if s["waves"]:
            # Per-device efficiency: GOP/s and W both scale with N, so the
            # cluster's GOP/s/W is the throughput-weighted mean over the
            # replicas that served work (≈ any one replica's, by design).
            # The port's replicas report no energy until an energy model
            # is calibrated on the card, so this block stays empty.
            g = [(p["gops_per_watt"], p["samples"]) for p in per.values()
                 if "gops_per_watt" in p]
            if g:
                w = sum(n for _, n in g) or 1
                s["gops_per_watt"] = float(sum(v * n for v, n in g) / w)
                s["ops_per_inference"] = next(
                    p["ops_per_inference"] for p in per.values()
                    if "ops_per_inference" in p)
        s["health"] = self.health()
        s["state"] = {
            k: int(np.sum([(p.get("state") or {}).get(k, 0)
                           for p in per.values()]))
            for k in ("live_streams", "capacity", "hits", "misses",
                      "evictions")}
        return s

    def health(self) -> Dict:
        """Cluster readiness: per-replica ``health()`` snapshots plus an
        overall ``status`` — ``failed`` when NO ring replica is ok-ish
        (the cluster cannot take traffic), ``degraded`` when any replica
        is unhealthy/failed/degraded/overloaded, else ``ok``."""
        with self._lock:
            servers = dict(self._servers)
            ring = set(self._ring.nodes)
            unhealthy = dict(self._unhealthy)
        per = {name: srv.health() for name, srv in servers.items()}
        serving = [n for n in ring if per.get(n, {}).get("status")
                   in ("ok", "degraded", "overloaded")]
        if not serving:
            status = "failed"
        elif unhealthy or any(h["status"] != "ok" for h in per.values()):
            status = "degraded"
        else:
            status = "ok"
        return {"status": status, "replicas": per,
                "ring": sorted(ring), "unhealthy": unhealthy}
