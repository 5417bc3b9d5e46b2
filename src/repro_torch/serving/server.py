"""``StreamServer`` — many named client streams, one accelerator
(counterpart of ``repro/serving/server.py``; waves go to the session's
device with ``torch.as_tensor`` and results come back with
``.cpu().numpy()``).

The paper's headline is *real-time* inference (§6: 32 873 samples/s on a
live sensor stream); the ROADMAP scenario is that stream multiplied by
"millions of users".  This module is the piece between the two: clients
``submit`` windows tagged with a stream id, the scheduler groups them into
fixed-size waves (one static shape for the jitted datapath), and — the part
the stateless ``Accelerator.serve`` path cannot do — each stream's
recurrent carry (whatever shape the model's cell spec declares)
survives across its windows, so window *k+1* continues the
recurrence window *k* left off, bit-exactly equal to running the stream's
concatenated sequence through the accelerator in one shot.

Deployment shape::

    server = StreamServer(session, batch=64, deadline_s=0.005)
    server.submit("sensor-17", window)        # (T, M) float, any thread
    for r in server.poll(timeout=0.1):        # StreamResult(stream_id, seq, y)
        route(r.stream_id, r.y)
    server.metrics_summary()                  # samples/s, p50/p95/p99
    server.close()

Multiple sessions (replicas of ONE configuration sharing one set of
weights, e.g. one per device) may be passed; waves are dispatched
round-robin across them by the single strictly-ordered compute thread
(load spreading — not yet parallel execution; the ordering is what keeps
per-stream carries consistent).  State lives either in a bounded host LRU
:class:`~repro_torch.serving.state.StateStore` or — when the fused
kernels head the ladder (``ServingConfig.state_residency``, default
``auto``) — in a device-resident slot table
(:class:`~repro_torch.serving.device_state.DeviceStateStore`): same LRU
semantics, but the (h, c) codes never cross the host/device boundary on
the hot path, only two (B,) slot-id vectors do.  An evicted or brand new
stream starts from the all-zero reset carry either way.

The round-robin is WAVE-level, not stream-level: with >= 2 sessions a
stream's consecutive windows may execute on DIFFERENT sessions
(``StreamResult.routed_replica`` records which, as the session index).
That is correct only because a multi-session server's carry lives
host-side in the shared ``StateStore`` — every session reads the same
store, so which session computed window *k* does not matter for window
*k+1*.  Device residency therefore requires a SINGLE session (one table
on one device; ``auto`` falls back to host for replicas): to scale
device-resident state across replicas use
``repro_torch.serving.cluster.ClusterServer``, which pins every stream to
exactly one replica by consistent hash so its carry stays replica-local.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import (Dict, Hashable, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np
import torch
from torch.autograd import profiler as _profiler

from repro_torch.backends.slot_graph import ROUTE, SlotGraphs
from repro_torch.kernels.qlstm_cell import LAUNCH_STAMP
from repro_torch.serving.faults import FaultInjector
from repro_torch.serving.metrics import (MetricsSink, WaveRecord,
                                         new_server_id, publish)
from repro_torch.serving.resilience import ExecutionGuard, ResiliencePolicy
from repro_torch.serving.scheduler import (OverloadPolicy, Slot, Wave,
                                           WaveScheduler)
from repro_torch.serving.state import StateStore


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _params_equal(a, b) -> bool:
    """True when two params dicts hold identical weights (replica check —
    the model is tiny, so exact comparison at construction is cheap)."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x is y or (x.shape == y.shape and torch.equal(x.cpu(), y.cpu()))
        for x, y in zip(la, lb))


# Profiler ranges of a wave's stages: the C++ range costs ~1 us to open
# and close against ``record_function``'s ~10.
_Range = torch._C._profiler._RecordFunctionFast
_NO_RANGE = contextlib.nullcontext()


def _stage(traced: bool, name: str):
    """A profiler range ``name`` on this thread while ``traced``, else a
    context that does nothing."""
    return _Range(name) if traced else _NO_RANGE


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs of the streaming subsystem (docs/SERVING.md has the tuning
    guide).

    ``batch``: static wave size the jitted datapath sees.  ``deadline_s``:
    flush a padded partial wave once the oldest pending window has waited
    this long (None = wait for full waves).  ``queue_depth``: assembled
    waves the compute thread may fall behind by (2 = double buffering).
    ``max_pending``: submitted-but-unassembled window bound — ``submit``
    blocks past it (None = 4 * batch); when pending saturates and no full
    wave can form (one window per stream), a partial wave is flushed
    rather than deadlocking the blocked submitters.  ``max_results``:
    computed-but-unpolled result bound — past it the compute thread blocks
    before emitting, which stalls the whole pipeline back to ``submit``
    (full backpressure to a stalled consumer).  The default ``None`` is
    unbounded: required for the submit-everything-then-``drain()`` pattern
    (``drain`` flushes before polling, so a bound smaller than the
    outstanding windows would deadlock it); production servers with a
    concurrent ``poll`` loop should set it.  ``max_streams``: LRU
    state-store capacity.  ``stateful``: carry (h, c) across a stream's windows
    (requires ``path="int"``); False gives the stateless
    ``Accelerator.serve`` semantics.  ``backend``: engine override
    (``ref`` | ``pallas`` | ``xla`` — all three carry state; the default
    follows the plan's ``stateful_backend``, docs/API.md §Backends).

    ``resilience``: the guarded-execution policy (retry/backoff/timeout +
    backend degradation, docs/SERVING.md §Reliability); every wave runs
    under it.  ``overload``: admission-control / load-shedding policy
    (None = legacy block-on-backpressure, never shed).

    ``state_residency``: where per-stream carries live on a stateful
    server.  ``auto`` follows the plan — the device-resident slot table
    when the fused pallas kernel heads the ladder (single-session
    servers; ``plan()['state_residency']``), else the host-side LRU
    ``StateStore``.  ``device`` forces the slot table (any stateful
    engine — ``ref``/``xla`` run the XLA-level slot adapter); ``host``
    forces the legacy host store.  Both sides are bit-identical; device
    residency just stops shipping (h, c) arrays across the host/device
    boundary every wave (docs/SERVING.md §State residency)."""

    batch: int = 256
    path: str = "int"
    backend: Optional[str] = None
    stateful: bool = True
    deadline_s: Optional[float] = 0.010
    queue_depth: int = 2
    max_pending: Optional[int] = None
    max_results: Optional[int] = None
    max_streams: int = 1024
    resilience: ResiliencePolicy = ResiliencePolicy()
    overload: Optional[OverloadPolicy] = None
    state_residency: str = "auto"

    def __post_init__(self):
        """Reject contradictory settings at construction time."""
        if self.stateful and self.path != "int":
            raise ValueError(
                f"stateful serving carries integer state codes, so it "
                f"requires path='int' (got path={self.path!r}); set "
                f"stateful=False for the float/qat paths")
        if self.state_residency not in ("auto", "host", "device"):
            raise ValueError(
                f"state_residency must be auto|host|device, got "
                f"{self.state_residency!r}")
        if self.state_residency == "device" and not self.stateful:
            raise ValueError(
                "state_residency='device' is a stateful-serving knob; a "
                "stateless server carries no per-stream state to place")
        if self.max_results is not None and self.max_results < 1:
            raise ValueError(
                f"max_results must be >= 1, got {self.max_results}")
        if self.resilience is None:
            raise ValueError(
                "resilience cannot be None — pass ResiliencePolicy("
                "max_retries=0) to minimise guarding instead of disabling "
                "it")


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """One prediction — or one structured per-stream failure.

    ``stream_id``/``seq`` identify the window (``seq`` is the value
    ``submit`` returned).  ``y`` is the (P,) float prediction, or ``None``
    when ``error`` is set: ``"shed"`` (deadline-aware load shedding
    dropped the window uncomputed) or a ``"compute_failed: ..."``
    description (every engine of the degradation ladder failed the wave).
    ``record`` is the window's row id in its server's stage record
    (``MetricsSink.windows``; -1 for a shed window, which has none).
    ``state_reset`` flags a window computed from the all-zero reset carry
    although the stream had history (LRU eviction, injected state loss, or
    a failed wave dropped it) — the prediction is a valid model output, it
    just lost the history; silent before, now reported.  ``backend`` names
    the engine that computed the window (None for error rows).

    ``routed_replica`` says WHERE the window ran: on a ``StreamServer``
    it is the index of the session that executed the wave (None for shed
    windows, which never executed anywhere) — with >= 2 sessions a
    stream's windows may carry DIFFERENT indices, the wave-level
    round-robin documented in the module docstring.  Through
    ``ClusterServer`` it is the replica NAME, and the routing invariant
    guarantees one stream always reports one replica."""

    stream_id: Hashable
    seq: int
    y: Optional[np.ndarray]
    error: Optional[str] = None
    state_reset: bool = False
    backend: Optional[str] = None
    routed_replica: Optional[Hashable] = None
    record: int = dataclasses.field(default=-1, repr=False, compare=False)

    @property
    def ok(self) -> bool:
        """True for a real prediction, False for a shed/failed window."""
        return self.error is None


class StreamServer:
    """Stateful streaming front-end over one or more ``Accelerator``
    sessions (see the module docstring for the deployment shape).

    Results are delivered through :meth:`poll` / :meth:`drain` as
    :class:`StreamResult` rows; padded slots of partial waves are computed
    and dropped — they are never emitted and never touch the state store."""

    def __init__(self, sessions, config: Optional[ServingConfig] = None,
                 fault_injector: Optional[FaultInjector] = None,
                 **overrides):
        """``sessions``: one ``Accelerator`` or a list of replicas of the
        same configuration (waves round-robin across them).  ``config`` or
        keyword overrides (``batch=``, ``deadline_s=``, ...) set the
        :class:`ServingConfig`.  ``fault_injector`` (tests/chaos drills
        only) wraps the execute path and the state store with a seeded
        fault schedule — see ``repro_torch.serving.faults``."""
        sessions = list(sessions) if isinstance(sessions, (list, tuple)) \
            else [sessions]
        if not sessions:
            raise ValueError("need at least one Accelerator session")
        for s in sessions[1:]:
            if s.model != sessions[0].model:
                raise ValueError(
                    "all sessions must be replicas of one configuration; "
                    f"got models {s.model} != {sessions[0].model}")
            if not _params_equal(s.params, sessions[0].params):
                # Same config but different weights would round-robin waves
                # across bit-incompatible models (and cross-pollinate their
                # carries through the shared state store).
                raise ValueError(
                    "all sessions must be replicas sharing one set of "
                    "weights; the given sessions' params differ")
        cfg = config or ServingConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        self.config = cfg
        #: The slot path's CUDA graph engine, on a CUDA session.
        self._slot_graphs: Optional[SlotGraphs] = None
        self._sessions = sessions
        self.fault_injector = fault_injector
        # Resolve the degradation ladder and build/validate NOW: a bad
        # path/backend, an unquantised session or a kernel that cannot be
        # built fails at construction, not in the compute thread.  On a
        # CUDA session the ladder ends at the fused engine, so a kernel
        # that fails to launch fails its wave (ok=False rows) instead of
        # being served by a plain torch engine.
        from repro_torch import backends as _backends
        device = sessions[0].device
        #: Resolved carry placement: "device" | "host" on a stateful
        #: server, None on a stateless one (ServingConfig.state_residency
        #: documents the knob; auto follows plan()["state_residency"]).
        self.state_residency: Optional[str] = None
        if cfg.stateful:
            ladder = _backends.degradation_ladder(
                sessions[0].model, sessions[0].accel, override=cfg.backend,
                stateful=True, device=device)
            residency = cfg.state_residency
            if residency == "auto":
                residency = ("device" if ladder[0] == "pallas"
                             and len(sessions) == 1 else "host")
            elif residency == "device" and len(sessions) > 1:
                # One table lives on one device; replicas round-robining
                # waves into private tables would shear a stream's carry
                # across them.  Sharding streams across per-replica tables
                # is ClusterServer's job (consistent routing).
                raise ValueError(
                    "state_residency='device' requires a single session; "
                    "use ClusterServer to shard streams across replicas, "
                    "each with its own device-resident table")
            self.state_residency = residency
            if residency == "device":
                self._fns = [[(n, s.compiled_stateful_slots(n))
                              for n in ladder] for s in sessions]
                self._slot_graphs = next((fn for _, fn in self._fns[0]
                                          if isinstance(fn, SlotGraphs)),
                                         None)
            else:
                self._fns = [[(n, s.compiled_stateful(n)) for n in ladder]
                             for s in sessions]
        elif cfg.path == "int":
            ladder = _backends.degradation_ladder(
                sessions[0].model, sessions[0].accel, override=cfg.backend,
                stateful=False, device=device)
            self._fns = [[(n, s.compiled(cfg.path, n)) for n in ladder]
                         for s in sessions]
        else:
            # float/qat run one plan-resolved graph; the ladder is trivial
            # but the guard's retry/timeout protection still applies.
            ladder = (cfg.path,)
            self._fns = [[(cfg.path, s.compiled(cfg.path, cfg.backend))]
                         for s in sessions]
        if fault_injector is not None:
            self._fns = [[(n, fault_injector.wrap_fn(fn, label=n))
                          for n, fn in per_session]
                         for per_session in self._fns]
        self.guard = ExecutionGuard(ladder, cfg.resilience)
        if not cfg.stateful:
            self.states = None
        elif self.state_residency == "device":
            from repro_torch.serving.device_state import DeviceStateStore
            self.states = DeviceStateStore(sessions[0], cfg.max_streams)
            if fault_injector is not None:
                self.states = fault_injector.wrap_device_state_store(
                    self.states)
        else:
            self.states = StateStore(cfg.max_streams)
            if fault_injector is not None:
                self.states = fault_injector.wrap_state_store(self.states)
        self._server_id = new_server_id()
        self.metrics = MetricsSink()
        publish(self._server_id, self.metrics)
        self._results: "queue.Queue" = queue.Queue(
            maxsize=cfg.max_results or 0)
        self._seq: Dict[Hashable, int] = {}
        # stream_id -> submission watermark of an end_stream request:
        # carries of windows submitted before it are not re-stored.  Every
        # tombstone is pruned once the stream has no windows in flight
        # (tracked in _outstanding), so neither dict can grow beyond the
        # streams currently inside the pipeline.
        self._ended: Dict[Hashable, int] = {}
        self._outstanding: Dict[Hashable, int] = {}
        self._seq_lock = threading.Lock()
        self._window_shape = None
        self._rr = 0
        self._sched = WaveScheduler(
            cfg.batch, self._execute, one_per_stream=cfg.stateful,
            deadline_s=cfg.deadline_s, queue_depth=cfg.queue_depth,
            max_pending=cfg.max_pending, overload=cfg.overload,
            on_shed=self._shed)

    # -- client surface -----------------------------------------------------

    def submit(self, stream_id: Hashable,
               window: Union[np.ndarray, torch.Tensor]) -> int:
        """Enqueue one (T, M) float window for ``stream_id``; returns the
        window's per-stream sequence number.  Blocks under backpressure
        (``max_pending``); with a reject-mode ``OverloadPolicy`` it raises
        ``ServerOverloaded`` instead of blocking when the server is
        saturated.  All windows of a server must share one shape (the
        jitted datapath is compiled for it).

        Inputs are validated HERE, per call: a malformed window (wrong
        rank, wrong feature width, non-float-convertible dtype, NaN/Inf)
        raises ``ValueError`` to this caller only — it never reaches the
        compute thread, where it would poison a whole wave of other
        clients' windows."""
        if isinstance(window, torch.Tensor):
            window = window.detach().cpu().numpy()
        try:
            w = np.asarray(window, dtype=np.float32)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"window is not convertible to a float32 array: {e}"
            ) from None
        if w.ndim != 2:
            raise ValueError(
                f"window must be a (T, M) array, got shape {w.shape}")
        m = self._sessions[0].model.input_size
        if w.shape[0] < 1 or w.shape[1] != m:
            raise ValueError(
                f"window shape {w.shape} does not match the model's "
                f"(T>=1, input_size={m})")
        if not np.isfinite(w).all():
            raise ValueError(
                "window contains NaN/Inf; the int datapath would quantise "
                "them to arbitrary codes and corrupt the stream's carry — "
                "rejected at submit")
        with self._seq_lock:
            if self._window_shape is None:
                self._window_shape = w.shape
            elif w.shape != self._window_shape:
                raise ValueError(f"window shape {w.shape} != first window's "
                                 f"{self._window_shape}; one server serves "
                                 f"one static shape")

        def alloc_seq() -> int:
            # Runs inside the scheduler's critical section, so the seq a
            # thread gets and its position in the FIFO cannot be reordered
            # against another thread submitting to the same stream.
            with self._seq_lock:
                seq = self._seq.get(stream_id, 0)
                self._seq[stream_id] = seq + 1
                if self.config.stateful:
                    self._outstanding[stream_id] = \
                        self._outstanding.get(stream_id, 0) + 1
                return seq

        self.metrics.note_submit(time.perf_counter())
        return self._sched.submit(stream_id, w, alloc_seq)

    def poll(self, timeout: float = 0.0) -> List[StreamResult]:
        """Completed predictions, in wave order (per-stream order is always
        submission order).  Returns immediately with whatever is ready;
        with ``timeout`` > 0, waits up to that long for the first result.
        Re-raises a compute-thread failure."""
        out: List[StreamResult] = []
        end = time.perf_counter() + timeout
        while True:
            try:
                while True:
                    out.append(self._results.get_nowait())
            except queue.Empty:
                pass
            if out:
                self.metrics.note_polled(out, time.perf_counter())
                return out
            err = self._sched.error
            if err is not None:
                raise err
            remaining = end - time.perf_counter()
            if remaining <= 0:
                return out
            try:
                out.append(self._results.get(timeout=min(remaining, 0.25)))
            except queue.Empty:
                pass

    def flush(self, timeout: Optional[float] = None) -> None:
        """Barrier: force partial waves and wait until every window
        submitted before the call has been computed."""
        self._sched.flush(timeout=timeout)

    def drain(self, timeout: Optional[float] = None) -> List[StreamResult]:
        """``flush`` then collect everything: all outstanding predictions."""
        self.flush(timeout=timeout)
        return self.poll()

    def end_stream(self, stream_id: Hashable) -> None:
        """Forget a stream (explicit end-of-stream): its carry on stateful
        servers, and its sequence numbering on every server — the next
        window under the same id starts a fresh stream, from the reset
        state and with its sequence numbering restarted at 0.  On
        stateless servers this is also the only way to prune a retired
        id's ``_seq`` entry, so long-lived deployments with rotating
        client ids should call it.

        Safe against in-flight windows: carries of windows submitted
        before this call are never re-stored (a tombstone watermark makes
        the compute thread skip their scatter), so a window submitted
        AFTER the call is guaranteed the zero reset carry."""
        if self.states is None:
            with self._seq_lock:
                self._seq.pop(stream_id, None)
            return
        watermark = self._sched.submission_watermark()
        with self._seq_lock:
            self._seq.pop(stream_id, None)
            # A tombstone is only needed while windows are in flight; it is
            # pruned by _retire once the last of them clears the pipeline.
            if self._outstanding.get(stream_id, 0) > 0:
                self._ended[stream_id] = max(watermark,
                                             self._ended.get(stream_id, 0))
            # Inside the lock: _scatter holds it across its tombstone check
            # AND its states.put, so the pop here cannot interleave with a
            # put and erase a reborn stream's carry (or miss a stale one).
            self.states.pop(stream_id)

    def reset_streams(self) -> None:
        """Forget EVERY stream — carries and sequence numbering — without
        tearing down the server: threads, compiled sessions, and (on the
        device path) the resident slot table all survive, so the next
        window is served by a warm datapath from a zero carry.

        This is the scenario harness's short-run reset
        (``repro.explore.serving_objective``): warm up once, then
        ``reset_streams()`` + ``reset_metrics()`` give a fresh measurement
        interval on an already-compiled server, point after point.
        Flushes first; call it between submission rounds, not concurrently
        with ``submit``."""
        self.flush()
        with self._seq_lock:
            ids = set(self._seq)
        if self.states is not None:
            # Streams seeded via seed_stream_state but never submitted
            # hold a carry without a _seq entry — end those too.
            ids.update(self.states.ids())
        for sid in ids:
            self.end_stream(sid)

    def read_stream_state(self, stream_id: Hashable):
        """A host-side copy of a stream's carry (per layer, a tuple of the
        cell's ``state_arity`` int32 rows — ``[(h, c), ...]`` for the
        LSTM), or ``None`` when the server holds none.  On a
        device-resident server this is the one sanctioned state read-back,
        meant for PLANNED stream movement (``ClusterServer`` drain) — not
        for the hot path.  Call only with the stream quiescent (no windows
        in flight), e.g. after ``flush()``."""
        if self.states is None:
            return None
        if self.state_residency == "device":
            return self.states.read_state(stream_id)
        st = self.states.get(stream_id)
        if st is None:
            return None
        return [tuple(a.copy() for a in layer) for layer in st]

    def seed_stream_state(self, stream_id: Hashable, state) -> None:
        """Plant a carry for ``stream_id`` (same per-layer carry-tuple
        layout ``read_stream_state`` returns) as if the server had
        computed it — the destination
        half of a warm stream handoff.  The stream's next window continues
        the recurrence from ``state`` with no ``state_reset`` flag.  Any
        streams the insertion LRU-evicts are reconciled exactly like a
        wave's own evictions."""
        if self.states is None:
            raise ValueError("cannot seed state on a stateless server")
        with self._seq_lock:
            if self.state_residency == "device":
                evicted = set(self.states.seed_state(stream_id, state))
            else:
                evicted = set(self.states.put(
                    stream_id,
                    [tuple(np.asarray(a).copy() for a in layer)
                     for layer in state]))
        self._reconcile_evictions(evicted)

    def close(self, abandon: bool = False,
              timeout: float = 30.0) -> List[str]:
        """Stop the server.  Default: drain submitted windows first;
        ``abandon=True`` discards pending work immediately.  A drain that
        cannot complete (a ``max_results``-bounded queue wedged by a
        consumer that stopped polling) escalates to abandon after
        ``timeout`` instead of leaking the worker threads.  Returns the
        names of any threads that survived the escalated join (empty =
        clean shutdown; also visible in ``health()["leaked_threads"]``)."""
        leaked = self._sched.close(abandon=abandon, timeout=timeout)
        self.guard.close()
        if self._slot_graphs is not None:
            self._slot_graphs.release(self.states.table)
        return leaked

    def __enter__(self) -> "StreamServer":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close(abandon=exc_type is not None)

    # -- metrics ------------------------------------------------------------

    def reset_metrics(self) -> None:
        """Start a fresh metrics window (e.g. after a warm-up wave, so the
        compile time stays out of the measured interval); the new sink
        becomes this server's entry in ``metrics.current_sinks()``."""
        self.metrics = MetricsSink()
        publish(self._server_id, self.metrics)

    def metrics_summary(self) -> Dict:
        """The serving report: achieved samples/s, per-window latency
        p50/p95/p99, occupancy, deadline flushes, state-store counters, and
        the energy model's GOP/s/W at the MEASURED operating point (mean
        wave compute latency, mean occupancy) — the paper's Table-4 metric
        evaluated where the server actually runs, with the card's
        constants (``core/energy.py``)."""
        s = self.metrics.summary()
        s["stateful"] = self.config.stateful
        s["sessions"] = len(self._sessions)
        s["state"] = self.states.stats() if self.states is not None else None
        s["state_residency"] = self.state_residency
        g = self.guard.stats()
        sched = self._sched.stats()
        counters = self.metrics.counters()
        s["faults"] = {
            "retries": g["retries"],
            "timeouts": g["timeouts"],
            "wave_failures": g["wave_failures"],
            "degradations": g["degradations"],
            "promotions": g["promotions"],
            "probes": g["probes"],
            "backend": g["backend"],
            "degraded": g["level"] > 0,
            "sheds": sched["sheds"],
            "rejections": sched["rejections"],
            "recoveries": sched["recoveries"],
            "deadline_miss_rate": sched["deadline_miss_rate"],
            "state_resets": counters.get("state_resets", 0),
            "stream_errors": counters.get("stream_errors", 0),
            "injected": (self.fault_injector.stats()
                         if self.fault_injector is not None else None),
        }
        # Per-wave host<->device state traffic: the device-residency win is
        # to_device/from_device pinned at 0 while only slot ids travel.
        s["state_transfer"] = {
            "to_device_bytes": counters.get("state_bytes_to_device", 0),
            "from_device_bytes": counters.get("state_bytes_from_device", 0),
            "slot_id_bytes": counters.get("slot_id_bytes", 0),
        }
        # The slot path's CUDA graphs: the engine's lifetime counts, and
        # the share of this window's waves that replayed a graph.
        s["slot_graph"] = None
        if self._slot_graphs is not None:
            s["slot_graph"] = {
                **self._slot_graphs.stats(),
                "replayed_share": (counters.get("slot_graph_replay", 0)
                                   / s["waves"] if s["waves"] else None)}
        s["health"] = self.health()
        if s["waves"]:
            sess = self._sessions[0]
            occupancy = max(1, round(s["mean_occupancy"]))
            rep = sess.report(latency_s=s["compute_ms_mean"] / 1e3,
                              batch=occupancy)
            s["ops_per_inference"] = rep["ops_per_inference"]
            s["energy"] = rep["energy"]
            s["gops_per_watt"] = rep["energy"]["gops_per_watt"]
        return s

    def health(self) -> Dict:
        """Live health snapshot — cheap enough for a readiness probe.

        ``status``: ``"failed"`` (an unrecovered compute-thread error is
        pending re-raise), ``"overloaded"`` (pending queue saturated),
        ``"degraded"`` (serving below the preferred engine), else
        ``"ok"``.  Plus the current engine and ladder, queue depths, the
        rolling deadline-miss rate, live stream count, and any leaked
        worker threads from the last ``close``.  Schema documented in
        docs/SERVING.md §Reliability."""
        g = self.guard.stats()
        sched = self._sched.stats()
        if sched["dead"]:
            status = "failed"
        elif sched["pending"] >= sched["max_pending"]:
            status = "overloaded"
        elif g["level"] > 0:
            status = "degraded"
        else:
            status = "ok"
        return {
            "status": status,
            "backend": g["backend"],
            "ladder": g["ladder"],
            "degraded": g["level"] > 0,
            "pending": sched["pending"],
            "max_pending": sched["max_pending"],
            "results_waiting": self._results.qsize(),
            "deadline_miss_rate": sched["deadline_miss_rate"],
            "live_streams": (len(self.states)
                             if self.states is not None else None),
            "state_residency": self.state_residency,
            "leaked_threads": list(self._sched.leaked_threads),
        }

    # -- compute thread -----------------------------------------------------

    def _execute(self, wave: Wave) -> None:
        """Gather carries -> GUARDED device datapath -> scatter carries ->
        emit.  Runs on the scheduler's compute thread, waves strictly in
        order — which is what makes the gather/scatter of consecutive
        windows of one stream consistent.

        The guard absorbs engine failures (retry, backoff, degradation
        down the bit-identical ladder); only a wave that fails on EVERY
        engine is converted into per-stream error results — the compute
        thread survives either way.

        The wave's stage stamps go to the sink's record with it; while a
        ``torch.profiler`` runs (one flag read otherwise), the stages are
        ``serving.*`` ranges on the profiler's timeline too."""
        traced = _profiler._is_profiler_enabled
        with _stage(traced, "serving.wave"):
            self._run_wave(wave, traced)

    def _run_wave(self, wave: Wave, traced: bool) -> None:
        """:meth:`_execute`'s wave, stamped into the sink's record."""
        sess_idx = self._rr % len(self._fns)
        fns = self._fns[sess_idx]
        self._rr += 1
        t0 = time.perf_counter()
        device_state = self.state_residency == "device"
        LAUNCH_STAMP.t = float("nan")
        with _stage(traced, "serving.prepare"):
            device = self._sessions[sess_idx].device
            if device_state:
                # Slot path: the carries never leave the table — only two
                # (B,) int32 slot-id vectors cross to the device.  The
                # allocator transaction (lookup + assign + tombstone checks)
                # happens BEFORE compute, so faults can only strand slots,
                # never corrupt the allocator<->table correspondence.
                g, s, reset, rows, evicted = self._gather_slots(wave)
                self.metrics.count("slot_id_bytes",
                                   int(g.nbytes + s.nbytes))
                # The slot datapath only reads the live table: every
                # attempt writes an output table of its own, and the live
                # table changes only at commit, after success.  That is
                # what makes an attempt the guard abandoned at its timeout
                # safe (its kernel may still run beside the retry on CUDA).
                # x and the ids go as host arrays: the engine stages them.
                ROUTE.last = None
                outcome = self.guard.run(fns, wave.x, self.states.table, g, s)
            elif self.config.stateful:
                x = torch.as_tensor(wave.x, device=device)
                gathered, reset = self._gather(wave, device)
                outcome = self.guard.run(fns, x, gathered)
            else:
                x = torch.as_tensor(wave.x, device=device)
                reset = [False] * len(wave.slots)
                outcome = self.guard.run(fns, x)
        if not outcome.ok:
            self._fail_wave(wave, outcome, t0, sess_idx)
            if device_state:
                # Slot assignment (and any LRU evictions) happened before
                # compute; the victims are still gone even though the
                # wave's table update was discarded.
                self._reconcile_evictions(evicted)
            return
        # A launch stamp on this thread is the successful attempt's only
        # when the wave took one attempt (a failed one may have launched).
        t_launch = (LAUNCH_STAMP.t if not outcome.attempt_errors
                    else float("nan"))
        if device_state:
            y, new_table = outcome.value
            if ROUTE.last is not None:      # the slot graphs' route
                self.metrics.count("slot_graph_" + ROUTE.last)
        elif self.config.stateful:
            y, new_state = outcome.value
        else:
            y = outcome.value
        with _stage(traced, "serving.sync"):
            # The graph path hands y back on the host already.
            y = (y.cpu() if y.is_cuda else y).numpy()
        t_host = time.perf_counter()
        with _stage(traced, "serving.emit"):
            if device_state:
                self.states.commit(new_table, rows)
                self._retire(wave)
                self._reconcile_evictions(evicted)
            elif self.config.stateful:
                evicted = self._scatter(wave, new_state)
                self._retire(wave)
                self._reconcile_evictions(evicted)
            n_reset = sum(reset)
            if n_reset:
                self.metrics.count("state_resets", n_reset)
            t1 = time.perf_counter()
            sink = self.metrics
            first = sink.record_wave(WaveRecord(
                t_done=t1, compute_s=t1 - t0, occupancy=wave.occupancy,
                batch=self.config.batch, deadline_flush=wave.deadline_flush,
                t_selected=wave.t_selected, t_exec=t0, t_launch=t_launch,
                t_host=t_host), wave.slots)
            self._emit_wave(sink, first, (
                StreamResult(slot.stream_id, slot.seq, y[i],
                             state_reset=reset[i], backend=outcome.backend,
                             routed_replica=sess_idx, record=first + i)
                for i, slot in enumerate(wave.slots)))

    def _fail_wave(self, wave: Wave, outcome, t0: float,
                   sess_idx: int) -> None:
        """Every ladder engine failed this wave: isolate the damage to the
        wave's own streams.  Their carries are dropped (a window was lost,
        so continuing from the pre-wave carry would be a silent gap — the
        next window restarts from the reset state and is FLAGGED
        ``state_reset``), each slot gets a structured error result, and
        the compute thread moves on."""
        err = f"compute_failed: {outcome.error}"
        if self.config.stateful:
            for slot in wave.slots:
                self.states.pop(slot.stream_id)
            self._retire(wave)
        self.metrics.count("stream_errors", wave.occupancy)
        t1 = time.perf_counter()
        sink = self.metrics
        first = sink.record_wave(WaveRecord(
            t_done=t1, compute_s=t1 - t0, occupancy=wave.occupancy,
            batch=self.config.batch, deadline_flush=wave.deadline_flush,
            t_selected=wave.t_selected, t_exec=t0), wave.slots)
        self._emit_wave(sink, first, (
            StreamResult(slot.stream_id, slot.seq, None, error=err,
                         routed_replica=sess_idx, record=first + i)
            for i, slot in enumerate(wave.slots)))

    def _emit_wave(self, sink: MetricsSink, first: int, results) -> None:
        """Emit a wave's results in order, stamping each as it goes on the
        results queue into ``sink``'s rows from record id ``first`` on."""
        stamps: List[float] = []
        for r in results:
            stamps.append(time.perf_counter())
            self._emit(r)
        sink.note_emitted(first, stamps)

    def _shed(self, slot: Slot) -> None:
        """Scheduler shed callback (assembler thread): the window was
        dropped uncomputed.  On a stateful server the stream's carry is
        dropped too — its recurrence now has a hole, and a silently wrong
        continuation is worse than a flagged reset — so the next window
        restarts from zero with ``state_reset=True``."""
        if self.config.stateful:
            with self._seq_lock:
                self.states.pop(slot.stream_id)
            self._retire_slot(slot.stream_id)
        self.metrics.count("sheds")
        self._emit(StreamResult(slot.stream_id, slot.seq, None,
                                error="shed"))

    def _emit(self, r: StreamResult) -> None:
        """Deliver one result.  With max_results set this blocks, stalling
        the compute thread and — through the wave queue and pending bounds
        — eventually submit(): full backpressure to a stalled consumer.
        Give up on abandon so close(abandon=True) cannot hang on a full
        results queue."""
        while True:
            try:
                self._results.put(r, timeout=0.1)
                return
            except queue.Full:
                if self._sched.stopped:
                    return

    def _gather(self, wave: Wave, device: torch.device):
        """Per-layer carry batch arrays for the wave (the cell's
        ``state_arity`` arrays per layer — (h, c) for the LSTM): stored
        carries for known streams, the zero reset state for new/evicted
        streams and padding rows.  Also returns per-slot ``state_reset``
        flags: True when a stream WITH HISTORY (seq > 0) found no carry —
        it was evicted, lost, or dropped by a failed wave, and its result
        must say so instead of silently continuing from zeros."""
        nl, arity, hidden = self._sessions[0].plan["state_shape"]
        bufs = [[np.zeros((self.config.batch, hidden), np.int32)
                 for _ in range(arity)] for _ in range(nl)]
        reset = [False] * len(wave.slots)
        for i, slot in enumerate(wave.slots):
            st = self.states.get(slot.stream_id)
            if st is not None:
                for li, layer_carry in enumerate(st):
                    for s, arr in enumerate(layer_carry):
                        bufs[li][s][i] = arr
            elif slot.seq > 0:
                reset[i] = True
        state = tuple(tuple(torch.as_tensor(a, device=device) for a in layer)
                      for layer in bufs)
        self.metrics.count("state_bytes_to_device",
                           sum(int(a.nbytes) for layer in state
                               for a in layer))
        return state, reset

    def _gather_slots(self, wave: Wave):
        """The device-residency counterpart of :meth:`_gather` +
        :meth:`_scatter`'s bookkeeping, run BEFORE compute: one allocator
        transaction under ``_seq_lock`` producing the wave's slot-id
        vectors.  Returns ``(gather, scatter, reset, rows, evicted)``:

        * ``gather[i]``: table row whose carry seeds batch row ``i`` at
          t == 0 — the stream's slot, or ZERO for new/evicted streams and
          padding (``reset[i]`` is flagged exactly like :meth:`_gather`);
        * ``scatter[i]``: row for the final carry at t == T-1 — the
          stream's (possibly new) slot, or TRASH for padding, tombstoned
          windows, and same-wave eviction victims;
        * ``rows``: the real scatters as ``(batch_row, stream_id)``, the
          unit the fault injector draws per-put faults over;
        * ``evicted``: ids LRU-evicted by this wave's assignments.

        The two phases replay the host path's store-op order — every
        lookup (get), then every assignment (put) in batch-row order — so
        hit/miss/eviction counters and any injected fault schedule match
        the host store's, draw for draw."""
        store = self.states
        batch = self.config.batch
        g = np.full(batch, store.zero_slot, dtype=np.int32)
        s = np.full(batch, store.trash_slot, dtype=np.int32)
        reset = [False] * len(wave.slots)
        rows: List[Tuple[int, Hashable]] = []
        evicted_all: set = set()
        with self._seq_lock:
            for i, slot in enumerate(wave.slots):
                sl = store.lookup(slot.stream_id)
                if sl is not None:
                    g[i] = sl
                elif slot.seq > 0:
                    reset[i] = True
            row_of_slot: Dict[int, int] = {}
            for i, slot in enumerate(wave.slots):
                sid = slot.stream_id
                watermark = self._ended.get(sid)
                if watermark is not None:
                    if slot.sub_idx < watermark:
                        continue   # ended-generation carry: scatter=TRASH
                    del self._ended[sid]   # stream reborn after the end
                sl, evicted = store.assign(sid)
                evicted_all.update(evicted)
                j = row_of_slot.pop(sl, None)
                if j is not None:
                    # An earlier row of THIS wave was assigned this slot
                    # and its stream was just LRU-evicted (batch >
                    # capacity): its carry would be dropped by the host
                    # store too — redirect its dead scatter to TRASH.
                    s[j] = store.trash_slot
                row_of_slot[sl] = i
                s[i] = sl
                rows.append((i, sid))
        return g, s, reset, rows, evicted_all

    def _scatter(self, wave: Wave, new_state) -> set:
        """Store each real slot's updated carry; returns the ids evicted by
        the wave's puts (reconciled by :meth:`_reconcile_evictions` after
        :meth:`_retire`).  Padding rows are dropped (they never touch the
        store); so are carries tombstoned by ``end_stream`` — windows
        submitted before the end must not resurrect the stream's state."""
        rows = [tuple(a.cpu().numpy() for a in layer) for layer in new_state]
        self.metrics.count("state_bytes_from_device",
                           sum(int(a.nbytes) for layer in rows
                               for a in layer))
        evicted_all = set()
        for i, slot in enumerate(wave.slots):
            sid = slot.stream_id
            # One lock section spans the tombstone check AND the put: an
            # end_stream between them could otherwise be silently undone
            # by the put, resurrecting the ended stream's carry.  The
            # store's own lock never takes _seq_lock, so no cycle.
            with self._seq_lock:
                watermark = self._ended.get(sid)
                if watermark is not None:
                    if slot.sub_idx < watermark:
                        continue       # ended-generation carry: drop it
                    del self._ended[sid]   # stream reborn after the end
                # copy(): a view of row i would pin the whole
                # (batch, hidden) wave array in the store for the stream's
                # lifetime.
                evicted_all.update(
                    self.states.put(sid, [tuple(a[i].copy() for a in layer)
                                          for layer in rows]))
        return evicted_all

    def _reconcile_evictions(self, evicted: set) -> None:
        """An evicted stream is forgotten ENTIRELY — carry and sequence
        numbering — so a returning client looks like a new stream (and a
        stateful server's _seq cannot grow without bound; state.py's
        docstring scenario is millions of users).  Runs after
        :meth:`_retire`, and only prunes a victim that is really gone:

        * a victim that was a LATER slot of the evicting wave re-stored
          its (correctly continued) carry — never really evicted, keeps
          its numbering;
        * a victim with windows still in flight keeps its numbering too —
          its pending window's scatter will re-store its carry before any
          later wave gathers it (waves compute strictly in order), so
          pruning here would hand out duplicate (stream_id, seq) keys."""
        with self._seq_lock:
            for vid in evicted:
                if vid not in self.states \
                        and self._outstanding.get(vid, 0) == 0:
                    self._seq.pop(vid, None)

    def _retire(self, wave: Wave) -> None:
        """Per-stream in-flight accounting: once a stream has no windows
        left in the pipeline, its end_stream tombstone (if any) can never
        match again and is pruned — this bounds ``_ended``/``_outstanding``
        by the streams currently inside the pipeline."""
        with self._seq_lock:
            for slot in wave.slots:
                self._retire_slot_locked(slot.stream_id)

    def _retire_slot(self, sid: Hashable) -> None:
        """One window left the pipeline outside a wave (it was shed)."""
        with self._seq_lock:
            self._retire_slot_locked(sid)

    def _retire_slot_locked(self, sid: Hashable) -> None:
        """Decrement a stream's in-flight count; prune its bookkeeping at
        zero.  Caller holds ``_seq_lock``."""
        left = self._outstanding.get(sid, 1) - 1
        if left > 0:
            self._outstanding[sid] = left
        else:
            self._outstanding.pop(sid, None)
            self._ended.pop(sid, None)


def serve_windows(session, stream: Iterable, batch: int = 256,
                  path: str = "int",
                  backend: Optional[str] = None) -> Iterator[np.ndarray]:
    """Ordered stateless mapping of a window iterator — the
    ``Accelerator.serve`` semantics, executed by the streaming subsystem.

    Windows of shape (T, M) are assembled into fixed-size waves of
    ``batch``; predictions of shape (P,) are yielded in submission order.
    The final partial wave is PADDED to the static shape by repeating the
    last window; padded outputs are computed and dropped — exactly
    ``len(list(stream))`` predictions are yielded, never more.  Unlike the
    legacy synchronous path, wave *N+1* is assembled while wave *N*
    computes (the scheduler's double buffering), and a slow consumer
    exerts backpressure instead of unbounded buffering."""
    config = ServingConfig(batch=batch, path=path, backend=backend,
                           stateful=False, deadline_s=None)
    # Validate NOW (cached on the session): a bad path/backend or an
    # unquantised session fails at the call site, not at first iteration.
    # The server itself — two live threads — is only constructed once the
    # generator is actually consumed, so an abandoned call leaks nothing.
    session.compiled(path, backend)

    def _gen():
        server = StreamServer(session, config)
        try:
            for w in stream:
                server.submit(None, w)
                for r in server.poll():
                    yield r.y
            for r in server.drain():
                yield r.y
        finally:
            server.close(abandon=True)

    return _gen()
