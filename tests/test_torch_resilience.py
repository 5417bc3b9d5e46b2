"""The port's serving reliability layer on the CPU: seeded chaos, guarded
execution, overload control — ``tests/test_resilience.py``'s battery,
with every fault run made in both packages.

The contract under test: a ``StreamServer`` under injected faults keeps
serving with zero crashes; every stream untouched by state faults stays
BIT-EXACT with the concatenated-sequence oracle; every stream that was
touched is FLAGGED (``StreamResult.error`` / ``state_reset``), never
silently wrong; and ``metrics_summary()["faults"]`` accounts for it.

Each seeded fault run goes through the port and through the reference
from the same seed, the same windows and the same weights (carried across
with ``repro_torch.convert``): the injection counters, the lost and
corrupted streams, and every row (its prediction bit for bit, its error
and reset flags, the engine that served it) must be the same.  Those
runs use ``deadline_s=None``, so waves form only when full or at
``drain``: the wave composition, and with it the order of the seeded
draws, is then the same in every run, which a deadline flush (timed on
the host clock) would not guarantee.  Every thread join and drain has a
timeout."""

import threading
import time

import pytest

pytest.importorskip("jax")  # the reference package; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro.serving as jserving  # noqa: E402
import repro_torch  # noqa: E402
import repro_torch.serving as tserving  # noqa: E402
from repro.core import qlstm as jq  # noqa: E402
from repro_torch import backends as tbackends  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import qlstm as tq  # noqa: E402
from repro_torch.serving import (DeviceStateStore, ExecutionGuard,  # noqa: E402
                                 FaultConfig, FaultInjector, InjectedFault,
                                 OverloadPolicy, ResiliencePolicy,
                                 ServerOverloaded, ServingConfig,
                                 StreamServer, WaveScheduler, WaveTimeout)

MODEL_KW = dict(input_size=1, hidden_size=8, num_layers=2, seq_len=4)
SEQ_LEN = MODEL_KW["seq_len"]

FAST = dict(max_retries=3, backoff_base_s=0.0)


@pytest.fixture(scope="module")
def sessions():
    js = repro.build(jq.QLSTMConfig(**MODEL_KW), seed=0).quantize()
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    ts = repro_torch.build(tq.QLSTMConfig(**MODEL_KW),
                           params=params_from_reference(tree),
                           device="cpu").quantize()
    return js, ts


@pytest.fixture(scope="module")
def sess(sessions):
    return sessions[1]


def _windows(n, seed=0, t=SEQ_LEN, m=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, t, m)).astype(np.float32)


def _oracle(sess, windows):
    """Per-window predictions of one stream run stateful on the port's
    bit-exact ref engine — the concatenated-sequence ground truth."""
    fn = sess.compiled_stateful("ref")
    state, ys = sess.init_state(1), []
    for w in windows:
        y, state = fn(w[None], state)
        ys.append(y.numpy()[0])
    return ys


def _run_chaos(pkg, sess, backend, seed=11, n_streams=6, k=3, policy=FAST,
               **rates):
    """One seeded chaos run through ``pkg`` (either package's serving
    module): submit k windows on each of n_streams, drain, return
    ({sid: windows}, {sid: {seq: row}}, summary, injector)."""
    xs = {f"s{i}": _windows(k, seed=50 + i) for i in range(n_streams)}
    inj = pkg.FaultInjector(seed=seed, **rates)
    cfg = pkg.ServingConfig(batch=4, backend=backend, deadline_s=None,
                            resilience=pkg.ResiliencePolicy(**policy))
    rows = {}
    with pkg.StreamServer(sess, cfg, fault_injector=inj) as srv:
        for w in range(k):
            for sid in xs:
                srv.submit(sid, xs[sid][w])
        for r in srv.drain(timeout=120):
            rows.setdefault(r.stream_id, {})[r.seq] = r
        summary = srv.metrics_summary()
    return xs, rows, summary, inj


def _chaos_both(sessions, backend, **kw):
    """The same seeded chaos run in the port and in the reference; asserts
    they injected the same faults and served the same rows, and returns
    the port's run."""
    js, ts = sessions
    run = _run_chaos(tserving, ts, backend, **kw)
    _, trows, tsum, tinj = run
    _, jrows, jsum, jinj = _run_chaos(jserving, js, backend, **kw)
    assert tinj.stats() == jinj.stats()
    assert tinj.lost_streams == jinj.lost_streams
    assert tinj.corrupted_streams == jinj.corrupted_streams
    for key in ("injected", "retries", "wave_failures", "degradations",
                "state_resets", "stream_errors", "sheds"):
        assert tsum["faults"][key] == jsum["faults"][key], key
    assert trows.keys() == jrows.keys()
    for sid in trows:
        assert trows[sid].keys() == jrows[sid].keys()
        for q, tr in trows[sid].items():
            jr = jrows[sid][q]
            assert (tr.ok, tr.state_reset, tr.backend) == \
                (jr.ok, jr.state_reset, jr.backend), (sid, q)
            if tr.ok:
                np.testing.assert_array_equal(tr.y, np.asarray(jr.y))
    return run


def _check_partition(sess, xs, rows, inj):
    """The chaos post-conditions: survivors bit-exact, casualties flagged
    (and bit-exact up to their first flagged window)."""
    touched = inj.lost_streams | inj.corrupted_streams
    for sid, wins in xs.items():
        oracle = _oracle(sess, wins)
        got = rows[sid]
        assert sorted(got) == list(range(len(wins)))   # no window lost
        flagged = [q for q in sorted(got)
                   if (not got[q].ok) or got[q].state_reset]
        if not flagged and sid not in touched:
            for q in sorted(got):                      # survivor: bit-exact
                np.testing.assert_array_equal(got[q].y, oracle[q])
        else:
            first = flagged[0] if flagged else len(wins)
            for q in range(first):                     # clean prefix only
                np.testing.assert_array_equal(got[q].y, oracle[q])
            for q in sorted(got):                      # errors carry no y
                if not got[q].ok:
                    assert got[q].y is None and got[q].error


# ---------------------------------------------------------------------------
# The chaos matrix: fault rates x backends (the acceptance scenario)
# ---------------------------------------------------------------------------

@pytest.mark.slow
@pytest.mark.chaos
@pytest.mark.parametrize("backend", ["ref", "xla", "pallas"])
@pytest.mark.parametrize("rate", [0.0, 0.05, 0.2])
def test_chaos_wave_faults_absorbed_bit_exactly(sessions, backend, rate):
    """Injected compute faults at 0/5/20% per attempt on every engine:
    retries absorb them, every stream completes bit-exact with the oracle,
    and the run equals the reference's, fault for fault."""
    xs, rows, summary, inj = _chaos_both(sessions, backend,
                                         wave_fault_rate=rate)
    _check_partition(sessions[1], xs, rows, inj)
    f = summary["faults"]
    assert f["injected"]["wave_faults"] == inj.stats()["wave_faults"]
    if rate == 0.0:
        assert f["injected"]["wave_faults"] == 0 and f["retries"] == 0
    elif f["injected"]["wave_faults"] > 0:
        assert f["retries"] >= 1 and f["stream_errors"] == 0


@pytest.mark.slow
@pytest.mark.chaos
def test_acceptance_64_streams_20pct_faults_on_pallas(sessions):
    """The acceptance scenario: 64 streams through the fused engine at a
    20% per-attempt wave-fault rate — zero crashes, every window answered,
    every stream bit-exact, counters consistent with the injected
    schedule, and the same schedule and rows as the reference's."""
    xs, rows, summary, inj = _chaos_both(sessions, "pallas", seed=17,
                                         n_streams=64, k=2,
                                         wave_fault_rate=0.2)
    assert sum(len(by) for by in rows.values()) == 128
    _check_partition(sessions[1], xs, rows, inj)
    f = summary["faults"]
    assert f["injected"] == inj.stats()
    assert f["stream_errors"] == 0 and f["sheds"] == 0
    if inj.stats()["wave_faults"]:
        assert f["retries"] >= 1


def test_chaos_injection_schedule_is_deterministic():
    """Same (seed, rates) -> the exact same raise/pass schedule, which is
    the reference's; a different seed -> a different one."""
    def schedule(pkg, seed):
        inj = pkg.FaultInjector(seed=seed, wave_fault_rate=0.3)
        fn = inj.wrap_fn(lambda: None)
        out = []
        for _ in range(64):
            try:
                fn()
                out.append(0)
            except pkg.InjectedFault:
                out.append(1)
        return out, inj.stats()

    a, sa = schedule(tserving, 7)
    b, sb = schedule(tserving, 7)
    c, _ = schedule(tserving, 8)
    assert a == b and sa == sb
    assert a != c
    assert sa["wave_faults"] == sum(a) and sa["attempts"] == 64
    assert (a, sa) == schedule(jserving, 7)


@pytest.mark.chaos
def test_chaos_state_loss_flags_reset_not_silence(sessions):
    """Lost carries (a crashed replica): the stream's next window is
    computed from the reset state and MUST come back ``state_reset=True``;
    untouched streams stay bit-exact; the resets are counted."""
    xs, rows, summary, inj = _chaos_both(sessions, "ref", seed=3, k=4,
                                         state_loss_rate=0.4)
    assert inj.stats()["state_losses"] > 0
    _check_partition(sessions[1], xs, rows, inj)
    n_reset = sum(r.state_reset for by in rows.values()
                  for r in by.values())
    assert n_reset > 0
    for sid, by in rows.items():
        if any(r.state_reset for r in by.values()):
            assert sid in inj.lost_streams
    assert summary["faults"]["state_resets"] == n_reset


@pytest.mark.chaos
def test_chaos_state_corruption_is_recorded(sessions):
    """Corrupted carries are the one fault the server cannot flag; the
    injector records the victims, and untouched streams still verify.
    The corrupted streams' rows equal the reference's too: both packages
    flip the same low bit of the same codes."""
    xs, rows, summary, inj = _chaos_both(sessions, "ref", seed=5, k=3,
                                         state_corrupt_rate=0.5)
    assert inj.stats()["state_corruptions"] > 0
    assert inj.corrupted_streams
    for sid, wins in xs.items():
        if sid in inj.corrupted_streams:
            continue
        oracle = _oracle(sessions[1], wins)
        for q, r in rows[sid].items():
            assert r.ok
            np.testing.assert_array_equal(r.y, oracle[q])


def test_wave_failure_isolated_to_error_results(sessions):
    """A wave that fails on EVERY engine (100% per-attempt fault rate, no
    retries) kills no thread: each window comes back as a structured
    ``compute_failed`` row, the server stays alive, and close() is
    clean."""
    xs, rows, summary, inj = _chaos_both(
        sessions, "ref", n_streams=4, k=2, wave_fault_rate=1.0,
        policy=dict(max_retries=0, backoff_base_s=0.0))
    assert sum(len(by) for by in rows.values()) == 8
    for by in rows.values():
        for r in by.values():
            assert not r.ok and "compute_failed" in r.error
            assert "InjectedFault" in r.error
    f = summary["faults"]
    assert f["wave_failures"] > 0
    assert f["stream_errors"] == 8


def test_injected_faults_on_a_cuda_ladder_fail_rows_never_degrade(
        sessions, monkeypatch):
    """On a CUDA session the ladder is ``("pallas",)``: an injected fault
    is retried on the kernel's engine and, when every retry fails, comes
    back as counted error rows — never as a wave served by a plain engine.
    The session runs on the CPU; only the ladder is resolved as for
    CUDA.  Every ok row is still bit-exact."""
    real = tbackends.degradation_ladder
    monkeypatch.setattr(tbackends, "degradation_ladder", lambda *a, **k: real(
        *a, **{**k, "device": torch.device("cuda")}))
    xs, rows, summary, inj = _run_chaos(
        tserving, sessions[1], "pallas", seed=17, n_streams=16, k=2,
        policy=dict(max_retries=1, backoff_base_s=0.0),
        wave_fault_rate=0.5)
    f = summary["faults"]
    assert summary["health"]["ladder"] == ["pallas"]
    assert f["degradations"] == 0 and f["wave_failures"] > 0
    assert all(r.backend in ("pallas", None) for by in rows.values()
               for r in by.values())
    assert f["stream_errors"] == sum(not r.ok for by in rows.values()
                                     for r in by.values()) > 0
    _check_partition(sessions[1], xs, rows, inj)


def test_degradation_and_promotion_round_trip_server(sess):
    """The preferred engine fails -> the guard serves the wave on the next
    ladder engine and (after degrade_after failures) officially degrades;
    once the engine heals, a recovery probe promotes back.  Results stay
    bit-exact through the whole round trip."""
    wins = _windows(6, seed=77)
    oracle = _oracle(sess, wins)
    cfg = ServingConfig(
        batch=2, backend="ref", deadline_s=0.005,
        resilience=ResiliencePolicy(max_retries=0, backoff_base_s=0.0,
                                    degrade_after=1, promote_after=1))
    srv = StreamServer(sess, cfg)
    preferred, real_fn = srv._fns[0][0]
    broken = {"on": True}

    def flaky(*args, **kwargs):
        if broken["on"]:
            raise RuntimeError("simulated engine outage")
        return real_fn(*args, **kwargs)

    srv._fns[0][0] = (preferred, flaky)
    try:
        rows = []
        for w in range(3):                        # outage: waves degrade
            srv.submit("s", wins[w])
            rows += srv.drain(timeout=60)
        assert srv.metrics_summary()["faults"]["degraded"]
        assert srv.health()["status"] == "degraded"
        broken["on"] = False                      # engine heals
        for w in range(3, 6):                     # probe promotes back
            srv.submit("s", wins[w])
            rows += srv.drain(timeout=60)
        f = srv.metrics_summary()["faults"]
        assert f["degradations"] >= 1 and f["promotions"] >= 1
        assert f["backend"] == preferred and not f["degraded"]
        assert srv.health()["status"] == "ok"
        by = {r.seq: r for r in rows}
        for q in range(6):
            assert by[q].ok
            np.testing.assert_array_equal(by[q].y, oracle[q])
        assert {by[q].backend for q in range(3)} != {preferred}
    finally:
        srv.close()


# ---------------------------------------------------------------------------
# ExecutionGuard unit tests (plain callables, no server)
# ---------------------------------------------------------------------------

def test_guard_retries_with_backoff_then_succeeds():
    calls = {"n": 0}

    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return x * 2

    g = ExecutionGuard(("a",), ResiliencePolicy(max_retries=2,
                                                backoff_base_s=0.0))
    out = g.run([("a", flaky)], 21)
    assert out.ok and out.value == 42 and out.backend == "a"
    assert out.retries == 2 and len(out.attempt_errors) == 2
    assert g.stats()["retries"] == 2 and g.stats()["wave_failures"] == 0


def test_guard_total_failure_reports_last_error():
    g = ExecutionGuard(("a", "b"), ResiliencePolicy(max_retries=0,
                                                    backoff_base_s=0.0))
    out = g.run([("a", lambda: 1 / 0), ("b", lambda: [][1])])
    assert not out.ok and out.value is None
    assert "IndexError" in out.error
    assert len(out.attempt_errors) == 2
    assert g.stats()["wave_failures"] == 1


def test_guard_timeout_abandons_attempt_and_degrades():
    """A hung attempt is abandoned at wave_timeout_s (never waited on) and
    the wave lands on the next ladder engine."""
    release = threading.Event()

    def hung(x):
        release.wait(5.0)
        return -1

    g = ExecutionGuard(("slow", "fast"), ResiliencePolicy(
        max_retries=0, backoff_base_s=0.0, wave_timeout_s=0.05))
    t0 = time.perf_counter()
    out = g.run([("slow", hung), ("fast", lambda x: x + 1)], 1)
    assert out.ok and out.value == 2 and out.backend == "fast"
    assert out.timeouts == 1
    assert time.perf_counter() - t0 < 2.0
    assert g.stats()["timeouts"] == 1
    assert g.stats()["abandoned_attempts"] == 1
    release.set()
    g.close()


def test_guard_degrade_then_probe_then_promote():
    broken = {"on": True}

    def pallas(x):
        if broken["on"]:
            raise RuntimeError("down")
        return ("pallas", x)

    fns = [("pallas", pallas), ("xla", lambda x: ("xla", x))]
    g = ExecutionGuard(("pallas", "xla"), ResiliencePolicy(
        max_retries=0, backoff_base_s=0.0, degrade_after=2,
        promote_after=2))
    assert g.run(fns, 0).backend == "xla"
    assert not g.degraded
    out = g.run(fns, 1)
    assert out.degraded and g.degraded
    assert g.backend == "xla"
    assert g.run(fns, 2).backend == "xla"
    assert g.run(fns, 3).backend == "xla"
    broken["on"] = False
    out = g.run(fns, 4)
    assert out.promoted and out.backend == "pallas"
    assert not g.degraded and g.backend == "pallas"
    s = g.stats()
    assert s["degradations"] == 1 and s["promotions"] == 1
    assert s["probes"] == 1


def test_guard_failed_probe_resets_clean_streak():
    fns = [("a", lambda: 1 / 0), ("b", lambda: "b")]
    g = ExecutionGuard(("a", "b"), ResiliencePolicy(
        max_retries=0, backoff_base_s=0.0, degrade_after=1,
        promote_after=2))
    g.run(fns)
    assert g.degraded
    g.run(fns)
    g.run(fns)
    g.run(fns)                                   # probe -> a fails -> b
    assert g.stats()["probes"] == 1
    g.run(fns)                                   # clean 1 again: NO probe
    assert g.stats()["probes"] == 1
    g.run(fns)
    g.run(fns)                                   # probe #2
    assert g.stats()["probes"] == 2


def test_resilience_policy_validation_and_backoff():
    with pytest.raises(ValueError, match="max_retries"):
        ResiliencePolicy(max_retries=-1)
    with pytest.raises(ValueError, match="backoff_factor"):
        ResiliencePolicy(backoff_factor=0.5)
    with pytest.raises(ValueError, match="wave_timeout_s"):
        ResiliencePolicy(wave_timeout_s=0.0)
    with pytest.raises(ValueError, match="degrade_after"):
        ResiliencePolicy(degrade_after=0)
    p = ResiliencePolicy(backoff_base_s=0.01, backoff_factor=2.0,
                         backoff_max_s=0.05)
    assert p.backoff_s(1) == pytest.approx(0.01)
    assert p.backoff_s(2) == pytest.approx(0.02)
    assert p.backoff_s(10) == pytest.approx(0.05)


def test_fault_config_validation():
    with pytest.raises(ValueError, match="wave_fault_rate"):
        FaultConfig(wave_fault_rate=1.5)
    with pytest.raises(ValueError, match="latency_spike_s"):
        FaultConfig(latency_spike_s=-1.0)
    with pytest.raises(ValueError, match="not both"):
        FaultInjector(FaultConfig(), wave_fault_rate=0.1)


# ---------------------------------------------------------------------------
# Overload: admission control and deadline-aware shedding
# ---------------------------------------------------------------------------

def test_overload_policy_validation():
    with pytest.raises(ValueError, match="admission"):
        OverloadPolicy(admission="panic")
    with pytest.raises(ValueError, match="reject_miss_rate"):
        OverloadPolicy(reject_miss_rate=2.0)
    with pytest.raises(ValueError, match="shed_after_s"):
        OverloadPolicy(shed_after_s=0.0)


def test_admission_control_rejects_when_saturated():
    release = threading.Event()
    sched = WaveScheduler(2, lambda wave: release.wait(10.0),
                          one_per_stream=False, deadline_s=None,
                          queue_depth=1, max_pending=2,
                          overload=OverloadPolicy(admission="reject",
                                                  reject_miss_rate=0.0))
    try:
        with pytest.raises(ServerOverloaded, match="admission rejected"):
            for i in range(64):
                sched.submit("s", np.zeros((4, 1), np.float32), lambda: 0)
        assert sched.stats()["rejections"] >= 1
    finally:
        release.set()
        sched.close(abandon=True, timeout=30)


def test_deadline_shedding_drops_hopeless_windows(sess):
    """Windows older than shed_after_s are dropped uncomputed: the client
    gets an ``error="shed"`` row, the stream's carry is dropped, and its
    NEXT window restarts flagged ``state_reset=True``."""
    wins = _windows(2, seed=9)
    cfg = ServingConfig(batch=8, deadline_s=None, backend="ref",
                        resilience=ResiliencePolicy(**FAST),
                        overload=OverloadPolicy(admission="block",
                                                shed_after_s=0.05))
    with StreamServer(sess, cfg) as srv:
        srv.submit("s", wins[0])
        deadline = time.perf_counter() + 10.0
        rows = []
        while not rows and time.perf_counter() < deadline:
            rows = srv.poll(timeout=0.2)
        assert len(rows) == 1
        (r,) = rows
        assert not r.ok and r.error == "shed" and r.y is None
        assert srv.metrics_summary()["faults"]["sheds"] == 1
        srv.submit("s", wins[1])
        srv.flush(timeout=30)
        (r2,) = srv.poll()
        assert r2.ok and r2.state_reset
        np.testing.assert_array_equal(r2.y, _oracle(sess, wins[1:2])[0])


def test_scheduler_error_clears_after_recovery():
    both_in = threading.Event()
    calls = []

    def execute(wave):
        both_in.wait(10.0)
        calls.append(wave)
        if len(calls) == 1:
            raise RuntimeError("transient device error")

    sched = WaveScheduler(1, execute, one_per_stream=False,
                          deadline_s=None, queue_depth=2)
    try:
        sched.submit("s", np.zeros((4, 1), np.float32), lambda: 0)
        sched.submit("s", np.zeros((4, 1), np.float32), lambda: 1)
        both_in.set()
        deadline = time.perf_counter() + 10.0
        while sched.stats()["recoveries"] == 0 \
                and time.perf_counter() < deadline:
            time.sleep(0.005)
        assert sched.stats()["recoveries"] == 1
        assert sched.error is None
        sched.submit("s", np.zeros((4, 1), np.float32), lambda: 2)
        sched.flush(timeout=10)
    finally:
        sched.close(abandon=True, timeout=30)


def test_close_reports_leaked_threads():
    release = threading.Event()
    sched = WaveScheduler(1, lambda wave: release.wait(30.0),
                          one_per_stream=False, deadline_s=None,
                          queue_depth=1)
    try:
        sched.submit("s", np.zeros((4, 1), np.float32), lambda: 0)
        time.sleep(0.1)
        leaked = sched.close(abandon=True, timeout=0.3)
        assert leaked == ["wave-compute"]
        assert sched.leaked_threads == ["wave-compute"]
    finally:
        release.set()


# ---------------------------------------------------------------------------
# submit() validation — malformed input never reaches the compute thread
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window,match", [
    (np.full((4, 1), np.nan, np.float32), "NaN"),
    (np.zeros((4,), np.float32), r"\(T, M\)"),
    (np.zeros((4, 3), np.float32), "input_size"),
    (np.zeros((0, 1), np.float32), "input_size"),
    ([["not", "numbers"], ["at", "all"]], "not convertible"),
])
def test_submit_rejects_malformed_windows(sess, window, match):
    with StreamServer(sess, batch=2, deadline_s=0.005) as srv:
        with pytest.raises(ValueError, match=match):
            srv.submit("s", window)
        assert srv.metrics_summary()["waves"] == 0
        assert srv.drain(timeout=30) == []


# ---------------------------------------------------------------------------
# Concurrency stress: submit/end_stream churn under chaos
# ---------------------------------------------------------------------------

def _join_all(threads):
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
        assert not t.is_alive()


@pytest.mark.slow
def test_concurrent_submit_end_stream_stress(sess):
    """4 client threads x 4 streams each, ending and reviving their
    streams mid-run, under a 5% injected fault rate: no deadlock, no
    crash, every submitted window answered exactly once, per-thread
    per-generation rows in submission order."""
    inj = FaultInjector(seed=21, wave_fault_rate=0.05)
    cfg = ServingConfig(batch=8, deadline_s=0.002, backend="ref",
                        resilience=ResiliencePolicy(**FAST))
    srv = StreamServer(sess, cfg, fault_injector=inj)
    n_threads, n_streams, k = 4, 4, 6
    submitted = [0] * n_threads
    errors = []

    def client(ti):
        try:
            rng = np.random.default_rng(100 + ti)
            for sid_i in range(n_streams):
                sid = f"t{ti}-{sid_i}"
                for w in range(k):
                    win = rng.uniform(0, 1, (SEQ_LEN, 1)).astype(np.float32)
                    srv.submit(sid, win)
                    submitted[ti] += 1
                    if w == 2:
                        srv.end_stream(sid)
        except BaseException as e:
            errors.append(e)

    _join_all([threading.Thread(target=client, args=(ti,))
               for ti in range(n_threads)])
    assert not errors, errors
    rows = srv.drain(timeout=120)
    assert srv.close(timeout=30) == []
    assert len(rows) == sum(submitted) == n_threads * n_streams * k
    per_stream = {}
    for r in rows:
        per_stream.setdefault(r.stream_id, []).append(r.seq)
    for sid, seqs in per_stream.items():
        assert sorted(seqs) == sorted(list(range(3)) * 2), sid


# ---------------------------------------------------------------------------
# Surfaces: ladder API, metrics counters
# ---------------------------------------------------------------------------

def test_api_degradation_ladder(sessions):
    js, ts = sessions
    ladder = ts.degradation_ladder()
    assert set(ladder) == {"ref", "xla", "pallas"}
    assert ladder[0] == ts.plan["stateful_backend"]
    assert ts.degradation_ladder(backend="xla")[0] == "xla"
    assert ladder == tbackends.degradation_ladder(ts.model, ts.accel)
    assert ladder == js.degradation_ladder()
    # On a CUDA session the ladder ends at the fused kernels' engine.
    assert tbackends.degradation_ladder(
        ts.model, ts.accel, device=torch.device("cuda")) == ("pallas",)


def test_metrics_sink_named_counters():
    from repro_torch.serving import MetricsSink
    m = MetricsSink()
    assert m.counters() == {}
    m.count("sheds")
    m.count("state_resets", 3)
    m.count("sheds")
    assert m.counters() == {"sheds": 2, "state_resets": 3}


def test_eviction_reset_is_flagged_on_returning_stream(sess):
    """A stream LRU-evicted while a window is still in flight keeps its
    numbering, and the in-flight window — computed from the reset carry —
    comes back ``state_reset=True`` and bumps the counter."""
    xs = {sid: _windows(2, seed=60 + i) for i, sid in enumerate("ab")}
    with StreamServer(sess, batch=2, deadline_s=None,
                      max_streams=1) as srv:
        for w in range(2):
            for sid in "ab":
                srv.submit(sid, xs[sid][w])
        rows = {(r.stream_id, r.seq): r for r in srv.drain(timeout=30)}
        assert rows[("a", 1)].state_reset
        assert rows[("a", 1)].ok
        assert not rows[("a", 0)].state_reset
        assert not rows[("b", 0)].state_reset
        assert srv.metrics_summary()["faults"]["state_resets"] >= 1
        np.testing.assert_array_equal(
            rows[("a", 1)].y, _oracle(sess, xs["a"][1:2])[0])


def test_wave_timeout_exception_type():
    assert issubclass(WaveTimeout, RuntimeError)
    assert issubclass(InjectedFault, RuntimeError)
    assert issubclass(ServerOverloaded, RuntimeError)


# ---------------------------------------------------------------------------
# Device-resident state under chaos (the slot table's partition contract)
# ---------------------------------------------------------------------------

def test_corrupt_slot_flips_the_low_bit_of_one_row(sess):
    """``DeviceStateStore.corrupt_slot``: the stream's row XOR 1, every
    other row untouched, False for an unknown stream."""
    store = DeviceStateStore(sess, capacity=4)
    slot, _ = store.assign("a")
    store.table[slot] = 6
    before = store.table.clone()
    assert store.corrupt_slot("a")
    assert not store.corrupt_slot("nobody")
    want = before.clone()
    want[slot] ^= 1
    assert torch.equal(store.table, want)
    assert int(store.table[slot].min()) == 7


@pytest.mark.chaos
def test_chaos_state_loss_on_device_store(sessions):
    """The host-store loss drill replayed against the DEVICE slot table
    (backend=pallas resolves state_residency=device): a committed row
    whose slot is dropped flags the stream's next window ``state_reset``,
    survivors stay bit-exact, the per-wave carry transfer counters stay at
    zero, and the reference's device store injects the same schedule."""
    xs, rows, summary, inj = _chaos_both(sessions, "pallas", seed=3, k=4,
                                         state_loss_rate=0.15,
                                         wave_fault_rate=0.1)
    assert summary["state_residency"] == "device"
    assert summary["state"]["residency"] == "device"
    assert inj.stats()["state_losses"] > 0
    _check_partition(sessions[1], xs, rows, inj)
    for sid, by in rows.items():
        if any(r.state_reset for r in by.values()):
            assert sid in inj.lost_streams
    t = summary["state_transfer"]
    assert t["to_device_bytes"] == 0 and t["from_device_bytes"] == 0
    assert t["slot_id_bytes"] > 0


@pytest.mark.chaos
def test_chaos_state_corruption_on_device_store(sessions):
    """Corrupted table rows (the device form of put-corruption) are
    recorded by the injector; untouched streams still verify bit-exactly
    through the slot-gathered path, and every row equals the
    reference's."""
    xs, rows, summary, inj = _chaos_both(sessions, "pallas", seed=5, k=3,
                                         state_corrupt_rate=0.5)
    assert summary["state_residency"] == "device"
    assert inj.stats()["state_corruptions"] > 0
    for sid, wins in xs.items():
        if sid in inj.corrupted_streams:
            continue
        oracle = _oracle(sessions[1], wins)
        for q, r in rows[sid].items():
            assert r.ok
            np.testing.assert_array_equal(r.y, oracle[q])


@pytest.mark.slow
def test_concurrent_device_store_stress(sess):
    """N client threads churning end_stream against the device slot table
    under injected wave faults AND state loss — no deadlock, every window
    answered exactly once, per-generation seq numbering intact; streams
    the injector never touched are bit-exact in BOTH generations; every
    reset flag traces back to a real cause."""
    inj = FaultInjector(seed=29, wave_fault_rate=0.1, state_loss_rate=0.12)
    cfg = ServingConfig(batch=8, deadline_s=0.002, backend="pallas",
                        state_residency="device",
                        resilience=ResiliencePolicy(**FAST))
    srv = StreamServer(sess, cfg, fault_injector=inj)
    assert srv.state_residency == "device"
    n_threads, n_streams, k = 4, 3, 6
    windows = {}
    errors = []

    def client(ti):
        try:
            rng = np.random.default_rng(200 + ti)
            for sid_i in range(n_streams):
                sid = f"t{ti}-{sid_i}"
                wins = rng.uniform(0, 1, (k, SEQ_LEN, 1)).astype(np.float32)
                windows[sid] = wins
                for w in range(k):
                    srv.submit(sid, wins[w])
                    if w == 2:
                        srv.end_stream(sid)
        except BaseException as e:
            errors.append(e)

    _join_all([threading.Thread(target=client, args=(ti,))
               for ti in range(n_threads)])
    assert not errors, errors
    rows = srv.drain(timeout=120)
    summary = srv.metrics_summary()
    assert srv.close(timeout=30) == []
    assert len(rows) == n_threads * n_streams * k
    assert summary["state_transfer"]["to_device_bytes"] == 0
    assert summary["state_transfer"]["from_device_bytes"] == 0
    per_stream = {}
    for r in rows:
        per_stream.setdefault(r.stream_id, []).append(r)
    verified = 0
    for sid, rs in per_stream.items():
        assert [r.seq for r in rs] == [0, 1, 2, 0, 1, 2], sid
        for idx, r in enumerate(rs):
            if not r.ok:
                assert r.y is None and r.error
            if r.state_reset and idx >= 3:
                assert sid in inj.lost_streams \
                    or any(not p.ok for p in rs[:idx]), sid
        if sid in inj.corrupted_streams:
            continue
        for gen, lo in ((rs[:3], 0), (rs[3:], 3)):
            if any((not r.ok) or r.state_reset for r in gen):
                continue
            oracle = _oracle(sess, windows[sid][lo:lo + 3])
            for q, r in enumerate(gen):
                np.testing.assert_array_equal(r.y, oracle[q])
            verified += 1
    assert verified >= 6
