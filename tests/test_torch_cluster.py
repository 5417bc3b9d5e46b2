"""The port's multi-replica serving cluster (``repro_torch.serving.cluster``
/ ``routing``) on the CPU — ``tests/test_cluster.py``'s battery, held
against the reference where the two can be compared.

The load-bearing guarantee is the ROUTING INVARIANT: every named stream's
windows all execute on ONE replica (consistent hash), so its carry stays
replica-local, and windowed-through-the-cluster is bit-identical on the
int path to the concatenated one-shot run.  ``HashRing`` must route
every key to the reference's replica name (10,000 keys, 4 seeds, before
and after a leave and a join), and the port's cluster must serve the
reference cluster's rows.  The replicas share the one CPU device here,
as ``serving_devices`` oversubscribes it; on one card they share
``cuda:0``.  Every drain and close has a timeout."""

import math
import time

import pytest

pytest.importorskip("jax")  # the reference package; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import qlstm as jq  # noqa: E402
from repro.serving import ClusterServer as JClusterServer  # noqa: E402
from repro.serving import HashRing as JHashRing  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import qlstm as tq  # noqa: E402
from repro_torch.launch.mesh import serving_devices  # noqa: E402
from repro_torch.serving import (ClusterConfig, ClusterServer,  # noqa: E402
                                 HashRing, MetricsSink, OverloadPolicy,
                                 ServerOverloaded)
from repro_torch.serving.metrics import WaveRecord  # noqa: E402

MODEL_KW = dict(input_size=1, hidden_size=8, num_layers=2, seq_len=4)
SEQ_LEN = MODEL_KW["seq_len"]
CPU = torch.device("cpu")


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


def _int(sess, x):
    """The session's int-path prediction for (B, T, 1) float windows."""
    return sess.infer(x, path="int").numpy()


# ---------------------------------------------------------------------------
# HashRing — the reference's routes, determinism and minimal disruption
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 7, 12345])
def test_ring_routes_every_key_to_the_reference_replica(seed):
    """10,000 keys (strings and ints) on the same replica names as the
    reference's ring, before and after a leave and a join."""
    keys = [f"sensor-{i}" for i in range(5000)] + list(range(5000))
    names = ["r0", "r1", "r2", "r3"]
    t, j = HashRing(names, seed=seed), JHashRing(names, seed=seed)
    assert t.assignments(keys) == j.assignments(keys)
    t.remove("r1")
    j.remove("r1")
    assert t.assignments(keys) == j.assignments(keys)
    t.add("r9")
    j.add("r9")
    assert t.assignments(keys) == j.assignments(keys)
    assert t.nodes == j.nodes and len(t) == len(j) == 4


def test_ring_deterministic_across_instances():
    keys = [f"stream-{i}" for i in range(500)]
    a = HashRing(["r0", "r1", "r2"], seed=7)
    b = HashRing(["r2", "r0", "r1"], seed=7)   # insertion order irrelevant
    assert a.assignments(keys) == b.assignments(keys)
    c = HashRing(["r0", "r1", "r2"], seed=8)
    assert c.assignments(keys) != a.assignments(keys)


def test_ring_balance():
    keys = [f"s{i}" for i in range(3000)]
    ring = HashRing(["r0", "r1", "r2", "r3"], vnodes=64, seed=0)
    counts = {n: 0 for n in ring.nodes}
    for n in ring.assignments(keys).values():
        counts[n] += 1
    for n, c in counts.items():
        assert 0.4 * 3000 / 4 < c < 2.2 * 3000 / 4, counts


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n_keys", [64, 500])
def test_ring_leave_moves_exactly_the_leavers_keys(seed, n_keys):
    keys = [f"k{i}" for i in range(n_keys)]
    ring = HashRing(["r0", "r1", "r2", "r3"], seed=seed)
    before = ring.assignments(keys)
    ring.remove("r2")
    after = ring.assignments(keys)
    for k in keys:
        if before[k] == "r2":
            assert after[k] != "r2"
        else:
            assert after[k] == before[k]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ring_join_moves_at_most_its_fair_share(seed):
    keys = [f"k{i}" for i in range(600)]
    ring = HashRing(["r0", "r1", "r2"], seed=seed)
    before = ring.assignments(keys)
    ring.add("r3")
    after = ring.assignments(keys)
    moved = [k for k in keys if after[k] != before[k]]
    assert all(after[k] == "r3" for k in moved)
    fair = math.ceil(len(keys) / 4)
    assert len(moved) <= 2 * fair, (len(moved), fair)


def test_ring_edge_cases():
    with pytest.raises(RuntimeError):
        HashRing().route("k")
    with pytest.raises(ValueError):
        HashRing(vnodes=0)
    ring = HashRing(["a"])
    with pytest.raises(ValueError):
        ring.add("a")
    with pytest.raises(KeyError):
        ring.remove("b")
    assert ring.route("anything") == "a"
    assert "a" in ring and len(ring) == 1


# ---------------------------------------------------------------------------
# MetricsSink.merge — the cluster aggregation primitive
# ---------------------------------------------------------------------------

def _rec(t, lat=0.010, occ=4, batch=4):
    return WaveRecord(t_done=t, compute_s=lat / 2, latency_s=lat,
                      occupancy=occ, batch=batch, deadline_flush=False)


def test_merge_empty_and_partial():
    assert MetricsSink.merge([]).summary()["waves"] == 0
    empty, live = MetricsSink(), MetricsSink()
    live.note_submit(100.0)
    live.record_wave(_rec(100.5))
    s = MetricsSink.merge([empty, live]).summary()
    assert s["waves"] == 1 and s["samples"] == 4
    assert s["wall_s"] == pytest.approx(0.5)


def test_merge_sums_counters_and_spans_walls():
    a, b = MetricsSink(), MetricsSink()
    a.note_submit(10.0)
    b.note_submit(10.2)
    for t in (10.5, 11.0):
        a.record_wave(_rec(t, occ=3))
    b.record_wave(_rec(12.0, occ=5))
    a.count("sheds", 2)
    b.count("sheds")
    b.count("state_resets", 4)
    m = MetricsSink.merge([a, b])
    s = m.summary()
    assert s["waves"] == 3 and s["samples"] == 11
    assert s["wall_s"] == pytest.approx(2.0)
    assert s["samples_per_s"] == pytest.approx(11 / 2.0)
    assert m.counters() == {"sheds": 3, "state_resets": 4}


def test_merge_percentiles_union_recent_window():
    a, b = MetricsSink(), MetricsSink()
    lats = []
    for i in range(20):
        (a if i % 2 else b).record_wave(_rec(100.0 + i, lat=0.001 * (i + 1)))
        lats.append(0.001 * (i + 1))
    s = MetricsSink.merge([a, b]).summary()
    want = np.percentile(np.asarray(lats), [50, 95, 99]) * 1e3
    assert s["latency_ms"]["p50"] == pytest.approx(want[0])
    assert s["latency_ms"]["p99"] == pytest.approx(want[2])


def test_merge_truncates_to_window():
    a = MetricsSink()
    for i in range(10):
        a.record_wave(_rec(100.0 + i))
    m = MetricsSink.merge([a], window=4)
    assert [r.t_done for r in m.waves] == [106.0, 107.0, 108.0, 109.0]
    assert m.summary()["waves"] == 10


# ---------------------------------------------------------------------------
# Accelerator.replicate — per-device pinned replicas
# ---------------------------------------------------------------------------

def test_replicate_pins_bit_identical_codes(sess):
    """Replicas carry the SAME integer codes (pinned, not re-quantised),
    on their device, and produce bit-identical int-path output."""
    reps = sess.replicate(2) + sess.replicate(1, devices=["cpu"])
    x = _windows(3, seed=5)
    want = _int(sess, x)
    for rep in reps:
        assert rep.device == CPU
        leaves = [t for layer in rep.qparams["layers"] for t in layer.values()]
        leaves += list(rep.qparams["dense"].values())
        assert all(t.device == rep.device for t in leaves)
        np.testing.assert_array_equal(_int(rep, x), want)


def test_replicate_requires_quantized():
    with pytest.raises(RuntimeError, match="quantised"):
        repro_torch.build(tq.QLSTMConfig(**MODEL_KW), device="cpu"
                          ).replicate(2)


def test_serving_devices_contract():
    """Oversubscribe by default; ``oversubscribe=False`` raises when the
    visible devices of the type are fewer than ``n``; explicit lists are
    taken as given.  A CUDA request is dealt cards only: with none
    visible it raises instead of handing out the CPU."""
    devs = serving_devices(3, kind="cpu")
    assert devs == [CPU] * 3
    with pytest.raises(ValueError):
        serving_devices(0)
    with pytest.raises(RuntimeError, match="oversubscribe"):
        serving_devices(3, oversubscribe=False, kind="cpu")
    with pytest.raises(ValueError):
        serving_devices(2, devices=[CPU])
    assert serving_devices(2, devices=["cpu", CPU, "cpu"]) == [CPU, CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no cuda device"):
            serving_devices(2, kind="cuda")
    with pytest.raises(ValueError, match="device type"):
        serving_devices(1, kind="tpu")


# ---------------------------------------------------------------------------
# ClusterServer — the routing invariant, end to end
# ---------------------------------------------------------------------------

def _cluster(sess, n=3, **kw):
    kw.setdefault("batch", 4)
    kw.setdefault("deadline_s", 0.002)
    return ClusterServer(sess.replicate(n), **kw)


@pytest.mark.slow
def test_cluster_routing_invariant_and_bit_exact_carry(sess):
    """Every stream's windows run on exactly one replica (the ring's
    assignment), and each stream's windowed-on-the-cluster predictions
    are bit-exact against the single-session concatenated run."""
    k, t = 3, SEQ_LEN
    streams = {f"c{i}": _windows(k, seed=30 + i) for i in range(9)}
    with _cluster(sess, 3) as cluster:
        expect = {sid: cluster.replica_for(sid) for sid in streams}
        for w in range(k):
            for sid, xs in streams.items():
                cluster.submit(sid, xs[w])
        results = cluster.drain(timeout=120)
    by = {}
    for r in results:
        assert r.ok
        assert r.routed_replica == expect[r.stream_id]
        by.setdefault(r.stream_id, {})[r.seq] = r.y
    assert len({expect[s] for s in streams}) > 1
    for sid, xs in streams.items():
        assert sorted(by[sid]) == list(range(k))
        for w in range(k):
            oracle = _int(sess, xs[:w + 1].reshape(1, (w + 1) * t, 1))
            np.testing.assert_array_equal(by[sid][w], oracle[0])


def test_cluster_rows_equal_the_reference_cluster(sessions):
    """The same streams through both packages' clusters: the same (stream,
    seq) rows on the same replica names with the same predictions."""
    js, ts = sessions
    k = 3
    streams = {f"x{i}": _windows(k, seed=120 + i) for i in range(10)}

    def serve(cluster):
        with cluster:
            for w in range(k):
                for sid, xs in streams.items():
                    cluster.submit(sid, xs[w])
            return {(r.stream_id, r.seq): r
                    for r in cluster.drain(timeout=120)}

    kw = dict(batch=4, deadline_s=0.002)
    trows = serve(ClusterServer(ts.replicate(3), **kw))
    jrows = serve(JClusterServer(js.replicate(3), **kw))
    assert trows.keys() == jrows.keys() and len(trows) == 10 * k
    for key, tr in trows.items():
        jr = jrows[key]
        assert (tr.routed_replica, tr.ok, tr.state_reset) == \
            (jr.routed_replica, jr.ok, jr.state_reset), key
        np.testing.assert_array_equal(tr.y, np.asarray(jr.y))


def test_cluster_rejects_non_replicas(sess):
    other = repro_torch.build(tq.QLSTMConfig(**MODEL_KW), seed=42,
                              device="cpu").quantize()
    with pytest.raises(ValueError, match="weights"):
        ClusterServer([sess, other], batch=2)
    with pytest.raises(ValueError, match="replica"):
        ClusterServer([], batch=2)
    with pytest.raises(ValueError, match="names"):
        ClusterServer(sess.replicate(2), names=["a"], batch=2)


def test_cluster_metrics_aggregate(sess):
    """metrics_summary: merged aggregate block + per-replica breakdown +
    summed fault/state counters + the ring block + the replicas'
    sample-weighted GOP/s/W."""
    with _cluster(sess, 2) as cluster:
        for i, w in enumerate(_windows(12, seed=6)):
            cluster.submit(f"m{i % 4}", w)
        cluster.drain(timeout=120)
        s = cluster.metrics_summary()
    assert s["samples"] == 12 and s["waves"] >= 3
    assert set(s["replicas"]) == {"r0", "r1"}
    assert s["samples_per_s"] > 0 and s["samples_per_s_sum"] > 0
    assert {"p50", "p95", "p99"} <= set(s["latency_ms"])
    assert s["faults"]["sheds"] == 0 and s["faults"]["backend"]
    assert s["faults"]["injected"] is None
    assert s["state"]["live_streams"] == 4
    assert s["ring"]["vnodes"] == 64
    assert s["ring"]["streams_routed"] == 4
    assert s["health"]["status"] == "ok"
    assert s["gops_per_watt"] > 0
    assert all(p["ops_per_inference"] == tq.ops_per_inference(sess.model)
               for p in s["replicas"].values() if p["waves"])


def test_cluster_end_stream(sess):
    x = _windows(2, seed=8)
    fresh = _int(sess, x[1:2])
    with _cluster(sess, 2, batch=2) as cluster:
        assert cluster.submit("e", x[0]) == 0
        cluster.flush(timeout=60)
        cluster.end_stream("e")
        assert cluster.submit("e", x[1]) == 0
        results = cluster.drain(timeout=60)
    last = [r for r in results if r.seq == 0][-1]
    np.testing.assert_array_equal(last.y, fresh[0])


def test_cluster_overload_propagates_replica_name(sess):
    policy = OverloadPolicy(admission="reject")
    with _cluster(sess, 2, batch=2, deadline_s=None, max_pending=2,
                  queue_depth=1, overload=policy) as cluster:
        with pytest.raises(ServerOverloaded, match="replica 'r[01]'"):
            for w in _windows(64, seed=9):
                cluster.submit("hot", w)
        cluster.drain(timeout=60)


def test_cluster_remove_replica_moves_only_its_streams(sess):
    """Drain/rebalance with HOST-resident state: the ring shrink moves
    ONLY the removed replica's streams; each restarts at its new home
    with seq 0 and ``state_reset=True``, its prediction a fresh stream's.
    Unmoved streams keep replica, numbering and carry."""
    k = 2
    streams = {f"d{i}": _windows(k + 1, seed=40 + i) for i in range(8)}
    with _cluster(sess, 3, state_residency="host") as cluster:
        for w in range(k):
            for sid, xs in streams.items():
                cluster.submit(sid, xs[w])
        cluster.drain(timeout=60)
        before = {sid: cluster.replica_for(sid) for sid in streams}
        victim = before["d0"]
        moved = cluster.remove_replica(victim)
        assert sorted(moved) == sorted(
            s for s, r in before.items() if r == victim)
        assert victim not in cluster.replicas
        for sid, xs in streams.items():
            cluster.submit(sid, xs[k])
        by = {r.stream_id: r for r in cluster.drain(timeout=60)}
        for sid, xs in streams.items():
            r = by[sid]
            if sid in moved:
                assert r.seq == 0 and r.state_reset
                assert r.routed_replica != victim
                np.testing.assert_array_equal(
                    r.y, _int(sess, xs[k].reshape(1, SEQ_LEN, 1))[0])
            else:
                assert r.seq == k and not r.state_reset
                assert r.routed_replica == before[sid]
                np.testing.assert_array_equal(
                    r.y, _int(sess, xs.reshape(1, (k + 1) * SEQ_LEN, 1))[0])
        with pytest.raises(KeyError):
            cluster.remove_replica(victim)


def test_cluster_remove_replica_warm_handoff_device_residency(sess):
    """With DEVICE-resident state (``auto`` on the fused plan) a planned
    drain is a WARM handoff: each moved carry is read back from the dying
    replica's slot table and seeded into the stream's new ring home (the
    read-back rows equal the ref engine's threaded state), so the next
    window continues bit-exactly — seq restarts at 0 with NO
    ``state_reset`` flag.  Unmoved streams keep everything."""
    k, t = 2, SEQ_LEN
    streams = {f"w{i}": _windows(k + 1, seed=60 + i) for i in range(8)}
    ref = sess.compiled_stateful("ref")

    def carry_after(xs, n):
        state = sess.init_state(1)
        for w in xs[:n]:
            _, state = ref(w[None], state)
        return state

    with _cluster(sess, 3) as cluster:
        assert all(s.state_residency == "device"
                   for s in cluster._servers.values())
        for w in range(k):
            for sid, xs in streams.items():
                cluster.submit(sid, xs[w])
        cluster.drain(timeout=60)
        before = {sid: cluster.replica_for(sid) for sid in streams}
        victim = before["w0"]
        moved = cluster.remove_replica(victim)
        assert sorted(moved) == sorted(
            s for s, r in before.items() if r == victim)
        assert victim not in cluster.replicas
        for sid in moved:
            dest = cluster.replica_for(sid)
            assert dest != victim
            got = cluster._servers[dest].read_stream_state(sid)
            assert got is not None
            oracle_state = carry_after(streams[sid], k)
            for li, (h, c) in enumerate(got):
                oh, oc = oracle_state[li]
                np.testing.assert_array_equal(h, oh.numpy()[0])
                np.testing.assert_array_equal(c, oc.numpy()[0])
        for sid, xs in streams.items():
            cluster.submit(sid, xs[k])
        by = {r.stream_id: r for r in cluster.drain(timeout=60)}
        for sid, xs in streams.items():
            r = by[sid]
            assert r.ok and not r.state_reset, sid
            if sid in moved:
                assert r.seq == 0 and r.routed_replica != victim
            else:
                assert r.seq == k and r.routed_replica == before[sid]
            np.testing.assert_array_equal(
                r.y, _int(sess, xs.reshape(1, (k + 1) * t, 1))[0])


def test_cluster_remove_replica_abandon_skips_handoff(sess):
    """``abandon=True`` on a device-residency drain: nothing is read back
    — moved streams restart COLD with the flagged reset."""
    k = 1
    streams = {f"a{i}": _windows(k + 1, seed=80 + i) for i in range(8)}
    with _cluster(sess, 3) as cluster:
        for sid, xs in streams.items():
            cluster.submit(sid, xs[0])
        cluster.drain(timeout=60)
        before = {sid: cluster.replica_for(sid) for sid in streams}
        victim = before["a0"]
        moved = cluster.remove_replica(victim, abandon=True)
        for sid, xs in streams.items():
            cluster.submit(sid, xs[k])
        by = {r.stream_id: r for r in cluster.drain(timeout=60)}
        for sid, xs in streams.items():
            r = by[sid]
            if sid in moved:
                assert r.seq == 0 and r.state_reset
                np.testing.assert_array_equal(
                    r.y, _int(sess, xs[k].reshape(1, SEQ_LEN, 1))[0])
            else:
                assert r.seq == k and not r.state_reset


def test_cluster_cannot_remove_last_replica(sess):
    with _cluster(sess, 1) as cluster:
        with pytest.raises(RuntimeError, match="last"):
            cluster.remove_replica("r0")
        assert cluster.replicas == ["r0"]


def test_cluster_add_replica_rebalances_lazily(sess):
    streams = {f"g{i}": _windows(2, seed=60 + i) for i in range(8)}
    with _cluster(sess, 2) as cluster:
        for sid, xs in streams.items():
            cluster.submit(sid, xs[0])
        cluster.drain(timeout=60)
        before = {sid: cluster.replica_for(sid) for sid in streams}
        name = cluster.add_replica(sess.replicate(1)[0])
        assert name == "r2" and name in cluster.replicas
        after = {sid: cluster.replica_for(sid) for sid in streams}
        stolen = [s for s in streams if after[s] != before[s]]
        assert all(after[s] == name for s in stolen)
        for sid, xs in streams.items():
            cluster.submit(sid, xs[1])
        for r in cluster.drain(timeout=60):
            if r.stream_id in stolen:
                assert r.seq == 0 and r.state_reset
                assert r.routed_replica == name
            else:
                assert r.seq == 1 and not r.state_reset
        other = repro_torch.build(tq.QLSTMConfig(**MODEL_KW), seed=42,
                                  device="cpu").quantize()
        with pytest.raises(ValueError, match="weights"):
            cluster.add_replica(other)


def test_cluster_failover_reroutes_on_failed_replica(sess, monkeypatch):
    streams = {f"f{i}": _windows(2, seed=70 + i) for i in range(6)}
    with _cluster(sess, 2) as cluster:
        for sid, xs in streams.items():
            cluster.submit(sid, xs[0])
        cluster.drain(timeout=60)
        owners = {sid: cluster.replica_for(sid) for sid in streams}
        victim = owners[next(iter(streams))]
        srv = cluster._servers[victim]
        monkeypatch.setattr(
            srv, "submit",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("dead")))
        monkeypatch.setattr(srv, "health", lambda: {"status": "failed"})
        hit = [s for s, r in owners.items() if r == victim]
        seq = cluster.submit(hit[0], streams[hit[0]][1])
        assert seq == 0
        assert victim not in cluster.replicas
        results = cluster.drain(timeout=60)
        moved = [r for r in results if r.stream_id == hit[0]]
        assert moved and moved[0].state_reset
        assert moved[0].routed_replica != victim
        h = cluster.health()
        assert h["status"] == "degraded"
        assert victim in h["unhealthy"]


def test_cluster_restore_replica(sess):
    with _cluster(sess, 2) as cluster:
        xs = _windows(3, seed=80)
        sid = "rt"
        home = cluster.replica_for(sid)
        other = next(n for n in cluster.replicas if n != home)
        cluster.submit(sid, xs[0])
        cluster.drain(timeout=60)
        cluster.mark_unhealthy(home, reason="drill")
        assert cluster.replica_for(sid) == other
        cluster.submit(sid, xs[1])
        r1 = cluster.drain(timeout=60)[0]
        assert r1.routed_replica == other and r1.seq == 0 and r1.state_reset
        with pytest.raises(RuntimeError, match="last"):
            cluster.mark_unhealthy(other)
        cluster.restore_replica(home)
        assert cluster.replica_for(sid) == home
        cluster.submit(sid, xs[2])
        r2 = cluster.drain(timeout=60)[0]
        assert r2.routed_replica == home and r2.seq == 0 and r2.state_reset
        np.testing.assert_array_equal(
            r2.y, _int(sess, xs[2].reshape(1, SEQ_LEN, 1))[0])


def test_cluster_poll_timeout_and_close(sess):
    with _cluster(sess, 2) as cluster:
        t0 = time.perf_counter()
        assert cluster.poll(timeout=0.05) == []
        assert time.perf_counter() - t0 >= 0.04
        cluster.submit("p", _windows(1, seed=90)[0])
        rows = cluster.poll(timeout=5.0)
        assert rows and rows[0].ok
    assert cluster.close(timeout=30) == []
    with pytest.raises(RuntimeError, match="closed"):
        cluster.submit("p", _windows(1, seed=90)[0])


def test_cluster_bad_window_raises_to_caller_only(sess):
    with _cluster(sess, 2) as cluster:
        with pytest.raises(ValueError, match="window"):
            cluster.submit("b", np.zeros((4, 3), np.float32))
        assert cluster.health()["status"] == "ok"
        assert len(cluster.replicas) == 2


def test_cluster_config_validation():
    with pytest.raises(ValueError, match="vnodes"):
        ClusterConfig(vnodes=0)


def test_build_cluster_front_door(sess):
    cluster = repro_torch.build_cluster(sess, 2, batch=2, deadline_s=0.002,
                                        vnodes=16)
    try:
        assert len(cluster.replicas) == 2
        assert cluster.config.vnodes == 16
        assert cluster.config.serving.batch == 2
        cluster.submit("q", _windows(1, seed=95)[0])
        rows = cluster.drain(timeout=60)
        assert rows[0].ok and rows[0].routed_replica in ("r0", "r1")
    finally:
        cluster.close(timeout=30)
