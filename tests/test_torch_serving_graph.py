"""The serving wave's slot datapath replayed from CUDA graphs
(``backends/slot_graph.py``) and the live table it relies on.

CPU tests: ``DeviceStateStore`` writes its live table in place (commit,
seed, corrupt), so the table keeps one address for the store's life; a
failed wave leaves the live table's bytes as they were; every engine's
slot path takes x and the slot ids as host arrays and only reads the
table it is handed; and the device-resident server answers a stream of
waves (resets, LRU evictions with batch > capacity, padding, ended
streams) exactly as the host-resident one.

``gpu`` tests, on the card: the graph path against the eager path bit
for bit, ``y`` and every table row, over hundreds of waves with all of
the above plus failed waves, ``corrupt_slot`` and ``seed_state``
between waves; two servers on one session; a table the engine has not
seen; a result that survives the next wave; one launch and one stamp a
replay; one capture, and every wave after warm-up replayed."""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch import backends as tbackends
from repro_torch.backends.slot_graph import SlotGraphs
from repro_torch.core import qlstm as tq
from repro_torch.kernels import qlstm_cell
from repro_torch.serving import (DeviceStateStore, FaultInjector,
                                 ResiliencePolicy, StreamServer)

MODEL_KW = dict(input_size=1, hidden_size=8, num_layers=2, seq_len=4)
T, M = MODEL_KW["seq_len"], MODEL_KW["input_size"]


def _session(device):
    return repro_torch.build(tq.QLSTMConfig(**MODEL_KW), seed=0,
                             device=device).quantize()


@pytest.fixture(scope="module")
def sess():
    return _session("cpu")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _window(rng):
    return rng.uniform(-1.0, 1.0, (T, M)).astype(np.float32)


def _drive(srv, rounds, streams, seed, events=True):
    """``rounds`` rounds of windows for a random subset of ``streams``
    streams each, flushed per round (``deadline_s=None``: waves are the
    submission order in chunks of ``batch``, the last padded), with an
    ended stream whose window is still pending, a corrupted row and a
    seeded carry between rounds.  Returns the results by (stream, seq)
    and, on a device-resident server, the table after every round."""
    rng = np.random.default_rng(seed)
    rows, tables = {}, []
    for r in range(rounds):
        order = rng.permutation(streams)[:rng.integers(1, streams + 1)]
        for j, i in enumerate(order):
            srv.submit(f"s{i}", _window(rng))
            if events and j == 0 and r % 7 == 3:
                # Pending (fewer than a wave): its scatter goes to TRASH.
                srv.end_stream(f"s{i}")
        srv.flush(timeout=120)
        if events and r % 11 == 5:
            srv.states.corrupt_slot(f"s{order[-1]}")
        if events and r % 13 == 6:
            carry = srv.read_stream_state(f"s{order[0]}")
            if carry is not None:
                srv.seed_stream_state(f"s{streams + r}", carry)
        for res in srv.poll():
            rows[(res.stream_id, res.seq)] = (
                None if res.y is None else res.y.copy(), res.state_reset,
                res.error)
        if srv.state_residency == "device":
            tables.append(srv.states.table.cpu().clone())
    return rows, tables


# ---------------------------------------------------------------------------
# CPU: the live table in place, host arrays in
# ---------------------------------------------------------------------------

def test_commit_seed_and_corrupt_keep_the_table_address(sess):
    """Waves with evictions, a seeded carry and a corrupted row: the store
    writes one table in place, never a new one."""
    with StreamServer(sess, batch=4, deadline_s=None,
                      max_streams=5) as srv:
        table = srv.states.table
        ptr = table.data_ptr()
        rows, tables = _drive(srv, 20, 8, seed=1)
        assert srv.states.table is table
        assert table.data_ptr() == ptr
        assert srv.states.stats()["evictions"] > 0
    assert any(not torch.equal(a, b) for a, b in zip(tables, tables[1:]))


def test_seed_state_writes_its_row_in_place(sess):
    store = DeviceStateStore(sess, capacity=4)
    table, before = store.table, store.table.clone()
    carry = [(np.full(8, 3, np.int32), np.full(8, -2, np.int32))] * 2
    assert store.seed_state("a", carry) == []
    assert store.table is table
    assert (table != before).flatten(1).any(1).sum() == 1
    for (h, c), (want_h, want_c) in zip(store.read_state("a"), carry):
        np.testing.assert_array_equal(h, want_h)
        np.testing.assert_array_equal(c, want_c)


def test_commit_copies_the_wave_table_in_place(sess):
    """``commit`` copies the wave's table into the live one, which keeps
    its object and address; the wave's table stays its own."""
    store = DeviceStateStore(sess, capacity=4)
    table, ptr = store.table, store.table.data_ptr()
    new = torch.full_like(table, 9)
    store.commit(new, [(0, "a"), (2, "b")])
    assert store.table is table and table.data_ptr() == ptr
    assert torch.equal(table, new) and new.data_ptr() != ptr


@pytest.mark.parametrize("failure", ["injector", "kernel"])
def test_failed_wave_leaves_the_live_table_unchanged(sess, monkeypatch,
                                                     failure):
    """A wave failed by the fault injector or by the kernel itself (the
    ladder resolved as on a CUDA card, so nothing below the fused engine
    carries it): error rows, and the live table's bytes as they were."""
    real = tbackends.degradation_ladder
    monkeypatch.setattr(tbackends, "degradation_ladder", lambda *a, **k: real(
        *a, **{**k, "device": torch.device("cuda")}))
    inj = (FaultInjector(seed=0, wave_fault_rate=1.0)
           if failure == "injector" else None)
    rng = np.random.default_rng(4)
    with StreamServer(sess, batch=4, deadline_s=None, max_streams=8,
                      fault_injector=inj,
                      resilience=ResiliencePolicy(max_retries=0)) as srv:
        for i in range(3):
            srv.seed_stream_state(f"s{i}", [
                tuple(rng.integers(-50, 50, 8).astype(np.int32)
                      for _ in range(2)) for _ in range(2)])
        before = srv.states.table.clone()
        if failure == "kernel":
            def launch_fails(*a, **k):
                raise RuntimeError("qlstm kernel launch failed: injected")
            monkeypatch.setattr(qlstm_cell, "qlstm_seq_slot", launch_fails)
        for i in range(5):
            srv.submit(f"s{i}", _window(rng))
        out = srv.drain(timeout=60)
        assert len(out) == 5 and not any(r.ok for r in out)
        assert torch.equal(srv.states.table, before)


@pytest.mark.parametrize("backend", ["ref", "xla", "pallas"])
def test_slot_path_takes_host_arrays(sess, backend):
    """x, gather and scatter as numpy arrays give what tensors give, on
    every engine, and the table handed in is only read."""
    rng = np.random.default_rng(2)
    table = sess.init_state_table(6)
    table[:6] = torch.as_tensor(rng.integers(-20, 20, (6, 2, 2, 8)),
                                dtype=torch.int32)
    before = table.clone()
    x = rng.uniform(0, 1, (4, T, M)).astype(np.float32)
    g = np.array([2, 6, 0, 5], np.int32)
    s = np.array([1, 7, 3, 4], np.int32)
    fn = sess.compiled_stateful_slots(backend)
    y_np, t_np = fn(x, table, g, s)
    y_t, t_t = fn(torch.as_tensor(x), table, torch.as_tensor(g),
                  torch.as_tensor(s))
    assert torch.equal(y_np, y_t) and torch.equal(t_np, t_t)
    assert torch.equal(table, before)


def test_device_server_answers_as_the_host_server(sess):
    """Over 40 rounds with resets, LRU evictions with batch > capacity,
    padded waves and ended streams, the device-resident server's rows,
    reset flags and state counters equal the host-resident one's (the
    semantics the slot table has always been held to)."""
    out = {}
    for residency in ("host", "device"):
        with StreamServer(sess, batch=8, deadline_s=None, max_streams=5,
                          state_residency=residency) as srv:
            rows, _ = _drive(srv, 40, 12, seed=9, events=False)
            stats = srv.states.stats()
        out[residency] = rows, {k: stats[k] for k in (
            "hits", "misses", "evictions", "live_streams")}
    (host, hstats), (dev, dstats) = out["host"], out["device"]
    assert hstats == dstats and hstats["evictions"] > 0
    assert host.keys() == dev.keys()
    for key in host:
        np.testing.assert_array_equal(host[key][0], dev[key][0])
        assert host[key][1:] == dev[key][1:]
    assert any(flag for _, flag, _ in dev.values())


# ---------------------------------------------------------------------------
# On the card: the graph path against the eager path
# ---------------------------------------------------------------------------

def _eager_twin(sess):
    """A copy of the CUDA session ``sess`` whose slot path runs eagerly:
    its ``SlotGraphs`` is handed every wave as device tensors, which it
    never replays."""
    twin = repro_torch.build(sess.model, sess.accel, params=sess.params,
                             device=sess.device).quantize()
    graphs = twin.compiled_stateful_slots("pallas")
    dev = twin.device

    def eager(x, table, g, s):
        return graphs(torch.as_tensor(x, device=dev), table,
                      torch.as_tensor(g, device=dev),
                      torch.as_tensor(s, device=dev))

    twin._fns[("int_stateful_slots", "pallas")] = eager
    return twin, graphs


def _pair(**kw):
    """The graph path's server and the eager path's, on equal sessions,
    with equal fault injectors when ``kw`` asks for faults."""
    sess = _session("cuda")
    twin, twin_graphs = _eager_twin(sess)
    faults = kw.pop("faults", None)
    servers = [StreamServer(
        s, fault_injector=None if faults is None else FaultInjector(
            seed=11, **faults), **kw) for s in (sess, twin)]
    return sess, servers, twin_graphs


@pytest.mark.gpu
@pytest.mark.parametrize("faults", [None, dict(
    wave_fault_rate=0.15, state_loss_rate=0.05, state_corrupt_rate=0.05)])
def test_graph_path_equals_eager_path_bit_for_bit(faults):
    """Hundreds of waves: resets, LRU evictions with batch > capacity,
    padded waves, ended streams, ``corrupt_slot`` and ``seed_state``
    between waves, and (with faults) failed waves and faulted commits.
    Every result and every table row equal the eager path's after every
    round, and every wave of the graph server replayed but the first."""
    _cuda()
    sess, (g_srv, e_srv), twin_graphs = _pair(
        batch=8, deadline_s=None, max_streams=5, faults=faults,
        resilience=ResiliencePolicy(max_retries=0))
    with g_srv, e_srv:
        g_rows, g_tables = _drive(g_srv, 150, 12, seed=21)
        e_rows, e_tables = _drive(e_srv, 150, 12, seed=21)
        summary = g_srv.metrics_summary()
        e_summary = e_srv.metrics_summary()
    assert g_rows.keys() == e_rows.keys()
    for key in g_rows:
        gy, ey = g_rows[key][0], e_rows[key][0]
        assert (gy is None) == (ey is None), key
        if gy is not None:
            np.testing.assert_array_equal(gy, ey)
        assert g_rows[key][1:] == e_rows[key][1:], key
    for r, (a, b) in enumerate(zip(g_tables, e_tables)):
        assert torch.equal(a, b), f"tables differ after round {r}"
    waves = summary["waves"]
    assert waves >= 200 and waves == e_summary["waves"]
    graph = summary["slot_graph"]
    assert graph["captures"] == 1 and graph["eager"] == 0
    failed = summary["faults"]["wave_failures"]
    assert summary["health"]["ladder"] == ["pallas"]
    assert graph["replays"] == waves - failed - 1
    assert twin_graphs.stats()["replays"] == 0
    if faults is not None:
        assert failed > 0
        assert summary["faults"]["injected"]["state_corruptions"] > 0


@pytest.mark.gpu
def test_injected_failure_leaves_the_live_table_unchanged_on_the_card():
    _cuda()
    sess = _session("cuda")
    rng = np.random.default_rng(5)
    with StreamServer(sess, batch=8, deadline_s=None, max_streams=8,
                      fault_injector=FaultInjector(seed=0,
                                                   wave_fault_rate=1.0),
                      resilience=ResiliencePolicy(max_retries=0)) as srv:
        for i in range(4):
            srv.seed_stream_state(f"s{i}", [
                tuple(rng.integers(-50, 50, 8).astype(np.int32)
                      for _ in range(2)) for _ in range(2)])
        before = srv.states.table.clone()
        for i in range(6):
            srv.submit(f"s{i}", _window(rng))
        out = srv.drain(timeout=60)
        assert len(out) == 6 and not any(r.ok for r in out)
        assert torch.equal(srv.states.table, before)


@pytest.mark.gpu
def test_two_servers_on_one_session_in_turn():
    """Each server's table gets its own graph and output table; each
    answers as the eager path; closing a server drops its graphs."""
    _cuda()
    sess = _session("cuda")
    twin, _ = _eager_twin(sess)
    graphs = sess.compiled_stateful_slots("pallas")
    ptrs = []
    for n in range(2):
        pair = [StreamServer(s, batch=8, deadline_s=None, max_streams=6)
                for s in (sess, twin)]
        with pair[0] as a, pair[1] as b:
            ptrs.append(a.states.table.data_ptr())
            a_rows, a_tables = _drive(a, 30, 10, seed=40 + n)
            b_rows, b_tables = _drive(b, 30, 10, seed=40 + n)
            assert graphs.stats()["graphs"] == 1
        assert graphs.stats()["graphs"] == 0
        assert a_rows.keys() == b_rows.keys()
        for key in a_rows:
            np.testing.assert_array_equal(a_rows[key][0], b_rows[key][0])
        assert all(torch.equal(x, y) for x, y in zip(a_tables, b_tables))
    assert graphs.stats()["captures"] == 2


@pytest.mark.gpu
def test_a_table_the_engine_has_not_seen_is_adopted():
    """A fresh ``init_state_table`` gets its own capture and the eager
    path's answers; the first table still replays its own graph."""
    _cuda()
    sess = _session("cuda")
    graphs = sess.compiled_stateful_slots("pallas")
    twin, _ = _eager_twin(sess)
    eager = twin.compiled_stateful_slots("pallas")
    rng = np.random.default_rng(8)
    tables = [sess.init_state_table(6) for _ in range(2)]
    mirrors = [t.clone() for t in tables]
    for step, k in enumerate([0, 0, 1, 1, 0, 1]):
        x = rng.uniform(-1, 1, (4, T, M)).astype(np.float32)
        g = rng.integers(0, 7, 4).astype(np.int32)
        s = rng.permutation(8)[:4].astype(np.int32)
        y, new = graphs(x, tables[k], g, s)
        ye, newe = eager(x, mirrors[k], g, s)
        assert torch.equal(y, ye.cpu()) and torch.equal(new, newe), step
        tables[k].copy_(new)
        mirrors[k].copy_(newe)
    st = graphs.stats()
    assert st["captures"] == 2 and st["replays"] == 4 and st["graphs"] == 2


@pytest.mark.gpu
def test_a_result_survives_the_next_wave():
    _cuda()
    sess = _session("cuda")
    rng = np.random.default_rng(3)
    with StreamServer(sess, batch=4, deadline_s=None, max_streams=8) as srv:
        kept = []
        for _ in range(4):
            for i in range(4):
                srv.submit(f"s{i}", _window(rng))
            srv.flush(timeout=60)
            res = srv.poll()
            kept.append([(r.y, r.y.copy()) for r in res])
        assert all(np.array_equal(y, copy) for wave in kept
                   for y, copy in wave)
        assert srv.metrics_summary()["slot_graph"]["replays"] >= 3


@pytest.mark.gpu
def test_one_launch_and_one_stamp_a_replay_after_warm_up():
    """After a warm-up wave: ``LAUNCHES["slot"]`` grows by one a wave,
    each wave's ``t_launch`` lies between its ``t_exec`` and ``t_host``,
    one graph was captured and every wave of the window replayed."""
    _cuda()
    sess = _session("cuda")
    rng = np.random.default_rng(6)
    with StreamServer(sess, batch=8, deadline_s=None, max_streams=64) as srv:
        for i in range(8):
            srv.submit(f"w{i}", _window(rng))
        srv.drain(timeout=60)
        srv.reset_streams()
        srv.reset_metrics()
        before = qlstm_cell.LAUNCHES["slot"]
        graphs = sess.compiled_stateful_slots("pallas")
        replays = graphs.stats()["replays"]
        for _ in range(10):
            for i in range(20):
                srv.submit(f"s{i}", _window(rng))
            srv.drain(timeout=60)
        summary = srv.metrics_summary()
        w = srv.metrics.windows()
    waves = summary["waves"]
    assert waves == 30
    assert qlstm_cell.LAUNCHES["slot"] - before == waves
    assert graphs.stats()["replays"] - replays == waves
    assert summary["slot_graph"]["captures"] == 1
    assert summary["slot_graph"]["replayed_share"] == 1.0
    assert not np.isnan(w["t_launch"]).any()
    assert (w["t_exec"] <= w["t_launch"]).all()
    assert (w["t_launch"] <= w["t_host"]).all()


def test_slot_graphs_is_the_fused_entry_only_on_cuda(sess):
    """A CPU session's slot path is the eager one; the graph engine is
    made only for a CUDA session's fused engine."""
    assert not isinstance(sess.compiled_stateful_slots("pallas"), SlotGraphs)
