"""The port's ``StreamServer`` on the CPU: stateful carry across windows
at both residencies, row-for-row agreement with the reference
``StreamServer`` on the same submissions, and device/host residency
bit-exact under eviction churn."""

import pytest

pytest.importorskip("jax")  # the reference package; absent on the card

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro.core import qlstm as jq  # noqa: E402
from repro.serving import StreamServer as JStreamServer  # noqa: E402
from repro_torch.convert import params_from_reference  # noqa: E402
from repro_torch.core import qlstm as tq  # noqa: E402
from repro_torch.serving import (DeviceStateStore, ServingConfig,  # noqa: E402
                                 StateStore, StreamServer)

MODEL_KW = dict(input_size=1, hidden_size=8, num_layers=2, seq_len=4)


@pytest.fixture(scope="module")
def sessions():
    js = repro.build(jq.QLSTMConfig(**MODEL_KW), seed=0).quantize()
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    ts = repro_torch.build(tq.QLSTMConfig(**MODEL_KW),
                           params=params_from_reference(tree),
                           device="cpu").quantize()
    return js, ts


def _windows(n, seed=0, t=4, m=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 1.0, (n, t, m)).astype(np.float32)


def _serve(server, streams, k):
    with server as srv:
        for w in range(k):
            for sid, xs in streams.items():
                srv.submit(sid, xs[w])
        rows = srv.drain(timeout=120)
        summary = srv.metrics_summary()
    return rows, summary


@pytest.mark.parametrize("residency", ["host", "device"])
def test_stream_server_carry_equals_unbatched_sequence(sessions, residency):
    """Interleaved streams each match their own one-shot run over the
    concatenated windows, bit for bit, at both residencies."""
    _, ts = sessions
    k = 3
    streams = {f"c{i}": _windows(k, seed=10 + i) for i in range(5)}
    rows, summary = _serve(StreamServer(ts, batch=4, deadline_s=0.005,
                                        max_streams=16,
                                        state_residency=residency),
                           streams, k)
    assert len(rows) == 5 * k and all(r.ok for r in rows)
    assert summary["state_residency"] == residency
    assert summary["faults"]["degradations"] == 0
    last = {r.stream_id: r for r in rows if r.seq == k - 1}
    for sid, xs in streams.items():
        full = ts.infer(xs.reshape(1, -1, 1), path="int", backend="ref")
        np.testing.assert_array_equal(last[sid].y, full.numpy()[0])
        assert last[sid].backend == "pallas"


def test_rows_equal_reference_stream_server(sessions):
    """Same submissions to both packages' servers: the same (stream id,
    seq) rows with the same predictions and reset flags."""
    js, ts = sessions
    k = 3
    streams = {f"s{i}": _windows(k, seed=30 + i) for i in range(6)}
    kw = dict(batch=4, deadline_s=0.005, max_streams=16)
    trows, _ = _serve(StreamServer(ts, **kw), streams, k)
    jrows, _ = _serve(JStreamServer(js, **kw), streams, k)
    key = lambda rows: {(r.stream_id, r.seq): r for r in rows}
    tk, jk = key(trows), key(jrows)
    assert tk.keys() == jk.keys()
    for kk in tk:
        np.testing.assert_array_equal(tk[kk].y, np.asarray(jk[kk].y))
        assert tk[kk].state_reset == jk[kk].state_reset
        assert tk[kk].backend == jk[kk].backend


def test_device_vs_host_bit_exact_under_eviction_churn(sessions):
    """More streams than slots (forced LRU evictions, slot reuse,
    mid-stream resets): the device path's results, reset flags and state
    counters match the host path's."""
    _, ts = sessions
    k, cap = 3, 4
    streams = {f"s{i}": _windows(k, seed=70 + i) for i in range(6)}

    def run(residency):
        rows = {}
        with StreamServer(ts, batch=4, deadline_s=0.005, max_streams=cap,
                          state_residency=residency) as srv:
            for w in range(k):
                for sid in streams:
                    srv.submit(sid, streams[sid][w])
                srv.flush(timeout=60)
            for r in srv.drain(timeout=60):
                rows[(r.stream_id, r.seq, r.state_reset)] = r.y
            stats = srv.states.stats()
            transfer = srv.metrics_summary()["state_transfer"]
        return rows, {q: stats[q] for q in ("hits", "misses", "evictions",
                                            "live_streams")}, transfer

    host_rows, host_stats, _ = run("host")
    dev_rows, dev_stats, dev_transfer = run("device")
    assert host_stats == dev_stats and host_stats["evictions"] > 0
    assert host_rows.keys() == dev_rows.keys()
    for key in host_rows:
        np.testing.assert_array_equal(host_rows[key], dev_rows[key])
    assert dev_transfer["to_device_bytes"] == 0
    assert dev_transfer["from_device_bytes"] == 0


def test_residency_resolution_and_summary(sessions):
    _, ts = sessions
    srv = StreamServer(ts, batch=2)
    assert srv.state_residency == "device"
    assert isinstance(srv.states, DeviceStateStore)
    assert srv.states.table.shape == (1026, 2, 2, 8)
    srv.close()
    srv = StreamServer(ts, batch=2, state_residency="host")
    assert isinstance(srv.states, StateStore)
    srv.close()
    per_step = repro_torch.build(
        tq.QLSTMConfig(**MODEL_KW),
        repro_torch.AcceleratorConfig(alu_mode="per_step"),
        device="cpu").quantize()
    srv = StreamServer(per_step, batch=2)
    assert srv.state_residency == "host"
    srv.close()
    with pytest.raises(ValueError, match="host|device"):
        ServingConfig(state_residency="gpu")
    rows, summary = _serve(StreamServer(ts, batch=2, deadline_s=0.005),
                           {"a": _windows(1)}, 1)
    assert summary["ops_per_inference"] == tq.ops_per_inference(ts.model)
    assert "energy" not in summary and "gops_per_watt" not in summary


@pytest.mark.parametrize("ladder_device", ["cuda", "cpu"])
def test_failing_kernel_is_not_served_by_a_plain_engine_on_cuda(
        sessions, monkeypatch, ladder_device):
    """A fused kernel that raises at launch: on a CUDA session the ladder
    ends at ``pallas``, so every wave fails with error rows and no row
    names the ``xla`` engine; on the CPU the guard degrades to ``xla`` as
    the reference's does.  The session runs on the CPU; only the ladder
    is resolved for ``ladder_device``."""
    from repro_torch import backends as tbackends
    from repro_torch.kernels import qlstm_cell
    from repro_torch.serving import ResiliencePolicy

    def launch_fails(*a, **k):
        raise RuntimeError("qlstm kernel launch failed: injected")

    real = tbackends.degradation_ladder
    monkeypatch.setattr(tbackends, "degradation_ladder", lambda *a, **k: real(
        *a, **{**k, "device": torch.device(ladder_device)}))
    monkeypatch.setattr(qlstm_cell, "qlstm_seq_slot", launch_fails)
    _, ts = sessions
    streams = {f"s{i}": _windows(2, seed=90 + i) for i in range(3)}
    rows, summary = _serve(StreamServer(
        ts, batch=4, deadline_s=0.005,
        resilience=ResiliencePolicy(max_retries=0, degrade_after=1)),
        streams, 2)
    assert len(rows) == 6
    if ladder_device == "cuda":
        assert summary["health"]["ladder"] == ["pallas"]
        assert not any(r.backend == "xla" for r in rows)
        assert all(not r.ok and r.error.startswith("compute_failed")
                   and r.backend is None for r in rows)
        assert summary["faults"]["degradations"] == 0
        assert summary["faults"]["wave_failures"] > 0
    else:
        assert all(r.ok and r.backend == "xla" for r in rows)
        assert summary["faults"]["degradations"] == 1


def test_read_and_seed_stream_state_round_trip(sessions):
    """A carry read back from one device-resident server and seeded into
    another continues the stream exactly where it left off."""
    _, ts = sessions
    xs = _windows(2, seed=5)
    with StreamServer(ts, batch=2, deadline_s=0.005) as a:
        a.submit("s", xs[0])
        a.drain(timeout=30)
        carry = a.read_stream_state("s")
    with StreamServer(ts, batch=2, deadline_s=0.005) as b:
        b.seed_stream_state("s", carry)
        b.submit("s", xs[1])
        (row,) = b.drain(timeout=30)
    assert not row.state_reset
    full = ts.infer(xs.reshape(1, -1, 1), path="int")
    np.testing.assert_array_equal(row.y, full.numpy()[0])
    assert isinstance(carry[0][0], np.ndarray)
    assert torch.is_tensor(b.states.table)
