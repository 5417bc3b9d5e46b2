"""The port's per-window stage record (``serving/metrics.py``): every
window a wave computes gets a row keyed by ``(stream_id, seq)`` with its
own and its wave's ``time.perf_counter`` stamps, the stages between them
add up to the window's submit -> polled time, the ring keeps the newest
rows, ``current_sinks`` reaches a server's record after ``reset_metrics``
and ``close``, and the compute thread opens ``serving.*`` profiler ranges
only while a profiler runs.  CPU tests; the one marked ``gpu`` takes the
fused kernel's launch stamp on the card."""

import gc
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile

import repro_torch
from repro_torch.core import qlstm as tq
from repro_torch.kernels.qlstm_cell import LAUNCH_STAMP
from repro_torch.serving import MetricsSink, StreamServer, WaveRecord
from repro_torch.serving import metrics as sm
from repro_torch.serving import server as server_mod
from repro_torch.serving.scheduler import Slot

MODEL_KW = dict(input_size=1, hidden_size=8, num_layers=1, seq_len=4)
STAMPS = ("t_submit", "t_selected", "t_exec", "t_launch", "t_host",
          "t_emitted", "t_polled")


@pytest.fixture(scope="module")
def sess():
    return repro_torch.build(tq.QLSTMConfig(**MODEL_KW), seed=0,
                             device="cpu").quantize()


def _stamped(fn):
    """An engine callable that stamps a launch as the fused kernel does
    (the CPU runs no kernel)."""
    def run(*args):
        out = fn(*args)
        LAUNCH_STAMP.t = time.perf_counter()
        return out
    return run


def _serve(server, streams=6, rounds=3, seed=0):
    """Submit ``rounds`` windows to each of ``streams`` streams and poll
    every result; returns the results."""
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for s in range(streams):
            server.submit(s, rng.uniform(0, 1, (MODEL_KW["seq_len"], 1))
                          .astype(np.float32))
    return server.drain(timeout=60)


def _profile(*activities):
    """A profiler that records every thread's ranges (the compute
    thread's with them)."""
    return profile(activities=list(activities),
                   experimental_config=_ExperimentalConfig(
                       profile_all_threads=True))


@pytest.mark.parametrize("residency", ["host", "device"])
def test_stamps_are_ordered_and_stages_add_up(sess, residency):
    """Each window's stamps never decrease, and its six stages add up to
    its submit -> polled time exactly."""
    with StreamServer(sess, batch=4, deadline_s=0.002, max_streams=16,
                      state_residency=residency) as srv:
        srv._fns = [[(n, _stamped(fn)) for n, fn in per]
                    for per in srv._fns]
        rows = _serve(srv)
        w = srv.metrics.windows()
    assert len(rows) == len(w["seq"]) == 18
    t = np.stack([w[k] for k in STAMPS])
    assert not np.isnan(t).any()
    assert (np.diff(t, axis=0) >= 0).all()
    total = sum(w[name] for name, _, _ in sm.STAGES)
    assert np.array_equal(total, w["t_polled"] - w["t_submit"])
    got = {(r.stream_id, r.seq): r.record for r in rows}
    assert sorted(got) == sorted(zip(w["stream"].tolist(),
                                     w["seq"].tolist()))


def test_a_window_row_carries_its_waves_stamps(sess):
    with StreamServer(sess, batch=4, deadline_s=0.002,
                      max_streams=16) as srv:
        _serve(srv, streams=5, rounds=2)
        w = srv.metrics.windows()
        waves = srv.metrics.waves
    assert w["wave"].max() + 1 == len(waves)
    for k, rec in enumerate(waves):
        mine = w["wave"] == k
        assert mine.sum() == rec.occupancy
        assert (w["t_selected"][mine] == rec.t_selected).all()
        assert (w["t_exec"][mine] == rec.t_exec).all()
        assert rec.t_selected <= rec.t_exec <= rec.t_done
        assert rec.compute_s == rec.t_done - rec.t_exec


@pytest.mark.parametrize("backend", ["xla", "ref"])
def test_no_launch_stamp_on_engines_without_a_kernel(sess, backend):
    with StreamServer(sess, batch=4, deadline_s=0.002, max_streams=16,
                      backend=backend) as srv:
        rows = _serve(srv, streams=4, rounds=2)
        w = srv.metrics.windows()
    assert {r.backend for r in rows} == {backend}
    assert np.isnan(w["t_launch"]).all()
    assert np.isnan(w["prepare"]).all() and np.isnan(w["sync"]).all()
    assert not np.isnan(w["t_host"]).any()


def _record(sink, t, occ, stream="s"):
    slots = [Slot(f"{stream}{i}", 0, i, t - 0.001) for i in range(occ)]
    first = sink.record_wave(WaveRecord(t_done=t, compute_s=0.0,
                                        occupancy=occ, batch=occ,
                                        deadline_flush=False, t_exec=t),
                             slots)
    sink.note_emitted(first, [t] * occ)
    return first


def test_the_ring_wraps_and_keeps_the_newest_rows():
    sink = MetricsSink(rows=8)
    firsts = [_record(sink, float(k), 3, stream=f"w{k}-") for k in range(5)]
    assert sink.rows_recorded == 15 and sink.ring_rows == 8
    w = sink.windows()
    assert w["stream"].tolist() == [f"w{k}-{i}" for k in (2, 3, 4)
                                    for i in range(3)][1:]
    assert (w["t_exec"] == np.repeat([2.0, 3.0, 4.0], 3)[1:]).all()
    assert (w["wave"] == np.repeat([2, 3, 4], 3)[1:]).all()
    assert np.isnan(w["t_polled"]).all()

    class R:
        def __init__(self, record):
            self.record = record

    # An overwritten row, a shed window's id and another sink's id are
    # passed over.
    other = _record(MetricsSink(rows=8), 0.0, 1)
    sink.note_polled([R(firsts[0]), R(firsts[4] + 1), R(-1), R(other)], 9.0)
    w = sink.windows()
    assert np.isnan(w["t_polled"][:-2]).all() and w["t_polled"][-2] == 9.0
    sink.note_polled([R(firsts[4]), R(firsts[4] + 1), R(firsts[4] + 2)], 10.0)
    assert (sink.windows()["t_polled"][-3:] == 10.0).all()
    with pytest.raises(ValueError, match="power of two"):
        MetricsSink(rows=12)


def test_the_record_holds_nothing_the_collector_walks():
    """Recording waves leaves no object the garbage collector tracks: the
    record is numpy columns (Python objects kept a window would grow every
    full collection's walk)."""
    sink = MetricsSink(window=1, rows=64)
    _record(sink, 0.0, 3)
    gc.collect()
    before = len(gc.get_objects())
    for k in range(40):
        _record(sink, float(k), 3, stream=f"w{k}-")
    gc.collect()
    assert len(gc.get_objects()) - before < 5


def test_current_sinks_reach_a_servers_record(sess):
    srv = StreamServer(sess, batch=4, deadline_s=0.002, max_streams=16)
    first = srv.metrics
    key = max(sm.current_sinks())
    assert sm.current_sinks()[key] is first
    _serve(srv, streams=3, rounds=1)
    srv.reset_metrics()
    assert sm.current_sinks()[key] is srv.metrics is not first
    _serve(srv, streams=2, rounds=1)
    sink = srv.metrics
    srv.close()
    del srv
    assert sm.current_sinks()[key] is sink
    assert len(sink.windows()["seq"]) == 2
    assert all(s is not first for s in sm.current_sinks().values())


def test_current_sinks_keep_the_newest_servers():
    for i in range(sm.KEEP_SERVERS + 3):
        sm.publish(sm.new_server_id(), MetricsSink(rows=2))
    keys = list(sm.current_sinks())
    assert len(keys) == sm.KEEP_SERVERS and keys == sorted(keys)
    assert keys[-1] == max(keys)


def test_snapshot_is_the_private_read(sess):
    with StreamServer(sess, batch=4, deadline_s=0.002,
                      max_streams=16) as srv:
        _serve(srv, streams=3, rounds=2)
        a, b = srv.metrics.snapshot(), srv.metrics._snapshot()
    assert a == b
    assert {"n_waves", "n_samples", "n_padded_slots", "n_deadline_flushes",
            "compute_s_total"} <= set(a)
    assert a["n_samples"] == 6


def test_latency_is_per_window_submit_to_polled(sess):
    with StreamServer(sess, batch=4, deadline_s=0.002,
                      max_streams=16) as srv:
        _serve(srv, streams=5, rounds=2)
        w = srv.metrics.windows()
        lat = srv.metrics_summary()["latency_ms"]
    want = (w["t_polled"] - w["t_submit"]) * 1e3
    assert lat["p50"] == pytest.approx(np.percentile(want, 50))
    assert lat["mean"] == pytest.approx(want.mean())


def test_profiler_ranges_only_while_a_profiler_runs(sess, monkeypatch):
    """No profiler range is made while no profiler runs; under one, each
    wave shows ``serving.wave`` around prepare, sync and emit."""
    made = []
    real = server_mod._Range

    def counting(name):
        made.append(name)
        return real(name)

    monkeypatch.setattr(server_mod, "_Range", counting)
    with StreamServer(sess, batch=4, deadline_s=0.002,
                      max_streams=16) as srv:
        srv._fns = [[(n, _stamped(fn)) for n, fn in per]
                    for per in srv._fns]
        _serve(srv, streams=4, rounds=1)
        assert made == []
        waves = srv.metrics.snapshot()["n_waves"]
        with _profile(ProfilerActivity.CPU) as prof:
            _serve(srv, streams=4, rounds=2, seed=1)
        waves = srv.metrics.snapshot()["n_waves"] - waves
        n_made = len(made)
        _serve(srv, streams=4, rounds=1, seed=2)
        assert len(made) == n_made
    names = [e.name for e in prof.events() if e.name.startswith("serving.")]
    for stage in ("wave", "prepare", "sync", "emit"):
        assert names.count(f"serving.{stage}") == waves


@pytest.mark.gpu
def test_launch_stamp_and_ranges_on_the_card():
    """On the fused engine each wave's ``t_launch`` lies between its
    ``t_exec`` and ``t_host``, and the ``serving.*`` ranges appear in a
    profiler's trace once for each wave it saw."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    sess = repro_torch.build(tq.QLSTMConfig(**MODEL_KW), seed=0,
                             device="cuda").quantize()
    with StreamServer(sess, batch=8, deadline_s=0.002,
                      max_streams=32) as srv:
        assert srv.guard.ladder[0] == "pallas"
        _serve(srv, streams=8, rounds=2)
        w = srv.metrics.windows()
        assert not np.isnan(w["t_launch"]).any()
        assert (w["t_exec"] <= w["t_launch"]).all()
        assert (w["t_launch"] <= w["t_host"]).all()
        waves = srv.metrics.snapshot()["n_waves"]
        with _profile(ProfilerActivity.CPU, ProfilerActivity.CUDA) as prof:
            _serve(srv, streams=8, rounds=2, seed=1)
            torch.cuda.synchronize()
        waves = srv.metrics.snapshot()["n_waves"] - waves
    # Host-side ranges only: with CUDA activity a range around kernel
    # launches also shows as a device-side annotation of the same name.
    names = [e.name for e in prof.events() if e.name.startswith("serving.")
             and str(e.device_type).endswith("CPU")]
    assert waves >= 2
    for stage in ("wave", "prepare", "sync", "emit"):
        assert names.count(f"serving.{stage}") == waves
