"""The stage metrics read the serving program's own record
(``perfbench/program_record.py``), here a record and a run made by hand:
the tail is ``window_p90_ms``'s, the six stage means add up to the tail's
submit -> polled mean, every reader gives nothing without a whole
record, and ``host_path_idle`` reads the device's idle time inside the
waves."""

import numpy as np
import pytest

from perfbench import program_record
from perfbench.bench import Run, Spec
from perfbench.trace import TraceResult
from repro_torch.serving import MetricsSink, WaveRecord
from repro_torch.serving import metrics as sm
from repro_torch.serving.scheduler import Slot

STAGE_METRICS = ("pending_ms.tail", "handoff_ms.tail", "prepare_ms.tail",
                 "sync_ms.tail", "emit_ms.tail", "delivery_ms.tail")
ALL = STAGE_METRICS + ("host_path_idle.tail",)
WAVE = 4


class _Result:
    def __init__(self, record):
        self.record = record


def _made(n=64, streams=5, rows=1 << 10, seed=3, launched=True):
    """A run of ``n`` windows over ``streams`` streams in waves of
    ``WAVE``, and the program's record of them in a sink of ``rows``
    rows, published as the newest server's; without a launch stamp
    unless ``launched``."""
    rng = np.random.default_rng(seed)
    t0 = 100.0
    i = np.arange(n)
    stream = i % streams
    due = t0 + 0.001 * i
    sub = due + rng.uniform(0, 1e-4, n)
    # Per wave and stage; a wave ends before the next starts, as on the
    # server's one compute thread.
    gaps = rng.uniform(1e-5, 5e-4, (n // WAVE, 6))
    sink = MetricsSink(rows=rows)
    done = np.empty(n)
    waves = []
    for w in range(n // WAVE):
        at = i[w * WAVE:(w + 1) * WAVE]
        t_sub = sub[at] + 2e-5
        stamps = np.max(t_sub) + np.cumsum(gaps[w, :4])
        slots = [Slot(int(stream[j]), int(j // streams), int(j), float(t))
                 for j, t in zip(at, t_sub)]
        first = sink.record_wave(WaveRecord(
            t_done=stamps[3], compute_s=stamps[3] - stamps[1],
            occupancy=WAVE, batch=8, deadline_flush=True,
            t_selected=stamps[0], t_exec=stamps[1],
            t_launch=stamps[2] if launched else np.nan,
            t_host=stamps[3]), slots)
        emitted = stamps[3] + gaps[w, 4] * np.arange(1, WAVE + 1) / WAVE
        sink.note_emitted(first, emitted.tolist())
        polled = emitted[-1] + gaps[w, 5]
        sink.note_polled([_Result(first + k) for k in range(WAVE)], polled)
        done[at] = polled + 3e-6
        waves.append((stamps[1], emitted[-1]))
    sm.publish(sm.new_server_id(), sink)
    run = Run(t0=t0, t1=t0 + 0.001 * n, stream=stream, k=i // streams,
              due=due, sub=sub, ret=sub + 1e-5, done=done,
              ok=np.ones(n, bool), trace=None)
    return run, sink, waves


def _read(run, name):
    return Spec().reader(name).read(run)


def test_the_tail_is_window_p90s():
    run, _, _ = _made()
    tail = program_record.tail(run)
    p90 = _read(run, "window_p90_ms") / 1e3
    lat = run.done - run.due
    assert tail.sum() >= 1
    assert np.array_equal(tail, lat >= p90)
    rec = program_record.record(run)
    assert np.array_equal(rec["seq"][rec["tail"]], run.k[tail])
    assert np.array_equal(rec["stream"][rec["tail"]].astype(int),
                          run.stream[tail])


def test_the_stage_means_add_up_to_the_tails_mean():
    run, _, _ = _made()
    means = [_read(run, name) for name in STAGE_METRICS]
    rec = program_record.record(run)
    t = rec["tail"]
    want = float(np.mean(rec["t_polled"][t] - rec["t_submit"][t])) * 1e3
    assert all(m is not None and m > 0 for m in means)
    assert sum(means) == pytest.approx(want, abs=1e-9)


def test_a_launch_stamp_of_nan_is_passed_over():
    run, _, _ = _made(launched=False)
    assert _read(run, "prepare_ms.tail") is None
    assert _read(run, "sync_ms.tail") is None
    assert _read(run, "pending_ms.tail") is not None


def test_nothing_without_a_whole_record(monkeypatch):
    run, _, _ = _made(rows=32)          # 64 windows: the ring wrapped
    assert all(_read(run, name) is None for name in ALL)
    run, _, _ = _made()
    monkeypatch.delattr(sm, "current_sinks")   # a program with no record
    assert all(_read(run, name) is None for name in ALL)


def test_host_path_idle_reads_the_idle_inside_the_waves():
    run, _, waves = _made()
    t_a, t_b = run.t0, run.t1 + 0.05
    run.trace = TraceResult(t_a, t_b, [("k", a, b) for a, b in waves], [])
    assert _read(run, "host_path_idle.tail") == 0.0
    # Device work over the first half of each wave only.
    half = [("k", a, (a + b) / 2) for a, b in waves]
    run = _made()[0]
    run.trace = TraceResult(t_a, t_b, half, [])
    want = 100 * sum((b - a) / 2 for a, b in waves) / (t_b - t_a)
    assert _read(run, "host_path_idle.tail") == pytest.approx(want)
    run.trace = None
    assert _read(run, "host_path_idle.tail") is None
