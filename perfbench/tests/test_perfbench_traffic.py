"""The generator: a seed repeats its schedule and windows, and each
stream's windows arrive in order."""

import json

import numpy as np

import pytest

from perfbench.arrivals.poisson import schedule as open_schedule
from perfbench.bench import Spec
from perfbench.traffic import Mix, Windows

MIX = Mix.from_dict("t", {"arrivals": "poisson", "streams": 500,
                          "rate_per_s": 20000, "batch": 64,
                          "deadline_s": 0.005})
SEED = 2 ** 31 + 12345


def test_a_seed_repeats_its_schedule_and_windows():
    a, b = open_schedule(MIX, SEED, 2.0), open_schedule(MIX, SEED, 2.0)
    for f in ("due", "stream", "k"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
    wa = Windows(SEED, 500, 6, 1).take(a.stream, a.k)
    wb = Windows(SEED, 500, 6, 1).take(b.stream, b.k)
    assert np.array_equal(wa, wb)
    c = open_schedule(MIX, SEED + 1, 2.0)
    assert not np.array_equal(a.stream[:500], c.stream[:500])


def test_arrivals_are_poisson_at_the_rate():
    s = open_schedule(MIX, SEED, 5.0)
    assert abs(len(s.due) - 100000) < 6 * 100000 ** 0.5
    assert np.all(np.diff(s.due) >= 0) and s.due[-1] < 5.0
    gaps = np.diff(s.due)
    assert abs(gaps.mean() * 20000 - 1) < 0.02
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05   # exponential


def test_each_streams_windows_arrive_in_order():
    s = open_schedule(MIX, SEED, 2.0)
    for st in range(MIX.streams):
        ks = s.k[s.stream == st]
        assert np.array_equal(ks, np.arange(len(ks)))
    counts = np.bincount(s.stream, minlength=MIX.streams)
    assert counts.max() - counts.min() <= 1


def test_windows_do_not_depend_on_how_far_a_run_got():
    w1 = Windows(SEED, 50, 6, 1)
    late = w1.round(7).copy()
    w2 = Windows(SEED, 50, 6, 1)
    for k in range(8):
        w2.round(k)
    assert np.array_equal(late, w2.round(7))
    assert late.dtype == np.float32 and late.min() >= 0 and late.max() <= 1
    assert np.ptp(late) > 0.2


def test_a_mix_gives_exactly_what_its_arrivals_read(tmp_path):
    (tmp_path / "perfbench" / "traffic").mkdir(parents=True)
    (tmp_path / "perfbench" / "arrivals").mkdir()
    (tmp_path / "perfbench" / "arrivals" / "poisson.py").write_text(
        'PARAMS = ("rate_per_s",)\n')
    (tmp_path / "BENCHMARK.json").write_text("{}")
    base = {"arrivals": "poisson", "streams": 5, "batch": 4,
            "deadline_s": 0.005}
    for name, extra in [("ok", {"rate_per_s": 10}), ("typo", {"rate": 10}),
                        ("more", {"rate_per_s": 10, "burst": 2})]:
        (tmp_path / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps({**base, **extra}))
    spec = Spec(tmp_path)
    assert spec.mix("ok").params == {"rate_per_s": 10}
    for name in ("typo", "more"):
        with pytest.raises(ValueError, match="reads"):
            spec.mix(name)


class _Clock:
    """A clock that moves only when the client sleeps or a ``submit``
    takes time, so a run of the sender is the same every time."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def sleep(self, s):
        self.t += max(0.0, s)


class _Server:
    """``submit`` takes ``cost`` seconds of the clock (blocks, where it is
    long); answers are never polled here."""

    def __init__(self, clk, cost):
        self.clk, self.cost = clk, cost

    def submit(self, s, x):
        self.clk.t += self.cost


def _loop(monkeypatch, cost, rate, seconds, seed=SEED):
    from perfbench import client
    from perfbench.arrivals.poisson_count import schedule
    clk = _Clock()
    monkeypatch.setattr(client, "clock", clk)
    monkeypatch.setattr(client.time, "sleep", clk.sleep)
    mix = Mix.from_dict("t", {"arrivals": "poisson_count", "streams": 50,
                              "rate_per_s": rate, "batch": 8,
                              "deadline_s": 0.005})
    sched = schedule(mix, seed, seconds)
    loop = client.OpenLoop(_Server(clk, cost), mix, Windows(seed, 50, 6, 1),
                           1, sched)
    loop.t0 = 0.0                     # no polling thread: nothing answers
    return loop, clk, sched


def _rows(loop):
    return [np.frombuffer(a, np.float64 if a.typecode == "d" else np.int64)
            .copy() for a in (loop.stream, loop.k, loop.due, loop.sub,
                              loop.ret)]


def _run_until_before(loop, t_stop):
    """``OpenLoop.run_until`` as it was before it looked at the clock
    between submits: it sent every arrival due before it looked."""
    from perfbench import client
    due, n, t0 = loop.sched_due, len(loop.sched_due), loop.t0
    while True:
        now = client.clock()
        if now >= t_stop:
            return
        i = loop.i
        while i < n and t0 + due[i] <= now:
            loop._submit(loop.sched_stream[i], loop.sched_k[i], t0 + due[i])
            i += 1
            now = client.clock()
        loop.i = i
        wake = min(t_stop, now + client.TICK_S,
                   t0 + due[i] if i < n else t_stop)
        client.time.sleep(max(0.0, wake - client.clock()))


def test_run_until_returns_at_its_close_when_submit_blocks(monkeypatch):
    """Above capacity: 1,000 arrivals due in the first 0.1 s, each submit
    held 50 ms.  The sender stops at its close with the rest unsent, and
    the next call goes on from the first arrival not sent."""
    loop, clk, sched = _loop(monkeypatch, cost=0.05, rate=10000, seconds=0.1)
    loop.run_until(0.5)
    assert 0.5 <= clk.t < 0.55
    stream, k, due, sub, ret = _rows(loop)
    assert len(stream) == loop.i == 10
    assert (sub < 0.5).all() and ret[-1] >= 0.5
    assert np.array_equal(stream, sched.stream[:10])
    assert np.array_equal(k, sched.k[:10])
    loop.run_until(0.7)
    stream, k, due, sub, _ = _rows(loop)
    assert len(stream) == loop.i == 14 and (sub[10:] >= 0.5).all()
    assert np.array_equal(due, sched.due[:14])
    assert len(sched.due) == 1000


def test_run_until_before_its_change_ran_past_the_close(monkeypatch):
    """The same arrivals under the sender as it was: it sent all 1,000
    before it looked at the clock again, 50 s past a 0.5 s close."""
    loop, clk, _ = _loop(monkeypatch, cost=0.05, rate=10000, seconds=0.1)
    _run_until_before(loop, 0.5)
    assert len(loop.stream) == 1000 and clk.t > 50.0


@pytest.mark.parametrize("t_stop", [0.3, 0.8017, 1.0])
def test_run_until_below_capacity_sends_as_before(monkeypatch, t_stop):
    """A server that keeps up (each submit 20 us, 1,000 arrivals a
    second): the windows sent and when, row for row, are those of the
    sender as it was, and they are every arrival due before the close."""
    got, was = [], []
    for run, out in ((lambda lp, t: lp.run_until(t), got),
                     (_run_until_before, was)):
        loop, clk, sched = _loop(monkeypatch, cost=2e-5, rate=1000,
                                 seconds=1.0)
        run(loop, 0.1)
        run(loop, t_stop)
        out.extend(_rows(loop))
    for a, b in zip(got, was):
        assert np.array_equal(a, b)
    stream, k, due, sub, _ = got
    n = int(np.count_nonzero(sched.due < t_stop))
    assert len(stream) == n > 250
    assert (sub >= due).all() and (sub - due).max() < 1e-3
