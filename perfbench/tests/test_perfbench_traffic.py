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
