"""``pems-steady``'s end-to-end rate: the count-fixed arrivals send the
same number of windows for every seed, ``windows_per_s`` counts the
windows answered inside the measured window, and the cell's latency tail
is still read, per layer, by ``window_p90_ms``'s reader."""

import numpy as np

from perfbench.arrivals import poisson_count
from perfbench.bench import Run, Spec
from perfbench.traffic import Mix

MIX = Mix.from_dict("t", {"arrivals": "poisson_count", "streams": 500,
                          "rate_per_s": 20000, "batch": 64,
                          "deadline_s": 0.005})
SEED = 2 ** 31 + 4242


def test_every_seed_sends_the_same_count():
    a = poisson_count.schedule(MIX, SEED, 5.0)
    b = poisson_count.schedule(MIX, SEED + 1, 5.0)
    assert len(a.due) == len(b.due) == 100000
    assert not np.array_equal(a.due, b.due)
    for s in (a, b):
        assert np.all(np.diff(s.due) >= 0)
        assert s.due[0] >= 0.0 and s.due[-1] < 5.0


def test_a_seed_repeats_its_arrivals():
    a = poisson_count.schedule(MIX, SEED, 2.0)
    b = poisson_count.schedule(MIX, SEED, 2.0)
    for f in ("due", "stream", "k"):
        assert np.array_equal(getattr(a, f), getattr(b, f))


def test_the_arrivals_are_poisson_at_the_rate():
    gaps = np.diff(poisson_count.schedule(MIX, SEED, 5.0).due)
    assert abs(gaps.mean() * 20000 - 1) < 0.01
    assert abs(gaps.std() / gaps.mean() - 1) < 0.05   # exponential
    # Counts in equal slices spread as a Poisson process's would.
    slices = np.bincount((poisson_count.schedule(MIX, SEED, 5.0).due
                          / 0.01).astype(int))
    assert abs(slices.var() / slices.mean() - 1) < 0.2


def _run(done, ok=None):
    n = len(done)
    return Run(t0=10.0, t1=20.0, due=np.linspace(10.0, 19.99, n),
               done=np.asarray(done, float),
               ok=np.ones(n, bool) if ok is None else np.asarray(ok))


def test_windows_per_s_counts_answers_inside_the_window():
    read = Spec().reader("windows_per_s").read
    assert read(_run([10.5] * 40)) == 4.0
    # Answered after the close, before the open, or with an error: not
    # counted.
    assert read(_run([10.5, 20.0, 25.0, 9.0, 11.0],
                     [True, True, True, True, False])) == 0.1
    assert read(_run([np.nan, 21.0])) is None


def test_pems_steady_reports_the_rate_and_its_tail_per_layer():
    spec = Spec()
    wl = spec.workload("pems-steady")
    mix = spec.mix(wl["traffic"])
    assert mix.arrivals == "poisson_count"
    assert {m["name"] for m in spec.metrics("pems-steady", False)} == {
        "windows_per_s", "setup_s"}
    layer = {m["name"]: m for m in spec.metrics("pems-steady", True)}
    assert layer["window_p90_ms.serve"]["moves"] == "windows_per_s"
    assert spec.reader("window_p90_ms.serve").__doc__.startswith(
        "``window_p90_ms``")
    assert {m["moves"] for m in layer.values()} == {"windows_per_s"}
