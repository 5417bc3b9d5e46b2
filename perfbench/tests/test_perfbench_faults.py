"""A run with the timed path broken underneath must come out as not
correct; unbroken, as correct.  The runs skip the look for a card and
drive the rest of a run on the CPU (the kernels' plain versions), at a
size a test run holds: arrivals faster than the CPU serves them and a
long deadline, so that waves are full."""

import pytest

from perfbench.bench import run_cell

SMALL = {"streams": 48, "batch": 8, "deadline_s": 0.5, "rate_per_s": 1500}
SEED = 2 ** 31 + 99


def state_unchanged(fn):
    """The datapath returns the carry (table or state) it was given."""
    def f(*args):
        y, _ = fn(*args)
        return y, args[1]
    return f


def half_the_batch(fn):
    """The second half of every wave's rows is left out (zeros)."""
    def f(*args):
        y, st = fn(*args)
        y = y.clone()
        y[y.shape[0] // 2:] = 0
        return y, st
    return f


def one_answer_altered(fn):
    """One window's answer, in the fourth wave, is off by 1/16: one code
    of (4,8), sixteen of (8,16)."""
    calls = [0]

    def f(*args):
        y, st = fn(*args)
        calls[0] += 1
        if calls[0] == 4:
            y = y.clone()
            y[0] += 2.0 ** -4
        return y, st
    return f


CELLS = ["pems-steady"]


@pytest.mark.parametrize("workload", CELLS)
def test_unbroken_run_is_correct(workload):
    out = run_cell(workload, SEED, 1.0, False, device="cpu",
                   mix_overrides=SMALL)[0]
    assert out["correct"], out["checks"]
    assert out["attempted"] > 200 and out["failed"] == 0
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("fault", [state_unchanged, half_the_batch,
                                   one_answer_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_broken_run_is_not_correct(workload, fault):
    out = run_cell(workload, SEED, 1.0, False, device="cpu",
                   mix_overrides=SMALL, fault=fault)[0]
    assert not out["correct"], out["checks"]
    assert out["checks"]["mismatched"]["value"] > 0


def test_open_loop_run_is_correct():
    out = run_cell("pems-steady", SEED, 1.0, False, device="cpu",
                   mix_overrides={"streams": 40, "batch": 16,
                                  "deadline_s": 0.005, "rate_per_s": 400})[0]
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"windows_per_s", "setup_s"}
