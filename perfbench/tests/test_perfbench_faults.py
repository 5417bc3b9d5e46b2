"""A run with the timed path broken underneath must come out as not
correct; unbroken, as correct.  The runs skip the look for a card and
drive the rest of a run on the CPU (the kernels' plain versions), at a
size a test run holds: arrivals faster than the CPU serves them and a
long deadline, so that waves are full."""

import numpy as np
import pytest

from perfbench.bench import run_cell
from perfbench.systems import qlstm_cluster

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


CELLS = ["pems-steady", "pems-cluster4"]


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


def test_cluster_run_keeps_each_stream_on_its_replica():
    """Every stream's windows on the one replica it hashes to, and the
    run's stage record is the replicas' merged: a row for every window
    sent, from streams of all four replicas."""
    out, run = run_cell("pems-cluster4", SEED, 1.0, False, device="cpu",
                        mix_overrides=SMALL)
    assert out["correct"], out["checks"]
    assert out["checks"]["misrouted"] == {"value": 0, "limit": 0}
    rec = run.program_sink.windows()
    assert len(rec["seq"]) == out["attempted"]
    homes = qlstm_cluster.ring_homes(
        ["r0", "r1", "r2", "r3"], np.unique(rec["stream"]).tolist(),
        run.config["vnodes"], run.config["ring_seed"])
    assert set(homes.values()) == {"r0", "r1", "r2", "r3"}


def test_a_stream_routed_off_its_replica_is_not_correct(monkeypatch):
    """A router that sends stream 0 to the replica after its own: the
    stream's answers are still right (its carry follows it), and the run
    is not correct, by ``misrouted`` alone."""
    from repro_torch.serving import routing
    route = routing.HashRing.route

    def off(self, key):
        home = route(self, key)
        if key != 0:
            return home
        names = sorted(self.nodes)
        return names[(names.index(home) + 1) % len(names)]

    monkeypatch.setattr(routing.HashRing, "route", off)
    out = run_cell("pems-cluster4", SEED, 1.0, False, device="cpu",
                   mix_overrides=SMALL)[0]
    assert not out["correct"]
    checks = {n: c["value"] for n, c in out["checks"].items()}
    assert checks["misrouted"] > 0
    assert checks["mismatched"] == checks["unanswered"] == 0
