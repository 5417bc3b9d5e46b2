"""Deterministic battery for the port's successive-halving search core
(``repro_torch.explore.halving``): the tests of ``tests/test_halving.py``
case for case, plus the reference and the port driven by the same
``measure`` function giving the same trace.

Everything here drives the search with synthetic measurement tables — no
server, no timing, no randomness — so every assertion is exact.  The live
serving-sweep integration lives in ``tests/test_torch_explore.py``.
"""

import math

import pytest

from repro_torch.explore import (ExploreError, parse_constraint,
                                 rung_schedule, successive_halving)

try:  # the JAX reference; the card's machine has none
    from repro import explore as jexplore
except ImportError:
    jexplore = None


def table_measure(table):
    """A measure() over a per-item metrics table, recording call order."""
    calls = []

    def measure(item, rung, fraction):
        calls.append((item, rung, fraction))
        return table[item]

    return measure, calls


# ---------------------------------------------------------------------------
# rung_schedule: sizes, fractions, and the analytic budget
# ---------------------------------------------------------------------------

def test_rung_schedule_halves_until_one_survivor():
    sizes, fractions = rung_schedule(12, eta=3)
    assert sizes == [12, 4, 2, 1]
    assert fractions[-1] == 1.0
    assert fractions == [3.0 ** (r - 3) for r in range(4)]
    # strictly increasing cost per rung
    assert all(a < b for a, b in zip(fractions, fractions[1:]))


def test_rung_schedule_explicit_rungs_and_degenerates():
    sizes, fractions = rung_schedule(24, eta=2, rungs=2)
    assert sizes == [24, 12]
    assert fractions == [0.5, 1.0]
    # one candidate: a single full-scenario rung
    assert rung_schedule(1, eta=2) == ([1], [1.0])
    # one rung: everything measured once, at the full scenario
    assert rung_schedule(7, eta=2, rungs=1) == ([7], [1.0])


def test_rung_schedule_rejects_bad_inputs():
    with pytest.raises(ExploreError, match="empty candidate set"):
        rung_schedule(0)
    with pytest.raises(ValueError, match="eta"):
        rung_schedule(4, eta=1)
    with pytest.raises(ValueError, match="rungs"):
        rung_schedule(4, rungs=0)


# ---------------------------------------------------------------------------
# promotion against a hand-computed oracle
# ---------------------------------------------------------------------------

def test_promotion_matches_hand_computed_oracle():
    # 4 items, eta=2 -> sizes [4, 2, 1].  Objective maximised:
    #   scores a=3, b=1, c=4, d=2
    # rung 0 ranking: c, a, d, b -> promote [c, a]
    # rung 1 ranking: c, a       -> promote [c]
    # rung 2 winner: c
    table = {"a": {"v": 3.0}, "b": {"v": 1.0},
             "c": {"v": 4.0}, "d": {"v": 2.0}}
    measure, calls = table_measure(table)
    res = successive_halving(["a", "b", "c", "d"], measure, objective="v",
                             eta=2, labels=list("abcd"))
    assert res["sizes"] == [4, 2, 1]
    assert [r["promoted"] for r in res["rungs"]] == [["c", "a"], ["c"], []]
    assert [r["measured"] for r in res["rungs"]] == \
        [["a", "b", "c", "d"], ["c", "a"], ["c"]]
    assert res["winner_label"] == "c"
    assert res["winner_feasible"] is True
    # measure() saw exactly the promoted survivors at each rung
    assert [c[0] for c in calls] == ["a", "b", "c", "d", "c", "a", "c"]
    assert [c[1] for c in calls] == [0, 0, 0, 0, 1, 1, 2]


def test_sense_min_inverts_the_ranking():
    table = {i: {"lat": v} for i, v in enumerate([5.0, 2.0, 9.0, 4.0])}
    measure, _ = table_measure(table)
    res = successive_halving(list(table), measure, objective="lat",
                             sense="min", eta=2)
    assert res["winner"] == 1          # the smallest latency
    assert res["rungs"][0]["promoted"] == ["1", "3"]


def test_constrained_ranking_puts_infeasible_below_feasible():
    # b has the best throughput but violates the SLO; a is the best
    # feasible point and must win.  Infeasible points order by violation.
    slo = parse_constraint("p99_ms<=5")
    table = {
        "a": {"v": 10.0, "p99_ms": 4.0},      # feasible
        "b": {"v": 99.0, "p99_ms": 9.0},      # violation 4
        "c": {"v": 50.0, "p99_ms": 6.0},      # violation 1
        "d": {"v": 5.0, "p99_ms": 1.0},       # feasible
    }
    measure, _ = table_measure(table)
    res = successive_halving(list(table), measure, objective="v",
                             constraint=slo, eta=2,
                             labels=list(table))
    assert res["rungs"][0]["ranking"] == ["a", "d", "c", "b"]
    assert res["winner_label"] == "a"
    assert res["winner_feasible"] is True


def test_all_infeasible_still_terminates_least_violating_first():
    slo = parse_constraint("p99_ms<=1")
    table = {"x": {"v": 1.0, "p99_ms": 7.0},
             "y": {"v": 1.0, "p99_ms": 3.0}}
    measure, _ = table_measure(table)
    res = successive_halving(["x", "y"], measure, objective="v",
                             constraint=slo, labels=["x", "y"])
    assert res["winner_label"] == "y"        # closest to the bound
    assert res["winner_feasible"] is False


# ---------------------------------------------------------------------------
# budget accounting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,eta,rungs", [(8, 2, None), (9, 3, None),
                                         (24, 2, 2), (5, 4, 3), (1, 2, None)])
def test_budget_never_exceeds_analytic_bound(n, eta, rungs):
    table = {i: {"v": float(i)} for i in range(n)}
    measure, calls = table_measure(table)
    res = successive_halving(list(range(n)), measure, objective="v",
                             eta=eta, rungs=rungs)
    sizes, _ = rung_schedule(n, eta, rungs)
    assert res["total_measurements"] == len(calls) == sum(sizes)
    assert res["total_measurements"] <= res["budget_bound"] == sum(sizes)


# ---------------------------------------------------------------------------
# determinism + degenerate spaces
# ---------------------------------------------------------------------------

def test_identical_runs_produce_identical_traces():
    table = {i: {"v": float((i * 7) % 5)} for i in range(10)}
    runs = []
    for _ in range(2):
        measure, _ = table_measure(table)
        runs.append(successive_halving(list(range(10)), measure,
                                       objective="v", eta=2))
    assert runs[0] == runs[1]


def test_ties_break_by_input_index():
    table = {i: {"v": 1.0} for i in range(4)}    # all tied
    measure, _ = table_measure(table)
    res = successive_halving(list(range(4)), measure, objective="v", eta=2)
    assert res["rungs"][0]["promoted"] == ["0", "1"]
    assert res["winner"] == 0
    assert res["winner_feasible"] is True


def test_single_item_space_terminates():
    measure, calls = table_measure({"only": {"v": 1.0}})
    res = successive_halving(["only"], measure, objective="v",
                             labels=["only"])
    assert res["sizes"] == [1]
    assert res["fractions"] == [1.0]
    assert res["winner_label"] == "only"
    assert len(calls) == 1


def test_failed_measurements_rank_last_and_never_win_feasibly():
    table = {"ok": {"v": 1.0}, "dead": None, "nan": {"v": float("nan")}}

    def measure(item, rung, fraction):
        return table[item]

    res = successive_halving(list(table), measure, objective="v",
                             labels=list(table))
    assert res["winner_label"] == "ok"
    assert res["rungs"][0]["ranking"][0] == "ok"
    # a space of only failures still terminates, flagged infeasible
    res2 = successive_halving(["dead"], lambda *a: None, objective="v",
                              labels=["dead"])
    assert res2["winner_feasible"] is False
    assert res2["results"] == {}


def test_empty_item_list_raises_explore_error():
    with pytest.raises(ExploreError, match="0 points survived"):
        successive_halving([], lambda *a: {}, objective="v")


def test_fractions_are_geometric_and_end_full():
    for n, eta in [(16, 2), (27, 3), (100, 4)]:
        sizes, fractions = rung_schedule(n, eta)
        assert fractions[-1] == 1.0
        for a, b in zip(fractions, fractions[1:]):
            assert math.isclose(b / a, eta)


# ---------------------------------------------------------------------------
# the port against the reference: one measure(), one trace
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,eta,rungs,slo", [
    (10, 2, None, None), (9, 3, None, "p99_ms<=5"),
    (7, 2, 2, "p99_ms<=3,samples_per_s>=2"), (1, 2, None, None)])
def test_same_measure_gives_the_reference_trace(n, eta, rungs, slo):
    """One measure() over the same table (a failed measurement at item 4,
    ties, SLO violators) gives the reference's trace and the reference's
    calls, entry for entry."""
    if jexplore is None:
        pytest.skip("the JAX reference package is not installed")
    table = {i: None if i == 4 else
             {"samples_per_s": float((i * 7) % 5),
              "p99_ms": float((i * 3) % 8)} for i in range(n)}
    runs = []
    for halving, parse in ((jexplore.successive_halving,
                            jexplore.parse_constraint),
                           (successive_halving, parse_constraint)):
        measure, calls = table_measure(table)
        res = halving(list(range(n)), measure, objective="samples_per_s",
                      eta=eta, rungs=rungs, constraint=parse(slo))
        runs.append((res, calls))
    assert runs[1] == runs[0]
