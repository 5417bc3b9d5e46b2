"""The port's design-space explorer (``repro_torch.explore``) held against
the reference's (``repro.explore``).

The tests of ``tests/test_explore.py`` run case for case on the port, on
the CPU (``device="cpu"``), plus cross-package checks:

  * dominance, fronts and SLO parsing give the reference's answers on the
    same hypothesis-drawn inputs (exactly: pure Python on both sides);
  * sweeps give the reference's labels, statuses, reasons, plan fields,
    ``front_reason``, ``weight_bytes`` and ``ops_per_inference`` (exactly;
    ``mxu_fill_fraction`` is ``None`` in the port by design, and the
    replica rule's message names the port's devices);
  * with the reference's weights carried across and the same windows, the
    int path equals the reference's bit for bit and ``int_float_mse`` /
    ``int_float_max_abs`` agree within the float path's 1e-5;
  * the port's ``autotune`` fed the reference's JSON payload picks the
    reference's winner;
  * serving halving sweeps agree in schedule, fractions, measurement
    counts and schema (timed rankings are not compared across packages).

Timed values are never asserted, only their structure."""

import json
import math

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

import repro_torch
from repro_torch import explore
from repro_torch.convert import params_from_reference
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.fixed_point import FXP_4_8, FXP_8_16, FixedPointConfig
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.explore import measure as explore_measure
from repro_torch.explore.space import point_from_config
from repro_torch.training.tree import tree_leaves

try:  # the JAX reference; the card's machine has none
    import jax
    import repro
    from repro import explore as jexplore
except ImportError:
    jax = None

DEV = "cpu"
FLOAT_ATOL = 1e-5
# bench_pareto's smoke sweep: the cell zoo, 3-objective front.
SMOKE_OBJECTIVES = dict(explore.DEFAULT_OBJECTIVES, int_float_mse="min")


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _x(shape, seed=0):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.5
            ).astype(np.float32)


# ---------------------------------------------------------------------------
# Pareto dominance / front extraction (pure)
# ---------------------------------------------------------------------------

MAXMIN = {"gops": "max", "mse": "min"}


def test_dominates_basic_and_senses():
    a = {"gops": 2.0, "mse": 0.1}
    b = {"gops": 1.0, "mse": 0.2}
    assert explore.dominates(a, b, MAXMIN)
    assert not explore.dominates(b, a, MAXMIN)
    c = {"gops": 1.0, "mse": 0.05}
    assert not explore.dominates(a, c, MAXMIN)
    assert not explore.dominates(c, a, MAXMIN)


def test_dominates_ties():
    a = {"gops": 2.0, "mse": 0.1}
    same = dict(a)
    assert not explore.dominates(a, same, MAXMIN)
    assert not explore.dominates(same, a, MAXMIN)
    better = {"gops": 2.0, "mse": 0.05}
    assert explore.dominates(better, a, MAXMIN)
    assert not explore.dominates(a, better, MAXMIN)


def test_pareto_front_hand_built_2d():
    pts = [
        {"gops": 3.0, "mse": 0.3},   # front
        {"gops": 2.0, "mse": 0.1},   # front
        {"gops": 1.0, "mse": 0.2},   # dominated by the one above
        {"gops": 3.0, "mse": 0.3},   # duplicate of a front point: kept
        {"gops": 0.5, "mse": 0.4},   # dominated by everything
    ]
    idx = explore.pareto_indices(pts, MAXMIN)
    assert idx == [0, 1, 3]
    assert explore.pareto_front(pts, MAXMIN) == [pts[0], pts[1], pts[3]]


def test_pareto_front_three_objectives():
    obj = {"gops": "max", "gops_w": "max", "mse": "min"}
    pts = [
        {"gops": 3.0, "gops_w": 1.0, "mse": 0.30},
        {"gops": 1.0, "gops_w": 3.0, "mse": 0.30},
        {"gops": 1.0, "gops_w": 1.0, "mse": 0.01},
        {"gops": 1.0, "gops_w": 1.0, "mse": 0.30},
    ]
    assert explore.pareto_indices(pts, obj) == [0, 1, 2]
    assert explore.pareto_indices(pts, {"gops": "max", "gops_w": "max"}) \
        == [0, 1]


def test_pareto_front_excludes_non_finite():
    pts = [
        {"gops": float("nan"), "mse": 0.0},
        {"gops": float("inf"), "mse": 0.1},
        {"gops": 1.0, "mse": 0.2},
    ]
    assert explore.pareto_indices(pts, MAXMIN) == [2]


def test_dominates_rejects_bad_sense():
    with pytest.raises(ValueError, match="sense"):
        explore.dominates({"g": 1}, {"g": 2}, {"g": "maximize"})


# ---------------------------------------------------------------------------
# SearchSpace
# ---------------------------------------------------------------------------

def test_search_space_size_grid_and_sample():
    s = explore.SearchSpace(fxp=(FXP_4_8, FXP_8_16),
                            alu_mode=("pipelined", "per_step"),
                            hidden_size=(8, 20))
    assert s.size == 8
    grid = list(s.grid())
    assert len(grid) == 8 and len({p.label for p in grid}) == 8
    sampled = s.sample(3, seed=0)
    assert len(sampled) == 3 and len(set(sampled)) == 3
    assert s.sample(3, seed=0) == sampled
    assert set(s.sample(99, seed=1)) == set(grid)
    assert explore.SearchSpace(hidden_size=16).hidden_size == (16,)


def test_search_space_validation():
    with pytest.raises(ValueError, match="hs_method"):
        explore.SearchSpace(hs_method=("bogus",))
    with pytest.raises(ValueError, match="no choices"):
        explore.SearchSpace(batch=())
    with pytest.raises(ValueError, match="positive ints"):
        explore.SearchSpace(hidden_size=(0,))


def test_point_configs_and_roundtrip():
    p = next(iter(explore.SearchSpace(fxp=FXP_8_16, alu_mode="per_step",
                                      hidden_size=12, batch=7).grid()))
    base = QLSTMConfig(input_size=3, seq_len=9)
    model, accel = p.configs(base)
    assert model.hidden_size == 12 and model.input_size == 3 \
        and model.seq_len == 9
    assert accel.fxp == FXP_8_16 and accel.alu_mode == "per_step"
    assert point_from_config(p.asdict()) == p
    assert isinstance(point_from_config(p.asdict()).fxp, FixedPointConfig)


# ---------------------------------------------------------------------------
# The smoke sweep: schema + dominance correctness
# ---------------------------------------------------------------------------

def _smoke_sweep(pkg, **kw):
    return pkg.sweep(pkg.smoke_space(cell=("lstm", "gru", "rglru")),
                     iters=2, objectives=SMOKE_OBJECTIVES, **kw)


@pytest.fixture(scope="module")
def smoke_payload(tmp_path_factory):
    """One shared smoke sweep, written to JSON and read back so the
    on-disk artifact is what gets schema-checked."""
    out = tmp_path_factory.mktemp("sweep") / "BENCH_pareto.json"
    out.write_text(json.dumps(_smoke_sweep(explore, device=DEV), indent=1))
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def ref_smoke_payload():
    """The reference's sweep of the same space, through JSON."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    return json.loads(json.dumps(_smoke_sweep(jexplore)))


def test_smoke_sweep_schema(smoke_payload):
    p = smoke_payload
    assert p["suite"] == "pareto"
    assert p["schema_version"] == explore.SCHEMA_VERSION == 2
    assert p["mode"] == "grid"
    assert isinstance(p["seed"], int)
    assert set(p["space"]) == set(explore.AXES)
    assert all(v in ("max", "min") for v in p["objectives"].values())
    assert len(p["points"]) >= 4
    for r in p["points"]:
        assert set(r) >= {"label", "config", "status", "pareto"}
        assert set(r["config"]) == set(explore.AXES)
        if r["status"] == "ok":
            assert set(r["metrics"]) == explore.METRIC_KEYS
            assert r["plan"]["backend"] in ("ref", "pallas", "xla")
            assert r["plan"]["mxu_fill_fraction"] is None
            assert all(math.isfinite(v) for v in r["metrics"].values()
                       if isinstance(v, float))


def test_smoke_sweep_front_dominance_correct(smoke_payload):
    p = smoke_payload
    ok = [r for r in p["points"] if r["status"] == "ok"]
    assert len(ok) >= 4
    front = [r for r in ok if r["pareto"]]
    assert front and sorted(p["front"]) == sorted(r["label"] for r in front)
    obj = p["objectives"]
    for r in front:
        assert not any(explore.dominates(o["metrics"], r["metrics"], obj)
                       for o in ok)
    for r in ok:
        if not r["pareto"]:
            assert any(explore.dominates(f["metrics"], r["metrics"], obj)
                       for f in front), r["label"]


def _plan_fields(row):
    return {k: v for k, v in row.get("plan", {}).items()
            if k != "mxu_fill_fraction"}


def _same_rows(port, ref):
    """Labels, configs, statuses, reasons and plan fields equal, and the
    counted metrics exactly."""
    assert [r["label"] for r in port["points"]] == \
        [r["label"] for r in ref["points"]]
    for p, r in zip(port["points"], ref["points"]):
        assert (p["config"], p["status"], p.get("reason")) == \
            (r["config"], r["status"], r.get("reason")), p["label"]
        assert _plan_fields(p) == _plan_fields(r), p["label"]
        if p["status"] == "ok" and "weight_bytes" in r["metrics"]:
            for k in ("weight_bytes", "ops_per_inference"):
                assert p["metrics"][k] == r["metrics"][k], (p["label"], k)
    for key in ("suite", "schema_version", "mode", "strategy", "seed",
                "space", "objectives", "objective", "constraint",
                "scenario", "front_reason"):
        assert port[key] == ref[key], key


def test_smoke_sweep_matches_reference(smoke_payload, ref_smoke_payload):
    _same_rows(smoke_payload, ref_smoke_payload)


def test_pruned_and_unsupported_rows_match_reference(reference):
    """A space of refused backends, residency on a cell with no fused
    kernel, and two-replica points: every row pruned the reference's way.
    The replica rule's message names the port's devices, so it is held
    to its rule and its count."""
    space = explore.SearchSpace(alu_mode=("pipelined", "per_step"),
                                backend=("pallas", "xla"), batch=4,
                                hidden_size=8, cell=("lstm", "gru"),
                                replicas=(1, 2),
                                state_residency=("auto", "device"))
    jspace = jexplore.SearchSpace(alu_mode=("pipelined", "per_step"),
                                  backend=("pallas", "xla"), batch=4,
                                  hidden_size=8, cell=("lstm", "gru"),
                                  replicas=(1, 2),
                                  state_residency=("auto", "device"))
    sc = dict(streams=2, windows_per_stream=1)
    port = explore.sweep(space, scenario=explore.ServingScenario(**sc),
                         strategy="full", device=DEV)
    ref = jexplore.sweep(jspace, scenario=jexplore.ServingScenario(**sc),
                         strategy="full")
    assert [r["label"] for r in port["points"]] == \
        [r["label"] for r in ref["points"]]
    statuses = set()
    for p, r in zip(port["points"], ref["points"]):
        assert p["status"] == r["status"], p["label"]
        statuses.add(p["status"])
        if r.get("reason", "").startswith("replicas_fit_devices:"):
            want = "replicas_fit_devices: need 2 devices for 2 replicas, have 1"
            assert p["reason"].startswith(want) and r["reason"].startswith(want)
        else:
            assert p.get("reason") == r.get("reason"), p["label"]
            assert p.get("plan") == r.get("plan"), p["label"]
    assert statuses == {"ok", "unsupported", "infeasible"}
    # Fronts with nothing to measure: the same front_reason.
    for kw in (dict(space=dict(alu_mode="per_step", backend="pallas",
                               batch=4)),
               dict(space=dict(backend="xla", batch=4, cell="gru",
                               state_residency="device"),
                    scenario=sc, strategy="full")):
        runs = []
        for pkg, extra in ((jexplore, {}), (explore, {"device": DEV})):
            s = {k: pkg.ServingScenario(**v) if k == "scenario" else v
                 for k, v in kw.items() if k != "space"}
            runs.append(pkg.sweep(pkg.SearchSpace(**kw["space"]), iters=1,
                                  **s, **extra))
        assert runs[1]["front"] == runs[0]["front"] == []
        assert runs[1]["front_reason"] == runs[0]["front_reason"] is not None


def test_sweep_int_and_float_error_match_reference(reference, monkeypatch):
    """The reference's weights carried across, the same windows: the int
    path bit for bit, the int-vs-float errors within the float path's
    1e-5."""
    axes = dict(backend=("ref", "xla"), batch=16, hidden_size=8,
                num_layers=2)
    space = explore.SearchSpace(fxp=(FXP_4_8, FXP_8_16), **axes)
    jspace = jexplore.SearchSpace(
        fxp=tuple(repro.core.fixed_point.FixedPointConfig(f.frac_bits,
                                                          f.total_bits)
                  for f in space.fxp), **axes)
    x = _x((5, 6, 1), seed=11)
    ref = jexplore.sweep(jspace, iters=1, eval_x=x, seed=2)

    def carried(model, accel, *, seed, device):
        jm = repro.core.qlstm.QLSTMConfig(hidden_size=model.hidden_size,
                                          num_layers=model.num_layers)
        jp = repro.build(jm, seed=seed).params
        params = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
        return repro_torch.build(model, accel, params=params, device=device)

    monkeypatch.setattr(explore.measure, "build", carried)
    port = explore.sweep(space, iters=1, eval_x=x, seed=2, device=DEV)
    for p, r in zip(port["points"], ref["points"]):
        assert p["label"] == r["label"] and p["status"] == r["status"] == "ok"
        for k in ("int_float_mse", "int_float_max_abs"):
            assert abs(p["metrics"][k] - r["metrics"][k]) <= FLOAT_ATOL, \
                (p["label"], k)
        model, accel = point_from_config(p["config"]).configs()
        jmodel, jaccel = jexplore.point_from_config(r["config"]).configs()
        xb = np.tile(x, (4, 1, 1))[:16]
        got = carried(model, accel, seed=2, device=DEV).quantize() \
            .infer(xb, path="int").numpy()
        want = np.asarray(repro.build(jmodel, jaccel, seed=2).quantize()
                          .infer(xb, path="int"))
        assert np.array_equal(got, want), p["label"]


def test_sweep_records_unsupported_backend_instead_of_raising():
    space = explore.SearchSpace(alu_mode="per_step", backend="pallas",
                                batch=4)
    payload = explore.sweep(space, iters=1, device=DEV)
    (row,) = payload["points"]
    assert row["status"] == "unsupported" and "pallas" in row["reason"]
    assert payload["front"] == [] and row["pareto"] is False


def test_sweep_respects_base_model_and_eval_x():
    base = QLSTMConfig(input_size=2, seq_len=4)
    space = explore.SearchSpace(backend="ref", batch=4, hidden_size=8)
    x = np.zeros((3, 4, 2), np.float32)
    payload = explore.sweep(space, base, iters=1, eval_x=x, device=DEV)
    (row,) = payload["points"]
    assert row["status"] == "ok"
    with pytest.raises(ValueError, match="windows"):
        explore.sweep(space, base, iters=1,
                      eval_x=np.zeros((3, 6, 1), np.float32), device=DEV)


def test_entry_points_without_a_card_raise(monkeypatch):
    """No card and no ``device=``: sweep, evaluate_point and autotune
    raise instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    space = explore.SearchSpace(backend="ref", batch=4)
    point = next(iter(space.grid()))
    for call in (lambda: explore.sweep(space, iters=1),
                 lambda: explore.evaluate_point(point, iters=1),
                 lambda: explore.autotune(space=space, iters=1)):
        with pytest.raises(RuntimeError, match="CUDA card"):
            call()


# ---------------------------------------------------------------------------
# autotune: constrained argmax on the feasible front (ref backend)
# ---------------------------------------------------------------------------

def test_autotune_constraint_satisfaction_ref_backend():
    space = explore.SearchSpace(fxp=(FXP_4_8, FXP_8_16), backend="ref",
                                batch=8)
    session = explore.autotune(
        space=space, iters=2,
        constraints={"int_float_mse": (None, 1e-4)}, device=DEV)
    assert isinstance(session, repro_torch.Accelerator)
    assert session.accel.fxp == FXP_8_16
    assert session.plan["backend"] == "ref"
    assert session.qparams is not None

    s = session.autotune_summary
    assert s["best"]["label"] in s["front"]
    assert s["best"]["metrics"]["int_float_mse"] <= 1e-4
    feasible = [r for r in s["sweep"]["points"]
                if r["status"] == "ok"
                and r["metrics"]["int_float_mse"] <= 1e-4]
    best_val = max(r["metrics"]["gops_per_watt"] for r in feasible)
    assert s["best"]["metrics"]["gops_per_watt"] == best_val

    y = session.infer(_x((4, 6, 1)), path="int")
    assert tuple(y.shape) == (4, 1)


def test_autotune_infeasible_constraints_raise():
    space = explore.SearchSpace(backend="ref", batch=4)
    with pytest.raises(ValueError, match="no feasible point"):
        explore.autotune(space=space, iters=1,
                         constraints={"samples_per_s": (1e18, None)},
                         device=DEV)


def test_autotune_reuses_payload_without_resweeping():
    """The payload's own argmin wins, and the session is rebuilt with the
    payload's seed.  No format is pinned: which format measures the lower
    int-vs-float MSE at a given seed depends on the drawn weights."""
    space = explore.SearchSpace(fxp=(FXP_4_8, FXP_8_16), backend="ref",
                                batch=8)
    payload = explore.sweep(space, iters=2, seed=3, device=DEV)
    assert payload["seed"] == 3
    calls = []
    session = explore.autotune(payload=payload, objective="int_float_mse",
                               log=calls.append, device=DEV)
    assert session.autotune_summary["sense"] == "min"
    best = min(payload["points"], key=lambda r: r["metrics"]["int_float_mse"])
    assert session.autotune_summary["best"]["label"] == best["label"]
    assert session.accel.fxp == point_from_config(best["config"]).fxp
    assert not any("/2]" in c for c in calls)
    cfgs = point_from_config(session.autotune_summary["best"]["config"])
    want = repro_torch.build(*cfgs.configs(), seed=3, device=DEV).params
    assert all(torch.equal(a, b) for a, b in
               zip(tree_leaves(session.params), tree_leaves(want)))


def test_autotune_on_the_reference_payload_picks_its_winner(
        ref_smoke_payload):
    ref_best = jexplore.autotune(payload=ref_smoke_payload) \
        .autotune_summary["best"]["label"]
    session = explore.autotune(payload=ref_smoke_payload, device=DEV)
    assert session.autotune_summary["best"]["label"] == ref_best
    model, accel = point_from_config(
        session.autotune_summary["best"]["config"]).configs()
    assert session.model.cell == model.cell and session.accel.fxp == accel.fxp


def test_sweep_and_autotune_validate_metric_names_upfront():
    space = explore.SearchSpace(backend="ref", batch=4)
    with pytest.raises(ValueError, match="unknown objective.*gops_per_wat"):
        explore.sweep(space, objectives={"gops_per_wat": "max"}, device=DEV)
    with pytest.raises(ValueError, match="sense"):
        explore.sweep(space, objectives={"gops_per_watt": "maximize"},
                      device=DEV)
    with pytest.raises(ValueError, match="unknown objective"):
        explore.autotune(space=space, objective="latency", device=DEV)
    with pytest.raises(ValueError, match="unknown constraint"):
        explore.autotune(space=space, constraints={"watts": (None, 1.0)},
                         device=DEV)


def test_sweep_base_accel_is_honoured():
    space = explore.SearchSpace(backend="ref", batch=4)
    payload = explore.sweep(space, None, AcceleratorConfig(ht_max=0.5),
                            iters=1, device=DEV)
    (row,) = payload["points"]
    assert row["status"] == "ok"
    session = explore.autotune(space=space, iters=1,
                               accel=AcceleratorConfig(ht_max=0.5),
                               device=DEV)
    assert session.model.acts.ht_max == 0.5


# ---------------------------------------------------------------------------
# ExploreError: empty/eliminated fronts fail loudly, naming the eliminator
# ---------------------------------------------------------------------------

def test_pareto_front_of_nothing_raises_explore_error():
    with pytest.raises(explore.ExploreError, match="0 measurements"):
        explore.pareto_front([], MAXMIN)
    assert issubclass(explore.ExploreError, ValueError)


def test_pareto_front_all_non_finite_raises_explore_error():
    pts = [{"gops": float("nan"), "mse": 0.1},
           {"gops": float("inf"), "mse": 0.2}]
    with pytest.raises(explore.ExploreError, match="non-finite"):
        explore.pareto_indices(pts, MAXMIN)


def test_dominates_missing_metric_names_it():
    with pytest.raises(explore.ExploreError, match="mse"):
        explore.dominates({"gops": 3.0}, {"gops": 2.0, "mse": 0.1}, MAXMIN)


def test_constrained_front_raises_naming_the_constraint():
    slo = explore.parse_constraint("p99_ms<=5")
    pts = [{"samples_per_s": 10.0, "p99_ms": 9.0},
           {"samples_per_s": 99.0, "p99_ms": 6.0}]
    with pytest.raises(explore.ExploreError, match=r"p99_ms<=5") as e:
        explore.constrained_pareto_front(
            pts, {"samples_per_s": "max"}, constraint=slo)
    assert "1" in str(e.value)


def test_constrained_front_filters_violators_keeps_feasible():
    slo = explore.parse_constraint("p99_ms<=5")
    pts = [{"samples_per_s": 10.0, "p99_ms": 4.0},
           {"samples_per_s": 99.0, "p99_ms": 6.0},
           {"samples_per_s": 5.0, "p99_ms": 1.0}]
    front = explore.constrained_pareto_front(
        pts, {"samples_per_s": "max", "p99_ms": "min"}, constraint=slo)
    assert pts[1] not in front
    assert pts[0] in front and pts[2] in front


# ---------------------------------------------------------------------------
# SLO parsing
# ---------------------------------------------------------------------------

def test_slo_parse_ok_violation_roundtrip():
    slo = explore.parse_constraint("p99_ms<=5")
    assert slo.ok({"p99_ms": 5.0}) and not slo.ok({"p99_ms": 5.01})
    assert slo.violation({"p99_ms": 7.5}) == 2.5
    assert slo.violation({"p99_ms": 2.0}) == 0.0
    assert slo.violation({}) == float("inf")
    assert explore.parse_constraint(slo.describe()) == slo
    multi = explore.parse_constraint("p99_ms<=5,samples_per_s>=100")
    assert multi.ok({"p99_ms": 4.0, "samples_per_s": 200.0})
    assert not multi.ok({"p99_ms": 4.0, "samples_per_s": 50.0})
    assert multi.violation({"p99_ms": 6.0, "samples_per_s": 50.0}) == 51.0


def test_slo_parse_rejects_garbage():
    with pytest.raises(ValueError, match="cannot parse"):
        explore.parse_constraint("p99_ms ~ 5")
    with pytest.raises(ValueError, match="unknown SLO metric"):
        explore.parse_constraint("p99<=5")
    with pytest.raises(ValueError, match="empty"):
        explore.parse_constraint(" , ")


# ---------------------------------------------------------------------------
# hypothesis properties: the constrained front never admits an SLO violator,
# and the port answers as the reference does on the same draws
# ---------------------------------------------------------------------------

metrics_strategy = st.lists(
    st.fixed_dictionaries({
        "samples_per_s": st.floats(1.0, 1e6, allow_nan=False),
        "p99_ms": st.floats(0.01, 100.0, allow_nan=False),
    }), min_size=1, max_size=12)


@pytest.mark.property
@settings(max_examples=60, deadline=None)
@given(pts=metrics_strategy, bound=st.floats(0.01, 100.0, allow_nan=False))
def test_property_constrained_front_respects_slo(pts, bound):
    slo = explore.SLO("p99_ms", "<=", bound)
    objectives = {"samples_per_s": "max", "p99_ms": "min"}
    if not any(slo.ok(p) for p in pts):
        with pytest.raises(explore.ExploreError):
            explore.constrained_pareto_front(pts, objectives, constraint=slo)
        return
    front = explore.constrained_pareto_front(pts, objectives, constraint=slo)
    assert front
    for p in front:
        assert slo.ok(p), "front admitted an SLO violator"
    feas = [p for p in pts if slo.ok(p)]
    for f in front:
        assert not any(explore.dominates(o, f, objectives) for o in feas)


def _answer(fn):
    try:
        return ("ok", fn())
    except ValueError as e:          # ExploreError included
        return (type(e).__name__, str(e))


@pytest.mark.property
@settings(max_examples=60, deadline=None)
@given(pts=st.lists(st.fixed_dictionaries({
           "samples_per_s": st.one_of(st.floats(1.0, 1e6),
                                      st.just(float("nan"))),
           "p99_ms": st.one_of(st.floats(0.0, 100.0),
                               st.just(float("inf")))}),
           min_size=0, max_size=10),
       bound=st.floats(0.0, 100.0),
       op=st.sampled_from(["<=", "<", ">=", ">"]),
       sense=st.sampled_from(["max", "min"]))
def test_property_fronts_and_slos_match_reference(pts, bound, op, sense):
    """Same draws, same answers: SLO parse/ok/violation, dominance, the
    front and the constrained front (or the same error)."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    obj = {"samples_per_s": sense, "p99_ms": "min"}
    for text in (f"p99_ms{op}{bound!r}", f"p99_ms{op}{bound!r},samples_per_s>=9"):
        slo, jslo = explore.parse_constraint(text), jexplore.parse_constraint(text)
        assert slo.describe() == jslo.describe()
        for p in pts:
            assert (slo.ok(p), slo.violation(p)) == (jslo.ok(p), jslo.violation(p))
        assert _answer(lambda: explore.constrained_pareto_front(
            pts, obj, constraint=slo)) == _answer(
            lambda: jexplore.constrained_pareto_front(pts, obj, constraint=jslo))
    assert _answer(lambda: explore.pareto_indices(pts, obj)) == \
        _answer(lambda: jexplore.pareto_indices(pts, obj))
    for a in pts:
        for b in pts:
            assert explore.dominates(a, b, obj) == jexplore.dominates(a, b, obj)


# ---------------------------------------------------------------------------
# serving axes: declarative prune agrees with the imperative serving plan
# ---------------------------------------------------------------------------

def test_space_gains_serving_axes_and_labels():
    assert "replicas" in explore.AXES and "state_residency" in explore.AXES
    sp = explore.SearchSpace(backend="xla", batch=4, replicas=(1, 2),
                             state_residency=("auto", "host"))
    labels = {p.label for p in sp.grid()}
    assert len(labels) == 4
    assert any(lab.endswith("_r2_host") for lab in labels)
    base = next(iter(explore.SearchSpace(backend="xla", batch=4).grid()))
    assert "_r" not in base.label and not base.label.endswith("_host")
    for p in sp.grid():
        assert point_from_config(p.asdict()) == p
    with pytest.raises(ValueError, match="state_residency"):
        explore.SearchSpace(state_residency=("gpu",))
    with pytest.raises(ValueError, match="positive ints"):
        explore.SearchSpace(replicas=(0,))


def test_prune_and_serving_plan_agree_across_the_axes():
    """The declarative constraint tree and the imperative serving_plan are
    two forms of one contract: a point prunes iff its plan raises, with
    matching rule names."""
    from repro_torch.explore.constraints import InfeasiblePoint
    from repro_torch.explore.serving_objective import serving_plan

    sp = explore.SearchSpace(backend=("auto", "ref", "xla", "pallas"),
                             batch=4, hidden_size=8,
                             cell=("lstm", "gru", "rglru"),
                             replicas=(1, 3),
                             state_residency=("auto", "host", "device"),
                             alu_mode=("pipelined", "per_step"))
    checked = 0
    for p in sp.grid():
        reason = sp.feasible(p, kind=DEV)
        try:
            pl = serving_plan(p, kind=DEV)
            planned = None
        except InfeasiblePoint as e:
            planned = str(e)
        if reason is None:
            assert planned is None, (p.label, planned)
            assert pl["replicas"] == p.replicas
            assert pl["state_residency"] in ("host", "device")
        else:
            assert planned is not None, (p.label, reason)
            decl = reason.split(":", 1)[0]
            imp = planned.split(":", 1)[0]
            assert {("backend_supported", "backend"),
                    ("device_residency", "state_residency"),
                    ("replicas_fit_devices", "replicas")} >= {(decl, imp)} \
                or decl.startswith(imp) or imp in decl, (decl, imp)
        checked += 1
    assert checked == sp.size == 4 * 3 * 2 * 3 * 2


def test_constraint_node_composition_operators():
    from repro_torch.explore.constraints import AllOf, AnyOf, Rule

    yes = Rule("yes", lambda *a: None)
    no = Rule("no", lambda *a: "bad value")
    assert (yes & no).check(None, None, None) == "no: bad value"
    assert (yes | no).check(None, None, None) is None
    assert (~yes).check(None, None, None) == \
        "~yes: point satisfies the negated rule"
    assert (~no).check(None, None, None) is None
    both = AllOf((yes, AnyOf((no, yes))))
    assert both.check(None, None, None) is None
    assert "no" in AnyOf((no, no)).check(None, None, None)


def test_sweep_all_infeasible_records_front_reason_no_builds():
    space = explore.SearchSpace(backend="xla", batch=4, cell="gru",
                                state_residency="device")
    payload = explore.sweep(space, scenario=explore.ServingScenario(
        streams=2, windows_per_stream=1), strategy="full", device=DEV)
    (row,) = payload["points"]
    assert row["status"] == "infeasible"
    assert "device" in row["reason"]
    assert payload["front"] == []
    assert payload["front_reason"] is not None
    assert "0 of 1 points" in payload["front_reason"]


def test_halving_without_scenario_is_rejected():
    space = explore.SearchSpace(backend="ref", batch=4)
    with pytest.raises(ValueError, match="halving"):
        explore.sweep(space, strategy="halving", device=DEV)
    with pytest.raises(ValueError, match="SLO"):
        explore.sweep(space, constraint="p99_ms<=5", device=DEV)


# ---------------------------------------------------------------------------
# live serving-aware search: schema v2, SLO satisfaction, determinism
# ---------------------------------------------------------------------------

SERVING_SLO = "p99_ms<=60000"
HALVING = dict(objective="samples_per_s", constraint=SERVING_SLO, eta=2,
               seed=0, strategy="halving")
# 64 streams: at rung 0 batch 1 serves 128 one-window waves and batch 16
# eight full ones, so batch 16 leads by an order of magnitude in both
# packages (8-20x on the CPU) and a host stall must last as long as the
# whole batch-1 run to swap them; with 3 streams (3 windows a wave) the
# lead was 1.4-3.5x and a loaded host swapped it.
HALVING_STREAMS = 64


def _halving(pkg, **kw):
    space = pkg.SearchSpace(backend="xla", batch=(1, 16), hidden_size=8,
                            num_layers=1)
    scenario = pkg.ServingScenario(streams=HALVING_STREAMS, windows_per_stream=3,
                                   deadline_ms=60000.0, name="t")
    return pkg.sweep(space, scenario=scenario, **HALVING, **kw)


def _scenario_key(point, scenario):
    return point.label, json.dumps(scenario.asdict(), sort_keys=True)


@pytest.fixture(scope="module")
def halving_run():
    """One shared serving halving sweep over a 2-point space whose ranking
    is robust (batch 1 vs 16 differ by an order of magnitude), and every
    measurement it took: its metrics by (point, truncated scenario)."""
    measured = {}
    real = explore_measure.evaluate_serving_point

    def recording(point, scenario, *a, **kw):
        row = real(point, scenario, *a, **kw)
        measured[_scenario_key(point, scenario)] = dict(row["metrics"])
        return row

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(explore_measure, "evaluate_serving_point", recording)
        payload = _halving(explore, device=DEV)
    return payload, measured


@pytest.fixture(scope="module")
def halving_payload(halving_run):
    return halving_run[0]


def test_serving_sweep_schema_v2(halving_payload):
    p = halving_payload
    assert p["schema_version"] == 2
    assert p["strategy"] == "halving"
    assert p["constraint"] == "p99_ms<=60000"
    assert p["scenario"]["streams"] == HALVING_STREAMS
    assert p["objective"] == "samples_per_s"
    tr = p["halving"]
    assert tr["sizes"] == [2, 1]
    assert tr["fractions"] == [0.5, 1.0]
    assert tr["total_measurements"] == 3 <= tr["budget_bound"]
    assert len(tr["rungs"]) == 2
    for r in p["points"]:
        assert r["status"] == "ok"
        m = r["metrics"]
        assert set(m) == set(explore.SERVING_METRIC_KEYS)
        op = r["operating_point"]
        assert set(op) >= {"scenario", "rung", "fraction", "final",
                           "p99_ms", "deadline_miss_rate", "feasible"}
        assert op["p99_ms"] == m["p99_ms"]
    finals = [r for r in p["points"] if r["operating_point"]["final"]]
    assert len(finals) == 1
    assert finals[0]["operating_point"]["fraction"] == 1.0
    truncated = [r for r in p["points"] if not r["operating_point"]["final"]]
    assert truncated and all(
        r["operating_point"]["scenario"]["windows_per_stream"] == 2
        for r in truncated)
    assert set(p["front"]) <= {r["label"] for r in finals}


def test_serving_sweep_matches_reference_schedule_and_schema(
        halving_payload, reference):
    """Rung sizes, fractions, measurement counts and every key of the
    payload, its trace, rows and operating points are the reference's;
    the winner is the batch-16 point in both."""
    ref = _halving(jexplore)
    p = halving_payload
    assert set(p) == set(ref)
    for k in ("eta", "sizes", "fractions", "total_measurements",
              "budget_bound", "objective", "sense", "constraint"):
        assert p["halving"][k] == ref["halving"][k], k
    assert set(p["halving"]) == set(ref["halving"])
    assert [len(r["measured"]) for r in p["halving"]["rungs"]] == \
        [len(r["measured"]) for r in ref["halving"]["rungs"]]
    assert p["scenario"] == ref["scenario"]
    for a, b in zip(p["points"], ref["points"]):
        assert a["label"] == b["label"] and set(a) == set(b)
        assert set(a["metrics"]) == set(b["metrics"])
        assert set(a["operating_point"]) == set(b["operating_point"])
        assert a["plan"] == b["plan"]
    assert p["halving"]["winner_label"].endswith("_b16_xla") and \
        ref["halving"]["winner_label"].endswith("_b16_xla")


def test_serving_autotune_satisfies_slo_on_remeasure(halving_payload):
    session = explore.autotune(payload=halving_payload,
                               objective="samples_per_s",
                               constraint=SERVING_SLO, device=DEV)
    assert isinstance(session, repro_torch.Accelerator)
    s = session.autotune_summary
    assert s["strategy"] == "halving"
    assert s["constraint"] == "p99_ms<=60000"
    assert s["operating_point"]["final"] is True
    assert s["operating_point"]["feasible"] is True
    assert s["halving"]["winner_label"] == s["best"]["label"]
    scenario = explore.ServingScenario.from_dict(halving_payload["scenario"])
    remeasured = session.measure_scenario(scenario)
    slo = explore.parse_constraint(SERVING_SLO)
    assert slo.ok(remeasured), remeasured


def test_serving_autotune_impossible_slo_names_it(halving_payload):
    with pytest.raises(explore.ExploreError,
                       match=r"no feasible point.*p99_ms<=0.0001"):
        explore.autotune(payload=halving_payload,
                         constraint="p99_ms<=0.0001", device=DEV)


def test_serving_halving_same_seed_identical_traces(halving_run, monkeypatch):
    """A second same-seed sweep, given the same measurements, reproduces
    the rung-promotion trace and picks the same config.

    Its servers run again, and each measurement it takes is replaced by
    the first sweep's for the same point and rung: two live runs are not
    the same measurement, and under a loaded host the two points' rung-0
    samples/s, read off the wall clock, can swap their ranking (then the
    promotion trace differs first, and the winner and front with it)."""
    halving_payload, measured = halving_run
    real = explore_measure.evaluate_serving_point
    replayed = []

    def replay(point, scenario, *a, **kw):
        row = real(point, scenario, *a, **kw)
        row["metrics"] = dict(measured[_scenario_key(point, scenario)])
        replayed.append(_scenario_key(point, scenario))
        return row

    monkeypatch.setattr(explore_measure, "evaluate_serving_point", replay)
    p2 = _halving(explore, device=DEV)
    assert sorted(replayed) == sorted(measured)
    strip = lambda tr: [(r["rung"], r["fraction"], r["measured"],  # noqa: E731
                         r["promoted"]) for r in tr["rungs"]]
    assert strip(p2["halving"]) == strip(halving_payload["halving"])
    assert p2["halving"]["winner_label"] == \
        halving_payload["halving"]["winner_label"]
    assert p2["front"] == halving_payload["front"]


def test_measure_scenario_session_api():
    sess = repro_torch.build(QLSTMConfig(hidden_size=8), seed=0,
                             device=DEV).quantize()
    sc = explore.ServingScenario(streams=2, windows_per_stream=2,
                                 deadline_ms=60000.0)
    m = sess.measure_scenario(sc)
    assert set(m) == set(explore.SERVING_METRIC_KEYS)
    assert m["samples_per_s"] > 0
    assert m["waves"] >= 1
    assert m["gops_per_watt"] > 0
