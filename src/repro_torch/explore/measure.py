"""Score one configuration point / sweep a whole space through the session
API.

Every point is evaluated exactly the way a user would deploy it.  Offline
sweeps build ``repro_torch.build(model, accel, device=...).quantize()``
and time the cached int-path entry (``Accelerator.compiled``) — one
warm-up call outside the clock, then ``iters`` calls between two
``torch.cuda.synchronize()`` on the card — with ``Accelerator.report()``
re-anchored at the *measured* latency so the energy model scores the real
operating point.  Serving sweeps (``scenario=...``) instead stand up a
short real ``StreamServer``/``ClusterServer`` run per point
(``repro_torch.explore.serving_objective``) and score
``metrics_summary()``-derived objectives: p50/p95/p99, achieved
samples/s, deadline-miss rate, GOP/s/W.

Structurally infeasible points (device residency without the fused plan,
replicas > devices, a refusing explicit backend — see
``repro_torch.explore.constraints``) are pruned BEFORE measurement and
recorded with the violated rule's reason.  ``strategy="halving"``
replaces the full per-point scenario with seeded successive halving
(``repro_torch.explore.halving``): rung 0 measures every survivor on a
cheap truncated scenario and each rung promotes the top ``1/eta`` on the
constrained objective.

Counterpart of ``repro/explore/measure.py``: the payload (schema v2) is
the reference's, so ``analysis/report.py --pareto`` renders either
package's and ``autotune(payload=...)`` reads either.  Sessions run on
``device=`` (``build``'s default: the card, raising without one).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import backends
from repro_torch.api import build, resolve_device
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.explore.pareto import (DEFAULT_OBJECTIVES, ExploreError,
                                        constrained_pareto_front)
from repro_torch.explore.serving_objective import (SERVING_METRIC_KEYS,
                                                   SERVING_MINIMISE,
                                                   ServingScenario,
                                                   evaluate_serving_point,
                                                   parse_constraint)
from repro_torch.explore.space import Point, SearchSpace

# v2: serving-aware sweeps — points gain "infeasible" status + reasons,
# ok rows of scenario sweeps carry the serving "operating_point" (scenario,
# rung, p99, miss rate), and the payload records strategy / scenario /
# constraint / halving trace / front_reason.
SCHEMA_VERSION = 2

# Every metric an OFFLINE sweep row carries — the vocabulary objectives and
# constraints may reference.  Validated BEFORE the measurement loop, so a
# typo fails in milliseconds instead of as a KeyError after minutes of
# timed builds.  Scenario sweeps use SERVING_METRIC_KEYS instead.
METRIC_KEYS = frozenset({
    "us_per_wave", "samples_per_s", "throughput_gops", "gops_per_watt",
    "total_w", "dynamic_w", "energy_j_per_wave", "int_float_mse",
    "int_float_max_abs", "weight_bytes", "ops_per_inference",
})

# Serving-mode default front: the achieved-rate / tail-latency trade-off.
SERVING_OBJECTIVES: Dict[str, str] = {
    "samples_per_s": "max",
    "p99_ms": "min",
}


def validate_metric_names(names, what: str, vocab=None) -> None:
    vocab = METRIC_KEYS if vocab is None else vocab
    unknown = sorted(set(names) - set(vocab))
    if unknown:
        raise ValueError(f"unknown {what} metric(s) {unknown}; "
                         f"known: {sorted(vocab)}")


def _eval_batch(point: Point, model: QLSTMConfig,
                eval_x: Optional[np.ndarray], seed: int,
                device: torch.device) -> torch.Tensor:
    """A (batch, T, M) float evaluation wave on ``device``: user data when
    given (tiled to the wave size), else synthetic windows in the
    normalised input range, drawn by a ``torch.Generator`` seeded with
    ``seed`` — not the reference's ``jax.random`` stream, which torch
    cannot reproduce; pass ``eval_x`` where both packages must see the
    same windows."""
    b, t, m = point.batch, model.seq_len, model.input_size
    if eval_x is not None:
        x = np.asarray(eval_x, np.float32)
        if x.shape[1:] != (t, m):
            raise ValueError(f"eval_x windows are {x.shape[1:]}, the swept "
                             f"model needs ({t}, {m})")
        reps = -(-b // len(x))
        return torch.as_tensor(np.tile(x, (reps, 1, 1))[:b], device=device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn((b, t, m), generator=gen, device=device) * 0.5


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def evaluate_point(point: Point, base_model: Optional[QLSTMConfig] = None,
                   base_accel: Optional[AcceleratorConfig] = None,
                   *, eval_x: Optional[np.ndarray] = None, iters: int = 20,
                   seed: int = 0, device=None) -> Dict:
    """Build, quantise, time, and score one configuration point on
    ``device`` (``build``'s default: the card).

    ``base_model``/``base_accel`` carry the non-swept parameters (see
    ``Point.configs``).  Returns the sweep-row dict (``status`` is ``"ok"``
    here; ``sweep`` records unsupported points instead of raising)."""
    model_cfg, accel_cfg = point.configs(base_model, base_accel)
    sess = build(model_cfg, accel_cfg, seed=seed, device=device).quantize()
    x = _eval_batch(point, sess.model, eval_x, seed, sess.device)

    fn = sess.compiled("int")
    fn(x)                                   # warm up outside the clock
    _sync(sess.device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(x)
    _sync(sess.device)
    wave_s = (time.perf_counter() - t0) / iters

    report = sess.report(latency_s=wave_s, batch=point.batch)
    energy = report["energy"]
    y_int = out.cpu().numpy()
    y_float = sess.infer(x, path="float").detach().cpu().numpy()
    err = y_int - y_float

    return {
        "label": point.label,
        "config": point.asdict(),
        "status": "ok",
        "plan": {
            "backend": report["backend"],
            "weight_memory": report["plan"]["weight_memory"],
            "weight_bytes": report["weight_bytes"],
            "mxu_fill_fraction": report["plan"]["mxu_fill_fraction"],
        },
        "metrics": {
            "us_per_wave": wave_s * 1e6,
            "samples_per_s": point.batch / wave_s,
            "throughput_gops": energy["throughput_gops"],
            "gops_per_watt": energy["gops_per_watt"],
            "total_w": energy["total_w"],
            "dynamic_w": energy["dynamic_w"],
            "energy_j_per_wave": energy["energy_j"],
            "int_float_mse": float(np.mean(err ** 2)),
            "int_float_max_abs": float(np.abs(err).max()),
            "weight_bytes": report["weight_bytes"],
            "ops_per_inference": report["ops_per_inference"],
        },
    }


def _enumerate(space: SearchSpace, mode: str, n: Optional[int],
               seed: int) -> List[Point]:
    if mode == "grid":
        return list(space.grid())
    if mode == "random":
        if n is None:
            raise ValueError("mode='random' needs n=<points to sample>")
        return list(space.sample(n, seed))
    raise ValueError(f"mode must be 'grid'|'random', got {mode!r}")


def _prune(space: SearchSpace, points: List[Point], base_model,
           base_accel, log, kind: str) -> Tuple[List[Point], Dict[str, Dict]]:
    """Split the candidate list on the space's constraint tree.  Pruned
    points become rows up front: backend refusals keep the historical
    ``"unsupported"`` status, structural invalidity (residency, replicas)
    is ``"infeasible"`` — both carry the violated rule's reason."""
    survivors: List[Point] = []
    pruned: Dict[str, Dict] = {}
    for point in points:
        reason = space.feasible(point, base_model, base_accel, kind)
        if reason is None:
            survivors.append(point)
            continue
        status = ("unsupported" if reason.startswith("backend_supported:")
                  else "infeasible")
        pruned[point.label] = {"label": point.label,
                               "config": point.asdict(),
                               "status": status, "reason": reason}
        if log:
            log(f"[sweep] pruned {point.label}: {reason}")
    return survivors, pruned


def sweep(space: SearchSpace, base_model: Optional[QLSTMConfig] = None,
          base_accel: Optional[AcceleratorConfig] = None, *,
          mode: str = "grid", n: Optional[int] = None, seed: int = 0,
          iters: int = 20, eval_x: Optional[np.ndarray] = None,
          objectives: Optional[Mapping[str, str]] = None,
          scenario: Optional[ServingScenario] = None,
          constraint=None, strategy: Optional[str] = None,
          objective: Optional[str] = None, eta: int = 2,
          rungs: Optional[int] = None,
          log: Optional[Callable[[str], None]] = None,
          device=None) -> Dict:
    """Measure a search space and extract the (constrained) Pareto front.

    Offline (``scenario=None``): every grid/sampled point is built and its
    int path timed.  Serving (``scenario=...``): each
    point is scored by a real short server run at the scenario's operating
    point; ``strategy="halving"`` runs seeded successive halving over the
    survivors (rung 0 on ``scenario.truncated(...)``, final rung on the
    full scenario), ranking on ``objective`` (default ``samples_per_s``)
    subject to ``constraint`` (an SLO string like ``"p99_ms<=5"``).

    Pruned/unsupported points are recorded with reasons and excluded from
    the front rather than aborting the sweep — an infeasible corner is a
    sweep *finding*.  When nothing reaches the front, ``front`` is empty
    and ``front_reason`` names what eliminated everything.

    Every session is built on ``device`` (``build``'s default: the card;
    with no card and no ``device`` the sweep raises before it measures)."""
    device = resolve_device(device)
    points = _enumerate(space, mode, n, seed)
    strategy = strategy or "full"
    if strategy not in ("full", "halving"):
        raise ValueError(f"strategy must be 'full'|'halving', "
                         f"got {strategy!r}")
    if strategy == "halving" and scenario is None:
        raise ValueError("strategy='halving' needs a ServingScenario — "
                         "rungs are scenario truncations")
    slo = parse_constraint(constraint)
    if slo is not None and scenario is None:
        raise ValueError("an SLO constraint needs a ServingScenario to "
                         "measure it under")

    vocab = SERVING_METRIC_KEYS if scenario is not None else METRIC_KEYS
    if objectives is None:
        objectives = SERVING_OBJECTIVES if scenario is not None \
            else DEFAULT_OBJECTIVES
    objectives = dict(objectives)
    if objective is None and scenario is not None:
        objective = "samples_per_s"
    if objective is not None:
        validate_metric_names([objective], "objective", vocab)
        objectives.setdefault(
            objective, "min" if objective in SERVING_MINIMISE else "max")
    validate_metric_names(objectives, "objective", vocab)
    for sense in objectives.values():
        if sense not in ("max", "min"):
            raise ValueError(f"objective sense must be 'max'|'min', "
                             f"got {sense!r}")

    survivors, pruned = _prune(space, points, base_model, base_accel, log,
                               device.type)
    rows_by_label: Dict[str, Dict] = dict(pruned)
    halving_trace = None

    if scenario is None:
        _sweep_offline(survivors, rows_by_label, base_model, base_accel,
                       eval_x=eval_x, iters=iters, seed=seed, log=log,
                       device=device)
        final_labels = [p.label for p in survivors
                        if rows_by_label[p.label]["status"] == "ok"]
    elif strategy == "full":
        for i, point in enumerate(survivors):
            row = evaluate_serving_point(point, scenario, base_model,
                                         base_accel, seed=seed, device=device)
            row["operating_point"] = _operating_point(
                scenario, None, 1.0, row["metrics"], slo, final=True)
            rows_by_label[point.label] = row
            if log:
                m = row["metrics"]
                log(f"[sweep {i + 1}/{len(survivors)}] {row['label']}: "
                    f"{m['samples_per_s']:,.0f} samples/s, "
                    f"p99={m['p99_ms']:.2f} ms")
        final_labels = [p.label for p in survivors]
    else:
        halving_trace, final_labels = _sweep_halving(
            survivors, rows_by_label, scenario, base_model, base_accel,
            seed=seed, objective=objective, slo=slo, eta=eta, rungs=rungs,
            log=log, device=device)

    rows = [rows_by_label[p.label] for p in points]
    front_labels, front_reason = _extract_front(
        rows_by_label, final_labels, objectives, slo)
    on_front = set(front_labels)
    for r in rows:
        r["pareto"] = r["label"] in on_front
    return {
        "suite": "pareto",
        "schema_version": SCHEMA_VERSION,
        "mode": mode,
        "strategy": strategy,
        # The init seed the measured sessions were built with — autotune
        # rebuilds the winner from a stored payload with THIS seed, so the
        # deployed weights are the ones the metrics describe.
        "seed": seed,
        "space": space.asdict(),
        "objectives": objectives,
        "objective": objective,
        "constraint": slo.describe() if slo is not None else None,
        "scenario": scenario.asdict() if scenario is not None else None,
        "halving": halving_trace,
        "points": rows,
        "front": front_labels,
        "front_reason": front_reason,
    }


def _sweep_offline(survivors, rows_by_label, base_model, base_accel, *,
                   eval_x, iters, seed, log, device) -> None:
    for i, point in enumerate(survivors):
        try:
            row = evaluate_point(point, base_model, base_accel,
                                 eval_x=eval_x, iters=iters, seed=seed,
                                 device=device)
        except backends.BackendUnsupported as e:
            row = {"label": point.label, "config": point.asdict(),
                   "status": "unsupported", "reason": str(e)}
        rows_by_label[point.label] = row
        if log:
            m = row.get("metrics", {})
            log(f"[sweep {i + 1}/{len(survivors)}] {row['label']}: "
                + (f"{m['samples_per_s']:,.0f} samples/s, "
                   f"{m['gops_per_watt']:.3f} GOP/s/W"
                   if row["status"] == "ok" else row["status"]))


def _sweep_halving(survivors, rows_by_label, scenario, base_model,
                   base_accel, *, seed, objective, slo, eta, rungs, log,
                   device):
    """Successive halving over the pruned survivors.  Sessions are built
    once per point and reused across rungs; every survivor gets a row
    carrying the metrics of its LAST measured rung and the operating
    point it was measured at."""
    from repro_torch.explore.halving import successive_halving
    if not survivors:
        return None, []
    sessions: Dict[str, object] = {}
    last_rung: Dict[str, int] = {}
    last_fraction: Dict[str, float] = {}
    plans: Dict[str, Dict] = {}

    def measure(point, rung, fraction):
        sc = scenario.truncated(fraction)
        sess = sessions.get(point.label)
        if sess is None:
            model_cfg, accel_cfg = point.configs(base_model, base_accel)
            sess = build(model_cfg, accel_cfg, seed=seed,
                         device=device).quantize()
            sessions[point.label] = sess
        row = evaluate_serving_point(point, sc, base_model, base_accel,
                                     seed=seed, session=sess)
        last_rung[point.label] = rung
        last_fraction[point.label] = fraction
        plans[point.label] = row["plan"]
        return row["metrics"]

    sense = "min" if objective in SERVING_MINIMISE else "max"
    trace = successive_halving(
        survivors, measure, objective=objective, sense=sense, eta=eta,
        rungs=rungs, constraint=slo,
        labels=[p.label for p in survivors], log=log)

    n_rungs = len(trace["sizes"])
    for idx, point in enumerate(survivors):
        metrics = trace["results"].get(idx)
        if metrics is None:
            rows_by_label[point.label] = {
                "label": point.label, "config": point.asdict(),
                "status": "failed",
                "reason": "scenario measurement returned nothing"}
            continue
        rung = last_rung[point.label]
        frac = last_fraction[point.label]
        rows_by_label[point.label] = {
            "label": point.label,
            "config": point.asdict(),
            "status": "ok",
            "plan": plans[point.label],
            "metrics": metrics,
            "operating_point": _operating_point(
                scenario.truncated(frac), rung, frac, metrics, slo,
                final=rung == n_rungs - 1),
        }
    final_labels = [lab for lab in trace["rungs"][-1]["measured"]]
    payload_trace = {k: trace[k] for k in
                     ("eta", "sizes", "fractions", "rungs", "winner_label",
                      "winner_feasible", "total_measurements",
                      "budget_bound", "objective", "sense", "constraint")}
    return payload_trace, final_labels


def _operating_point(scenario, rung, fraction, metrics, slo, *,
                     final: bool) -> Dict:
    """The per-point serving operating-point record of schema v2: which
    scenario (possibly truncated) the metrics were measured under, at
    which halving rung, and how the point stands against the SLO."""
    return {
        "scenario": scenario.asdict(),
        "rung": rung,
        "fraction": fraction,
        "final": final,
        "p99_ms": metrics.get("p99_ms"),
        "deadline_miss_rate": metrics.get("deadline_miss_rate"),
        "constraint": slo.describe() if slo is not None else None,
        "feasible": slo.ok(metrics) if slo is not None else True,
    }


def _extract_front(rows_by_label, final_labels, objectives, slo):
    """The front over the final-rung ok rows, restricted to SLO-feasible
    points.  Never raises: an eliminated-everything sweep records
    ``front_reason`` instead (the ExploreError message), because an
    empty front is a sweep *finding* the report must render."""
    candidates = [rows_by_label[lab] for lab in final_labels
                  if rows_by_label.get(lab, {}).get("status") == "ok"]
    if not candidates:
        n = len(rows_by_label)
        reasons = sorted({r.get("reason", r["status"])
                          for r in rows_by_label.values()
                          if r["status"] != "ok"})
        return [], (f"0 of {n} points reached measurement"
                    + (f": {'; '.join(reasons)[:400]}" if reasons else ""))
    try:
        front = constrained_pareto_front(
            candidates, objectives, constraint=slo,
            key=lambda r: r["metrics"])
    except ExploreError as e:
        return [], str(e)
    return [r["label"] for r in front], None
