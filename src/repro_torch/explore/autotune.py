"""``autotune`` — from a search space to the best deployable session.

The paper's workflow, automated: sweep the parameterised design, keep the
points that satisfy the deployment constraints (a power envelope, a
real-time samples/s floor, an accuracy budget — and, serving-aware, an
SLO like "p99 <= 5 ms" measured under a real ``ServingScenario``), and
return the ``Accelerator`` session for the point that maximises the
objective among the Pareto-optimal survivors.  The returned session is
rebuilt and quantised — ready for ``infer``/``serve`` — and carries the
sweep evidence in ``session.autotune_summary`` (for scenario searches:
the serving operating point and the full halving rung-promotion trace).

Counterpart of ``repro/explore/autotune.py``: sessions are built on
``device=`` (``build``'s default: the card, raising without one), and a
stored payload of either package is read the same way.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np

from repro_torch.api import Accelerator, build, resolve_device
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.explore.measure import (METRIC_KEYS, sweep,
                                         validate_metric_names)
from repro_torch.explore.pareto import (DEFAULT_OBJECTIVES, ExploreError,
                                        pareto_indices)
from repro_torch.explore.serving_objective import (SERVING_METRIC_KEYS,
                                                   SERVING_MINIMISE,
                                                   ServingScenario,
                                                   parse_constraint)
from repro_torch.explore.space import (SearchSpace, paper_space,
                                       point_from_config)

# Senses for objectives/constraints whose "better" direction isn't "bigger".
_MINIMISE = ("int_float_mse", "int_float_max_abs", "total_w", "dynamic_w",
             "energy_j_per_wave", "us_per_wave", "weight_bytes")

Constraint = Union[Tuple[Optional[float], Optional[float]], Callable]


def _satisfies(metrics: Mapping, constraints: Mapping[str, Constraint]) -> bool:
    for name, c in constraints.items():
        if callable(c):
            if not c(metrics):
                return False
            continue
        lo, hi = c
        v = float(metrics[name])
        if lo is not None and v < lo:
            return False
        if hi is not None and v > hi:
            return False
    return True


def autotune(model: Optional[QLSTMConfig] = None,
             space: Optional[SearchSpace] = None, *,
             accel: Optional[AcceleratorConfig] = None,
             objective: Optional[str] = None,
             constraints: Optional[Mapping[str, Constraint]] = None,
             constraint=None,
             scenario: Optional[ServingScenario] = None,
             strategy: Optional[str] = None, eta: int = 2,
             rungs: Optional[int] = None,
             mode: str = "grid", n: Optional[int] = None, seed: int = 0,
             iters: int = 20, eval_x: Optional[np.ndarray] = None,
             payload: Optional[Dict] = None,
             log: Optional[Callable[[str], None]] = None,
             device=None) -> Accelerator:
    """Search ``space`` and return the best buildable session.

    ``objective`` is a sweep metric name (maximised, unless it is a
    cost-like metric); the default is ``gops_per_watt`` offline and
    ``samples_per_s`` for scenario searches.  ``constraints`` maps metric
    names to ``(min, max)`` bounds (``None`` = unbounded) or to a predicate
    over the metrics dict, e.g.::

        autotune(cfg, space,
                 objective="gops_per_watt",
                 constraints={"total_w": (None, 61.0),        # power cap
                              "samples_per_s": (30_000, None)})  # real-time

    Serving-aware search adds ``scenario`` (a
    :class:`~repro_torch.explore.serving_objective.ServingScenario` — each point
    is scored by a real short ``StreamServer``/``ClusterServer`` run at
    that operating point) and ``constraint``, an SLO string like
    ``"p99_ms<=5"`` — the constrained objective "max samples/s s.t.
    p99 <= 5 ms".  With a scenario the sweep defaults to
    ``strategy="halving"`` (seeded successive halving; ``eta``/``rungs``
    tune the schedule) and ``session.autotune_summary`` records the
    serving ``operating_point`` plus the full ``halving`` rung-promotion
    trace — deterministic given ``seed``.

    The winner is chosen on the Pareto front *of the feasible points* (the
    front is recomputed after filtering, so a constraint that excludes the
    unconstrained front still yields the constrained optimum).  Raises
    :class:`~repro_torch.explore.pareto.ExploreError` (a ``ValueError``) naming
    the eliminating constraint when no evaluated point is feasible.

    ``model``/``accel`` carry the non-swept base configuration, exactly as
    they do for :func:`repro_torch.explore.sweep`.

    ``payload`` reuses an existing sweep result (the dict from
    :func:`repro_torch.explore.sweep`, or a loaded ``BENCH_pareto.json``) instead
    of re-measuring; the winning session is rebuilt from the recorded point
    config *with the payload's recorded init seed*, so the deployed weights
    are the ones the stored metrics (and the constraint selection) actually
    describe.  ``model``/``accel`` must then match the sweep's bases.

    Every session (the sweep's and the winner's) is built on ``device``
    (``build``'s default: the card; with no card and no ``device``,
    ``autotune`` raises before it sweeps)."""
    device = resolve_device(device)
    constraints = dict(constraints or {})
    serving = scenario is not None or (payload is not None
                                       and payload.get("scenario"))
    vocab = SERVING_METRIC_KEYS if serving else METRIC_KEYS
    if objective is None:
        objective = "samples_per_s" if serving else "gops_per_watt"
    validate_metric_names([objective], "objective", vocab)
    validate_metric_names([k for k, c in constraints.items()
                           if not callable(c)], "constraint", vocab)
    slo = parse_constraint(constraint)
    if slo is not None and not serving:
        raise ValueError("an SLO constraint needs a scenario (or a stored "
                         "scenario-sweep payload) to measure it under")
    minimise = SERVING_MINIMISE if serving else _MINIMISE
    sense = "min" if objective in minimise else "max"
    objectives = dict({} if serving else DEFAULT_OBJECTIVES)
    objectives[objective] = sense
    if serving:
        objectives.setdefault("p99_ms", "min")

    if payload is None:
        space = space or paper_space()
        strategy = strategy or ("halving" if scenario is not None
                                else "full")
        payload = sweep(space, model, accel, mode=mode, n=n, seed=seed,
                        iters=iters, eval_x=eval_x, objectives=objectives,
                        scenario=scenario, constraint=slo,
                        strategy=strategy, objective=objective, eta=eta,
                        rungs=rungs, log=log, device=device)
    if slo is None and payload.get("constraint"):
        slo = parse_constraint(payload["constraint"])

    ok = [r for r in payload["points"] if r["status"] == "ok"]
    # Scenario sweeps only compare points at their FINAL operating point:
    # earlier-rung metrics were measured on a truncated scenario and are
    # not commensurable with full-scenario ones.
    if serving:
        candidates = [r for r in ok
                      if (r.get("operating_point") or {}).get("final")]
    else:
        candidates = ok
    feasible = [r for r in candidates
                if _satisfies(r["metrics"], constraints)
                and (slo is None or slo.ok(r["metrics"]))]
    if not feasible:
        named = slo.describe() if slo is not None else repr(constraints)
        closest = ""
        if slo is not None and candidates:
            worst = min(candidates,
                        key=lambda r: slo.violation(r["metrics"]))
            closest = (f" (closest: {worst['label']} misses it by "
                       f"{slo.violation(worst['metrics']):.4g})")
        raise ExploreError(
            f"no feasible point: constraint {named} eliminated all "
            f"{len(candidates)} candidate(s) of {len(ok)} evaluated"
            f"{closest}")

    front_idx = pareto_indices(feasible, objectives,
                               key=lambda r: r["metrics"])
    front = [feasible[i] for i in front_idx]
    signed = ((lambda v: -v) if sense == "min" else (lambda v: v))
    best = max(front, key=lambda r: signed(float(r["metrics"][objective])))

    model_cfg, accel_cfg = point_from_config(best["config"]).configs(model,
                                                                     accel)
    # A stored payload was measured with ITS seed; rebuilding with any other
    # would deploy weights the selected metrics never described.
    session = build(model_cfg, accel_cfg, seed=payload.get("seed", seed),
                    device=device).quantize()
    session.autotune_summary = {
        "objective": objective,
        "sense": sense,
        "constraints": {k: (repr(c) if callable(c) else list(c))
                        for k, c in constraints.items()},
        "constraint": slo.describe() if slo is not None else None,
        "scenario": payload.get("scenario"),
        "strategy": payload.get("strategy", "full"),
        "operating_point": best.get("operating_point"),
        "halving": payload.get("halving"),
        "best": best,
        "front": [r["label"] for r in front],
        "n_evaluated": len(ok),
        "n_feasible": len(feasible),
        "sweep": payload,
    }
    if log:
        log(f"[autotune] best={best['label']} "
            f"{objective}={best['metrics'][objective]:.4g} "
            f"({len(front)} on the feasible front, "
            f"{len(feasible)}/{len(ok)} feasible)")
    return session
