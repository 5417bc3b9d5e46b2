"""Design-space exploration over the parameterised accelerator —
counterpart of ``repro/explore``, on the port's sessions.

The paper's claim is not one good configuration but a *parameterised
design*: Table-2 meta-parameters span a space of accelerators, each scored
by throughput (GOP/s), energy efficiency (GOP/s/W) and accuracy.  This
package makes that claim executable — offline and at a serving operating
point — on the CUDA card (every entry point takes ``device=``; the default
is the card, and with no card the call raises):

    from repro_torch import explore

    space = explore.paper_space()            # Table-4 axes as a SearchSpace
    result = explore.sweep(space, iters=5)   # build+measure every point
    front = [p for p in result["points"] if p["pareto"]]

    session = explore.autotune(              # best deployable session
        objective="gops_per_watt",
        constraints={"samples_per_s": (30_000, None)})

    scenario = explore.ServingScenario(streams=8, deadline_ms=5.0)
    session = explore.autotune(              # serving-aware: SLO-constrained
        objective="samples_per_s",           # successive halving over real
        constraint="p99_ms<=5",              # StreamServer runs
        space=space, scenario=scenario)

Layout (module for module the reference's):

  * ``space``       — :class:`SearchSpace` / :class:`Point` over the
                      Table-2 axes plus the serving deployment axes.
  * ``constraints`` — composable validity rules pruning structurally
                      infeasible points before measurement.
  * ``measure``     — :func:`evaluate_point` / :func:`sweep`: build each
                      point through ``repro_torch.build``; offline timed
                      loops or real ``ServingScenario`` runs per point.
  * ``serving_objective`` — :class:`ServingScenario`, SLO strings,
                      :func:`serving_plan`.
  * ``halving``     — :func:`successive_halving` (pure Python).
  * ``pareto``      — dominance and fronts (pure Python).
  * ``autotune``    — :func:`autotune`: constrained argmax on the feasible
                      Pareto front, returning a quantised ``Accelerator``.

``repro_torch.analysis.report --pareto`` renders a sweep payload as a
markdown table.
"""

from repro_torch.explore.autotune import autotune  # noqa: F401
from repro_torch.explore.constraints import (  # noqa: F401
    AllOf, AnyOf, ConstraintNode, InfeasiblePoint, Not, Rule,
    backend_supported, default_constraints, device_residency_needs_fused,
    replicas_fit_devices)
from repro_torch.explore.halving import (  # noqa: F401
    rung_schedule, successive_halving)
from repro_torch.explore.measure import (  # noqa: F401
    METRIC_KEYS, SCHEMA_VERSION, SERVING_OBJECTIVES, evaluate_point, sweep)
from repro_torch.explore.pareto import (  # noqa: F401
    DEFAULT_OBJECTIVES, ExploreError, constrained_pareto_front, dominates,
    pareto_front, pareto_indices)
from repro_torch.explore.serving_objective import (  # noqa: F401
    SERVING_METRIC_KEYS, SERVING_MINIMISE, SLO, SLOSet, ServingScenario,
    evaluate_serving_point, parse_constraint, serving_plan)
from repro_torch.explore.space import (  # noqa: F401
    AXES, Point, SearchSpace, paper_space, point_from_config, smoke_space)

__all__ = [
    "AXES", "AllOf", "AnyOf", "ConstraintNode", "DEFAULT_OBJECTIVES",
    "ExploreError", "InfeasiblePoint", "METRIC_KEYS", "Not", "Point",
    "Rule", "SCHEMA_VERSION", "SERVING_METRIC_KEYS", "SERVING_MINIMISE",
    "SERVING_OBJECTIVES", "SLO", "SLOSet", "SearchSpace", "ServingScenario",
    "autotune", "backend_supported", "constrained_pareto_front",
    "default_constraints", "device_residency_needs_fused", "dominates",
    "evaluate_point", "evaluate_serving_point", "paper_space",
    "pareto_front", "pareto_indices", "parse_constraint",
    "point_from_config", "replicas_fit_devices", "rung_schedule",
    "serving_plan", "smoke_space", "successive_halving", "sweep",
]
