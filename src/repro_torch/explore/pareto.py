"""Pareto-dominance and front extraction over sweep metrics (a copy of
``repro/explore/pareto.py``, which is pure Python).

Objectives are a mapping ``{metric_name: "max" | "min"}`` — the paper's
pair is ``{"throughput_gops": "max", "gops_per_watt": "max"}``; adding
``{"int_float_mse": "min"}`` gives the 3-objective accuracy-aware front.
Points are plain mappings (metric name -> value), or arbitrary items with a
``key=`` extractor.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Mapping, Optional, Sequence

# The paper scores a configuration by throughput and energy efficiency
# (GOP/s and GOP/s/W, Table 4).
DEFAULT_OBJECTIVES: Dict[str, str] = {
    "throughput_gops": "max",
    "gops_per_watt": "max",
}

_SENSES = ("max", "min")


class ExploreError(ValueError):
    """A search step that has nothing left to offer — a front asked of 0
    measurements, a sweep whose every point was eliminated, an SLO no
    candidate satisfies.  The message names what eliminated everything, so
    ``report --pareto`` renders the reason instead of a bare header.
    Subclasses ``ValueError`` so pre-existing ``except ValueError``
    call sites keep working."""


def _signed(value: float, sense: str) -> float:
    if sense not in _SENSES:
        raise ValueError(f"objective sense must be 'max'|'min', got {sense!r}")
    return value if sense == "max" else -value


def _metric(m: Mapping, name: str) -> float:
    try:
        return float(m[name])
    except KeyError:
        raise ExploreError(
            f"point carries no metric {name!r} (has: {sorted(m)}) — "
            f"was it measured? 0-measurement rows cannot enter a front"
        ) from None


def dominates(a: Mapping, b: Mapping,
              objectives: Optional[Mapping[str, str]] = None) -> bool:
    """True iff ``a`` is at least as good as ``b`` on every objective and
    strictly better on at least one.  Identical points never dominate each
    other (both stay on the front).  A point missing an objective metric
    raises :class:`ExploreError` naming the metric."""
    objectives = objectives or DEFAULT_OBJECTIVES
    strictly_better = False
    for name, sense in objectives.items():
        av = _signed(_metric(a, name), sense)
        bv = _signed(_metric(b, name), sense)
        if av < bv:
            return False
        if av > bv:
            strictly_better = True
    return strictly_better


def _finite(m: Mapping, objectives: Mapping[str, str]) -> bool:
    return all(math.isfinite(_metric(m, name)) for name in objectives)


def pareto_indices(items: Sequence,
                   objectives: Optional[Mapping[str, str]] = None,
                   key: Optional[Callable] = None) -> List[int]:
    """Indices of the non-dominated items, in input order.

    Items with a non-finite (NaN/inf) objective value are excluded — a
    failed measurement must not survive as "incomparable, therefore
    optimal".  An EMPTY front is never returned silently: 0 items, or a
    set whose every item was excluded, raises :class:`ExploreError`
    naming what eliminated everything.  O(n^2); sweeps are hundreds of
    points, not millions."""
    objectives = objectives or DEFAULT_OBJECTIVES
    if not items:
        raise ExploreError(
            "no points to extract a Pareto front from (0 measurements — "
            "did every sweep point fail or get pruned?)")
    key = key or (lambda it: it)
    metrics = [key(it) for it in items]
    valid = [i for i, m in enumerate(metrics) if _finite(m, objectives)]
    if not valid:
        raise ExploreError(
            f"all {len(items)} points were eliminated: non-finite values "
            f"for objectives {sorted(objectives)} — every measurement "
            f"failed")
    return [i for i in valid
            if not any(dominates(metrics[j], metrics[i], objectives)
                       for j in valid if j != i)]


def pareto_front(items: Sequence,
                 objectives: Optional[Mapping[str, str]] = None,
                 key: Optional[Callable] = None) -> List:
    """The non-dominated items themselves (see :func:`pareto_indices`)."""
    return [items[i] for i in pareto_indices(items, objectives, key)]


def constrained_pareto_front(items: Sequence,
                             objectives: Optional[Mapping[str, str]] = None,
                             *, constraint=None,
                             key: Optional[Callable] = None) -> List:
    """The Pareto front restricted to constraint-feasible items.

    ``constraint`` is an SLO object (``ok(metrics)`` / ``violation`` /
    ``describe()``; see ``serving_objective.parse_constraint``) or
    ``None`` (plain front).  When the input is non-empty but the
    constraint eliminates every item, raises :class:`ExploreError` naming
    the constraint and the closest miss — a front that silently dropped
    the SLO would deploy a violating point."""
    if constraint is None:
        return pareto_front(items, objectives, key)
    key = key or (lambda it: it)
    feasible = [it for it in items if constraint.ok(key(it))]
    if items and not feasible:
        closest = min(items, key=lambda it: constraint.violation(key(it)))
        raise ExploreError(
            f"constraint {constraint.describe()!r} eliminated all "
            f"{len(items)} measured points (closest miss violates it by "
            f"{constraint.violation(key(closest)):.4g})")
    return pareto_front(feasible, objectives, key)
