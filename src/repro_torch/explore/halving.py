"""Seeded successive halving over a candidate set (a copy of
``repro/explore/halving.py``, which is pure Python).

Pure algorithm, no server: ``measure(item, rung, fraction)`` is injected,
so the deterministic battery in ``tests/test_torch_halving.py`` drives it with
synthetic measurement tables and the sweep drives it with real
``ServingScenario`` runs.  Rung 0 measures every candidate on the cheapest
truncated scenario; each rung promotes the top ``1/eta`` on the constrained
objective to a longer scenario; the final rung runs the full scenario
(fraction 1.0).  Every decision — ranking, tie-breaking, promotion — is a
deterministic function of the measurements, and the measurements are a
deterministic function of the caller's seed, so two identical runs produce
identical rung-promotion traces.

Ranking under a constraint: feasible candidates sort by the signed
objective, every infeasible candidate sorts BELOW every feasible one,
ordered by constraint-violation magnitude (so an all-infeasible rung still
promotes the least-violating survivors and terminates).  Ties break by
input index — stable and seed-independent.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.explore.pareto import ExploreError

__all__ = ["rung_schedule", "successive_halving"]


def rung_schedule(n: int, eta: int = 2, rungs: Optional[int] = None
                  ) -> Tuple[List[int], List[float]]:
    """The halving plan for ``n`` candidates: per-rung survivor counts and
    scenario fractions.

    Survivor counts follow ``n_{r+1} = max(1, ceil(n_r / eta))``; with
    ``rungs=None`` the schedule runs until a single survivor remains.
    Fractions are geometric, ``eta**(r - (rungs-1))``, so the final rung is
    always the full scenario (fraction 1.0).  The analytic measurement
    budget is ``sum(sizes)`` — every survivor is measured once per rung."""
    if n < 1:
        raise ExploreError("successive halving over an empty candidate set "
                           "(0 points survived pruning)")
    if eta < 2:
        raise ValueError(f"eta must be >= 2, got {eta}")
    if rungs is None:
        rungs, size = 1, n
        while size > 1:
            size = max(1, math.ceil(size / eta))
            rungs += 1
    if rungs < 1:
        raise ValueError(f"rungs must be >= 1, got {rungs}")
    sizes = [n]
    for _ in range(1, rungs):
        sizes.append(max(1, math.ceil(sizes[-1] / eta)))
    fractions = [float(eta) ** (r - (rungs - 1)) for r in range(rungs)]
    return sizes, fractions


def successive_halving(items: Sequence, measure: Callable, *,
                       objective: str, sense: str = "max",
                       eta: int = 2, rungs: Optional[int] = None,
                       constraint=None, labels: Optional[Sequence[str]] = None,
                       log: Optional[Callable[[str], None]] = None) -> Dict:
    """Run the halving search and return the full decision trace.

    ``measure(item, rung, fraction)`` returns the item's metrics dict for
    that rung (``None`` = failed measurement, ranked as infinitely
    infeasible).  ``constraint`` is an SLO object (``ok(metrics)`` /
    ``violation(metrics)`` / ``describe()``, see
    ``serving_objective.parse_constraint``) or ``None``.

    Returns ``{"eta", "sizes", "fractions", "rungs": [{rung, fraction,
    measured, promoted}], "results": {index: last metrics}, "winner",
    "winner_label", "winner_feasible", "total_measurements",
    "budget_bound", "objective", "sense", "constraint"}`` — the trace the
    sweep payload records and the reproducibility tests compare."""
    if sense not in ("max", "min"):
        raise ValueError(f"sense must be 'max'|'min', got {sense!r}")
    sizes, fractions = rung_schedule(len(items), eta, rungs)
    labels = list(labels) if labels is not None \
        else [str(i) for i in range(len(items))]
    if len(labels) != len(items):
        raise ValueError(f"{len(labels)} labels for {len(items)} items")

    def rank_key(pair):
        idx, m = pair
        v = None if m is None else m.get(objective)
        finite = v is not None and math.isfinite(float(v))
        feasible = finite and (constraint is None or constraint.ok(m))
        if feasible:
            primary = -float(v) if sense == "max" else float(v)
            return (0, primary, idx)
        if constraint is not None and m is not None:
            return (1, constraint.violation(m), idx)
        return (1, float("inf"), idx)

    survivors = list(range(len(items)))
    results: Dict[int, Dict] = {}
    trace: List[Dict] = []
    total = 0
    ranked: List[Tuple[int, Optional[Dict]]] = []
    for r in range(len(sizes)):
        frac = fractions[r]
        scored = []
        for idx in survivors:
            m = measure(items[idx], r, frac)
            total += 1
            if m is not None:
                results[idx] = m
            scored.append((idx, m))
        ranked = sorted(scored, key=rank_key)
        rec = {"rung": r, "fraction": frac,
               "measured": [labels[i] for i, _ in scored],
               "ranking": [labels[i] for i, _ in ranked],
               "promoted": []}
        if r + 1 < len(sizes):
            survivors = [i for i, _ in ranked[:sizes[r + 1]]]
            rec["promoted"] = [labels[i] for i in survivors]
        trace.append(rec)
        if log:
            log(f"[halving r{r}] fraction={frac:g} measured={len(scored)} "
                f"promoted={len(rec['promoted'])}")

    winner_idx, winner_m = ranked[0]
    feasible = (winner_m is not None
                and winner_m.get(objective) is not None
                and math.isfinite(float(winner_m[objective]))
                and (constraint is None or constraint.ok(winner_m)))
    return {
        "eta": eta,
        "sizes": sizes,
        "fractions": fractions,
        "rungs": trace,
        "results": results,
        "winner": winner_idx,
        "winner_label": labels[winner_idx],
        "winner_feasible": feasible,
        "total_measurements": total,
        "budget_bound": sum(sizes),
        "objective": objective,
        "sense": sense,
        "constraint": constraint.describe() if constraint is not None
        else None,
    }
