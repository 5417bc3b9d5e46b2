"""Declarative, composable validity constraints over search-space points.

The serving-aware search space (cells x backends x residency x replicas)
contains points that are *structurally* infeasible — device-resident state
on a cell with no fused kernel, more replicas than devices, an explicit
backend that refuses the configuration.  Measuring them would waste a
build + scenario run each, so the space prunes them up front.

The pruning rules are composed declaratively, node-style: every rule is a
:class:`ConstraintNode`; ``&`` / ``|`` / ``~`` build composite trees out of
leaves, exactly like an expression graph — a new axis ships its validity
rule as one more leaf ANDed into :func:`default_constraints` instead of a
branch inside the sweep loop.  A node's ``check(point, ...)`` returns
``None`` for a feasible point or a human-readable reason string (prefixed
with the violated rule's name, so the sweep can attribute eliminations per
rule).

The imperative twin of this module is
:func:`repro_torch.explore.serving_objective.serving_plan`, which *raises*
on the same points; ``tests/test_torch_explore.py`` holds the two in
agreement (prune/plan property test).

Counterpart of ``repro/explore/constraints.py`` on the port's
``backends``, ``plan`` and ``launch.mesh.serving_devices``.  The
replica rule counts devices of one type, ``kind`` (a session's
``device.type``: ``"cuda"`` counts cards, ``"cpu"`` the one CPU), so one
card, like one TPU chip, prunes every ``replicas > 1`` point.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple


class InfeasiblePoint(ValueError):
    """A search-space point that cannot be deployed as configured (the
    imperative form of a failed :class:`ConstraintNode` check)."""


@dataclasses.dataclass(frozen=True)
class ConstraintNode:
    """Base of the composable constraint tree.

    Subclasses implement :meth:`check`; composition is structural —
    ``a & b`` (both must hold), ``a | b`` (either suffices), ``~a``
    (must fail) — so a search space's validity predicate is data, not
    control flow."""

    def check(self, point, base_model=None, base_accel=None
              ) -> Optional[str]:
        """``None`` when ``point`` is feasible, else the reason."""
        raise NotImplementedError

    @property
    def name(self) -> str:
        """Short structural label used in composed reasons."""
        raise NotImplementedError

    def __and__(self, other: "ConstraintNode") -> "AllOf":
        return AllOf((self, other))

    def __or__(self, other: "ConstraintNode") -> "AnyOf":
        return AnyOf((self, other))

    def __invert__(self) -> "Not":
        return Not(self)


@dataclasses.dataclass(frozen=True)
class Rule(ConstraintNode):
    """A leaf: a named predicate over ``(point, base_model, base_accel)``
    returning ``None`` (feasible) or a reason fragment."""

    rule_name: str
    fn: Callable = dataclasses.field(compare=False)

    def check(self, point, base_model=None, base_accel=None
              ) -> Optional[str]:
        reason = self.fn(point, base_model, base_accel)
        return None if reason is None else f"{self.rule_name}: {reason}"

    @property
    def name(self) -> str:
        return self.rule_name


@dataclasses.dataclass(frozen=True)
class AllOf(ConstraintNode):
    """Conjunction: feasible iff every child is; reports the FIRST
    violated child's reason (children are checked in order, cheap rules
    first by construction)."""

    children: Tuple[ConstraintNode, ...]

    def check(self, point, base_model=None, base_accel=None
              ) -> Optional[str]:
        for child in self.children:
            reason = child.check(point, base_model, base_accel)
            if reason is not None:
                return reason
        return None

    @property
    def name(self) -> str:
        return "(" + " & ".join(c.name for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class AnyOf(ConstraintNode):
    """Disjunction: feasible iff at least one child is; reports every
    child's reason when all fail."""

    children: Tuple[ConstraintNode, ...]

    def check(self, point, base_model=None, base_accel=None
              ) -> Optional[str]:
        reasons = []
        for child in self.children:
            reason = child.check(point, base_model, base_accel)
            if reason is None:
                return None
            reasons.append(reason)
        return " | ".join(reasons)

    @property
    def name(self) -> str:
        return "(" + " | ".join(c.name for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Not(ConstraintNode):
    """Negation: feasible iff the child is NOT."""

    child: ConstraintNode

    def check(self, point, base_model=None, base_accel=None
              ) -> Optional[str]:
        reason = self.child.check(point, base_model, base_accel)
        if reason is None:
            return f"~{self.child.name}: point satisfies the negated rule"
        return None

    @property
    def name(self) -> str:
        return f"~{self.child.name}"


# -- the built-in leaves ------------------------------------------------------

def _backend_supported(point, base_model, base_accel) -> Optional[str]:
    if point.backend == "auto":
        return None         # auto always resolves to something runnable
    from repro_torch import backends
    model_cfg, accel_cfg = point.configs(base_model, base_accel)
    try:
        backends.select_stateful(model_cfg, accel_cfg)
    except backends.BackendUnsupported as e:
        return str(e)
    return None


def backend_supported() -> Rule:
    """An explicit (non-``auto``) backend must accept the configuration —
    the fused pallas engine refuses e.g. ``alu_mode='per_step'``."""
    return Rule("backend_supported", _backend_supported)


def _device_residency_fused(point, base_model, base_accel) -> Optional[str]:
    if point.state_residency != "device":
        return None
    from repro_torch.core.accelerator import plan
    model_cfg, accel_cfg = point.configs(base_model, base_accel)
    pl = plan(model_cfg, accel_cfg)
    if pl["state_residency"] != "device":
        return (f"device-resident carry needs the fused stateful plan; "
                f"cell={point.cell!r} on backend={point.backend!r} resolves "
                f"to stateful_backend={pl['stateful_backend']!r} (host "
                f"residency)")
    return None


def device_residency_needs_fused() -> Rule:
    """``state_residency='device'`` is only a deployable operating point
    where the plan itself resolves device residency (the fused pallas
    stateful path); pinning it elsewhere measures an adapter degradation,
    not a design point."""
    return Rule("device_residency", _device_residency_fused)


def _replicas_fit(point, base_model, base_accel, *,
                  kind: Optional[str] = None) -> Optional[str]:
    if point.replicas <= 1:
        return None
    from repro_torch.launch.mesh import serving_devices
    try:
        serving_devices(point.replicas, oversubscribe=False, kind=kind)
    except (RuntimeError, ValueError) as e:
        return str(e)
    return None


def replicas_fit_devices(kind: Optional[str] = None) -> Rule:
    """An ``n``-replica point needs ``n`` distinct devices of type ``kind``
    (the production posture of ``launch.mesh.serving_devices``; ``None``
    counts the cards, and with none visible the rule fails with that
    reason: nothing counts the CPU unasked) — a replica that
    silently shares a device is a capacity-planning bug, not a
    candidate."""
    return Rule("replicas_fit_devices",
                functools.partial(_replicas_fit, kind=kind))


def default_constraints(kind: Optional[str] = None) -> ConstraintNode:
    """The composite every :class:`~repro_torch.explore.space.SearchSpace`
    applies unless it carries its own tree: backend feasibility AND
    fused-plan device residency AND replica/device fit (on devices of
    type ``kind``)."""
    return (backend_supported()
            & device_residency_needs_fused()
            & replicas_fit_devices(kind))
