"""Placement — counterpart of ``repro/sharding``: the LM side's
logical-axis rules on a ``DeviceMesh`` (``DTensor`` placements, the
context-scoped ``constrain``) and the serving cluster's per-replica
placement."""

from repro_torch.sharding.partition import (  # noqa: F401
    DEFAULT_RULES, PRODUCTION_TP, ParamSharding, constrain, distribute,
    logical_to_spec, param_shardings, pin_to_device, place,
    replica_shardings, resolve_rules, rules_context, spec_to_placements)

__all__ = ["DEFAULT_RULES", "PRODUCTION_TP", "ParamSharding", "constrain",
           "distribute", "logical_to_spec", "param_shardings",
           "pin_to_device", "place", "replica_shardings", "resolve_rules",
           "rules_context", "spec_to_placements"]
