"""Placement helpers — counterpart of ``repro/sharding``.  Only
``pin_to_device`` (the serving cluster's per-replica placement) is
ported; the LM side's logical-axis rules wait for the sharded LM."""

from repro_torch.sharding.partition import pin_to_device  # noqa: F401

__all__ = ["pin_to_device"]
