"""--arch registry — counterpart of ``repro/models/registry.py``, over the
port's ``ARCH_CONFIGS`` (the architectures whose family it runs)."""
from __future__ import annotations

from repro_torch.configs import ARCH_CONFIGS
from repro_torch.configs.base import ModelConfig


def get_config(name: str) -> ModelConfig:
    """The ported config of ``name``; a ``KeyError`` says whether the
    reference has it but the port does not run it yet."""
    return ARCH_CONFIGS[name]


def list_archs():
    return sorted(ARCH_CONFIGS)
