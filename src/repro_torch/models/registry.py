"""--arch registry: name -> (ModelConfig | QLSTMConfig) — counterpart of
``repro/models/registry.py``."""
from __future__ import annotations

from repro_torch.configs import ARCH_CONFIGS


def get_config(name: str):
    if name not in ARCH_CONFIGS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCH_CONFIGS)}")
    return ARCH_CONFIGS[name]


def list_archs():
    return sorted(ARCH_CONFIGS)
