"""--arch config registry + reduced (smoke-test) config derivation —
counterpart of ``repro/configs/__init__.py``.

``ARCH_CONFIGS`` holds only the architectures whose family the port runs
(the hybrid RecurrentGemma family); asking it for any other of the
reference's architectures raises a ``KeyError`` that says so.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,  # noqa: F401
                                      RecurrentConfig, RWKVConfig, ShapeSpec,
                                      SHAPES)
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg

# The reference's architectures that the port does not run yet.
NOT_PORTED = ("qwen2-vl-2b", "phi3.5-moe", "mixtral-8x7b", "musicgen-medium",
              "gemma2-2b", "gemma2-27b", "qwen1.5-0.5b", "codeqwen1.5-7b",
              "rwkv6-7b", "lstm-pems")


class _ArchConfigs(dict):
    def __missing__(self, name):
        if name in NOT_PORTED:
            raise KeyError(f"arch {name!r} is not ported yet to repro_torch "
                           f"(see ROADMAP.md); ported: {sorted(self)}")
        raise KeyError(f"unknown arch {name!r}; ported: {sorted(self)}")


ARCH_CONFIGS = _ArchConfigs({"recurrentgemma-2b": _rg})


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Shrink a full config to a CPU-smoke-testable one of the SAME family:
    few layers (>= one full block pattern), narrow dims, tiny vocab, few
    experts."""
    kw = dict(
        n_layers=3 if cfg.family == "hybrid" else 2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=96,
        vocab_size=128,
        remat="none",
    )
    if cfg.family == "hybrid":
        kw["n_layers"] = 4  # one (rec,rec,attn) period + 1 tail rec
        kw["recurrent"] = dataclasses.replace(cfg.recurrent, lru_width=64)
        kw["attn"] = dataclasses.replace(cfg.attn, window=8)
    if cfg.rwkv is not None:
        kw["rwkv"] = dataclasses.replace(cfg.rwkv, head_dim=16, lora_r=8,
                                         lora_w=8, chunk=8)
        kw["n_heads"] = 4
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(cfg.moe, num_experts=4, top_k=2,
                                        d_ff=96)
    if cfg.attn is not None and "attn" not in kw:
        sec = (2, 3, 3) if cfg.attn.mrope_sections else None
        kw["attn"] = dataclasses.replace(
            cfg.attn, mrope_sections=sec,
            window=min(cfg.attn.window, 8) if cfg.attn.window else None,
            alt_window=8 if cfg.attn.alt_window else None)
    return cfg.replace(**kw)
