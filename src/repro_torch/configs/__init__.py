"""--arch config registry + reduced (smoke-test) config derivation —
counterpart of ``repro/configs/__init__.py``: the same eleven
architectures under the same names.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import (AttnConfig, ModelConfig, MoEConfig,  # noqa: F401
                                      RecurrentConfig, RWKVConfig, ShapeSpec,
                                      SHAPES)
from repro_torch.configs.codeqwen15_7b import CONFIG as _codeqwen
from repro_torch.configs.gemma2_27b import CONFIG as _gemma27
from repro_torch.configs.gemma2_2b import CONFIG as _gemma2
from repro_torch.configs.lstm_pems import CONFIG as _lstm
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.phi35_moe import CONFIG as _phi
from repro_torch.configs.qwen15_05b import CONFIG as _qwen05
from repro_torch.configs.qwen2_vl_2b import CONFIG as _qwenvl
from repro_torch.configs.recurrentgemma_2b import CONFIG as _rg
from repro_torch.configs.rwkv6_7b import CONFIG as _rwkv

ARCH_CONFIGS = {
    "qwen2-vl-2b": _qwenvl,
    "phi3.5-moe": _phi,
    "mixtral-8x7b": _mixtral,
    "musicgen-medium": _musicgen,
    "gemma2-2b": _gemma2,
    "gemma2-27b": _gemma27,
    "qwen1.5-0.5b": _qwen05,
    "codeqwen1.5-7b": _codeqwen,
    "recurrentgemma-2b": _rg,
    "rwkv6-7b": _rwkv,
    "lstm-pems": _lstm,
}

ASSIGNED_ARCHS = [k for k in ARCH_CONFIGS if k != "lstm-pems"]


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
