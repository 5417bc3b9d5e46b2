"""Model / shape configuration schema — counterpart of
``repro/configs/base.py``.

One ``ModelConfig`` describes any of the reference's architectures; one
``ShapeSpec`` describes one input-shape cell; ``batch_axes`` names a
batch's logical axes for the sharding rules.  The reference's
``input_specs`` and ``shape_applicable`` (the dry run's inputs) are not
ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.core.quant import NO_QUANT, QuantConfig


# ---------------------------------------------------------------------------
# Sub-configs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnConfig:
    rope_theta: float = 10000.0
    mrope_sections: Optional[Tuple[int, ...]] = None  # qwen2-vl M-RoPE
    qkv_bias: bool = False                            # qwen1.5 family
    window: Optional[int] = None                      # uniform SWA (mixtral)
    alt_window: Optional[int] = None                  # gemma2: even layers local
    attn_softcap: Optional[float] = None              # gemma2: 50.0
    query_scale: Optional[float] = None               # gemma2-27b override
    sinusoidal: bool = False                          # musicgen positions


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    expert_parallel: bool = False


@dataclasses.dataclass(frozen=True)
class RecurrentConfig:  # RecurrentGemma / Griffin
    lru_width: int
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("rec", "rec", "attn")
    c_exponent: float = 8.0


@dataclasses.dataclass(frozen=True)
class RWKVConfig:  # RWKV-6 "Finch"
    head_dim: int = 64
    lora_r: int = 64
    lora_w: int = 128
    chunk: int = 128


# ---------------------------------------------------------------------------
# ModelConfig
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | vlm | audio | hybrid | ssm | lstm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    norm: str = "rmsnorm"        # rmsnorm | layernorm | gemma_rmsnorm
    post_norms: bool = False
    act: str = "silu"
    mlp_type: str = "swiglu"     # swiglu | geglu | mlp
    tie_embeddings: bool = False
    final_softcap: Optional[float] = None
    attn: Optional[AttnConfig] = None
    moe: Optional[MoEConfig] = None
    recurrent: Optional[RecurrentConfig] = None
    rwkv: Optional[RWKVConfig] = None
    embed_inputs: bool = True
    quant: QuantConfig = NO_QUANT
    hard_acts: bool = False      # C2: swap soft nonlinearities for hard ones
    dtype: str = "bfloat16"      # activations; master params are float32
    remat: str = "full"          # full: training checkpoints each layer (period); none
    sharding_overrides: Tuple[Tuple[str, Optional[str]], ...] = ()
    notes: str = ""

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def uniform_window(self) -> Optional[int]:
        return self.attn.window if (self.attn and self.attn.window) else None

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kinds(self) -> Tuple[str, ...]:
        """Per-layer block kind (attention/recurrent), resolved from family."""
        if self.family == "ssm":
            return ("rwkv",) * self.n_layers
        if self.family == "hybrid":
            pat = self.recurrent.block_pattern
            return tuple(pat[i % len(pat)] for i in range(self.n_layers))
        return ("attn",) * self.n_layers

    def layer_windows(self, seq_len: int) -> Tuple[int, ...]:
        """Effective attention window per attention layer.  A window >=
        seq_len means global."""
        out = []
        a = self.attn
        for i, kind in enumerate(self.layer_kinds()):
            if kind != "attn":
                continue
            if a and a.window:
                out.append(min(a.window, seq_len))
            elif a and a.alt_window and i % 2 == 0:
                out.append(min(a.alt_window, seq_len))
            else:
                out.append(seq_len)
        return tuple(out)

    def subquadratic(self) -> bool:
        """True iff decoding at very long context needs only bounded state."""
        kinds = self.layer_kinds()
        if all(k in ("rwkv", "rec") for k in kinds):
            return True
        a = self.attn
        win = a.window or a.alt_window if a else None
        if self.family == "hybrid":
            return win is not None
        return a is not None and a.window is not None


# ---------------------------------------------------------------------------
# ShapeSpec — the input-shape cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256, microbatches=4),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def batch_axes():
    """Logical axes of a (batch, seq) input: the batch splits by the
    ``"batch"`` rule, the sequence stays whole."""
    return ("batch", None)  # (batch, seq)
