"""Mixtral 8x7B: 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    act="silu", mlp_type="swiglu",
    attn=AttnConfig(rope_theta=1e6, window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff=14336),
    notes="SWA bounds the KV cache to 4096 => long_500k decode runs with a "
          "ring-buffer cache (DESIGN.md §4). TP-MoE (8 experts !% 16 shards: "
          "experts replicated, expert-ff TP-sharded).",
)
