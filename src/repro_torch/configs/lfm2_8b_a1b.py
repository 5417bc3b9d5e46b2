"""LFM2-8B-A1B (Liquid AI): 24 layers, 18 gated short-conv blocks (3 taps,
no bias) and 6 GQA blocks (32 q / 8 KV heads, per-head RMSNorm on q and
k), layers 0-1 a dense SwiGLU of 7168, layers 2-23 a sigmoid-routed MoE
of 32 experts of 1792, top 4, with a selection-only expert bias (routed
scale 1); tied embeddings.  The port's own architecture: the JAX package has none.
[https://huggingface.co/LiquidAI/LFM2-8B-A1B/blob/main/config.json]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

_ATTN = (2, 6, 10, 14, 18, 21)

CONFIG = ModelConfig(
    name="lfm2-8b-a1b", family="moe",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
    d_ff=7168, vocab_size=65536,
    act="silu", mlp_type="swiglu", tie_embeddings=True,
    attn=AttnConfig(rope_theta=1e6, qk_norm=True),
    moe=MoEConfig(num_experts=32, top_k=4, d_ff=1792, router="sigmoid"),
    layer_types=tuple("attn" if i in _ATTN else "conv" for i in range(24)),
    num_dense_layers=2, conv_width=3, norm_eps=1e-5,
    notes="Tied head: the published 8.3B total / 1.5B active counts hold "
          "only with it (8.34B with the head tied, 1.56B active). bf16.",
)
