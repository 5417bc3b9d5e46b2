"""Qwen1.5-0.5B: QKV bias, tied embeddings. [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
    d_ff=2816, vocab_size=151936,
    act="silu", mlp_type="swiglu", tie_embeddings=True,
    attn=AttnConfig(rope_theta=1e6, qkv_bias=True),
)
