"""Gemma2-27B. [arXiv:2408.00118]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b", family="dense",
    n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    norm="gemma_rmsnorm", post_norms=True, act="gelu_tanh", mlp_type="geglu",
    tie_embeddings=True, final_softcap=30.0,
    attn=AttnConfig(rope_theta=10000.0, alt_window=4096, attn_softcap=50.0,
                    query_scale=(4608 / 32) ** -0.5),
    notes="query_pre_attn_scalar = d_model/n_heads = 144 (27B-specific).",
)
