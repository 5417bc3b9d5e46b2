"""Gemma2-2B: local/global alternating attention, logit softcaps, GeGLU,
pre+post sublayer norms. [arXiv:2408.00118]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="dense",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    norm="gemma_rmsnorm", post_norms=True, act="gelu_tanh", mlp_type="geglu",
    tie_embeddings=True, final_softcap=30.0,
    attn=AttnConfig(rope_theta=10000.0, alt_window=4096, attn_softcap=50.0),
    notes="Even layers local (4096), odd global; attn softcap 50, final 30. "
          "hard_acts=True turns softcaps into clips (C2 beyond-paper).",
)
