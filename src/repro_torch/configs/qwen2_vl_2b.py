"""Qwen2-VL-2B — LM backbone with M-RoPE; vision frontend is a stub
(input_specs supplies precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, head_dim=128,
    d_ff=8960, vocab_size=151936,
    act="silu", mlp_type="swiglu", tie_embeddings=True,
    attn=AttnConfig(rope_theta=1e6, mrope_sections=(16, 24, 24), qkv_bias=True),
    embed_inputs=False,
    notes="M-RoPE (temporal/height/width rotary sections); dynamic-resolution "
          "ViT frontend stubbed per task spec. 12 heads over 16-way TP relies "
          "on GSPMD padding (DESIGN.md §5).",
)
