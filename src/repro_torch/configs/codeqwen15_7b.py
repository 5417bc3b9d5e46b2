"""CodeQwen1.5-7B (qwen1.5 arch, MHA). [hf:Qwen/CodeQwen1.5-7B]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
    d_ff=13440, vocab_size=92416,
    act="silu", mlp_type="swiglu",
    attn=AttnConfig(rope_theta=1e6, qkv_bias=True),
)
