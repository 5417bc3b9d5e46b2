"""RWKV-6 'Finch' 7B: attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64, head_dim=64,
    d_ff=14336, vocab_size=65536,
    norm="layernorm",
    rwkv=RWKVConfig(head_dim=64, lora_r=64, lora_w=128, chunk=128),
    notes="Chunked block-parallel WKV for train/prefill (C3 philosophy: keep "
          "the MXU busy); sequential O(1)-state recurrence for decode. "
          "long_500k runs (state-based).",
)
