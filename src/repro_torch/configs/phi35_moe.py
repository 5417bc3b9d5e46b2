"""Phi-3.5-MoE (42B total / 6.6B active): 16 experts, top-2.
[hf:microsoft/Phi-3.5-MoE-instruct]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab_size=32064,
    act="silu", mlp_type="swiglu",
    attn=AttnConfig(rope_theta=10000.0),
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=6400, expert_parallel=True),
    sharding_overrides=(("experts", "model"), ("expert_mlp", None)),
    notes="16 experts / 16-way TP => true expert parallelism (1 expert per "
          "model shard); router kept fp32/softmax-exact.",
)
