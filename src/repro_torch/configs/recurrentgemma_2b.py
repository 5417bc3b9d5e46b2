"""RecurrentGemma-2B (Griffin): RG-LRU + local attention, 1 attn : 2 rec.
[arXiv:2402.19427] — the reference's ``configs/recurrentgemma_2b.py``."""
from repro_torch.configs.base import AttnConfig, ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256000,
    norm="gemma_rmsnorm", act="gelu_tanh", mlp_type="geglu",
    tie_embeddings=True, final_softcap=30.0,
    attn=AttnConfig(rope_theta=10000.0, window=2048),
    recurrent=RecurrentConfig(lru_width=2560, conv_width=4,
                              block_pattern=("rec", "rec", "attn")),
    notes="26 layers = 8 x (rec,rec,attn) + 2 rec tail. long_500k runs: "
          "RG-LRU state is O(1), attn KV ring-bounded at 2048.",
)
