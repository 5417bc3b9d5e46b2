"""MusicGen-medium decoder backbone over EnCodec tokens; audio frontend
(EnCodec + codebook interleaving) stubbed — input_specs supplies frame
embeddings. [arXiv:2306.05284]"""
from repro_torch.configs.base import AttnConfig, ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab_size=2048,
    norm="layernorm", act="gelu", mlp_type="mlp",
    attn=AttnConfig(sinusoidal=True),
    embed_inputs=False,
    notes="MHA (kv=24), sinusoidal positions, LayerNorm, plain GELU MLP. "
          "24 heads over 16-way TP relies on GSPMD padding.",
)
