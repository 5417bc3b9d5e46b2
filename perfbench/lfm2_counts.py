"""Operations the benchmark counts for LFM2 (``lfm2_sessions``' cells),
from the configuration's published keys, and the card's bf16 peak.

A token's operations are two for each multiply-add of the weights it
passes through (its active parameters outside the embedding: every
mixer's and dense FFN's matrices, the router, its top-k experts' three
matrices, the conv taps), and the attention's two products over its
context (``4 * heads * head_dim * context`` for each attention layer).
The tied head runs once a turn, on its last token, as the program
computes it.  Norms, RoPE, softmax and the gates' arithmetic are not
counted.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA's H100 SXM data sheet: dense bf16 on the tensor cores, at the
# 700 W power limit.
BF16_PEAK_FLOPS = 989e12


def token_macs(cfg: Dict) -> int:
    """Multiply-adds of one token's active weights outside the embedding."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    hd, kv = d // h, cfg["num_key_value_heads"]
    conv = 4 * d * d + cfg["conv_L_cache"] * d
    attn = 2 * d * h * hd + 2 * d * kv * hd
    dense = 3 * d * cfg["intermediate_size"]
    moe = d * cfg["num_experts"] + cfg["num_experts_per_tok"] * 3 * d \
        * cfg["moe_intermediate_size"]
    total = 0
    for i, kind in enumerate(cfg["layer_types"]):
        total += conv if kind == "conv" else attn
        total += dense if i < cfg["num_dense_layers"] else moe
    return total


def flops(cfg: Dict, tokens: int, ctx_tokens: int, turns: int) -> float:
    """Operations of ``turns`` turns of ``tokens`` tokens in all, whose
    attended tokens' contexts sum to ``ctx_tokens``."""
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    n_attn = sum(k != "conv" for k in cfg["layer_types"])
    return (2.0 * token_macs(cfg) * tokens
            + 4.0 * d * n_attn * ctx_tokens       # heads * head_dim == d
            + 2.0 * d * cfg["vocab_size"] * turns)
