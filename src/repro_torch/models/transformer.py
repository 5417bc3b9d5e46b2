"""Decoder-only LM — counterpart of ``repro/models/transformer.py``, for
the hybrid family (RecurrentGemma: the (rec, rec, attn) pattern grouped
into full periods plus a homogeneous tail of rec layers).

The params keep the reference's stacked layout, so carrying weights
across is a plain map of leaves: ``groups[j]`` holds pattern position
j's leaves with a leading axis over the ``full`` periods, and ``tail`` is
a list of stacks.  A Python loop over periods and layers takes the place
of the reference's ``scan``.  The homogeneous families (dense, MoE, SSM)
raise ``NotImplementedError``: they are later slices (ROADMAP.md).

Entry points:
  init_model      -> (params, axes)
  forward_prefill -> last-token logits of a full sequence
  init_cache      -> decode cache (rec state f32/bf16, KV bf16)
  forward_decode  -> one-token serve step against the cache
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import rglru as RG
from repro_torch.models.modules import param, tree_index, tree_leaves, unbox

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _not_ported(cfg: ModelConfig):
    return NotImplementedError(
        f"the {cfg.family!r} family ({cfg.name}) is not ported yet: "
        f"repro_torch runs the hybrid family; see ROADMAP.md §1 (LM side: "
        f"dense qwen1.5-0.5B, MoE, RWKV-6)")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str,
                stack: Tuple[int, ...]):
    """One block kind's params, stacked over `stack` layers."""
    blk: Dict[str, Any] = {
        "ln1": L.init_norm(gen, cfg, stack),
        "ln2": L.init_norm(gen, cfg, stack),
    }
    if cfg.post_norms:
        blk["ln1_post"] = L.init_norm(gen, cfg, stack)
        blk["ln2_post"] = L.init_norm(gen, cfg, stack)
    if kind == "attn":
        blk["mixer"] = L.init_attn(gen, cfg, stack)
    elif kind == "rec":
        blk["mixer"] = RG.init_rglru_block(gen, cfg, stack)
    else:
        raise _not_ported(cfg)
    if cfg.moe is not None:
        raise _not_ported(cfg)
    blk["mlp"] = L.init_mlp(gen, cfg, stack)
    return blk


def init_model(cfg: ModelConfig, gen: torch.Generator) -> Tuple[Any, Any]:
    """Returns (params, logical_axes) twin trees; the float32 master
    params are drawn from ``gen`` on its device."""
    if cfg.family != "hybrid":
        raise _not_ported(cfg)
    tree: Dict[str, Any] = {}
    tree["embed"] = param(gen, (cfg.vocab_size, cfg.d_model),
                          ("vocab", "embed"), scale=1.0)
    pat = cfg.recurrent.block_pattern
    full = cfg.n_layers // len(pat)
    tail = cfg.n_layers - full * len(pat)
    if not all(k == pat[0] for k in pat[:tail]):
        raise ValueError("the tail of the block pattern must be homogeneous")
    tree["groups"] = [_init_block(gen, cfg, kind, (full,)) for kind in pat]
    tree["tail"] = [_init_block(gen, cfg, pat[0], (tail,))] if tail else []
    tree["final_norm"] = L.init_norm(gen, cfg)
    if not cfg.tie_embeddings:
        tree["lm_head"] = param(gen, (cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), scale=cfg.d_model ** -0.5)
    return unbox(tree)


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def _block_apply(p, x: Tensor, kind: str, cfg: ModelConfig, *,
                 positions: Tensor, window: Optional[int] = None,
                 mode: str = "train", state=None, cache_pos=None,
                 ring_window=None):
    """Residual block: norm -> mixer -> (+), norm -> mlp -> (+).

    Returns (x, new_state); new_state is None outside decode.  (The
    reference also returns the MoE auxiliary loss, always 0 here.)"""
    h = L.norm_apply(p["ln1"], x, cfg)
    new_state = None
    if kind == "attn":
        if mode == "decode":
            h, new_state = L.attn_apply(p["mixer"], h, positions, cfg=cfg,
                                        window=window, mode=mode,
                                        cache=state, cache_pos=cache_pos,
                                        ring_window=ring_window)
        else:
            h = L.attn_apply(p["mixer"], h, positions, cfg=cfg,
                             window=window, mode=mode)
    elif kind == "rec":
        if mode == "decode":
            h, new_state = RG.rec_block_apply(p["mixer"], h, cfg, mode, state)
        else:
            h = RG.rec_block_apply(p["mixer"], h, cfg, mode)
    else:
        raise _not_ported(cfg)
    if cfg.post_norms:
        h = L.norm_apply(p["ln1_post"], h, cfg)
    x = x + h.to(x.dtype)

    h = L.mlp_apply(p["mlp"], L.norm_apply(p["ln2"], x, cfg), cfg, mode)
    if cfg.post_norms:
        h = L.norm_apply(p["ln2_post"], h, cfg)
    return x + h.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _embed(params, batch: Dict[str, Tensor], cfg: ModelConfig) -> Tensor:
    if "inputs_embeds" in batch:
        h = batch["inputs_embeds"].to(_dtype(cfg))
    else:
        h = params["embed"][batch["tokens"]].to(_dtype(cfg))
    if cfg.norm == "gemma_rmsnorm":
        # sqrt(d) rounded to the activation dtype first, as the reference
        # does (bf16: sqrt(2560) = 50.596 -> 50.5).
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    if cfg.attn and cfg.attn.sinusoidal:
        raise NotImplementedError("sinusoidal positions (musicgen) are not "
                                  "ported yet (ROADMAP.md)")
    return h


def _logits(params, h: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        logits = h @ params["embed"].to(h.dtype).T
    else:
        logits = L.linear(h, params["lm_head"], cfg.quant)
    logits = logits.float()
    if cfg.final_softcap:
        cap = cfg.final_softcap
        logits = torch.clamp(logits, -cap, cap) if cfg.hard_acts \
            else cap * torch.tanh(logits / cap)
    return logits


def _positions_for(batch, b: int, s: int, device=None) -> Tensor:
    if "position_ids" in batch:
        return batch["position_ids"]
    return torch.arange(s, device=device).expand(b, s)


def _run_blocks(params, h: Tensor, cfg: ModelConfig, positions: Tensor,
                mode: str) -> Tensor:
    """The layer stack over a full sequence (train/prefill)."""
    if cfg.family != "hybrid":
        raise _not_ported(cfg)
    seq = h.shape[1]
    pat = cfg.recurrent.block_pattern
    full = cfg.n_layers // len(pat)
    attn_win = min(cfg.layer_windows(seq), default=seq)
    attn_win = None if attn_win >= seq else int(attn_win)
    for period in range(full):
        for j, kind in enumerate(pat):
            h, _ = _block_apply(tree_index(params["groups"][j], period), h,
                                kind, cfg, positions=positions,
                                window=attn_win if kind == "attn" else None,
                                mode=mode)
    for p in params["tail"]:
        for layer in range(tree_leaves(p)[0].shape[0]):
            h, _ = _block_apply(tree_index(p, layer), h, pat[0], cfg,
                                positions=positions, mode=mode)
    return h


# ---------------------------------------------------------------------------
# forward: prefill / decode
# ---------------------------------------------------------------------------

def forward_prefill(params, batch: Dict[str, Tensor],
                    cfg: ModelConfig) -> Tensor:
    """Last-token logits (B, 1, V), float32, of a full sequence."""
    tokens_or_embeds = batch.get("tokens", batch.get("inputs_embeds"))
    b, s = tokens_or_embeds.shape[:2]
    positions = _positions_for(batch, b, s, device=tokens_or_embeds.device)
    h = _embed(params, batch, cfg)
    h = _run_blocks(params, h, cfg, positions, "prefill")
    h = L.norm_apply(params["final_norm"], h, cfg)
    return _logits(params, h[:, -1:], cfg)


def cache_spec(cfg: ModelConfig, batch: int,
               seq_len: int) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """{name: (shape, dtype)} for the decode cache.  The reference also
    gives each entry logical axes for sharding, which a single card does
    not need.

    The attention KV cache is bounded by the window when every attention
    layer is windowed (a ring buffer in decode).  KV and the conv state
    are bf16 and the recurrent h f32, whatever the activation dtype."""
    if cfg.quant.quantize_kv:
        raise NotImplementedError("the int8 KV cache is not ported yet "
                                  "(ROADMAP.md)")
    kinds = cfg.layer_kinds()
    specs = {}
    n_attn = sum(k == "attn" for k in kinds)
    if n_attn:
        s_cache = max(cfg.layer_windows(seq_len))
        kv_shape = (n_attn, batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
        specs["k"] = (kv_shape, torch.bfloat16)
        specs["v"] = (kv_shape, torch.bfloat16)
    n_rec = sum(k == "rec" for k in kinds)
    if n_rec:
        w, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
        specs["rec_h"] = ((n_rec, batch, w), torch.float32)
        specs["rec_conv"] = ((n_rec, batch, cw - 1, w), torch.bfloat16)
    if any(k == "rwkv" for k in kinds):
        raise _not_ported(cfg)
    return specs


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> Dict[str, Tensor]:
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt) in cache_spec(cfg, batch, seq_len).items()}


# block kind -> (state key, cache key) pairs
_STATE_KEYS = {
    "attn": (("k", "k"), ("v", "v")),
    "rec": (("h", "rec_h"), ("conv", "rec_conv")),
}


def _state_slice(cache, kind: str, i: int) -> Dict[str, Tensor]:
    """Layer ``i``'s state of kind ``kind`` (views into the cache)."""
    return {sk: cache[ck][i] for sk, ck in _STATE_KEYS[kind]}


def _state_write(new_cache, kind: str, i: int, ns: Dict[str, Tensor]):
    """Write layer ``i``'s new state into ``new_cache`` in place, cast to
    the cache's dtypes."""
    for sk, ck in _STATE_KEYS[kind]:
        new_cache[ck][i] = ns[sk]


def forward_decode(params, cache: Dict[str, Tensor], batch: Dict[str, Any],
                   cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serve step: one new token per sequence against the cache.

    ``batch["cache_pos"]`` is the step's position (an int or a 0-dim
    tensor).  Cache layout as in the reference: the attention cache is
    ordered by period; the rec states by (pattern position, period), then
    the tail.  Returns (logits (B, 1, V) float32, new cache); the cache
    passed in is left as it was."""
    if cfg.family != "hybrid":
        raise _not_ported(cfg)
    cache_pos = int(batch["cache_pos"])
    tokens_or_embeds = batch.get("tokens", batch.get("inputs_embeds"))
    b = tokens_or_embeds.shape[0]
    dev = tokens_or_embeds.device
    positions = (batch["position_ids"] if "position_ids" in batch
                 else torch.full((b, 1), cache_pos, device=dev))
    h = _embed(params, batch, cfg)
    new_cache = {k: v.clone() for k, v in cache.items()}
    seq_budget = cache["k"].shape[2] if "k" in cache else None
    ring = (seq_budget if (cfg.uniform_window and
                           seq_budget == cfg.uniform_window) else None)

    pat = cfg.recurrent.block_pattern
    full = cfg.n_layers // len(pat)
    win = cfg.attn.window or ((1 << 31) - 1)
    n_rec_pos = sum(k == "rec" for k in pat)
    for period in range(full):
        rj = aj = 0
        for j, kind in enumerate(pat):
            if kind == "rec":
                i, rj = rj * full + period, rj + 1
            else:
                i, aj = aj * full + period, aj + 1
            h, ns = _block_apply(
                tree_index(params["groups"][j], period), h, kind, cfg,
                positions=positions, window=win if kind == "attn" else None,
                mode="decode", state=_state_slice(cache, kind, i),
                cache_pos=cache_pos, ring_window=ring)
            _state_write(new_cache, kind, i, ns)
    lo = n_rec_pos * full
    for p in params["tail"]:
        for layer in range(tree_leaves(p)[0].shape[0]):
            h, ns = _block_apply(tree_index(p, layer), h, "rec", cfg,
                                 positions=positions, mode="decode",
                                 state=_state_slice(cache, "rec", lo),
                                 cache_pos=cache_pos)
            _state_write(new_cache, "rec", lo, ns)
            lo += 1
    h = L.norm_apply(params["final_norm"], h, cfg)
    return _logits(params, h, cfg), new_cache
