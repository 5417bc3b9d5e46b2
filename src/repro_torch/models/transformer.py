"""Generic decoder-only LM covering every architecture of the reference —
counterpart of ``repro/models/transformer.py``.

Composition rules (from ModelConfig), as in the reference:
  * families dense/moe/vlm/audio — a homogeneous stack of attention blocks
    (``blocks``, every leaf stacked over ``n_layers``), with per-layer
    attention windows (gemma2's local/global alternation, mixtral's SWA);
  * family ssm (RWKV-6) — the rwkv time-mix mixer + channel-mix "MLP";
  * family hybrid (RecurrentGemma) — the (rec, rec, attn) pattern grouped
    into full periods (``groups[j]`` holds pattern position j's leaves
    with a leading axis over the periods) plus a homogeneous ``tail``;
  * per-layer ``cfg.layer_types`` (LFM2: gated short-conv and attention
    blocks in no period, dense MLPs then MoEs) — ``layers[i]`` holds
    layer i's own leaves, unstacked.

Under a mesh every entry point takes ``DTensor`` params, batches and
caches (``launch.serve.cache_shardings``); the embedding lookup is
vocab-parallel and the loss's per-token terms run on local rows
(``local_map``).

The params keep the reference's stacked layout, so carrying weights
across is a plain map of leaves; a Python loop over layers takes the
place of the reference's ``scan``.  With ``cfg.remat == "full"`` a
training forward recomputes each layer (each period for the hybrid) in
the backward pass, through ``torch.utils.checkpoint``, where the
reference wraps its scan body in ``jax.checkpoint``: the results are the
same, only the activation memory differs.

Entry points:
  init_model      -> (params, axes)
  num_params / num_active_params -> analytic counts (nothing allocated)
  forward_train   -> next-token cross-entropy (+ MoE aux) over a batch
  forward_prefill -> last-token logits of a full sequence
  init_cache      -> decode cache (KV bf16 or int8 + scales, rec / rwkv state)
  forward_decode  -> one-token serve step against the cache
  forward_extend  -> a ragged chunk per row appended to each row's cache
                     in place, at the row's own position (LFM2)
  quantize_model_params -> W8/W8A8 serve weights (C1 at LM scale)
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import quantize_tensor
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
from repro_torch.models import short_conv as SC
from repro_torch.models.modules import param, tree_index, tree_leaves, unbox
from repro_torch.sharding.partition import PRODUCTION_TP, constrain, place

Tensor = torch.Tensor

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
_NO_WINDOW = (1 << 31) - 1


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(gen: Optional[torch.Generator], cfg: ModelConfig, kind: str,
                stack: Tuple[int, ...], moe: Optional[bool] = None):
    """One block kind's params, stacked over `stack` layers; ``moe``
    picks the MoE or the dense MLP (default: MoE where the config has
    one)."""
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
    elif kind == "conv":
        blk["mixer"] = SC.init_conv_block(gen, cfg, stack)
    elif kind == "rwkv":
        rw = RW.init_rwkv_block(gen, cfg, stack)
        blk["mixer"] = {k: v for k, v in rw.items() if not k.startswith("cm_")}
        blk["mlp"] = {k: v for k, v in rw.items() if k.startswith("cm_")}
        return blk
    if cfg.moe is not None if moe is None else moe:
        blk["mlp"] = MOE.init_moe(gen, cfg, stack)
    else:
        blk["mlp"] = L.init_mlp(gen, cfg, stack)
    return blk


def init_model(cfg: ModelConfig,
               gen: Optional[torch.Generator]) -> Tuple[Any, Any]:
    """Returns (params, logical_axes) twin trees; the float32 master
    params are drawn from ``gen`` on its device (``gen=None``: shape-only
    tensors on the ``meta`` device)."""
    tree: Dict[str, Any] = {}
    tree["embed"] = param(gen, (cfg.vocab_size, cfg.d_model),
                          ("vocab", "embed"), scale=1.0)
    if cfg.family == "hybrid":
        pat = cfg.recurrent.block_pattern
        full = cfg.n_layers // len(pat)
        tail = cfg.n_layers - full * len(pat)
        if not all(k == pat[0] for k in pat[:tail]):
            raise ValueError("the tail of the block pattern must be homogeneous")
        tree["groups"] = [_init_block(gen, cfg, kind, (full,)) for kind in pat]
        tree["tail"] = [_init_block(gen, cfg, pat[0], (tail,))] if tail else []
    elif cfg.layer_types is not None:
        tree["layers"] = [_init_block(gen, cfg, kind, (), cfg.moe_layer(i))
                          for i, kind in enumerate(cfg.layer_kinds())]
    else:
        tree["blocks"] = _init_block(gen, cfg, cfg.layer_kinds()[0],
                                     (cfg.n_layers,))
    tree["final_norm"] = L.init_norm(gen, cfg)
    if not cfg.tie_embeddings:
        tree["lm_head"] = param(gen, (cfg.d_model, cfg.vocab_size),
                                ("embed", "vocab"), scale=cfg.d_model ** -0.5)
    return unbox(tree)


def num_params(cfg: ModelConfig) -> int:
    """Analytic parameter count (no allocation)."""
    return sum(x.numel() for x in tree_leaves(init_model(cfg, None)[0]))


def num_active_params(cfg: ModelConfig) -> int:
    """Active params per token (MoE: only top_k experts count)."""
    n = num_params(cfg)
    if cfg.moe is None:
        return n
    m = cfg.moe
    per_layer_expert = 3 * cfg.d_model * m.d_ff
    moe_layers = sum(cfg.moe_layer(i) for i in range(cfg.n_layers))
    return n - moe_layers * (m.num_experts - m.top_k) * per_layer_expert


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def _block_apply(p, x: Tensor, kind: str, cfg: ModelConfig, *,
                 positions: Tensor, window: Optional[int] = None,
                 mode: str = "train", state=None, cache_pos=None,
                 ring_window=None, moe: Optional[bool] = None):
    """Residual block: norm -> mixer -> (+), norm -> mlp -> (+).

    Returns (x, aux, new_state): aux is the MoE auxiliary loss (0.0 for
    other blocks), new_state None outside decode.  ``moe`` picks the MoE
    or the dense MLP (default: MoE where the config has one)."""
    aux = 0.0
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
    elif kind == "conv":  # full sequences only; serving goes through extend
        h, _ = SC.conv_block_apply(p["mixer"], h, cfg, mode)
    elif kind == "rwkv":
        if mode == "decode":
            h, tm_state = RW.time_mix_apply(p["mixer"], h, cfg, mode,
                                            {"tm_shift": state["tm_shift"],
                                             "wkv": state["wkv"]})
            new_state = dict(tm_state)
        else:
            h = RW.time_mix_apply(p["mixer"], h, cfg, mode)
    if cfg.post_norms:
        h = L.norm_apply(p["ln1_post"], h, cfg)
    x = x + h.to(x.dtype)

    h = L.norm_apply(p["ln2"], x, cfg)
    if kind == "rwkv":
        if mode == "decode":
            h, cm_state = RW.channel_mix_apply(p["mlp"], h, cfg, mode,
                                               {"cm_shift": state["cm_shift"]})
            new_state.update(cm_state)
        else:
            h = RW.channel_mix_apply(p["mlp"], h, cfg, mode)
    elif cfg.moe is not None if moe is None else moe:
        h, aux = MOE.moe_apply(p["mlp"], h, cfg, mode)
    else:
        h = L.mlp_apply(p["mlp"], h, cfg, mode)
    if cfg.post_norms:
        h = L.norm_apply(p["ln2_post"], h, cfg)
    x = constrain(x + h.to(x.dtype), "batch", None, None)
    return x, aux, new_state


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def _lookup(table: Tensor, tokens: Tensor, dtype: torch.dtype) -> Tensor:
    """``table[tokens]`` cast to ``dtype``.  Under a mesh it is the
    vocab-parallel lookup: the table keeps its vocab split and is gathered
    along its other dim (FSDP's gather), each rank takes the rows of its
    own vocab slice for its own token rows (zeros for the others), and the
    rows are summed over the vocab split — exact, as one rank holds each
    row.  Its backward scatters into each rank's own slice; DTensor's
    index backward into a split table fails in torch 2.11."""
    if not isinstance(table, DTensor):
        return table[tokens].to(dtype)
    mesh = table.device_mesh
    split = [p == Shard(0) for p in table.placements]
    t_pl = tuple(Shard(0) if v else Replicate() for v in split)
    tok_pl = tuple(Shard(0) if p == Shard(0) and not v else Replicate()
                   for p, v in zip(tokens.placements, split))
    coord, shard, n = mesh.get_coordinate(), 0, 1
    for i, v in enumerate(split):
        if v:
            shard, n = shard * mesh.size(i) + coord[i], n * mesh.size(i)
    lo = shard * (table.shape[0] // n)

    def rows(t, tok):
        idx = tok - lo
        hit = (idx >= 0) & (idx < t.shape[0])
        out = t[idx.clamp(0, t.shape[0] - 1)].to(dtype)
        return torch.where(hit[..., None], out, torch.zeros((), dtype=dtype,
                                                             device=out.device))
    out_pl = tuple(Partial() if v else p for v, p in zip(split, tok_pl))
    # the table's local gradient holds only this rank's token rows
    grad_pl = tuple(Shard(0) if v else (Partial() if p == Shard(0) else p)
                    for v, p in zip(split, tok_pl))
    h = local_map(rows, out_placements=(out_pl,), in_placements=(t_pl, tok_pl),
                  in_grad_placements=(grad_pl, tok_pl),
                  device_mesh=mesh)(place(table, t_pl), place(tokens, tok_pl))
    return place(h, tok_pl)


def _embed(params, batch: Dict[str, Tensor], cfg: ModelConfig,
           positions: Optional[Tensor] = None) -> Tensor:
    dt = _dtype(cfg)
    if "inputs_embeds" in batch:
        h = batch["inputs_embeds"].to(dt)
    else:
        emb = params["embed"]
        if isinstance(emb, dict):  # quantised embedding
            h = _lookup(emb["q"], batch["tokens"], dt) * emb["s"].to(dt)
        else:
            h = _lookup(emb, batch["tokens"], dt)
    if cfg.norm == "gemma_rmsnorm":
        # sqrt(d) rounded to the activation dtype first, as the reference
        # does (bf16: sqrt(2560) = 50.596 -> 50.5).
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=h.dtype)
    if cfg.attn and cfg.attn.sinusoidal:
        h = h + L.sinusoidal_embedding(positions, cfg.d_model).to(h.dtype)
    return constrain(h, "batch", None, None)


def _logits(params, h: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        emb = params["embed"]
        w = (emb["q"].to(h.dtype) * emb["s"].to(h.dtype)).T \
            if isinstance(emb, dict) else emb.to(h.dtype).T
        logits = h @ w
    else:
        logits = L.linear(h, params["lm_head"], cfg.quant,
                          "serve" if isinstance(params["lm_head"], dict)
                          else "train")
    logits = logits.float()
    if cfg.final_softcap:
        cap = cfg.final_softcap
        logits = torch.clamp(logits, -cap, cap) if cfg.hard_acts \
            else cap * torch.tanh(logits / cap)
    return constrain(logits, "batch", None, "vocab")


def _positions_for(batch, b: int, s: int, device=None) -> Tensor:
    if "position_ids" in batch:
        return batch["position_ids"]
    return torch.arange(s, device=device).expand(b, s)


def _run_blocks(params, h: Tensor, cfg: ModelConfig, positions: Tensor,
                mode: str):
    """The layer stack(s) over a full sequence (train/prefill); returns
    (h, summed MoE aux loss).  A training forward under autograd with
    ``cfg.remat == "full"`` checkpoints each unit the reference's
    ``jax.checkpoint`` wraps: a layer, or a period of the hybrid's
    pattern."""
    seq = h.shape[1]
    remat = mode == "train" and cfg.remat == "full" and torch.is_grad_enabled()

    def run(fn, *args):
        return (checkpoint(fn, *args, use_reentrant=False) if remat
                else fn(*args))

    def block(p, kind, window, moe=None):
        def fn(x):
            x, aux, _ = _block_apply(p, x, kind, cfg, positions=positions,
                                     window=window, mode=mode, moe=moe)
            return x, aux
        return fn

    aux_total = 0.0
    if cfg.layer_types is not None:
        for i, (p, kind) in enumerate(zip(params["layers"],
                                          cfg.layer_kinds())):
            h, aux = run(block(p, kind, None, cfg.moe_layer(i)), h)
            aux_total = aux_total + aux
        return h, aux_total
    if cfg.family == "hybrid":
        pat = cfg.recurrent.block_pattern
        full = cfg.n_layers // len(pat)
        attn_win = min(cfg.layer_windows(seq), default=seq)
        attn_win = None if attn_win >= seq else int(attn_win)

        def period_fn(period):
            def fn(x):
                aux_sum = 0.0
                for j, kind in enumerate(pat):
                    x, aux = block(tree_index(params["groups"][j], period),
                                   kind, attn_win if kind == "attn" else None)(x)
                    aux_sum = aux_sum + aux
                return x, aux_sum
            return fn

        for period in range(full):
            h, aux = run(period_fn(period), h)
            aux_total = aux_total + aux
        for p in params["tail"]:
            for layer in range(tree_leaves(p)[0].shape[0]):
                h, aux = run(block(tree_index(p, layer), pat[0], None), h)
                aux_total = aux_total + aux
        return h, aux_total
    kind = cfg.layer_kinds()[0]
    windows = [None] * cfg.n_layers
    if kind == "attn":  # SWA / gemma2's local/global alternation
        windows = [None if w >= seq else int(w) for w in cfg.layer_windows(seq)]
    for layer in range(cfg.n_layers):
        h, aux = run(block(tree_index(params["blocks"], layer), kind,
                           windows[layer]), h)
        aux_total = aux_total + aux
    return h, aux_total


# ---------------------------------------------------------------------------
# forward: train / prefill / decode
# ---------------------------------------------------------------------------

def forward_train(params, batch: Dict[str, Tensor], cfg: ModelConfig
                  ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Next-token cross-entropy over one (micro)batch, as the reference
    computes it: logits[:, :-1] against labels[:, 1:], labels of -1 as
    padding, plus 0.01 x the MoE auxiliary loss.  ``batch`` holds
    ``tokens`` (or ``inputs_embeds`` for an arch without an embedding
    input), ``labels`` and, for M-RoPE, ``position_ids`` (3, B, S).
    Returns (loss, {"ce", "aux"}), f32 scalars."""
    tokens_or_embeds = batch.get("tokens", batch.get("inputs_embeds"))
    b, s = tokens_or_embeds.shape[:2]
    positions = _positions_for(batch, b, s, device=tokens_or_embeds.device)
    h = _embed(params, batch, cfg, positions)
    h, aux = _run_blocks(params, h, cfg, positions, "train")
    h = L.norm_apply(params["final_norm"], h, cfg)
    # The loss takes whole vocab rows: under a mesh the vocab-sharded
    # logits are gathered over "model" first (a gather against a vocab
    # shard has no working DTensor strategy).
    logits = constrain(_logits(params, h, cfg)[:, :-1],  # (B, S-1, V) f32
                       "batch", None, None)
    labels = batch["labels"][:, 1:]
    lw = (labels >= 0).float()                           # -1 = padding
    ce = torch.sum(_token_nll(logits, labels) * lw) / lw.sum().clamp_min(1.0)
    aux = torch.as_tensor(aux, dtype=torch.float32, device=ce.device)
    return ce + 0.01 * aux, {"ce": ce, "aux": aux}


def _nll(logits: Tensor, labels: Tensor) -> Tensor:
    lse = torch.logsumexp(logits, -1)
    return lse - torch.gather(logits, -1,
                              labels.clamp_min(0)[..., None].long())[..., 0]


def _token_nll(logits: Tensor, labels: Tensor) -> Tensor:
    """Each token's -log p(label) from f32 logits (B, S, V) with whole
    vocab rows.  Under a mesh it runs on each rank's own rows through
    ``local_map``: DTensor's gather backward builds a zero tensor of the
    global logits' shape on every rank before it slices its rows."""
    if not isinstance(logits, DTensor):
        return _nll(logits, labels)
    pl = tuple(p if p == Shard(0) else Replicate() for p in logits.placements)
    return local_map(_nll, out_placements=(pl,), in_placements=(pl, pl),
                     device_mesh=logits.device_mesh)(place(logits, pl),
                                                     place(labels, pl))


def forward_prefill(params, batch: Dict[str, Tensor],
                    cfg: ModelConfig) -> Tensor:
    """Last-token logits (B, 1, V), float32, of a full sequence."""
    tokens_or_embeds = batch.get("tokens", batch.get("inputs_embeds"))
    b, s = tokens_or_embeds.shape[:2]
    positions = _positions_for(batch, b, s, device=tokens_or_embeds.device)
    h = _embed(params, batch, cfg, positions)
    h, _ = _run_blocks(params, h, cfg, positions, "prefill")
    h = L.norm_apply(params["final_norm"], h, cfg)
    return _logits(params, h[:, -1:], cfg)


def cache_spec(cfg: ModelConfig, batch: int, seq_len: int
               ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype, Tuple]]:
    """{name: (shape, dtype, logical_axes)} for the decode cache.

    The attention KV cache is bounded by the window when every attention
    layer is windowed (a ring buffer in decode).  LFM2's short-conv
    blocks keep their last ``conv_width - 1`` conv inputs (``conv``, bf16)
    beside the KV of its attention blocks.  KV is bf16, or int8 with
    f32 per-(token, head) scales when ``cfg.quant.quantize_kv``; the conv
    and token-shift states are bf16 and the recurrent states f32, whatever
    the activation dtype.  The KV cache shards its heads over the
    production TP width when they divide it, else its sequence dim
    (``kv_seq``: sequence-parallel decode attention), as the reference
    lays it out."""
    kinds = cfg.layer_kinds()
    specs = {}
    n_attn = sum(k == "attn" for k in kinds)
    if n_attn:
        s_cache = max(cfg.layer_windows(seq_len))
        kv_shape = (n_attn, batch, s_cache, cfg.n_kv_heads, cfg.head_dim)
        kv_dtype = torch.int8 if cfg.quant.quantize_kv else torch.bfloat16
        seq_ax = None if cfg.n_kv_heads % PRODUCTION_TP == 0 else "kv_seq"
        axes = ("layers", "batch", seq_ax, "kv_heads", None)
        specs["k"] = (kv_shape, kv_dtype, axes)
        specs["v"] = (kv_shape, kv_dtype, axes)
        if cfg.quant.quantize_kv:
            specs["k_scale"] = (kv_shape[:-1], torch.float32, axes[:-1])
            specs["v_scale"] = (kv_shape[:-1], torch.float32, axes[:-1])
    n_conv = sum(k == "conv" for k in kinds)
    if n_conv:
        specs["conv"] = ((n_conv, batch, cfg.conv_width - 1, cfg.d_model),
                         torch.bfloat16, ("layers", "batch", None, "mlp"))
    n_rec = sum(k == "rec" for k in kinds)
    if n_rec:
        w, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
        specs["rec_h"] = ((n_rec, batch, w), torch.float32,
                          ("layers", "batch", "lru"))
        specs["rec_conv"] = ((n_rec, batch, cw - 1, w), torch.bfloat16,
                             ("layers", "batch", None, "lru"))
    n_rwkv = sum(k == "rwkv" for k in kinds)
    if n_rwkv:
        hd = cfg.rwkv.head_dim
        nh = cfg.d_model // hd
        specs["wkv"] = ((n_rwkv, batch, nh, hd, hd), torch.float32,
                        ("layers", "batch", "act_heads", None, None))
        specs["tm_shift"] = ((n_rwkv, batch, cfg.d_model), torch.bfloat16,
                             ("layers", "batch", None))
        specs["cm_shift"] = ((n_rwkv, batch, cfg.d_model), torch.bfloat16,
                             ("layers", "batch", None))
    return specs


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               device=None) -> Dict[str, Tensor]:
    return {k: torch.zeros(sh, dtype=dt, device=device)
            for k, (sh, dt, _) in cache_spec(cfg, batch, seq_len).items()}


# block kind -> (state key, cache key) pairs
_STATE_KEYS = {
    "attn": (("k", "k"), ("v", "v"), ("k_scale", "k_scale"),
             ("v_scale", "v_scale")),
    "rec": (("h", "rec_h"), ("conv", "rec_conv")),
    "rwkv": (("wkv", "wkv"), ("tm_shift", "tm_shift"), ("cm_shift", "cm_shift")),
}


def _state_slice(cache, kind: str, i: int) -> Dict[str, Tensor]:
    """Layer ``i``'s state of kind ``kind`` (views into the cache)."""
    return {sk: cache[ck][i] for sk, ck in _STATE_KEYS[kind] if ck in cache}


def _stack_states(cache, kind: str, states, cast: bool):
    """The cache entries of ``kind`` from every layer's new state
    (``states[i]`` is layer ``i``'s), stacked over the layers; ``cast``
    takes the cache's dtypes, else the dtypes the blocks returned."""
    out = {}
    for sk, ck in _STATE_KEYS[kind]:
        if ck in cache:
            out[ck] = torch.stack([ns[sk].to(cache[ck].dtype) if cast
                                   else ns[sk] for ns in states])
    return out


def forward_decode(params, cache: Dict[str, Tensor], batch: Dict[str, Any],
                   cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One serve step: one new token per sequence against the cache.

    ``batch["cache_pos"]`` is the step's position (an int or a 0-dim
    tensor).  Cache layout as in the reference: homogeneous families stack
    every state over the layers; for the hybrid family the attention cache
    is ordered by period, the rec states by (pattern position, period),
    then the tail.  As in the reference, a homogeneous family's new states
    replace the cache's entries whole, in the dtype the block returns (a
    token shift is the activation's dtype), while the hybrid family's are
    written into the cache's dtypes.  Returns (logits (B, 1, V) float32,
    new cache); the cache passed in is left as it was."""
    cache_pos = int(batch["cache_pos"])
    tokens_or_embeds = batch.get("tokens", batch.get("inputs_embeds"))
    b = tokens_or_embeds.shape[0]
    dev = tokens_or_embeds.device
    if cfg.layer_types is not None:  # one token a row through extend
        new_cache = {k: v.clone() for k, v in cache.items()}
        logits = forward_extend(params, new_cache, {
            "tokens": batch["tokens"].reshape(-1), "rows": range(b),
            "starts": [cache_pos] * b, "lens": [1] * b}, cfg)
        return logits[:, None], new_cache
    positions = (batch["position_ids"] if "position_ids" in batch
                 else torch.full((b, 1), cache_pos, device=dev))
    h = _embed(params, batch, cfg, positions)
    seq_budget = cache["k"].shape[2] if "k" in cache else None
    ring = (seq_budget if (cfg.uniform_window and
                           seq_budget == cfg.uniform_window) else None)

    if cfg.family != "hybrid":
        kind = cfg.layer_kinds()[0]
        wins = ([min(w, _NO_WINDOW) for w in cfg.layer_windows(1 << 60)]
                if kind == "attn" else [None] * cfg.n_layers)
        states = []
        for layer in range(cfg.n_layers):
            h, _, ns = _block_apply(
                tree_index(params["blocks"], layer), h, kind, cfg,
                positions=positions, window=wins[layer], mode="decode",
                state=_state_slice(cache, kind, layer), cache_pos=cache_pos,
                ring_window=ring)
            states.append(ns)
        new_cache = {**cache, **_stack_states(cache, kind, states, False)}
        h = L.norm_apply(params["final_norm"], h, cfg)
        return _logits(params, h, cfg), new_cache

    states = {"attn": {}, "rec": {}}
    pat = cfg.recurrent.block_pattern
    full = cfg.n_layers // len(pat)
    win = cfg.attn.window or _NO_WINDOW
    n_rec_pos = sum(k == "rec" for k in pat)
    for period in range(full):
        rj = aj = 0
        for j, kind in enumerate(pat):
            if kind == "rec":
                i, rj = rj * full + period, rj + 1
            else:
                i, aj = aj * full + period, aj + 1
            h, _, ns = _block_apply(
                tree_index(params["groups"][j], period), h, kind, cfg,
                positions=positions, window=win if kind == "attn" else None,
                mode="decode", state=_state_slice(cache, kind, i),
                cache_pos=cache_pos, ring_window=ring)
            states[kind][i] = ns
    lo = n_rec_pos * full
    for p in params["tail"]:
        for layer in range(tree_leaves(p)[0].shape[0]):
            h, _, ns = _block_apply(tree_index(p, layer), h, "rec", cfg,
                                    positions=positions, mode="decode",
                                    state=_state_slice(cache, "rec", lo),
                                    cache_pos=cache_pos)
            states["rec"][lo] = ns
            lo += 1
    new_cache = dict(cache)
    for kind, per in states.items():
        new_cache.update(_stack_states(cache, kind,
                                       [per[i] for i in range(len(per))], True))
    h = L.norm_apply(params["final_norm"], h, cfg)
    return _logits(params, h, cfg), new_cache


def _range(name: str):
    """A profiler range named ``name`` while a profiler runs, else
    nothing."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.autograd.profiler.record_function(name)
    return contextlib.nullcontext()


class ExtendProbe:
    """What :func:`forward_extend` reports beside its logits: ``claims``
    (MoE layers, experts) int64 on the device, gaining each layer's
    claims per expert (no host sync), where given; ``section(name)`` the
    context around each layer's ``lfm2.conv``/``lfm2.attn`` mixer and
    ``lfm2.moe``/``lfm2.mlp`` FFN (a profiler range by default)."""

    claims: Optional[Tensor] = None

    def section(self, name: str):
        return _range(name)


def _ragged_meta(rows, starts, lens, positions: int, device,
                 varlen: bool) -> Dict[str, Any]:
    """Host-built indices of a ragged chunk, in one copy to the device:
    each packed token's position (``pos``) and cache row (``at_row``),
    each row's cache row (``rows_t``) and its last token's packed index
    (``last``); with ``varlen``, the packed flash call's row offsets
    (``cu_q``, ``cu_k``) and the flat cache rows of every row's k, v
    from 0 to its last new position (``kv_at``, over ``positions`` a
    row)."""
    rows, starts, lens = (np.asarray(a, np.int64) for a in (rows, starts,
                                                             lens))
    if len(rows) != len(set(rows.tolist())):
        raise ValueError("a row may appear once in an extend call")
    first = np.r_[0, np.cumsum(lens)[:-1]]
    pos = np.arange(int(lens.sum())) - np.repeat(first - starts, lens)
    parts = [pos, np.repeat(rows, lens), rows, first + lens - 1]
    ctx = starts + lens
    if varlen:
        parts += [np.r_[0, np.cumsum(lens)], np.r_[0, np.cumsum(ctx)],
                  np.concatenate([r * positions + np.arange(c)
                                  for r, c in zip(rows, ctx)])]
    cut = np.cumsum([len(t) for t in parts])[:-1]
    got = torch.as_tensor(np.concatenate(parts),
                          device=device).tensor_split(cut.tolist())
    meta = dict(zip(("pos", "at_row", "rows_t", "last"), got),
                rows=rows.tolist(), starts=starts.tolist(),
                lens=lens.tolist())
    if varlen:
        meta.update(cu_q=got[4].to(torch.int32), cu_k=got[5].to(torch.int32),
                    kv_at=got[6], max_q=int(lens.max()),
                    max_k=int(ctx.max()))
    return meta


def _lower_right(q: Tensor, k: Tensor, v: Tensor, scale: float) -> Tensor:
    """One row's attention: q (n, H, hd) against k, v (ctx, KV, hd), the
    queries at the last n of the ctx positions, causal."""
    from torch.nn.attention.bias import causal_lower_right
    n, ctx = q.shape[0], k.shape[0]
    return F.scaled_dot_product_attention(
        q.transpose(0, 1)[None], k.transpose(0, 1)[None],
        v.transpose(0, 1)[None],
        attn_mask=causal_lower_right(n, ctx) if n > 1 else None,
        scale=scale, enable_gqa=True)[0].transpose(0, 1)


def _varlen(q: Tensor, k: Tensor, v: Tensor, cu_q: Tensor, cu_k: Tensor,
            max_q: int, max_k: int, scale: float) -> Tensor:
    """Flash attention over packed rows (``cu_q``/``cu_k`` their int32
    offsets), causal from each row's bottom right."""
    return torch.ops.aten._flash_attention_forward(
        q, k, v, cu_q, cu_k, max_q, max_k, 0.0, True, False,
        scale=scale)[0]


def _attn_extend(p, x: Tensor, cfg: ModelConfig, cache: Dict[str, Tensor],
                 layer: int, meta: Dict[str, Any]) -> Tensor:
    """GQA over a packed ragged chunk x (N, d): each token's k and v
    written into attention layer ``layer``'s cache (rows, S, KV, hd) at
    its row and position (int8 codes and per-(token, head) scales for an
    int8 cache), then each row's queries against its cache from 0 to its
    last new position, causal from the bottom right: one packed flash
    call over every row's cached k, v on the card (``meta["kv_at"]``
    gathers them; it raises where the flash call cannot run), one call
    a row elsewhere and for an int8 cache."""
    a = cfg.attn
    scale = a.query_scale or cfg.head_dim ** -0.5
    pos, at_row = meta["pos"], meta["at_row"]
    q = L.linear(x, p["wq"], cfg.quant, "serve")
    k = L.linear(x, p["wk"], cfg.quant, "serve")
    v = L.linear(x, p["wv"], cfg.quant, "serve")
    if a.qk_norm:
        q, k = L.qk_norm(p, q, k, cfg)
    q = L.apply_rope(q[None], pos[None], a.rope_theta)[0]
    k = L.apply_rope(k[None], pos[None], a.rope_theta)[0]
    kc, vc = cache["k"][layer], cache["v"][layer]
    scaled = kc.dtype == torch.int8
    if scaled:
        ks, vs = cache["k_scale"][layer], cache["v_scale"][layer]
        (k, k_s), (v, v_s) = L._q8(k.float()), L._q8(v.float())
        ks.index_put_((at_row, pos), k_s)
        vs.index_put_((at_row, pos), v_s)
    kc.index_put_((at_row, pos), k.to(kc.dtype))
    vc.index_put_((at_row, pos), v.to(vc.dtype))
    if "kv_at" in meta and not scaled:
        flat = lambda c: c.reshape(-1, *c.shape[2:])[meta["kv_at"]]
        out = _varlen(q, flat(kc).to(q.dtype), flat(vc).to(q.dtype),
                      meta["cu_q"], meta["cu_k"], meta["max_q"],
                      meta["max_k"], scale)
    else:
        def held(c, sc, r, ctx):
            """Row r's first ctx cached entries, dequantised."""
            t = c[r, :ctx].float() * sc[r, :ctx, :, None] if scaled \
                else c[r, :ctx]
            return t.to(q.dtype)
        out = torch.empty_like(q)
        at = 0
        for r, s0, n in zip(meta["rows"], meta["starts"], meta["lens"]):
            ctx = s0 + n
            out[at:at + n] = _lower_right(
                q[at:at + n], held(kc, scaled and ks, r, ctx),
                held(vc, scaled and vs, r, ctx), scale)
            at += n
    return L.linear(out.reshape(x.shape[0], -1), p["wo"], cfg.quant, "serve")


def forward_extend(params, cache: Dict[str, Tensor], batch: Dict[str, Any],
                   cfg: ModelConfig,
                   probe: Optional[ExtendProbe] = None) -> Tensor:
    """Append a ragged chunk of tokens to each row's cache, in place.

    ``batch``: ``tokens`` (N,) the rows' new tokens packed in row order,
    and per row (host ints) ``rows`` its row of the cache, ``starts`` its
    first new position and ``lens`` its token count.  Row r's tokens take
    positions ``starts[r] .. starts[r] + lens[r] - 1``, attend to its
    cache below them, and continue its conv state; the new k, v and conv
    states are written into ``cache`` (``cache_spec``'s ``k``, ``v``,
    their scales for an int8 KV cache, and ``conv``).  A row starting over is given position 0 and a zeroed
    conv state by the caller.  Returns each row's last-token logits (R,
    V) float32.  Configs with ``layer_types`` (LFM2) only."""
    if cfg.layer_types is None or set(cfg.layer_kinds()) - {"conv", "attn"}:
        raise ValueError(f"{cfg.name}: forward_extend runs conv and "
                         f"attention layers given as layer_types")
    probe = probe or ExtendProbe()
    dev = batch["tokens"].device
    meta = _ragged_meta(batch["rows"], batch["starts"], batch["lens"],
                        cache["k"].shape[2], dev, dev.type == "cuda")
    rows_t = meta["rows_t"]
    taps, tail = SC.ragged_taps(meta["lens"], cfg.conv_width - 1, dev)
    h = _embed(params, {"tokens": batch["tokens"][None]}, cfg)[0]
    ci = ai = mi = 0
    for i, (p, kind) in enumerate(zip(params["layers"], cfg.layer_kinds())):
        x = L.norm_apply(p["ln1"], h, cfg)
        with probe.section(f"lfm2.{kind}"):
            if kind == "conv":
                y, state = SC.conv_extend(p["mixer"], x, cfg,
                                          cache["conv"][ci][rows_t], taps,
                                          tail)
                cache["conv"][ci].index_copy_(0, rows_t,
                                              state.to(cache["conv"].dtype))
                ci += 1
            else:
                y = _attn_extend(p["mixer"], x, cfg, cache, ai, meta)
                ai += 1
        h = h + y.to(h.dtype)
        x = L.norm_apply(p["ln2"], h, cfg)
        if cfg.moe_layer(i):
            with probe.section("lfm2.moe"):
                y = MOE.moe_dropless(p["mlp"], x, cfg, None if probe.claims
                                     is None else probe.claims[mi])
            mi += 1
        else:
            with probe.section("lfm2.mlp"):
                y = L.mlp_apply(p["mlp"], x, cfg, "serve")
        h = h + y.to(h.dtype)
    h = L.norm_apply(params["final_norm"], h[meta["last"]], cfg)
    return _logits(params, h, cfg)


# ---------------------------------------------------------------------------
# serve-time quantisation (C1 at LM scale)
# ---------------------------------------------------------------------------

# leaves kept in full precision: norms, biases, gates'/decays' small tensors,
# ddlerp/LoRA params, the MoE router, depthwise conv — the reference's lists.
_QUANT_EXCLUDE_EXACT = frozenset(
    {"u", "w0", "lam", "mu", "mu_x", "cm_mu_r", "cm_mu_k", "conv_w", "conv_b",
     "ln_x", "router", "b", "b_a", "b_i"})
_QUANT_EXCLUDE_PREFIX = ("ln", "b_", "bq", "bk", "bv", "lora", "wl_", "bias",
                         "final_norm")


def _quantizable(path: str, x) -> bool:
    if not isinstance(x, torch.Tensor) or x.ndim < 2:
        return False
    if not x.is_floating_point():
        return False
    leaf = path.split("/")[-1]
    if leaf in _QUANT_EXCLUDE_EXACT:
        return False
    return not any(leaf.startswith(e) for e in _QUANT_EXCLUDE_PREFIX)


def quantize_model_params(params, axes, cfg: ModelConfig):
    """Replace weight leaves with {"q": int8, "s": f32 scale}: per-out-
    channel, power-of-two scales when ``cfg.quant.p2_scale`` (the paper's
    shift-requant, C1), reduced over the contraction dim — the first dim
    after any leading ``layers``/``experts`` dims, which ``linear``
    contracts — so each layer, expert and output channel keeps its own
    scale, e.g. (L, d, H, hd) -> scale (L, 1, H, hd).  Returns (params,
    axes) twin trees for serving."""

    def walk(p, a, path=""):
        if isinstance(p, dict):
            pairs = {k: walk(p[k], a[k], f"{path}/{k}") for k in p}
            return ({k: v[0] for k, v in pairs.items()},
                    {k: v[1] for k, v in pairs.items()})
        if isinstance(p, list):
            pairs = [walk(x, y, f"{path}/{i}") for i, (x, y) in enumerate(zip(p, a))]
            return [x for x, _ in pairs], [y for _, y in pairs]
        if _quantizable(path, p):
            c = 0
            while c < p.ndim - 1 and a[c] in ("layers", "experts"):
                c += 1
            qt = quantize_tensor(p, axis=(c,), p2=cfg.quant.p2_scale)
            s_axes = tuple(a[i] if i != c else None for i in range(p.ndim))
            return {"q": qt.values, "s": qt.scale}, {"q": a, "s": s_axes}
        return p, a

    return walk(params, axes)
