"""Generic decoder-only LM covering every architecture of the reference —
counterpart of ``repro/models/transformer.py``.

Composition rules (from ModelConfig), as in the reference:
  * families dense/moe/vlm/audio — a homogeneous stack of attention blocks
    (``blocks``, every leaf stacked over ``n_layers``), with per-layer
    attention windows (gemma2's local/global alternation, mixtral's SWA);
  * family ssm (RWKV-6) — the rwkv time-mix mixer + channel-mix "MLP";
  * family hybrid (RecurrentGemma) — the (rec, rec, attn) pattern grouped
    into full periods (``groups[j]`` holds pattern position j's leaves
    with a leading axis over the periods) plus a homogeneous ``tail``.

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
  quantize_model_params -> W8/W8A8 serve weights (C1 at LM scale)
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import quantize_tensor
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import rwkv6 as RW
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
    elif kind == "rwkv":
        rw = RW.init_rwkv_block(gen, cfg, stack)
        blk["mixer"] = {k: v for k, v in rw.items() if not k.startswith("cm_")}
        blk["mlp"] = {k: v for k, v in rw.items() if k.startswith("cm_")}
        return blk
    if cfg.moe is not None:
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
    return n - cfg.n_layers * (m.num_experts - m.top_k) * per_layer_expert


# ---------------------------------------------------------------------------
# block body
# ---------------------------------------------------------------------------

def _block_apply(p, x: Tensor, kind: str, cfg: ModelConfig, *,
                 positions: Tensor, window: Optional[int] = None,
                 mode: str = "train", state=None, cache_pos=None,
                 ring_window=None):
    """Residual block: norm -> mixer -> (+), norm -> mlp -> (+).

    Returns (x, aux, new_state): aux is the MoE auxiliary loss (0.0 for
    other blocks), new_state None outside decode."""
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
    elif cfg.moe is not None:
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

    def block(p, kind, window):
        def fn(x):
            x, aux, _ = _block_apply(p, x, kind, cfg, positions=positions,
                                     window=window, mode=mode)
            return x, aux
        return fn

    aux_total = 0.0
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
    layer is windowed (a ring buffer in decode).  KV is bf16, or int8 with
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
