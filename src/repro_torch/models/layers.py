"""Transformer substrate — counterpart of ``repro/models/layers.py``:
norms, RoPE / M-RoPE, sinusoidal positions, GQA attention (windowed /
softcapped / chunked online softmax, int8 KV cache) and GLU MLPs, all
quantisation-aware (C1) and hard-activation-capable (C2).

Attention is the reference's chunked online softmax in plain torch (a
loop over q chunks, each scanning its kv blocks), with the same static
causal-triangle and sliding-window block skipping for prefill, so a long
prefill never materialises a (T, S) score matrix.  It is not a kernel:
the reference's model path computes it in ``jnp`` too, and its flash
kernel (``kernels/flash_attention.py``) is not on that path.

Under a mesh (``sharding.partition.rules_context``) attention, a decode
step's cache write and attention, and w8a8's int8 product run on each
rank's local shards through ``local_map``; ``linear`` lays out its
operands before the product.

``linear`` takes float weights or the ``{"q", "s"}`` int8 serve weights
of ``transformer.quantize_model_params``: w8 dequantises the weight into
the matmul; w8a8 quantises the activation per tensor and runs the int8 x
int8 -> int32 product through the port's integer GEMM
(``core.quant.int8_matmul``: the CUDA kernel K4 on the card, never a
plain product there).  Float weights in ``"train"`` mode with
quantisation enabled take the fake-quant product ``core.quant.fq_matmul``
(the straight-through estimator), as the reference's QAT does.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hard_act import HARD_VARIANT, get_float_act
from repro_torch.core.quant import (QuantConfig, _p2_round_scale, fq_matmul,
                                   int8_matmul)
from repro_torch.models.modules import Boxed, param
from repro_torch.sharding.partition import constrain, place

Tensor = torch.Tensor

NEG_INF = -1e30


def act_fn(name: str, cfg: ModelConfig):
    """Resolve an activation, honouring the hard_acts flag (C2)."""
    if cfg.hard_acts:
        name = HARD_VARIANT.get(name, name)
    return get_float_act(name)


# ---------------------------------------------------------------------------
# Quantisation-aware linear
# ---------------------------------------------------------------------------

def linear(x: Tensor, w, quant: QuantConfig, mode: str = "train") -> Tensor:
    """x @ w where w is a float tensor or a {"q", "s"} int8 dict (serve).
    Contraction is over x's last dim and w's first; w's extra trailing
    dims (e.g. (d, H, hd)) are flattened and restored.  The casts and
    products follow the reference's order.  Under a mesh the operands are
    laid out by :func:`_place_operands` before the product; w8a8's int8
    product runs on each rank's local operands through ``local_map``
    (K4 reads raw pointers), its row-parallel partial int32 sums
    all-reduced after, so the accumulators equal the unsharded ones bit
    for bit, and its activation scale is the global ``amax``."""
    if isinstance(w, dict):  # quantised serve weights
        wq, ws = w["q"], w["s"]
        shp = wq.shape
        w2 = wq.reshape(shp[0], -1)
        if quant.mode == "w8a8":
            # dynamic per-tensor activation quant, int8 x int8 -> int32
            s_x = x.abs().amax().clamp_min(1e-12) / 127.0
            if quant.p2_scale:
                s_x = _p2_round_scale(s_x)
            xq = torch.clamp(torch.floor(x / s_x + 0.5), -128, 127).to(torch.int8)
            acc = (_local_int8_matmul(xq, w2) if isinstance(xq, DTensor)
                   else int8_matmul(xq, w2))
            y = (acc.float() * s_x * ws.reshape(1, -1)).to(x.dtype)
        else:  # w8: dequantise weights into the matmul
            y = _product(x, w2.to(x.dtype) * ws.reshape(1, -1).to(x.dtype),
                         lambda a, b: a @ b)
        return y.reshape(x.shape[:-1] + shp[1:])
    shp = w.shape
    w2 = w.reshape(shp[0], -1).to(x.dtype)
    y = _product(x, w2, (lambda a, b: fq_matmul(a, b, quant))
                 if mode == "train" and quant.enabled else (lambda a, b: a @ b))
    return y.reshape(x.shape[:-1] + shp[1:])


def _product(x: Tensor, w2: Tensor, mm) -> Tensor:
    """``mm(x, w2)``; under a mesh with the operands laid out first."""
    if not isinstance(x, DTensor):
        return mm(x, w2)
    x, w2, out_pl = _place_operands(x, w2)
    return place(mm(x, w2), out_pl)


def _local_int8_matmul(xq: DTensor, w2: DTensor) -> DTensor:
    """``int8_matmul`` under a mesh: the operands laid out as
    :func:`_place_operands` lays out a float product, the int32 product
    of each rank's local blocks (K4 on the card), and where the weight is
    split by contraction row, each rank's partial sums all-reduced
    (int32 addition wraps alike in any order)."""
    xq, w2, out_pl = _place_operands(xq, w2)
    local_pl = tuple(Partial() if wp == Shard(0) else p
                     for p, wp in zip(out_pl, w2.placements))
    acc = local_map(int8_matmul, out_placements=(local_pl,),
                    in_placements=(tuple(xq.placements), tuple(w2.placements)),
                    device_mesh=xq.device_mesh)(xq, w2)
    return place(acc, out_pl)


def _place_operands(x: DTensor, w2: DTensor):
    """Lay out x @ w2 under a mesh before the product: per mesh axis, x
    split along a leading dim keeps it and takes the whole weight (FSDP's
    gather); a weight split by output column keeps it with x whole
    (column-parallel); a weight split by contraction row takes x split
    likewise (row-parallel; the partial sums are all-reduced after).
    Returns (x, w2, the product's placements).  Left to itself DTensor may
    split the flattened output over an axis that the unflattened dims
    cannot take (2 KV heads over 4-way TP), which GSPMD pads and DTensor
    refuses, in the forward or in the gradient's view back."""
    last = x.ndim - 1
    xpl, wpl, ypl = [], [], []
    for xp, wp in zip(x.placements, w2.placements):
        if isinstance(xp, Shard) and xp.dim < last:
            xpl.append(xp), wpl.append(Replicate()), ypl.append(xp)
        elif wp == Shard(1):
            xpl.append(Replicate()), wpl.append(wp), ypl.append(Shard(last))
        elif wp == Shard(0):
            xpl.append(Shard(last)), wpl.append(wp), ypl.append(Replicate())
        else:
            xpl.append(Replicate()), wpl.append(Replicate())
            ypl.append(Replicate())
    return place(x, xpl), place(w2, wpl), tuple(ypl)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(gen: torch.Generator, cfg: ModelConfig,
              stack: Tuple[int, ...] = ()) -> Boxed:
    axes = ("layers",) * len(stack) + (None,)
    init = "zeros" if cfg.norm == "gemma_rmsnorm" else "ones"
    return param(gen, stack + (cfg.d_model,), axes, init=init)


def norm_apply(w: Tensor, x: Tensor, cfg: ModelConfig) -> Tensor:
    """The config's norm over x's last dim with ``cfg.norm_eps``, in f32,
    cast back to x's dtype."""
    eps = cfg.norm_eps
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps) * w
    else:
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        y = y * (1.0 + w) if cfg.norm == "gemma_rmsnorm" else y * w
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def _rope_angles(positions: Tensor, dim: int,
                 theta: float) -> Tuple[Tensor, Tensor]:
    """positions (...,) -> cos/sin (..., dim/2), in float32."""
    freq = theta ** (-torch.arange(0, dim, 2, dtype=torch.float32,
                                   device=positions.device) / dim)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: Tensor, positions: Tensor, theta: float,
               mrope_sections: Optional[Tuple[int, ...]] = None) -> Tensor:
    """x: (B, T, H, hd); positions: (B, T) or, for M-RoPE, (3, B, T).
    Rotates the two halves of hd.

    M-RoPE (Qwen2-VL): the head_dim's frequency slots are partitioned into
    sections, each rotated by its own positional stream (temporal /
    height / width)."""
    hd = x.shape[-1]
    if mrope_sections is not None:
        cos3, sin3 = _rope_angles(positions, hd, theta)  # (3, B, T, hd/2)
        parts_c, parts_s = [], []
        off = 0
        for i, sec in enumerate(mrope_sections):
            parts_c.append(cos3[i, ..., off:off + sec])
            parts_s.append(sin3[i, ..., off:off + sec])
            off += sec
        cos, sin = torch.cat(parts_c, -1), torch.cat(parts_s, -1)
    else:
        cos, sin = _rope_angles(positions, hd, theta)    # (B, T, hd/2)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     -1).to(x.dtype)


def sinusoidal_embedding(positions: Tensor, dim: int) -> Tensor:
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig,
              stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    la = ("layers",) * len(stack)
    p = {
        "wq": param(gen, stack + (d, h, hd), la + ("embed", "heads", "head_dim"),
                    scale=d ** -0.5),
        "wk": param(gen, stack + (d, kv, hd), la + ("embed", "kv_heads", "head_dim"),
                    scale=d ** -0.5),
        "wv": param(gen, stack + (d, kv, hd), la + ("embed", "kv_heads", "head_dim"),
                    scale=d ** -0.5),
        "wo": param(gen, stack + (h * hd, d), la + ("heads", "embed"),
                    scale=(h * hd) ** -0.5),
    }
    if cfg.attn and cfg.attn.qk_norm:
        p["q_norm"] = param(gen, stack + (hd,), la + (None,), init="ones")
        p["k_norm"] = param(gen, stack + (hd,), la + (None,), init="ones")
    if cfg.attn and cfg.attn.qkv_bias:
        p["bq"] = param(gen, stack + (h, hd), la + ("heads", "head_dim"), init="zeros")
        p["bk"] = param(gen, stack + (kv, hd), la + ("kv_heads", "head_dim"), init="zeros")
        p["bv"] = param(gen, stack + (kv, hd), la + ("kv_heads", "head_dim"), init="zeros")
    return p


def _softcap(scores: Tensor, cap: Optional[float], hard: bool) -> Tensor:
    if cap is None:
        return scores
    if hard:
        return torch.clamp(scores, -cap, cap)
    return cap * torch.tanh(scores / cap)


def _attn_q_chunk(qb: Tensor, qi: int, j_lo: int, kg: Tensor, vg: Tensor, *,
                  qc: int, kc: int, scale: float, softcap, hard_softcap: bool,
                  causal: bool, window: Optional[int], s_valid: int,
                  q_offset: int, ksg: Optional[Tensor] = None,
                  vsg: Optional[Tensor] = None) -> Tensor:
    """Online-softmax attention of ONE q chunk against kv blocks
    [j_lo, j_lo + kg.shape[1]).  qb: (B, qc, KV, g, hd); kg/vg:
    (B, nj, kc, KV, hd); ksg/vsg: (B, nj, kc, KV) int8-KV scales or None.
    Returns (B, qc, KV, g, hd) in fp32."""
    b, _, kvh, g, hd = qb.shape
    dev = qb.device
    qpos = q_offset + qi * qc + torch.arange(qc, device=dev)
    qf = qb.float()
    m = torch.full((b, kvh, g, qc), -math.inf, device=dev)
    l = torch.zeros((b, kvh, g, qc), device=dev)
    acc = torch.zeros((b, kvh, g, qc, hd), device=dev)
    for jj in range(kg.shape[1]):
        kpos = (j_lo + jj) * kc + torch.arange(kc, device=dev)
        sc = torch.einsum("bqkgh,bskh->bkgqs", qf, kg[:, jj].float()) * scale
        if ksg is not None:
            sc = sc * ksg[:, jj].transpose(1, 2)[:, :, None, None, :]
        sc = _softcap(sc, softcap, hard_softcap)
        mask = kpos[None, :] < s_valid
        if causal:
            mask = mask & (kpos[None, :] <= qpos[:, None])
        if window is not None:
            mask = mask & ((qpos[:, None] - kpos[None, :]) < window)
        sc = torch.where(mask, sc, NEG_INF)
        m_new = torch.maximum(m, sc.amax(-1))
        p = torch.exp(sc - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        if vsg is not None:
            p = p * vsg[:, jj].transpose(1, 2)[:, :, None, None, :]
        acc = acc * corr[..., None] + torch.einsum(
            "bkgqs,bskh->bkgqh", p, vg[:, jj].float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, hard_softcap: bool = False,
                    scale: float = 1.0, q_offset: int = 0,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    kv_valid_len: Optional[int] = None,
                    k_scale: Optional[Tensor] = None,
                    v_scale: Optional[Tensor] = None) -> Tensor:
    """Chunked online-softmax attention.

    q: (B, T, H, hd); k, v: (B, S, KV, hd); GQA via head grouping.  Key s
    is kept for query t when ``s < kv_valid_len``, ``s <= t`` (causal,
    positions offset by ``q_offset``) and ``t - s < window``.
    k_scale/v_scale (B, S, KV): int8-KV dequantisation scales — k's folds
    into the scores, v's into the softmax weights, so the cache is only
    read as int8.  Returns (B, T, H, hd) in q's dtype, accumulated in
    fp32."""
    b, t, h, hd = q.shape
    s, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qc = min(q_chunk, t)
    kc = min(kv_chunk, s)
    tp, sp = -t % qc, -s % kc
    if tp:
        q = F.pad(q, (0, 0, 0, 0, 0, tp))
    if sp:
        k = F.pad(k, (0, 0, 0, 0, 0, sp))
        v = F.pad(v, (0, 0, 0, 0, 0, sp))
        if k_scale is not None:
            k_scale = F.pad(k_scale, (0, 0, 0, sp))
            v_scale = F.pad(v_scale, (0, 0, 0, sp))
    nq, nk = (t + tp) // qc, (s + sp) // kc
    qg = q.reshape(b, nq, qc, kvh, g, hd)
    kg = k.reshape(b, nk, kc, kvh, hd)
    vg = v.reshape(b, nk, kc, kvh, hd)
    kw = dict(qc=qc, kc=kc, scale=scale, softcap=softcap,
              hard_softcap=hard_softcap, window=window,
              s_valid=s if kv_valid_len is None else kv_valid_len)
    if k_scale is not None:
        kw.update(ksg=k_scale.reshape(b, nk, kc, kvh),
                  vsg=v_scale.reshape(b, nk, kc, kvh))

    # Causal-triangle path (prefill: t == s, no offset): per-q-chunk static
    # kv bounds skip the strictly-future blocks, and a sliding window also
    # skips the wholly expired past ones.
    if (causal and t == s and tp == 0 and sp == 0 and q_offset == 0
            and kv_valid_len is None and k_scale is None):
        outs = []
        for qi in range(nq):
            j_hi = ((qi + 1) * qc + kc - 1) // kc
            j_lo = 0 if window is None else max(0, (qi * qc - window + 1) // kc)
            outs.append(_attn_q_chunk(qg[:, qi], qi, j_lo, kg[:, j_lo:j_hi],
                                      vg[:, j_lo:j_hi], causal=True,
                                      q_offset=0, **kw))
        return torch.stack(outs, 1).reshape(b, t, h, hd).to(q.dtype)

    outs = [_attn_q_chunk(qg[:, qi], qi, 0, kg, vg, causal=causal,
                          q_offset=q_offset, **kw) for qi in range(nq)]
    out = torch.stack(outs, 1).reshape(b, t + tp, h, hd)
    return out[:, :t].to(q.dtype)


def _q8(t: Tensor) -> Tuple[Tensor, Tensor]:
    """(B, 1, KV, hd) f32 -> int8 codes and (B, 1, KV) f32 scales, one
    scale per (token, head), rounded half up."""
    s_ = t.abs().amax(-1).clamp_min(1e-6) / 127.0
    tq = torch.clamp(torch.floor(t / s_[..., None] + 0.5), -128, 127)
    return tq.to(torch.int8), s_


def attn_apply(p: Dict[str, Any], x: Tensor, positions: Tensor, *,
               cfg: ModelConfig, window: Optional[int] = None,
               mode: str = "train", cache: Optional[Dict[str, Tensor]] = None,
               cache_pos: Optional[int] = None,
               ring_window: Optional[int] = None):
    """GQA attention block body.

    train/prefill: full-sequence causal (chunked), returns y.  decode: x is
    (B, 1, d); the cache {"k", "v"}, each (B, Smax, KV, hd), is written at
    ``cache_pos`` (``cache_pos % ring_window`` for a ring-buffer cache) into
    a new tensor; returns (y, new_cache).  An int8 cache also holds
    {"k_scale", "v_scale"}, each (B, Smax, KV): each new token's k and v
    are stored as per-(token, head) symmetric int8 with their scales."""
    a = cfg.attn
    scale = (a.query_scale or cfg.head_dim ** -0.5) if a else cfg.head_dim ** -0.5
    q = linear(x, p["wq"], cfg.quant, mode)
    k = linear(x, p["wk"], cfg.quant, mode)
    v = linear(x, p["wv"], cfg.quant, mode)
    if a and a.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    if a and a.qk_norm:
        q, k = qk_norm(p, q, k, cfg)
    if not (a and a.sinusoidal):
        q = apply_rope(q, positions, a.rope_theta, a.mrope_sections)
        k = apply_rope(k, positions, a.rope_theta, a.mrope_sections)
    q = constrain(q, "batch", None, "act_heads", None)
    k = constrain(k, "batch", None, "act_heads", None)
    softcap = a.attn_softcap if a else None

    if mode == "decode":
        s_cache = cache["k"].shape[1]
        attend = functools.partial(
            flash_attention, causal=False,
            window=None if ring_window else window, softcap=softcap,
            hard_softcap=cfg.hard_acts, scale=scale, q_offset=cache_pos,
            kv_valid_len=min(cache_pos + 1, s_cache), q_chunk=1,
            kv_chunk=min(4096, s_cache))
        slot = cache_pos % ring_window if ring_window else cache_pos
        step = functools.partial(_decode_write_attend, attend, slot)
        out, st = (_local_decode(step, q, k, v, cache)
                   if isinstance(q, DTensor) else step(q, k, v, cache))
        y = linear(out.reshape(*x.shape[:2], -1), p["wo"], cfg.quant, mode)
        return y, st

    attend = functools.partial(flash_attention, causal=True, window=window,
                               softcap=softcap, hard_softcap=cfg.hard_acts,
                               scale=scale)
    out = (_local_attention(attend, q, k, v) if isinstance(q, DTensor)
           else attend(q, k, v))
    return linear(out.reshape(*x.shape[:2], -1), p["wo"], cfg.quant, mode)


def qk_norm(p: Dict[str, Any], q: Tensor, k: Tensor, cfg: ModelConfig):
    """Per-head RMSNorm of q and k over head_dim (LFM2), before RoPE."""
    return norm_apply(p["q_norm"], q, cfg), norm_apply(p["k_norm"], k, cfg)


def _decode_write_attend(attend, slot: int, q: Tensor, k: Tensor, v: Tensor,
                         cache: Dict[str, Tensor]):
    """One decode step's attention: the new token's k and v written at
    ``slot`` of a copy of the cache (int8 codes and their scales for an
    int8 cache), then ``attend(q, k_cache, v_cache)``.  Returns (out, the
    new cache)."""
    st = dict(cache)
    idx = torch.tensor([slot], device=q.device)
    kscale = vscale = None
    if st["k"].dtype == torch.int8:
        # C1 on the cache: per-(token, head) symmetric int8
        kq, ks_new = _q8(k.float())
        vq, vs_new = _q8(v.float())
        st["k"] = st["k"].index_copy(1, idx, kq)
        st["v"] = st["v"].index_copy(1, idx, vq)
        st["k_scale"] = kscale = st["k_scale"].index_copy(1, idx, ks_new)
        st["v_scale"] = vscale = st["v_scale"].index_copy(1, idx, vs_new)
    else:
        st["k"] = st["k"].index_copy(1, idx, k.to(st["k"].dtype))
        st["v"] = st["v"].index_copy(1, idx, v.to(st["v"].dtype))
    return attend(q, st["k"], st["v"], k_scale=kscale, v_scale=vscale), st


def _local_decode(step, q: DTensor, k: DTensor, v: DTensor,
                  cache: Dict[str, DTensor]):
    """``step(q, k, v, cache)`` under a mesh, on each rank's own batch rows
    and kv-head groups through ``local_map``, per mesh axis as the cache
    is laid out: a cache split by batch or by kv heads keeps its split
    (q's heads follow k's in whole GQA groups); a cache split along its
    sequence (``kv_seq``) is gathered whole before the step — an
    all-gather of the layer's cache that the collective counters see —
    and the new cache is split again after it (a local slice).  Returns
    (out, the new cache in the cache's placements)."""
    keys = list(cache)
    held = tuple(cache["k"].placements)
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in held)

    def local(q, k, v, *entries):
        out, st = step(q, k, v, dict(zip(keys, entries)))
        return (out, *(st[n] for n in keys))
    run = local_map(local, out_placements=(pl,) * (1 + len(keys)),
                    in_placements=(pl,) * (3 + len(keys)),
                    device_mesh=q.device_mesh)
    out, *new = run(*(place(t, pl) for t in (q, k, v)),
                    *(place(cache[n], pl) for n in keys))
    return out, {n: place(t, held) for n, t in zip(keys, new)}


def _local_attention(attend, q: DTensor, k: DTensor, v: DTensor) -> DTensor:
    """``attend(q, k, v)`` under a mesh, on each rank's own batch rows and
    kv-head groups through ``local_map``: heads stay split where q's and
    k's both are (their blocks then hold whole GQA groups), the sequence
    whole.  Elsewhere the heads are gathered: a split of q's heads that
    k's fewer heads cannot follow has no DTensor layout."""
    pl = []
    for qp, kp in zip(q.placements, k.placements):
        if qp == Shard(0) or (qp == Shard(2) and kp == Shard(2)):
            pl.append(qp)
        else:
            pl.append(Replicate())
    pl = tuple(pl)
    return local_map(attend, out_placements=(pl,), in_placements=(pl, pl, pl),
                     device_mesh=q.device_mesh)(*(place(t, pl)
                                                  for t in (q, k, v)))


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    d, f = cfg.d_model, cfg.d_ff
    la = ("layers",) * len(stack)
    if cfg.mlp_type in ("swiglu", "geglu"):
        return {
            "w_gate": param(gen, stack + (d, f), la + ("embed", "mlp")),
            "w_up": param(gen, stack + (d, f), la + ("embed", "mlp")),
            "w_down": param(gen, stack + (f, d), la + ("mlp", "embed")),
        }
    return {
        "w_up": param(gen, stack + (d, f), la + ("embed", "mlp")),
        "w_down": param(gen, stack + (f, d), la + ("mlp", "embed")),
    }


def mlp_apply(p: Dict[str, Any], x: Tensor, cfg: ModelConfig,
              mode: str = "train") -> Tensor:
    f = act_fn(cfg.act, cfg)
    if cfg.mlp_type in ("swiglu", "geglu"):
        h = f(linear(x, p["w_gate"], cfg.quant, mode)) * \
            linear(x, p["w_up"], cfg.quant, mode)
    else:
        h = f(linear(x, p["w_up"], cfg.quant, mode))
    h = constrain(h, "batch", None, "mlp")
    return linear(h, p["w_down"], cfg.quant, mode)
