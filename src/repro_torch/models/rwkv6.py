"""RWKV-6 "Finch" block (attention-free, data-dependent decay) —
counterpart of ``repro/models/rwkv6.py``.

Two sequence-mixing formulations, as in the reference:

  * ``wkv_sequential`` — the literal per-token recurrence
    S_t = diag(d_t) S_{t-1} + k_t v_t^T.  O(1) state; used for decode and
    as the correctness oracle.
  * ``wkv_chunked``    — the block-parallel form: within a chunk of C
    tokens the outputs come from (C x C) matmuls with pairwise decay
    factors exp(L_{t-1} - L_s) (all <= 1), and chunks are chained by a
    loop.  Used for prefill and training.

The reference folds the pairwise factor into r_t exp(L_{t-1}) and
k_s exp(-L_s); its clamp of exp(-L_s) (``maximum(-L_s, -60)``) never
acts, since -L_s >= 0, so once a channel's decay sums past ~88 within a
chunk exp(-L_s) overflows and 0 x inf makes the output NaN (a 128-token
training chunk at published widths does).  The port splits each chunk
into sub-chunks of ``SUB`` tokens.  Between sub-chunks it keeps the
factorised matmul, rebased on the later sub-chunk's start:
r_t exp(L_{t-1} - L_i) times k_s exp(L_i - L_s), both <= 1.  Within a
sub-chunk it forms each exp(L_{t-1} - L_s) <= 1 itself.  So no factor
exceeds 1: the same values to fp32 rounding where the reference's are
finite, and finite where they are not.

The token-shift gates are sigmoids, so hard-activation capable (C2).
Mixed-precision products follow the reference's promotion (a bf16
activation against an f32 parameter computes in f32).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hard_act import hard_sigmoid_star
from repro_torch.models.layers import linear
from repro_torch.models.modules import Boxed, param
from repro_torch.sharding.partition import constrain, place

Tensor = torch.Tensor


def _sigmoid(x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.hard_acts:
        return hard_sigmoid_star(x, slope=0.125, bound=3.0)
    return torch.sigmoid(x)


def _mm(a: Tensor, b: Tensor) -> Tensor:
    """a @ b in the promoted dtype of the two, as ``jnp``'s ``@`` does."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_rwkv_block(gen: torch.Generator, cfg: ModelConfig,
                    stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    d = cfg.d_model
    r = cfg.rwkv.lora_r
    rw = cfg.rwkv.lora_w
    f = cfg.d_ff
    la = ("layers",) * len(stack)
    P = lambda shape, axes, **kw: param(gen, stack + shape, la + axes, **kw)  # noqa: E731
    zeros = lambda shape, axes: P(shape, axes, init="zeros")  # noqa: E731
    return {
        # --- time mix ---
        "mu_x": zeros((d,), (None,)),             # base lerp for the ddlerp input
        "mu": zeros((5, d), (None, None)),        # per-channel mu for r,k,v,w,g
        "lora_a": P((5, d, r), (None, "embed", None), scale=d ** -0.5),
        "lora_b": zeros((5, r, d), (None, None, None)),
        "w_r": P((d, d), ("embed", "heads_d")),
        "w_k": P((d, d), ("embed", "heads_d")),
        "w_v": P((d, d), ("embed", "heads_d")),
        "w_g": P((d, d), ("embed", "heads_d")),
        "w_o": P((d, d), ("heads_d", "embed")),
        "w0": zeros((d,), (None,)),               # decay base
        "wl_a": P((d, rw), ("embed", None), scale=d ** -0.5),
        "wl_b": zeros((rw, d), (None, None)),
        "u": zeros((d,), (None,)),                # per-channel bonus
        "ln_x": P((d,), (None,), init="ones"),
        # --- channel mix ---
        "cm_mu_r": zeros((d,), (None,)),
        "cm_mu_k": zeros((d,), (None,)),
        "cm_r": P((d, d), ("embed", "mlp2")),
        "cm_k": P((d, f), ("embed", "mlp")),
        "cm_v": P((f, d), ("mlp", "embed")),
    }


# ---------------------------------------------------------------------------
# wkv core
# ---------------------------------------------------------------------------

def wkv_sequential(r, k, v, w, u, state: Optional[Tensor] = None):
    """Literal recurrence.  r,k,v: (B, T, H, N); w: (B, T, H, N) decay
    logits (d_t = exp(-exp(w))); u: (H, N).  state: (B, H, N, N) or None.
    Returns (y (B, T, H, N) f32, final_state)."""
    b, t, h, n = r.shape
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    r, k, v, w = (a.float() for a in (r, k, v, w))
    uu = u[None][..., None]
    ys = []
    for i in range(t):
        rt, kt, vt = r[:, i], k[:, i], v[:, i]            # (B, H, N)
        d = torch.exp(-torch.exp(w[:, i]))
        kv = kt[..., :, None] * vt[..., None, :]          # (B, H, N, N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rt, state + uu * kv))
        state = d[..., None] * state + kv
    return torch.stack(ys, 1), state


SUB = 16   # sub-chunk length of wkv_chunked's intra-chunk scores


def wkv_chunked(r, k, v, w, u, state: Optional[Tensor] = None,
                chunk: int = 128):
    """Block-parallel WKV.  Same signature/semantics as wkv_sequential.

    With per-channel decays d_t on the k-dim and L_t = cumsum(log d)
    within a chunk,
      y_t = r_t . (S_chunk_in * exp(L_{t-1}))            [inter-chunk]
          + sum_{s<t} (r_t exp(L_{t-1}-L_s) . k_s) v_s   [intra, strictly lower]
          + (r_t . u k_t) v_t                            [current-token bonus]
    The chunk is rounded up to whole sub-chunks of ``SUB`` tokens.  The
    intra-chunk terms of all chunks are formed at once (temporaries of
    ~24x the inputs' size); only the state is carried by a loop.
    """
    b, t, h, n = r.shape
    c = min(chunk, t)
    cs = min(SUB, c)
    c = -(-c // cs) * cs
    ns = c // cs
    pad = (-t) % c
    if pad:
        z = lambda a: F.pad(a, (0, 0, 0, 0, 0, pad))  # noqa: E731
        r, k, v = z(r), z(k), z(v)
        # decay logits padded with -1e30 => d = 1 (no decay), so the
        # chunk-final state stays valid for the prefill->decode handoff.
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=-1e30)
    nc = (t + pad) // c
    rc, kc, vc = (a.float().reshape(b, nc, c, h, n) for a in (r, k, v))
    logd = -torch.exp(w.float()).reshape(b, nc, c, h, n)   # log d_t (<= 0)
    L = torch.cumsum(logd, dim=2)                          # L_t within chunk
    Lprev = L - logd                                       # L_{t-1}
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    lower = lambda m: torch.tril(torch.ones((m, m), dtype=torch.bool,  # noqa: E731
                                            device=r.device), diagonal=-1)
    tri, before = lower(cs), lower(ns)      # s < t; sub-chunk j < i
    # Intra-chunk terms of every chunk at once (z: chunk, i/j: sub-chunk).
    rs, ks, Ls, Lps = (a.reshape(b, nc, ns, cs, h, n) for a in (rc, kc, L, Lprev))
    L0 = Lps[:, :, :, :1]                                  # L before sub-chunk i
    # s in an earlier sub-chunk j < i: r_t exp(L_{t-1} - L0_i) times
    # k_s exp(L0_i - L_s), both <= 1, contracted over n by a matmul
    q = rs * torch.exp(Lps - L0)
    gap = L0[:, :, :, None] - Ls[:, :, None]               # (B, Z, ns_i, ns_j, cs, H, N)
    kk = ks[:, :, None] * torch.exp(
        torch.where(before[:, :, None, None, None], gap, -torch.inf))
    scores = torch.einsum("bzithn,bzijshn->bzhitjs", q, kk)
    # s < t in the same sub-chunk: exp(L_{t-1} - L_s) <= 1 pairwise
    gap = Lps[:, :, :, :, None] - Ls[:, :, :, None]        # (B, Z, ns, cs, cs, H, N)
    decay = torch.exp(torch.where(tri[:, :, None, None], gap, -torch.inf))
    diag = torch.einsum("bzithn,bzitshn,bzishn->bzhits", rs, decay, ks)
    eye = torch.eye(ns, device=r.device)
    scores = (scores + torch.einsum("bzhits,ij->bzhitjs", diag, eye)
              ).reshape(b, nc, h, c, c)
    y = torch.einsum("bzhcs,bzshn->bzchn", scores, vc)
    y = y + torch.einsum("bzchn,bzchn->bzch", rc, u * kc)[..., None] * vc
    # Chunk to chunk: S' = diag(exp(L_C)) S + sum_s exp(L_C - L_s) k_s v_s,
    # and y_t += r_t exp(L_{t-1}) . S_in.
    LC = L[:, :, -1]                                       # (B, Z, H, N)
    kv = torch.einsum("bzshn,bzshm->bzhnm", kc * torch.exp(LC[:, :, None] - L), vc)
    states = []
    for z in range(nc):
        states.append(state)
        state = torch.exp(LC[:, z])[..., None] * state + kv[:, z]
    y = y + torch.einsum("bzchn,bzhnm->bzchm", rc * torch.exp(Lprev),
                         torch.stack(states, 1))
    return y.reshape(b, nc * c, h, n)[:, :t], state


def _wkv_local(r, k, v, w, u, chunk: int):
    """``wkv_chunked`` from a zero state under a mesh, on each rank's own
    batch rows and heads through ``local_map``: every (row, head) runs
    its own recurrence, so the split is exact; time stays whole.  Its
    chunked einsums over a split batch and heads have no working DTensor
    layout of their own, and one local call spares the host the dispatch
    of each of them."""
    pl = tuple(p if p in (Shard(0), Shard(2)) else Replicate()
               for p in r.placements)
    u_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in pl)
    # u's local gradient sums only this rank's rows: partial over batch
    u_grad = tuple(Partial() if p == Shard(0) else q for p, q in zip(pl, u_pl))
    s_pl = tuple(Shard(1) if p == Shard(2) else p for p in pl)
    args = [place(t, want) for t, want in zip((r, k, v, w, u),
                                             (pl,) * 4 + (u_pl,))]
    return local_map(lambda r, k, v, w, u: wkv_chunked(r, k, v, w, u, None,
                                                       chunk),
                     out_placements=(pl, s_pl),
                     in_placements=(pl,) * 4 + (u_pl,),
                     in_grad_placements=(pl,) * 4 + (u_grad,),
                     device_mesh=r.device_mesh)(*args)


# ---------------------------------------------------------------------------
# block
# ---------------------------------------------------------------------------

def _shift(x: Tensor, last: Optional[Tensor] = None) -> Tensor:
    """Token shift: x_{t-1} (zeros / ``last`` state at t=0)."""
    if last is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    if x.shape[1] > 1:
        return torch.cat([last[:, None, :], x[:, :-1]], 1)
    return last[:, None, :]


def _ddlerp(p, x: Tensor, xx: Tensor, which: int) -> Tensor:
    """Data-dependent lerp (the Finch token-shift innovation)."""
    base = x + (xx - x) * p["mu_x"]
    lora = _mm(torch.tanh(_mm(base, p["lora_a"][which])), p["lora_b"][which])
    mu = p["mu"][which] + lora
    return x + (xx - x) * mu


def time_mix_apply(p, x: Tensor, cfg: ModelConfig, mode: str = "train",
                   state: Optional[Dict[str, Tensor]] = None):
    b, t, d = x.shape
    h = d // cfg.rwkv.head_dim
    n = cfg.rwkv.head_dim
    xx = _shift(x, state["tm_shift"] if state else None)
    xr, xk, xv, xw, xg = (_ddlerp(p, x, xx, i) for i in range(5))
    r = linear(xr, p["w_r"], cfg.quant, mode).reshape(b, t, h, n)
    k = linear(xk, p["w_k"], cfg.quant, mode).reshape(b, t, h, n)
    v = linear(xv, p["w_v"], cfg.quant, mode).reshape(b, t, h, n)
    g = linear(xg, p["w_g"], cfg.quant, mode)
    g = g * _sigmoid(g, cfg)  # silu/hard-silu gate
    w = (p["w0"] + _mm(torch.tanh(_mm(xw, p["wl_a"])), p["wl_b"])
         ).reshape(b, t, h, n)
    u = p["u"].reshape(h, n)
    r = constrain(r, "batch", None, "act_heads", None)
    k = constrain(k, "batch", None, "act_heads", None)

    wkv_state = state["wkv"] if state else None
    if mode == "decode" or t == 1:
        y, s_new = wkv_sequential(r, k, v, w, u, wkv_state)
    elif isinstance(r, DTensor):
        y, s_new = _wkv_local(r, k, v, w, u, cfg.rwkv.chunk)
    else:
        y, s_new = wkv_chunked(r, k, v, w, u, wkv_state, cfg.rwkv.chunk)
    y = y.reshape(b, t, d).to(x.dtype)
    # per-head groupnorm (ln_x approximates RWKV's GroupNorm over heads)
    yh = y.reshape(b, t, h, n).float()
    yh = yh * torch.rsqrt(yh.square().mean(-1, keepdim=True) + 1e-5)
    y = (yh.reshape(b, t, d) * p["ln_x"]).to(x.dtype)
    out = linear(y * g, p["w_o"], cfg.quant, mode)
    if state is not None or mode == "decode":
        return out, {"tm_shift": x[:, -1], "wkv": s_new}
    return out


def channel_mix_apply(p, x: Tensor, cfg: ModelConfig, mode: str = "train",
                      state: Optional[Dict[str, Tensor]] = None):
    xx = _shift(x, state["cm_shift"] if state else None)
    xr = x + (xx - x) * p["cm_mu_r"]
    xk = x + (xx - x) * p["cm_mu_k"]
    r = _sigmoid(linear(xr, p["cm_r"], cfg.quant, mode), cfg)
    k = torch.square(F.relu(linear(xk, p["cm_k"], cfg.quant, mode)))
    k = constrain(k, "batch", None, "mlp")
    y = r * linear(k, p["cm_v"], cfg.quant, mode)
    if state is not None or mode == "decode":
        return y, {"cm_shift": x[:, -1]}
    return y
