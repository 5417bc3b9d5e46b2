"""RWKV-6 "Finch" block (attention-free, data-dependent decay) —
counterpart of ``repro/models/rwkv6.py``.

Two sequence-mixing formulations, as in the reference:

  * ``wkv_sequential`` — the literal per-token recurrence
    S_t = diag(d_t) S_{t-1} + k_t v_t^T.  O(1) state; used for decode and
    as the correctness oracle.
  * ``wkv_chunked``    — the block-parallel form: within a chunk of C
    tokens the outputs come from (C x C) matmuls with pairwise decay
    factors exp(L_{t-1} - L_s) (all <= 1), and chunks are chained by a
    loop.  Used for prefill.

The token-shift gates are sigmoids, so hard-activation capable (C2).
Mixed-precision products follow the reference's promotion (a bf16
activation against an f32 parameter computes in f32).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hard_act import hard_sigmoid_star
from repro_torch.models.layers import linear
from repro_torch.models.modules import Boxed, param

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


def wkv_chunked(r, k, v, w, u, state: Optional[Tensor] = None,
                chunk: int = 128):
    """Block-parallel WKV.  Same signature/semantics as wkv_sequential.

    With per-channel decays d_t on the k-dim and L_t = cumsum(log d)
    within a chunk,
      y_t = r_t . (S_chunk_in * exp(L_{t-1}))            [inter-chunk]
          + sum_{s<t} (r_t exp(L_{t-1}-L_s) . k_s) v_s   [intra, strictly lower]
          + (r_t . u k_t) v_t                            [current-token bonus]
    """
    b, t, h, n = r.shape
    c = min(chunk, t)
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
    if state is None:
        state = torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
    tri = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                     diagonal=-1)                          # strictly lower
    ys = []
    for j in range(nc):
        rb, kb, vb, Lb, ldb = rc[:, j], kc[:, j], vc[:, j], L[:, j], logd[:, j]
        Lprev = Lb - ldb                                   # L_{t-1}
        r_in = rb * torch.exp(Lprev)                       # decay from chunk start
        y_inter = torch.einsum("bchn,bhnm->bchm", r_in, state)
        # exp(-L_s) can overflow for strongly decayed channels; clamped,
        # since those channels contribute ~0 through exp(L_{t-1}).
        k_out = kb * torch.exp(torch.clamp_min(-Lb, -60.0))
        scores = torch.einsum("bchn,bshn->bhcs", r_in, k_out)
        scores = torch.where(tri[None, None], scores, 0.0)
        y_intra = torch.einsum("bhcs,bshn->bchn", scores, vb)
        bonus = torch.einsum("bchn,bchn->bch", rb, u[None, None] * kb)
        y_bonus = bonus[..., None] * vb
        # S' = diag(exp(L_C)) S + sum_s exp(L_C - L_s) k_s v_s
        LC = Lb[:, -1:]                                    # (B, 1, H, N)
        k_fold = kb * torch.exp(LC - Lb)
        state = torch.exp(LC[:, 0])[..., None] * state + \
            torch.einsum("bshn,bshm->bhnm", k_fold, vb)
        ys.append(y_inter + y_intra + y_bonus)
    y = torch.stack(ys, 1).reshape(b, nc * c, h, n)[:, :t]
    return y, state


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

    wkv_state = state["wkv"] if state else None
    if mode == "decode" or t == 1:
        y, s_new = wkv_sequential(r, k, v, w, u, wkv_state)
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
    y = r * linear(k, p["cm_v"], cfg.quant, mode)
    if state is not None or mode == "decode":
        return y, {"cm_shift": x[:, -1]}
    return y
