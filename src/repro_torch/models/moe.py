"""Mixture-of-Experts layer: top-k routing with grouped capacity dispatch
— counterpart of ``repro/models/moe.py``.

Each batch row is a dispatch group: the slot-assignment cumsum runs over
the row's own (token, k) claims in flattened order, and claims past an
expert's capacity are dropped, exactly as in the reference.  The top-k is
a stable descending sort, so equal router probabilities keep the lower
expert index first, as ``jax.lax.top_k`` does.

The router softmax stays in fp32 and is never quantised or hardened.
Experts stored as ``{"q", "s"}`` int8 serve weights are dequantised into
the expert products (``_deq``), as in the reference; in ``"train"`` mode
with quantisation on, float experts are fake-quantised (``_fq``) and
carry the straight-through gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import fake_quant_tensor
from repro_torch.models.layers import act_fn, linear
from repro_torch.models.modules import Boxed, param

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff, m.num_experts
    la = ("layers",) * len(stack)
    return {
        "router": param(gen, stack + (d, e), la + ("embed", None)),
        "w_gate": param(gen, stack + (e, d, f), la + ("experts", "embed", "expert_mlp"),
                        scale=d ** -0.5),
        "w_up": param(gen, stack + (e, d, f), la + ("experts", "embed", "expert_mlp"),
                      scale=d ** -0.5),
        "w_down": param(gen, stack + (e, f, d), la + ("experts", "expert_mlp", "embed"),
                        scale=f ** -0.5),
    }


def capacity(cfg: ModelConfig, t: int) -> int:
    """Capacity per expert per group; short sequences get dropless
    capacity so prefill == sequential decode exactly."""
    m = cfg.moe
    return int(max(1, t * m.top_k * m.capacity_factor / m.num_experts,
                   min(t, 16)))


def route(p: Dict[str, Any], x: Tensor, cfg: ModelConfig, mode: str = "train"):
    """The router's decisions for x (B, T, d): (probs (B, T, E) f32, gate
    values (B, T, k) renormalised, expert ids (B, T, k), capacity slots
    (B, T*k), destinations (B, T*k) into the (E*cap + 1)-row buffer whose
    last row takes the dropped claims)."""
    m = cfg.moe
    b, t, _ = x.shape
    cap = capacity(cfg, t)
    logits = linear(x, p["router"], cfg.quant, mode).float()
    probs = torch.softmax(logits, -1)                       # fp32, exact
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :m.top_k], expert_idx[..., :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    flat_e = expert_idx.reshape(b, t * m.top_k)
    eo = F.one_hot(flat_e, m.num_experts).to(torch.int32)
    slot = (torch.cumsum(eo, 1) - 1) * eo
    slot = torch.gather(slot, 2, flat_e[..., None])[..., 0]
    dest = torch.where(slot < cap, flat_e * cap + slot,
                       torch.full_like(flat_e, m.num_experts * cap))
    return probs, gate_vals, expert_idx, slot, dest


def moe_apply(p: Dict[str, Any], x: Tensor, cfg: ModelConfig,
              mode: str = "train") -> Tuple[Tensor, Tensor]:
    """x: (B, T, d) -> (y, aux_loss), aux_loss the Switch-style
    load-balancing loss E * sum_e(frac_tokens_e * mean_prob_e)."""
    m = cfg.moe
    b, t, d = x.shape
    cap = capacity(cfg, t)
    probs, gate_vals, expert_idx, _, dest = route(p, x, cfg, mode)
    one_hot = F.one_hot(expert_idx[..., 0], m.num_experts).float()
    aux = m.num_experts * torch.sum(one_hot.mean((0, 1)) * probs.mean((0, 1)))

    xk = x[:, :, None, :].expand(b, t, m.top_k, d).reshape(b, t * m.top_k, d)
    buf = torch.zeros((b, m.num_experts * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), xk)
    eb = buf[:, :-1].reshape(b, m.num_experts, cap, d)

    f = act_fn(cfg.act, cfg)
    if mode == "train" and cfg.quant.enabled:
        wg, wu, wd = (_fq(p[k], cfg) for k in ("w_gate", "w_up", "w_down"))
        eb = eb.to(torch.promote_types(eb.dtype, wg.dtype))  # as jnp promotes
    else:
        wg, wu, wd = (_deq(p[k], x.dtype) for k in ("w_gate", "w_up", "w_down"))
    h = f(torch.einsum("becd,edf->becf", eb, wg)) * \
        torch.einsum("becd,edf->becf", eb, wu)
    out = torch.einsum("becf,efd->becd", h, wd)

    # Combine: gather each token's surviving claims, weight by gates.
    flat_out = torch.cat([out.reshape(b, -1, d),
                          torch.zeros((b, 1, d), dtype=out.dtype,
                                      device=out.device)], 1)
    y = torch.gather(flat_out, 1, dest[..., None].expand(-1, -1, d))
    y = y.reshape(b, t, m.top_k, d)
    return torch.sum(y * gate_vals.to(y.dtype)[..., None], 2), aux


def _fq(w, cfg: ModelConfig):
    """The reference's per-out-channel fake-quantised expert weight, with
    its straight-through gradient."""
    return fake_quant_tensor(w, axis=tuple(range(w.ndim - 1)),
                             p2=cfg.quant.p2_scale)


def _deq(w, dtype):
    if isinstance(w, dict):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)
