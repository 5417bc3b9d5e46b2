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
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import fake_quant_tensor
from repro_torch.models.layers import act_fn, linear
from repro_torch.models.modules import Boxed, param
from repro_torch.sharding.partition import constrain, place

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


def _rows_local(fn, n_out: int, *args):
    """``fn(*args)``; under a mesh, on each rank's own batch rows (dim 0)
    with every other dim whole, through ``local_map``.  Routing, the
    dispatch scatter and the combine gather work row by row (a row is a
    dispatch group) and have no DTensor sharding strategy."""
    if not isinstance(args[0], DTensor):
        return fn(*args)
    pl = tuple(p if p == Shard(0) else Replicate()
               for p in args[0].placements)
    return local_map(fn, out_placements=(pl,) * n_out,
                     in_placements=(pl,) * len(args),
                     device_mesh=args[0].device_mesh)(*(place(a, pl)
                                                       for a in args))


def _route_logits(logits: Tensor, m, cap: int):
    """(probs, gate values, expert ids, top-1 one-hot, slots, destinations)
    from the router's f32 logits (B, T, E)."""
    b, t, _ = logits.shape
    probs = torch.softmax(logits, -1)                       # fp32, exact
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    gate_vals, expert_idx = gate_vals[..., :m.top_k], expert_idx[..., :m.top_k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    top1 = F.one_hot(expert_idx[..., 0], m.num_experts).float()

    flat_e = expert_idx.reshape(b, t * m.top_k)
    eo = F.one_hot(flat_e, m.num_experts).to(torch.int32)
    slot = (torch.cumsum(eo, 1) - 1) * eo
    slot = torch.gather(slot, 2, flat_e[..., None])[..., 0]
    dest = torch.where(slot < cap, flat_e * cap + slot,
                       torch.full_like(flat_e, m.num_experts * cap))
    return probs, gate_vals, expert_idx, top1, slot, dest


def _routing(p: Dict[str, Any], x: Tensor, cfg: ModelConfig, mode: str):
    m = cfg.moe
    logits = linear(x, p["router"], cfg.quant, mode).float()
    cap = capacity(cfg, x.shape[1])
    return _rows_local(lambda lg: _route_logits(lg, m, cap), 6, logits)


def route(p: Dict[str, Any], x: Tensor, cfg: ModelConfig, mode: str = "train"):
    """The router's decisions for x (B, T, d): (probs (B, T, E) f32, gate
    values (B, T, k) renormalised, expert ids (B, T, k), capacity slots
    (B, T*k), destinations (B, T*k) into the (E*cap + 1)-row buffer whose
    last row takes the dropped claims)."""
    probs, gate_vals, expert_idx, _, slot, dest = _routing(p, x, cfg, mode)
    return probs, gate_vals, expert_idx, slot, dest


def _dispatch(x: Tensor, dest: Tensor, top_k: int, n_experts: int,
              cap: int) -> Tensor:
    """Each token's claims scattered into its row's (E, cap, d) buffer."""
    b, t, d = x.shape
    xk = x[:, :, None, :].expand(b, t, top_k, d).reshape(b, t * top_k, d)
    buf = torch.zeros((b, n_experts * cap + 1, d), dtype=x.dtype,
                      device=x.device)
    buf.scatter_(1, dest[..., None].expand(-1, -1, d), xk)
    return buf[:, :-1].reshape(b, n_experts, cap, d)


def _combine(out: Tensor, dest: Tensor, gate_vals: Tensor,
             top_k: int) -> Tensor:
    """Gather each token's surviving claims, weighted by its gates."""
    b, d = out.shape[0], out.shape[-1]
    flat_out = torch.cat([out.reshape(b, -1, d),
                          torch.zeros((b, 1, d), dtype=out.dtype,
                                      device=out.device)], 1)
    y = torch.gather(flat_out, 1, dest[..., None].expand(-1, -1, d))
    y = y.reshape(b, -1, top_k, d)
    return torch.sum(y * gate_vals.to(y.dtype)[..., None], 2)


def moe_apply(p: Dict[str, Any], x: Tensor, cfg: ModelConfig,
              mode: str = "train") -> Tuple[Tensor, Tensor]:
    """x: (B, T, d) -> (y, aux_loss), aux_loss the Switch-style
    load-balancing loss E * sum_e(frac_tokens_e * mean_prob_e)."""
    m = cfg.moe
    cap = capacity(cfg, x.shape[1])
    probs, gate_vals, _, top1, _, dest = _routing(p, x, cfg, mode)
    aux = m.num_experts * torch.sum(top1.mean((0, 1)) * probs.mean((0, 1)))

    eb = _rows_local(lambda x, dest: _dispatch(x, dest, m.top_k,
                                               m.num_experts, cap),
                     1, x, dest)
    ep_axis = "experts" if m.expert_parallel else None
    eb = constrain(eb, "batch", ep_axis, None, None)

    # Expert FFN (batched over [group, expert]; ff dim TP-sharded)
    f = act_fn(cfg.act, cfg)
    fake_quant = mode == "train" and cfg.quant.enabled
    if fake_quant:
        wg, wu, wd = (_fq(p[k], cfg) for k in ("w_gate", "w_up", "w_down"))
        eb = eb.to(torch.promote_types(eb.dtype, wg.dtype))  # as jnp promotes
    else:
        wg, wu, wd = (_deq(p[k], x.dtype) for k in ("w_gate", "w_up", "w_down"))
    h = f(torch.einsum("becd,edf->becf", eb, wg)) * \
        torch.einsum("becd,edf->becf", eb, wu)
    if not fake_quant:
        h = constrain(h, "batch", ep_axis, None,
                      "expert_mlp" if not m.expert_parallel else None)
    out = torch.einsum("becf,efd->becd", h, wd)
    out = constrain(out, "batch", ep_axis, None, None)
    y = _rows_local(lambda out, dest, g: _combine(out, dest, g, m.top_k),
                    1, out, dest, gate_vals)
    return y, aux


def _fq(w, cfg: ModelConfig):
    """The reference's per-out-channel fake-quantised expert weight, with
    its straight-through gradient."""
    return fake_quant_tensor(w, axis=tuple(range(w.ndim - 1)),
                             p2=cfg.quant.p2_scale)


def _deq(w, dtype):
    if isinstance(w, dict):
        return w["q"].to(dtype) * w["s"].to(dtype)
    return w.to(dtype)
