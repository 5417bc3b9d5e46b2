"""Optimizers written out on tensors: AdamW and SGD with momentum, with
global-norm clipping and a warmup-cosine schedule.

Counterpart of ``repro/training/optimizer.py``, operation for operation
in the reference's order, so the same gradients give the same update up
to the last bit of the library functions (``cos``, ``pow``, ``sqrt``).
``torch.optim`` is not used: its AdamW orders the update differently.
The state mirrors the param tree; every tensor stays on the params'
device, the step count included, so an update never waits on the host.
Under a mesh the params and gradients are ``DTensor``s: the moments are
made in the params' placements (``zeros_like``), and the global norm sums
each leaf's partial sum of squares, which DTensor reduces across the
ranks that split the leaf, into one replicated norm.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.training.tree import tree_leaves, tree_map

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class OptConfig:
    name: str = "adamw"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


def schedule(cfg: OptConfig, step: Tensor) -> Tensor:
    """Linear warmup -> cosine decay to min_lr_frac*lr."""
    step = step.to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params, cfg: OptConfig) -> Dict[str, Any]:
    zeros = lambda: tree_map(torch.zeros_like, params)
    count = torch.zeros((), dtype=torch.int32,
                        device=tree_leaves(params)[0].device)
    if cfg.name == "adamw":
        return {"mu": zeros(), "nu": zeros(), "count": count}
    if cfg.name == "sgd":
        return {"mu": zeros(), "count": count}
    raise ValueError(cfg.name)


def clip_by_global_norm(grads, max_norm: float):
    gn = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32)))
                        for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.to(torch.float32) * scale).to(g.dtype),
                    grads), gn


@torch.no_grad()
def apply_updates(params, grads, state: Dict[str, Any], cfg: OptConfig
                  ) -> Tuple[Any, Dict[str, Any], Dict[str, Tensor]]:
    """One step: returns new params, new state and ``{"lr", "grad_norm"}``
    (tensors on the params' device); the inputs are left as they were."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    count = state["count"] + 1
    lr = schedule(cfg, count)
    if cfg.name == "adamw":
        mu = tree_map(lambda m, g: cfg.b1 * m + (1 - cfg.b1) * g.to(m.dtype),
                      state["mu"], grads)
        nu = tree_map(lambda v, g: cfg.b2 * v + (1 - cfg.b2) *
                      torch.square(g.to(v.dtype)), state["nu"], grads)
        c = count.to(torch.float32)
        bc1 = 1 - cfg.b1 ** c
        bc2 = 1 - cfg.b2 ** c

        def upd(p, m, v):
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            u = u + cfg.weight_decay * p.to(u.dtype)
            return (p.to(torch.float32) - lr * u).to(p.dtype)

        new_params = tree_map(upd, params, mu, nu)
        return new_params, {"mu": mu, "nu": nu, "count": count}, \
            {"lr": lr, "grad_norm": gnorm}
    # sgd + momentum
    mu = tree_map(lambda m, g: 0.9 * m + g.to(m.dtype), state["mu"], grads)
    new_params = tree_map(
        lambda p, m: (p.to(torch.float32) - lr * m).to(p.dtype), params, mu)
    return new_params, {"mu": mu, "count": count}, {"lr": lr, "grad_norm": gnorm}
