"""Gradient-communication compression — counterpart of
``repro/training/compress.py``.

Modes:
  * "none"  — f32 gradient flow.
  * "bf16"  — gradients cast to bf16 before cross-microbatch
              accumulation (the reference's data-parallel wire format).
  * "int8"  — error-feedback int8: g_q = round(g / s) with a per-leaf
              power-of-two scale; the residual (g - s * g_q) is carried in
              the train state and added back next step.

On one card there is no collective to shrink: the modes change the
gradient's values exactly as the reference's do, so a run trains the
same.  The int8 scale is ``exp2(ceil(log2(amax / 127)))`` with log2 and
exp2 as ``jnp`` computes them (``core.quant._log2``/``_exp2``), so the
codes equal the reference's.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from repro_torch.core.quant import _exp2, _log2
from repro_torch.training.tree import tree_leaves, tree_map


def init_error_state(params) -> Any:
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _int8(g: torch.Tensor, e: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + e
    amax = gf.abs().max().clamp_min(1e-30)
    s = _exp2(torch.ceil(_log2(amax / 127.0)))
    gq = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
    deq = gq.float() * s
    return deq, gf - deq


def compress(grads, mode: str, err_state: Optional[Any] = None
             ) -> Tuple[Any, Optional[Any]]:
    """Returns (compressed-then-decompressed grads, new error state)."""
    if mode == "none":
        return grads, err_state
    if mode == "bf16":
        return tree_map(lambda g: g.to(torch.bfloat16), grads), err_state
    if mode == "int8":
        pairs = [_int8(g, e) for g, e in zip(tree_leaves(grads),
                                             tree_leaves(err_state))]
        deq, err = iter([d for d, _ in pairs]), iter([e for _, e in pairs])
        return (tree_map(lambda _: next(deq), grads),
                tree_map(lambda _: next(err), grads))
    raise ValueError(f"unknown compression mode {mode!r}")
