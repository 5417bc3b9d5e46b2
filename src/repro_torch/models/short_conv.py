"""LFM2's gated short convolution block (the ``conv`` layers of
``cfg.layer_types``), following Liquid AI's published equations:

  B, C, x = split(in_proj(h), 3)          in_proj: d -> 3d, no bias
  y = out_proj(C * conv(B * x))           out_proj: d -> d, no bias

``conv`` is depthwise and causal over ``cfg.conv_width`` taps with no
bias: ``conv(u)[t] = sum_j w[j] * u[t - (L-1) + j]``, ``u`` before the
sequence being the carried state (zeros for a new sequence).  The state
is the conv's last ``L - 1`` inputs ``B * x``; the cache keeps it in
bf16.  The taps are summed in f32 and cast to the activation dtype.

Two layouts: :func:`conv_block_apply` over a (B, T, d) batch (train,
prefill), and :func:`conv_extend` over a packed ragged chunk, each row
continuing its own carried state (``transformer.forward_extend``).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import linear
from repro_torch.models.modules import Boxed, param

Tensor = torch.Tensor


def init_conv_block(gen: Optional[torch.Generator], cfg: ModelConfig,
                    stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    d, taps = cfg.d_model, cfg.conv_width
    la = ("layers",) * len(stack)
    return {
        "in_proj": param(gen, stack + (d, 3, d), la + ("embed", None, "mlp"),
                         scale=d ** -0.5),
        "conv_w": param(gen, stack + (taps, d), la + (None, "mlp"),
                        scale=taps ** -0.5),
        "out_proj": param(gen, stack + (d, d), la + ("mlp", "embed")),
    }


def _gated_input(p, h: Tensor, cfg: ModelConfig, mode: str):
    """(B * x, C) from the block's input."""
    b, c, x = linear(h, p["in_proj"], cfg.quant, mode).unbind(-2)
    return b * x, c


def conv_block_apply(p: Dict[str, Any], h: Tensor, cfg: ModelConfig,
                     mode: str = "train", state: Optional[Tensor] = None):
    """h (B, T, d) -> (y (B, T, d), new state (B, L-1, d) in h's dtype);
    ``state``: the conv's previous L-1 inputs, zeros where None."""
    bx, c = _gated_input(p, h, cfg, mode)
    n, t, d = bx.shape
    keep = cfg.conv_width - 1
    prev = (torch.zeros((n, keep, d), dtype=bx.dtype, device=bx.device)
            if state is None else state.to(bx.dtype))
    ext = torch.cat([prev, bx], 1)
    w = p["conv_w"].float()
    conv = sum(ext[:, j:j + t].float() * w[j] for j in range(cfg.conv_width))
    y = c * conv.to(c.dtype)
    return linear(y, p["out_proj"], cfg.quant, mode), ext[:, ext.shape[1] - keep:]


def ragged_taps(lens, keep: int, device) -> Tuple[Tensor, Tensor]:
    """Gather indices for the packed conv: ``taps`` (keep + 1, N), where
    ``taps[j, n]`` is the row of ``cat([state rows, packed inputs])`` that
    tap j of packed token n reads, and ``tail`` (R * keep,) the rows that
    become each row's new state.  ``lens``: the rows' token counts (host
    ints).  The state rows come first, ``keep`` per row."""
    import numpy as np
    lens = np.asarray(lens, np.int64)
    r = len(lens)
    start = np.r_[0, np.cumsum(lens)[:-1]]
    row = np.repeat(np.arange(r), lens)
    off = np.arange(int(lens.sum())) - start[row]
    base = r * keep

    def at(row, e):
        """Row of the concatenation holding position e of a row's
        extended sequence (its ``keep`` state entries, then its tokens)."""
        return np.where(e < keep, row * keep + e, base + start[row] + e - keep)

    taps = np.stack([at(row, off + j) for j in range(keep + 1)])
    rr = np.repeat(np.arange(r), keep)
    tail = at(rr, lens[rr] + np.tile(np.arange(keep), r))
    return (torch.as_tensor(taps, device=device),
            torch.as_tensor(tail, device=device))


def conv_extend(p: Dict[str, Any], h: Tensor, cfg: ModelConfig,
                state: Tensor, taps: Tensor, tail: Tensor):
    """h (N, d) packed rows -> (y (N, d), new state (R, L-1, d) in h's
    dtype); ``state`` (R, L-1, d) each row's carried state, ``taps`` and
    ``tail`` from :func:`ragged_taps`."""
    bx, c = _gated_input(p, h, cfg, "serve")
    keep = cfg.conv_width - 1
    ext = torch.cat([state.reshape(-1, bx.shape[-1]).to(bx.dtype), bx])
    w = p["conv_w"].float()
    conv = sum(ext[taps[j]].float() * w[j] for j in range(keep + 1))
    y = c * conv.to(c.dtype)
    new = ext[tail].reshape(state.shape[0], keep, -1)
    return linear(y, p["out_proj"], cfg.quant, "serve"), new
