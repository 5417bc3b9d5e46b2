"""RecurrentGemma / Griffin recurrent block: conv1d + RG-LRU — counterpart
of ``repro/models/rglru.py``.

Block structure (Griffin):
  y = W_out( GeLU(W_gate x)  *  RGLRU(conv1d(W_x x)) )
RG-LRU:
  r_t = sigma(W_a x_t + b_a)              (recurrence gate)
  i_t = sigma(W_i x_t + b_i)              (input gate)
  log a_t = -c * r_t * softplus(Lambda)   (data-dependent decay, c = 8)
  h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

With ``cfg.hard_acts`` the gates are the paper's HardSigmoid*.  For
train and prefill the gates and inputs are computed for the whole
sequence in torch and the serial recurrence runs on the hand-written
kernel (``kernels/rglru_scan.py``, K7) for CUDA tensors, on its plain
version for CPU tensors; the reference uses an associative scan there, so
the two agree to fp32 rounding, not bit for bit.  In ``"train"`` mode the
recurrence goes through ``rglru_seq_grad``, whose backward is one more K7
launch; prefill calls the kernel plainly.  Decode keeps the O(1) state and
is plain torch, as in the reference.

The dtypes follow the reference: the conv multiplies the bf16 ``W_x x``
by the f32 conv weights, so everything from the conv to ``W_out``'s
product runs in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hard_act import hard_sigmoid_star
from repro_torch.kernels import rglru_scan as K
from repro_torch.models.layers import act_fn, linear
from repro_torch.models.modules import Boxed, param

Tensor = torch.Tensor


def _gate_sigmoid(x: Tensor, cfg: ModelConfig) -> Tensor:
    if cfg.hard_acts:  # C2: the paper's HardSigmoid* in float form
        return hard_sigmoid_star(x, slope=0.125, bound=3.0)
    return torch.sigmoid(x)


def init_rglru_block(gen: torch.Generator, cfg: ModelConfig,
                     stack: Tuple[int, ...] = ()) -> Dict[str, Boxed]:
    d, w = cfg.d_model, cfg.recurrent.lru_width
    cw = cfg.recurrent.conv_width
    la = ("layers",) * len(stack)
    return {
        "w_x": param(gen, stack + (d, w), la + ("embed", "lru")),
        "w_gate": param(gen, stack + (d, w), la + ("embed", "lru")),
        "w_out": param(gen, stack + (w, d), la + ("lru", "embed")),
        "conv_w": param(gen, stack + (cw, w), la + (None, "lru"), scale=cw ** -0.5),
        "conv_b": param(gen, stack + (w,), la + ("lru",), init="zeros"),
        "w_a": param(gen, stack + (w, w), la + ("lru", None), scale=w ** -0.5),
        "b_a": param(gen, stack + (w,), la + ("lru",), init="zeros"),
        "w_i": param(gen, stack + (w, w), la + ("lru", None), scale=w ** -0.5),
        "b_i": param(gen, stack + (w,), la + ("lru",), init="zeros"),
        "lam": param(gen, stack + (w,), la + ("lru",), init="ones"),
    }


def _decay(p, gx: Tensor, cfg: ModelConfig):
    """log a_t (negative), the input normaliser sqrt(1 - a_t^2) and the
    input gate i_t.  (The reference returns a_t = exp(log a_t) first.)"""
    c = cfg.recurrent.c_exponent
    r = _gate_sigmoid(linear(gx, p["w_a"], cfg.quant) + p["b_a"], cfg)
    i = _gate_sigmoid(linear(gx, p["w_i"], cfg.quant) + p["b_i"], cfg)
    log_a = -c * r * F.softplus(p["lam"])
    mult = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, mult, i


def rglru_scan(p, x: Tensor, cfg: ModelConfig, mode: str = "train") -> Tensor:
    """The linear recurrence over the full sequence.  x: (B, T, W) ->
    h: (B, T, W) in x's dtype; differentiable in ``"train"`` mode."""
    log_a, mult, i = _decay(p, x, cfg)
    b = mult * (i * x)
    scan = K.rglru_seq_grad if mode == "train" else K.rglru_seq
    # (T, B, W) views in, (B, T, W) out: the kernel takes strides.
    h = scan(log_a.transpose(0, 1), b.transpose(0, 1)).transpose(0, 1)
    return h.to(x.dtype)


def rglru_step(p, x_t: Tensor, h_prev: Tensor, cfg: ModelConfig) -> Tensor:
    """O(1) decode step. x_t: (B, 1, W); h_prev: (B, W)."""
    log_a, mult, i = _decay(p, x_t, cfg)
    return torch.exp(log_a)[:, 0] * h_prev + (mult * (i * x_t))[:, 0]


def _causal_conv(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Depthwise causal conv1d, width cfg.recurrent.conv_width."""
    cw = cfg.recurrent.conv_width
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = sum(xp[:, k:k + x.shape[1], :] * p["conv_w"][k] for k in range(cw))
    return y + p["conv_b"]


def rec_block_apply(p, x: Tensor, cfg: ModelConfig, mode: str = "train",
                    state: Dict[str, Tensor] = None):
    """Full Griffin recurrent block.

    train/prefill: returns y (B, T, d).
    decode: x is (B, 1, d); state {"h": (B, W), "conv": (B, cw-1, W)};
    returns (y, new_state)."""
    gate = act_fn("gelu", cfg)(linear(x, p["w_gate"], cfg.quant, mode))
    gx = linear(x, p["w_x"], cfg.quant, mode)
    if mode == "decode":
        window = torch.cat([state["conv"], gx], dim=1)          # (B, cw, W)
        dt = torch.promote_types(window.dtype, p["conv_w"].dtype)
        cx = torch.einsum("bkw,kw->bw", window.to(dt),
                          p["conv_w"].to(dt))[:, None, :] + p["conv_b"]
        h = rglru_step(p, cx, state["h"], cfg)
        y = linear(gate * h[:, None, :], p["w_out"], cfg.quant, mode)
        return y, {"h": h, "conv": window[:, 1:, :]}
    cx = _causal_conv(p, gx, cfg)
    h = rglru_scan(p, cx, cfg, mode)
    return linear(gate * h, p["w_out"], cfg.quant, mode)
