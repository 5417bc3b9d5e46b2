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

Under a mesh (``sharding.partition.rules_context``) the operands are
``DTensor``s and the kernel, which reads raw pointers and strides, runs
on each rank's local shards through ``local_map``: the recurrence is
independent across batch and width, so batch split over ``data`` and W
over ``model`` (``"lru"``) give the exact result; time stays whole.  The
Function's backward runs inside the same ``local_map``.

The dtypes follow the reference: the conv multiplies the bf16 ``W_x x``
by the f32 conv weights, so everything from the conv to ``W_out``'s
product runs in f32.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.core.hard_act import hard_sigmoid_star
from repro_torch.kernels import rglru_scan as K
from repro_torch.models.layers import act_fn, linear
from repro_torch.models.modules import Boxed, param
from repro_torch.sharding.partition import constrain, place

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

    def run(log_a, b):
        # (T, B, W) views in, (B, T, W) out: the kernel takes strides.
        return scan(log_a.transpose(0, 1), b.transpose(0, 1)).transpose(0, 1)

    if isinstance(b, DTensor):
        log_a = constrain(log_a, "batch", None, "lru")
        b = constrain(b, "batch", None, "lru")
        pl = tuple(b.placements)       # the rules keep time ("seq") whole
        run = local_map(run, out_placements=(pl,), in_placements=(pl, pl),
                        device_mesh=b.device_mesh)
    return run(log_a, b).to(x.dtype)


def rglru_step(p, x_t: Tensor, h_prev: Tensor, cfg: ModelConfig) -> Tensor:
    """O(1) decode step. x_t: (B, 1, W); h_prev: (B, W)."""
    log_a, mult, i = _decay(p, x_t, cfg)
    return torch.exp(log_a)[:, 0] * h_prev + (mult * (i * x_t))[:, 0]


def _conv(x: Tensor, w: Tensor, b: Tensor) -> Tensor:
    cw = w.shape[0]
    xp = F.pad(x, (0, 0, cw - 1, 0))
    y = sum(xp[:, k:k + x.shape[1], :] * w[k] for k in range(cw))
    return y + b


def _causal_conv(p, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Depthwise causal conv1d, width cfg.recurrent.conv_width.  Under a
    mesh it runs on each rank's own rows and channels through
    ``local_map`` (each channel's conv is its own; time stays whole): the
    padded, shifted products have no dependable DTensor layout (torch
    2.11 lost a mesh dim of the padded tensor's placements)."""
    if not isinstance(x, DTensor):
        return _conv(x, p["conv_w"], p["conv_b"])
    pl = tuple(x.placements)
    w_pl = tuple(Shard(1) if q == Shard(2) else Replicate() for q in pl)
    b_pl = tuple(Shard(0) if q == Shard(2) else Replicate() for q in pl)
    # the weights' local gradients sum only this rank's rows
    row = lambda q, w: Partial() if q == Shard(0) else w  # noqa: E731
    return local_map(_conv, out_placements=(pl,),
                     in_placements=(pl, w_pl, b_pl),
                     in_grad_placements=(pl, tuple(map(row, pl, w_pl)),
                                         tuple(map(row, pl, b_pl))),
                     device_mesh=x.device_mesh)(
        x, place(p["conv_w"], w_pl), place(p["conv_b"], b_pl))


def rec_block_apply(p, x: Tensor, cfg: ModelConfig, mode: str = "train",
                    state: Dict[str, Tensor] = None):
    """Full Griffin recurrent block.

    train/prefill: returns y (B, T, d).
    decode: x is (B, 1, d); state {"h": (B, W), "conv": (B, cw-1, W)};
    returns (y, new_state)."""
    gate = act_fn("gelu", cfg)(linear(x, p["w_gate"], cfg.quant, mode))
    gx = linear(x, p["w_x"], cfg.quant, mode)
    gx = constrain(gx, "batch", None, "lru")
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
