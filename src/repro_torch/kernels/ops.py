"""Public wrappers over the hand-written kernels — counterpart of
``repro/kernels/ops.py``, with its names, signatures and validation.

Dispatch: ``use_kernel=True`` calls the kernel entry, which launches the
CUDA kernel for CUDA tensors (or raises) and runs its plain torch version
for CPU tensors; ``use_kernel=False`` runs the plain-torch oracle of
``kernels/ref.py``, as the reference's does.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.accelerator import AcceleratorConfig, resolve_model
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.hard_act import hard_sigmoid_star, hard_tanh
from repro_torch.kernels.quant_matmul import quant_matmul as _quant_matmul

Tensor = torch.Tensor


def qlstm_seq(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
              model: QLSTMConfig, accel: Optional[AcceleratorConfig] = None,
              use_kernel: bool = True) -> Tensor:
    """Time-major quantised LSTM layer: (T, B, M) codes -> (T, B, H) codes.

    Thin layer-level wrapper over the engines' ``layer`` entries: the fused
    kernel (``qlstm_cell.qlstm_seq``) of the ``pallas`` engine, or the
    plain-torch oracle of the ``ref`` engine with ``use_kernel=False``.
    Both implement exactly the pipelined (late-rounding) ALU with the hard
    activations; any other Table-2 point (per-step baseline ALU, LUT
    activations) raises ``BackendUnsupported`` — run it through
    ``core.qlstm.forward_int`` / ``Accelerator.infer`` (the xla engine)
    instead."""
    from repro_torch import backends
    accel = accel or AcceleratorConfig()
    m = resolve_model(model, accel, warn=False)
    reason = backends.common.supports_fused(m, accel)
    if reason is not None:
        raise backends.BackendUnsupported(
            f"qlstm_seq runs the fused layered datapath only: {reason}")
    name = "pallas" if use_kernel else "ref"
    return backends.get(name).layer(x_int, w_x, w_h, b_wide, m, accel)


def quant_matmul(x_int8: Tensor, w_int8: Tensor, use_kernel: bool = True,
                 block=(128, 128, 128)) -> Tensor:
    """(M,K) x (K,N) int8 -> int32 accumulator."""
    if not use_kernel:
        return ref.quant_matmul_ref(x_int8, w_int8)
    return _quant_matmul(x_int8, w_int8, out_mode="int32", block=block)


def quant_matmul_requant(x_int: Tensor, w_int: Tensor, cfg: FixedPointConfig,
                         use_kernel: bool = True,
                         block=(128, 128, 128)) -> Tensor:
    """Fixed-point matmul with the fused S5 requantisation."""
    if not use_kernel:
        return ref.quant_matmul_requant_ref(x_int, w_int, cfg)
    return _quant_matmul(x_int, w_int, out_mode="requant", cfg=cfg,
                         block=block)


def hard_sigmoid_star_int(x_int: Tensor, cfg: FixedPointConfig,
                          method: str = "arithmetic", slope_shift: int = 3,
                          bound: float = 3.0,
                          use_kernel: bool = True) -> Tensor:
    """Integer HardSigmoid* (paper C2), any shape of codes in ``cfg``; the
    three methods (arithmetic | 1to1 | step) are bit-identical."""
    if not use_kernel:
        return ref.hard_act_ref(x_int, cfg, method, slope_shift, bound)
    return hard_sigmoid_star(x_int, cfg=cfg, method=method,
                             slope_shift=slope_shift, bound=bound)


def hard_tanh_int(x_int: Tensor, cfg: FixedPointConfig, min_val: float = -1.0,
                  max_val: float = 1.0, use_kernel: bool = True) -> Tensor:
    """Integer HardTanh (paper C2): clip the codes at the quantised
    [min_val, max_val] thresholds."""
    if not use_kernel:
        return ref.hard_tanh_ref(x_int, cfg, min_val, max_val)
    return hard_tanh(x_int, cfg=cfg, min_val=min_val, max_val=max_val)


def mha_flash(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
              window=None, scale=None, block_q: int = 128,
              block_k: int = 128, use_kernel: bool = True) -> Tensor:
    """Multi-head (GQA) wrapper over the flash-attention kernel.

    q: (B, T, H, hd); k, v: (B, S, KV, hd) -> (B, T, H, hd)."""
    b, t, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    kr = torch.repeat_interleave(k, g, dim=2) if g > 1 else k
    vr = torch.repeat_interleave(v, g, dim=2) if g > 1 else v
    q2 = q.transpose(1, 2).reshape(b * h, t, hd)
    k2 = kr.transpose(1, 2).reshape(b * h, s, hd)
    v2 = vr.transpose(1, 2).reshape(b * h, s, hd)
    if use_kernel:
        o = flash_attention(q2, k2, v2, causal=causal, window=window,
                            scale=scale, block_q=block_q, block_k=block_k)
    else:
        o = ref.attention_ref(q2, k2, v2, causal=causal, window=window,
                              scale=scale)
    return o.reshape(b, h, t, hd).transpose(1, 2)
