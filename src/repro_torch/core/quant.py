"""Tensor-level int8 quantisation — the paper's C1 generalised to LM
scale; counterpart of the serving half of ``repro/core/quant.py``.

  * symmetric int8 codes with per-channel (weights) or per-tensor
    (activations) scales,
  * optional power-of-two scales (``p2=True``): every requantisation is a
    shift,
  * int8 KV-cache quantisation for decode.

The conventions are the reference's: round half up (``floor(v + 0.5)``)
and saturation at [-128, 127]; a power-of-two scale is rounded up as
``exp2(ceil(log2(s)))``, with log2 and exp2 computed as ``jnp`` defines
them, ``log(s) / log(2)`` and ``exp(x * ln 2)`` in the scale's own dtype.
So a bf16 "power of two" is the reference's bf16 value, not an exact one
(exp2(-4) is 0.0629883 in bf16).  ``qmatmul``'s int8 x int8 -> int32 product
runs through the port's integer GEMM (``kernels/quant_matmul.py``: the
CUDA kernel on the card, its plain version on the CPU), which equals the
reference's ``dot_general`` bit for bit.  Fake quantisation
(``fake_quant_tensor``, ``fq_matmul``) carries the reference's
straight-through gradient for LM training: identity inside the clip
range, zero outside it and one half exactly on a bound, as ``jnp.clip``
(a ``minimum`` of a ``maximum``, each splitting a tie) gives; ``torch.clamp``
would give one there.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional, Sequence

import torch

Tensor = torch.Tensor

INT8_QMAX = 127.0


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantisation policy for a module / the whole model.

    mode:
      "none"  — full precision.
      "w8"    — weight-only int8.
      "w8a8"  — weights and activations int8.
    p2_scale: round scales to powers of two (paper-faithful; requant = shift).
    per_channel: per-output-channel weight scales.
    quantize_kv: int8 KV cache (decode shapes).
    """

    mode: str = "none"
    p2_scale: bool = True
    per_channel: bool = True
    quantize_kv: bool = False
    stochastic: bool = False

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def act_quant(self) -> bool:
        return self.mode == "w8a8"


NO_QUANT = QuantConfig("none")
W8 = QuantConfig("w8")
W8A8 = QuantConfig("w8a8")


class QTensor(NamedTuple):
    """A symmetric-quantised tensor: values * scale ≈ original."""

    values: Tensor  # int8
    scale: Tensor   # f32, broadcastable against values

    @property
    def shape(self):
        return self.values.shape

    def dequantize(self) -> Tensor:
        return self.values.float() * self.scale


def _log2(x: Tensor) -> Tensor:
    """``jnp.log2``: log(x) / log(2), both in x's dtype."""
    two = torch.full((), 2.0, dtype=x.dtype, device=x.device)
    return torch.log(x) / torch.log(two)


def _exp2(x: Tensor) -> Tensor:
    """``jnp.exp2``: exp(x * ln 2), ln 2 rounded to f32 then to x's dtype
    and the product taken in x's dtype."""
    ln2 = torch.full((), float(torch.tensor(math.log(2.0), dtype=torch.float32)),
                     dtype=x.dtype, device=x.device)
    return torch.exp(x * ln2)


def _p2_round_scale(scale: Tensor) -> Tensor:
    """Round a positive scale UP to the next power of two (never clips)."""
    return _exp2(torch.ceil(_log2(scale.clamp_min(1e-30))))


def compute_scale(x: Tensor, axis: Optional[Sequence[int]] = None,
                  p2: bool = True, qmax: float = INT8_QMAX) -> Tensor:
    amax = (x.abs().amax() if axis is None
            else x.abs().amax(dim=tuple(axis), keepdim=True))
    scale = amax.clamp_min(1e-12) / qmax
    return _p2_round_scale(scale) if p2 else scale


def _codes(x: Tensor, scale: Tensor) -> Tensor:
    """Round half up and saturate to int8."""
    return torch.clamp(torch.floor(x / scale + 0.5), -128, 127).to(torch.int8)


def quantize_tensor(x: Tensor, axis: Optional[Sequence[int]] = None,
                    p2: bool = True) -> QTensor:
    """Symmetric int8 quantisation.  ``axis`` = reduction axes for the
    scale (None -> per-tensor)."""
    scale = compute_scale(x, axis=axis, p2=p2)
    return QTensor(_codes(x, scale), scale.float())


def quantize_weight(w: Tensor, cfg: QuantConfig, out_axis: int = -1) -> QTensor:
    """Per-output-channel (or per-tensor) weight quantisation."""
    if cfg.per_channel:
        axes = tuple(i for i in range(w.ndim) if i != (out_axis % w.ndim))
        return quantize_tensor(w, axis=axes, p2=cfg.p2_scale)
    return quantize_tensor(w, axis=None, p2=cfg.p2_scale)


def fake_quant_tensor(x: Tensor, axis: Optional[Sequence[int]] = None,
                      p2: bool = True) -> Tensor:
    """STE fake quantisation: forward dequant(quant(x)), backward the
    identity with saturation clipping (the scale carries no gradient)."""
    scale = compute_scale(x, axis=axis, p2=p2).detach()
    q = torch.clamp(torch.floor(x / scale + 0.5), -128, 127) * scale
    xc = torch.minimum(torch.maximum(x, -128.0 * scale), 127.0 * scale)
    return xc + (q - xc).detach()


def fq_matmul(x: Tensor, w: Tensor, cfg: QuantConfig) -> Tensor:
    """QAT-time matmul: fake-quantise the weights (per output channel, or
    per tensor) and, for w8a8, the activations per tensor, then multiply
    in float.  Differentiable through the straight-through estimator."""
    if not cfg.enabled:
        return x @ w
    wf = (fake_quant_tensor(w, axis=tuple(range(w.ndim - 1)), p2=cfg.p2_scale)
          if cfg.per_channel else fake_quant_tensor(w, p2=cfg.p2_scale))
    xf = fake_quant_tensor(x, p2=cfg.p2_scale) if cfg.act_quant else x
    return xf @ wf.to(x.dtype)


def int8_matmul(xq: Tensor, wq: Tensor) -> Tensor:
    """int8 codes (..., K) x (K, N) -> int32 accumulator (..., N), exact,
    through the port's integer GEMM (K4 on a CUDA device)."""
    from repro_torch.kernels.quant_matmul import quant_matmul
    acc = quant_matmul(xq.reshape(-1, xq.shape[-1]), wq, out_mode="int32")
    return acc.reshape(xq.shape[:-1] + wq.shape[1:])


def qmatmul(x: Tensor, wq: QTensor, cfg: QuantConfig) -> Tensor:
    """x @ w with the paper's datapath, by mode.

    w8a8: quantise x per-tensor, int8 x int8 -> int32 accumulate (late
          rounding, C3), dequantise once at the end.
    w8:   dequantise weights into the matmul (weight-only compression).
    """
    if cfg.mode == "w8a8":
        xq = quantize_tensor(x, axis=None, p2=cfg.p2_scale)
        acc = int8_matmul(xq.values, wq.values)
        return acc.float() * (xq.scale * wq.scale)
    return x @ wq.dequantize().to(x.dtype)


# ---------------------------------------------------------------------------
# KV-cache quantisation
# ---------------------------------------------------------------------------

def quantize_kv(kv: Tensor) -> QTensor:
    """Per-head int8 KV quantisation: reduce over every axis except heads
    (axis -2 of [..., seq, heads, head_dim])."""
    axes = tuple(i for i in range(kv.ndim) if i != kv.ndim - 2)
    return quantize_tensor(kv, axis=axes, p2=True)


def dequantize_kv(kvq: QTensor, dtype=torch.bfloat16) -> Tensor:
    return kvq.dequantize().to(dtype)
