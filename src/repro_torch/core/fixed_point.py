"""Fixed-point arithmetic — the paper's (a, b) quantisation datapath (C1),
on torch tensors.

Counterpart of ``repro/core/fixed_point.py``.  Paper notation: ``(a, b)`` =
``a`` fractional bits out of ``b`` total bits; the standard configuration
is ``(4, 8)``, the baseline [15] used ``(8, 16)``.

Every integer function here reproduces the reference's int32 semantics
bit for bit, including XLA's two's-complement wraparound.  Torch differs
from XLA in three places, and the code below absorbs each:

  * ``int8 @ int8`` on the CPU returns int8 and wraps, and CUDA's
    ``torch.matmul`` takes no integer tensors at all, so integer products
    are never ``torch.matmul``: :func:`int_matmul` multiplies by
    broadcasting in int64 and narrows the sum back to int32;
  * ``torch.sum`` of int32 returns int64, so sums are narrowed to int32
    (modular, like XLA's wrapping int32 adds) BEFORE the round-half-up
    shift;
  * out-of-range float -> int casts are undefined in C++, so
    :func:`quantize` clamps in float first (XLA's cast saturates and maps
    NaN to 0, which the clamp reproduces).

Rounding conventions (part of the hardware semantics):

  * ``f_round`` (Algorithm 1 line 5 / pipeline stage S5): round half up,
    ``(v + 2**(s-1)) >> s`` with an arithmetic shift;
  * the HardSigmoid* slope division is a plain arithmetic right shift
    (truncation toward −∞).
"""

from __future__ import annotations

import dataclasses
from typing import Union

import torch

Tensor = torch.Tensor
TensorLike = Union[Tensor, float, int]


@dataclasses.dataclass(frozen=True)
class FixedPointConfig:
    """The paper's ``(a, b)`` fixed-point format.

    Attributes:
      frac_bits:  ``a`` — number of fractional bits.
      total_bits: ``b`` — total width in bits (including sign).
      signed:     two's-complement when True.
    """

    frac_bits: int
    total_bits: int
    signed: bool = True

    def __post_init__(self):
        if self.total_bits < 2 or self.total_bits > 31:
            raise ValueError(f"total_bits must be in [2, 31], got {self.total_bits}")
        if self.frac_bits < 0 or self.frac_bits > self.total_bits:
            raise ValueError("frac_bits must be in [0, total_bits]")

    @property
    def int_min(self) -> int:
        return -(1 << (self.total_bits - 1)) if self.signed else 0

    @property
    def int_max(self) -> int:
        return (1 << (self.total_bits - 1)) - 1 if self.signed else (1 << self.total_bits) - 1

    @property
    def scale(self) -> float:
        """Value of one LSB: 2**-a."""
        return 2.0 ** (-self.frac_bits)

    @property
    def min_value(self) -> float:
        return self.int_min * self.scale

    @property
    def max_value(self) -> float:
        return self.int_max * self.scale

    @property
    def num_values(self) -> int:
        return 1 << self.total_bits

    @property
    def storage_dtype(self) -> torch.dtype:
        """Narrowest native dtype that stores the integer code."""
        if self.total_bits <= 8:
            return torch.int8
        if self.total_bits <= 16:
            return torch.int16
        return torch.int32

    def __str__(self) -> str:  # paper's "(a,b)" notation
        return f"({self.frac_bits},{self.total_bits})"


FXP_4_8 = FixedPointConfig(4, 8)       # this work's standard
FXP_6_8 = FixedPointConfig(6, 8)       # Table 1 variant
FXP_8_10 = FixedPointConfig(8, 10)     # Table 1 variant
FXP_8_16 = FixedPointConfig(8, 16)     # baseline [15]
FXP_8_16_ACC = FixedPointConfig(8, 16)  # product/accumulator format of (4,8)x(4,8)
FXP_8_32_ACC = FixedPointConfig(8, 32 - 1)  # wide accumulator (int32 carrier)


# ---------------------------------------------------------------------------
# Integer-domain primitives (bit-exact hardware semantics)
# ---------------------------------------------------------------------------

def wrap_int32(v: Tensor) -> Tensor:
    """Narrow an integer tensor to int32 modulo 2**32 — XLA's wrapping
    int32 arithmetic, applied once after exact int64 work."""
    return v.to(torch.int32)


def int_matmul(x: Tensor, w: Tensor) -> Tensor:
    """Integer ``(..., K) x (K, N) -> (..., N)`` int32 product with int32
    wraparound: broadcast multiply in int64, sum, narrow.  The only integer
    matmul of the port's plain paths (``torch.matmul`` is not used on
    integers)."""
    prod = x.to(torch.int64).unsqueeze(-1) * w.to(torch.int64)
    return wrap_int32(prod.sum(dim=-2))


def saturate(v: Tensor, cfg: FixedPointConfig) -> Tensor:
    """Clamp an int32 carrier to the cfg's representable integer range."""
    return torch.clamp(v, cfg.int_min, cfg.int_max)


def round_shift_right(v: Tensor, shift: int) -> Tensor:
    """Round-half-up arithmetic right shift: the paper's ``f_round`` core.

    ``(v + 2**(shift-1)) >> shift`` with the add wrapping at int32.  For
    shift == 0 it is the identity."""
    if shift == 0:
        return v
    return wrap_int32(v.to(torch.int64) + (1 << (shift - 1))) >> shift


def trunc_shift_right(v: Tensor, shift: int) -> Tensor:
    """Plain arithmetic right shift (truncation toward −∞)."""
    if shift == 0:
        return v
    return v >> shift


def requantize(v: Tensor, src: FixedPointConfig, dst: FixedPointConfig,
               rounding: str = "half_up") -> Tensor:
    """f_round: convert integer codes between fixed-point formats, e.g. the
    paper's ``mul16 (8,16) -> mul8 (4,8)``."""
    shift = src.frac_bits - dst.frac_bits
    if shift < 0:
        v = v << (-shift)
    elif rounding == "half_up":
        v = round_shift_right(v, shift)
    elif rounding == "trunc":
        v = trunc_shift_right(v, shift)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    return saturate(v, dst)


# ---------------------------------------------------------------------------
# Float <-> fixed-point conversion
# ---------------------------------------------------------------------------

def quantize(x: TensorLike, cfg: FixedPointConfig,
             rounding: str = "half_up") -> Tensor:
    """Float -> integer code (int32 carrier), saturating."""
    x = torch.as_tensor(x, dtype=torch.float32)
    scaled = x * (1 << cfg.frac_bits)
    if rounding == "half_up":
        v = torch.floor(scaled + 0.5)
    elif rounding == "nearest_even":
        v = torch.round(scaled)
    elif rounding == "trunc":
        v = torch.trunc(scaled)
    else:
        raise ValueError(f"unknown rounding {rounding!r}")
    v = torch.clamp(torch.nan_to_num(v, nan=0.0), cfg.int_min, cfg.int_max)
    return v.to(torch.int32)


def dequantize(v: Tensor, cfg: FixedPointConfig) -> Tensor:
    """Integer code -> float."""
    return v.to(torch.float32) * cfg.scale


def quantize_to_storage(x: TensorLike, cfg: FixedPointConfig) -> Tensor:
    """Float -> integer code in the narrowest native dtype."""
    return quantize(x, cfg).to(cfg.storage_dtype)


def fake_quant(x: Tensor, cfg: FixedPointConfig) -> Tensor:
    """Straight-through-estimator fake quantisation (QAT building block):
    forward ``dequantize(quantize(x))``, backward identity inside the
    representable range."""
    q = dequantize(quantize(x, cfg), cfg)
    xc = torch.clamp(x, cfg.min_value, cfg.max_value)
    return xc + (q - xc).detach()


# ---------------------------------------------------------------------------
# Fixed-point multiply / MAC (Algorithm 1 semantics)
# ---------------------------------------------------------------------------

def product_config(a: FixedPointConfig, b: FixedPointConfig) -> FixedPointConfig:
    """Format of a full-precision product: fracs add, widths add
    ((4,8)x(4,8) -> (8,16), Algorithm 1 line 4)."""
    return FixedPointConfig(a.frac_bits + b.frac_bits,
                            min(a.total_bits + b.total_bits, 31))


def fxp_mul(x: Tensor, w: Tensor, cfg_x: FixedPointConfig,
            cfg_w: FixedPointConfig) -> Tensor:
    """Integer product in the widened format (no rounding — exact)."""
    return wrap_int32(x.to(torch.int64) * w.to(torch.int64))


def fxp_mac_per_step_rounding(x: Tensor, w: Tensor,
                              cfg: FixedPointConfig) -> Tensor:
    """Algorithm 1 as printed: round every product back to (a,b) before
    accumulating, saturating at each add (the non-pipelined baseline).

    x: (..., N) codes, w: (..., N) codes -> (...,) accumulated code."""
    prod_cfg = product_config(cfg, cfg)
    x, w = torch.broadcast_tensors(x.to(torch.int32), w.to(torch.int32))
    acc = torch.zeros(x.shape[:-1], dtype=torch.int32, device=x.device)
    for k in range(x.shape[-1]):
        m8 = requantize(fxp_mul(x[..., k], w[..., k], cfg, cfg), prod_cfg, cfg)
        acc = saturate(acc + m8, cfg)
    return acc


def fxp_mac_late_rounding(x: Tensor, w: Tensor, cfg: FixedPointConfig,
                          acc_bits: int = 32) -> Tensor:
    """The pipelined-ALU datapath (S1–S5): accumulate products at full
    width, round ONCE at the end (stage S5)."""
    prod_cfg = product_config(cfg, cfg)
    acc = wrap_int32((x.to(torch.int64) * w.to(torch.int64)).sum(dim=-1))
    if acc_bits < 32:
        acc = saturate(acc, FixedPointConfig(prod_cfg.frac_bits, acc_bits))
    return requantize(acc, prod_cfg, cfg)


def fxp_matvec_late_rounding(x: Tensor, w: Tensor, bias: Tensor,
                             cfg: FixedPointConfig) -> Tensor:
    """Integer matmul + bias with late rounding: ``round(x @ w + bias_wide)``.

    x: (..., K) codes in cfg; w: (K, N) codes in cfg; bias: (N,) codes in
    the product format (2a frac bits), added into the wide accumulator
    before the single rounding."""
    prod_cfg = product_config(cfg, cfg)
    acc = wrap_int32(int_matmul(x, w).to(torch.int64) + bias.to(torch.int64))
    return requantize(acc, prod_cfg, cfg)
