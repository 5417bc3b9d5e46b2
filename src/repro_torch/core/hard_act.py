"""Hard activation functions — the paper's contribution C2, on torch
tensors.

Counterpart of ``repro/core/hard_act.py``: float-domain activations (for
the float path) and integer-domain activations with bit-exact hardware
semantics:

  * HardTanh      — clip at the quantised bounds;
  * HardSigmoid*  — slope 2**-k (bit-shiftable), saturation at ±bound, in
    three bit-identical forms: ``arithmetic`` (shift + add), ``1to1``
    (full lookup table) and ``step`` (merged step thresholds);
  * LUT Sigmoid/Tanh — the 256-entry tables of the baseline [15].

The tables are built on the host with numpy exactly as the reference
builds them (``step_table`` / ``one_to_one_table`` are numpy arrays in
both packages), and the thresholds round the way the reference rounds:
``bound_int`` with Python ``round``, the HardTanh bounds with
``floor(v * 2**a + 0.5)``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.fixed_point import (FixedPointConfig, saturate,
                                          trunc_shift_right)

Tensor = torch.Tensor

HARDSIGMOID_METHODS = ("arithmetic", "1to1", "step")


# ---------------------------------------------------------------------------
# Float domain
# ---------------------------------------------------------------------------

def hard_tanh(x: Tensor, min_val: float = -1.0, max_val: float = 1.0) -> Tensor:
    return torch.clamp(x, min_val, max_val)


def hard_sigmoid(x: Tensor) -> Tensor:
    """PyTorch HardSigmoid: relu6(x + 3) / 6 == clip(x/6 + 1/2, 0, 1)."""
    return torch.clamp(x / 6.0 + 0.5, 0.0, 1.0)


def hard_sigmoid_star(x: Tensor, slope: float = 0.125,
                      bound: float = 3.0) -> Tensor:
    """The paper's HardSigmoid*: configurable slope, saturation at ±bound,
    linear region ``[-bound, bound)``."""
    lin = x * slope + 0.5
    return torch.where(x < -bound, torch.zeros_like(x),
                       torch.where(x >= bound, torch.ones_like(x), lin))


def hard_silu(x: Tensor) -> Tensor:
    """HardSwish: x * HardSigmoid(x)."""
    return x * hard_sigmoid(x)


def hard_gelu(x: Tensor) -> Tensor:
    """Hard approximation of GELU: x * HardSigmoid(1.702 * x)."""
    return x * hard_sigmoid(1.702 * x)


def get_float_act(name: str):
    # jax.nn.gelu defaults to the tanh approximation, so "gelu" maps to it.
    return {
        "sigmoid": torch.sigmoid,
        "tanh": torch.tanh,
        "silu": F.silu,
        "gelu": functools.partial(F.gelu, approximate="tanh"),
        "gelu_tanh": functools.partial(F.gelu, approximate="tanh"),
        "relu": F.relu,
        "relu2": lambda x: torch.square(F.relu(x)),
        "hard_tanh": hard_tanh,
        "hard_sigmoid": hard_sigmoid,
        "hard_sigmoid_star": hard_sigmoid_star,
        "hard_silu": hard_silu,
        "hard_gelu": hard_gelu,
    }[name]


HARD_VARIANT = {  # soft activation -> its hard replacement
    "sigmoid": "hard_sigmoid_star",
    "tanh": "hard_tanh",
    "silu": "hard_silu",
    "gelu": "hard_gelu",
    "gelu_tanh": "hard_gelu",
    "relu": "relu",
    "relu2": "relu2",
}


# ---------------------------------------------------------------------------
# Integer domain — HardSigmoid* (three methods, bit-identical)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HardSigmoidStarSpec:
    """Fixed-point HardSigmoid* specification: slope = 2**-slope_shift,
    bound = saturation threshold (paper: 3.0)."""

    cfg: FixedPointConfig
    slope_shift: int = 3
    bound: float = 3.0

    @property
    def bound_int(self) -> int:
        return int(round(self.bound * (1 << self.cfg.frac_bits)))

    @property
    def half_int(self) -> int:  # 0.5 in (a,b)
        return 1 << (self.cfg.frac_bits - 1)

    @property
    def one_int(self) -> int:  # 1.0 in (a,b)
        return 1 << self.cfg.frac_bits


def hs_star_int_arithmetic(x_int: Tensor, spec: HardSigmoidStarSpec) -> Tensor:
    """``arithmetic`` method: truncating shift + add, then saturation
    selects (the linear segment clamped to [0, 1])."""
    x_int = x_int.to(torch.int32)
    lin = trunc_shift_right(x_int, spec.slope_shift) + spec.half_int
    lin = torch.clamp(lin, 0, spec.one_int)
    y = torch.where(x_int < -spec.bound_int, torch.zeros_like(lin),
                    torch.where(x_int >= spec.bound_int,
                                torch.full_like(lin, spec.one_int), lin))
    return saturate(y, spec.cfg)


@functools.lru_cache(maxsize=None)
def _full_table_np(spec: HardSigmoidStarSpec) -> np.ndarray:
    """Output code for every representable input code (host-side, cached)."""
    xs = np.arange(spec.cfg.int_min, spec.cfg.int_max + 1, dtype=np.int32)
    lin = np.clip((xs >> spec.slope_shift) + spec.half_int, 0, spec.one_int)
    y = np.where(xs < -spec.bound_int, 0,
                 np.where(xs >= spec.bound_int, spec.one_int, lin))
    return np.clip(y, spec.cfg.int_min, spec.cfg.int_max).astype(np.int32)


def one_to_one_table(spec: HardSigmoidStarSpec) -> np.ndarray:
    """The ``1to1`` LUT over all 2**b inputs (saturated regions folded in)."""
    return _full_table_np(spec)


def num_1to1_entries(spec: HardSigmoidStarSpec) -> int:
    """Non-trivial LUT entries (the linear region); 96 for (4,8)."""
    return 2 * spec.bound_int


@functools.lru_cache(maxsize=None)
def _step_table_np(spec: HardSigmoidStarSpec) -> Tuple[np.ndarray, np.ndarray]:
    table = _full_table_np(spec)
    xs = np.arange(spec.cfg.int_min, spec.cfg.int_max + 1, dtype=np.int32)
    change = np.nonzero(np.diff(table))[0] + 1
    outputs = np.concatenate([table[:1], table[change]])
    return xs[change].astype(np.int32), outputs.astype(np.int32)


def step_table(spec: HardSigmoidStarSpec) -> Tuple[np.ndarray, np.ndarray]:
    """The ``step`` method's merged table: (thresholds, outputs) with
    ``y(x) = outputs[sum(x >= thresholds)]``; 14 entries for (4,8).
    Built once per spec (it scans all 2**b codes), copied per call."""
    thresholds, outputs = _step_table_np(spec)
    return thresholds.copy(), outputs.copy()


def num_step_entries(spec: HardSigmoidStarSpec) -> int:
    _, outputs = step_table(spec)
    return len(outputs)


def _take(table: np.ndarray, idx: Tensor) -> Tensor:
    return torch.as_tensor(table, device=idx.device)[idx.to(torch.int64)]


def hs_star_int_1to1(x_int: Tensor, spec: HardSigmoidStarSpec) -> Tensor:
    return _take(one_to_one_table(spec),
                 x_int.to(torch.int32) - spec.cfg.int_min)


def hs_star_int_step(x_int: Tensor, spec: HardSigmoidStarSpec) -> Tensor:
    thresholds, outputs = step_table(spec)
    x = x_int.to(torch.int32)
    thr = torch.as_tensor(thresholds, device=x.device)
    # sum of comparators == the FPGA's cascaded-comparator mux.
    idx = (x.unsqueeze(-1) >= thr).sum(dim=-1)
    return _take(outputs, idx)


def hs_star_int_step_unrolled(x_int: Tensor,
                              spec: HardSigmoidStarSpec) -> Tensor:
    """``step`` as an unrolled comparator cascade — gather-free, the form
    the fused kernels use; bit-identical to :func:`hs_star_int_step`."""
    thresholds, outputs = step_table(spec)
    x = x_int.to(torch.int32)
    y = torch.full_like(x, int(outputs[0]))
    for thr, prev, nxt in zip(thresholds, outputs[:-1], outputs[1:]):
        y = y + torch.where(x >= int(thr), int(nxt) - int(prev), 0).to(torch.int32)
    return y


def hs_star_int(x_int: Tensor, spec: HardSigmoidStarSpec,
                method: str = "arithmetic") -> Tensor:
    if method == "arithmetic":
        return hs_star_int_arithmetic(x_int, spec)
    if method == "1to1":
        return hs_star_int_1to1(x_int, spec)
    if method == "step":
        return hs_star_int_step(x_int, spec)
    raise ValueError(f"unknown HardSigmoid* method {method!r}; "
                     f"expected one of {HARDSIGMOID_METHODS}")


# ---------------------------------------------------------------------------
# Integer domain — HardTanh
# ---------------------------------------------------------------------------

def hard_tanh_bounds(cfg: FixedPointConfig, min_val: float = -1.0,
                     max_val: float = 1.0) -> Tuple[int, int]:
    """The two comparator thresholds: round half up, saturate."""
    def _q(v: float) -> int:
        code = int(np.floor(v * (1 << cfg.frac_bits) + 0.5))
        return int(np.clip(code, cfg.int_min, cfg.int_max))

    return _q(min_val), _q(max_val)


def hard_tanh_int(x_int: Tensor, cfg: FixedPointConfig,
                  min_val: float = -1.0, max_val: float = 1.0) -> Tensor:
    """Two fixed-point comparators (5 LUTs on the FPGA)."""
    lo, hi = hard_tanh_bounds(cfg, min_val, max_val)
    return torch.clamp(x_int.to(torch.int32), lo, hi)


# ---------------------------------------------------------------------------
# Integer domain — baseline [15]: 256-entry LUT Sigmoid / Tanh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _lut_act_table_np(kind: str, cfg: FixedPointConfig) -> np.ndarray:
    xs = np.arange(cfg.int_min, cfg.int_max + 1, dtype=np.int32)
    xf = xs.astype(np.float64) * cfg.scale
    if kind == "sigmoid":
        yf = 1.0 / (1.0 + np.exp(-xf))
    elif kind == "tanh":
        yf = np.tanh(xf)
    else:
        raise ValueError(kind)
    y = np.floor(yf * (1 << cfg.frac_bits) + 0.5).astype(np.int32)
    return np.clip(y, cfg.int_min, cfg.int_max)


def lut_sigmoid_int(x_int: Tensor, cfg: FixedPointConfig) -> Tensor:
    """Baseline [15]: full-table sigmoid (2**b entries; 256 for b=8)."""
    return _take(_lut_act_table_np("sigmoid", cfg),
                 x_int.to(torch.int32) - cfg.int_min)


def lut_tanh_int(x_int: Tensor, cfg: FixedPointConfig) -> Tensor:
    return _take(_lut_act_table_np("tanh", cfg),
                 x_int.to(torch.int32) - cfg.int_min)
