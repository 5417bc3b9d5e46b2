"""Plain integer LSTM: the reference that decides ``correct``.

A straightforward implementation of the paper's quantised LSTM (§4,
Algorithm 1 and the pipelined ALU) in plain torch integer operations,
written from the paper's rules and independent of the code under test:
it imports nothing of the program and is handed only the float master
weights and the float windows the benchmark made.

Semantics, for an ``(a, b)`` fixed-point format (``a`` fractional bits
of ``b``):

* quantise: ``floor(v * 2**a + 0.5)`` in float32, clamped to the code
  range; weights in ``(a, b)``, biases in the product format ``(2a,
  min(2b, 31))``;
* a product of two ``(a, b)`` codes is exact in ``2a`` fractional bits;
  rounding back to ``(a, b)`` adds ``2**(a-1)`` (wrapping at 32 bits),
  shifts right by ``a`` (arithmetic) and saturates;
* ``pipelined`` ALU: the gate pre-activation ``x W_x + h W_h + b`` is
  summed at full width and rounded once; ``per_step`` ALU (Algorithm 1
  as printed): every product is rounded to ``(a, b)`` and the running
  sum saturates at each add, inputs before the hidden state, then the
  rounded bias is added;
* HardSigmoid*: ``(x >> slope_shift) + 1/2`` clamped to [0, 1], 0 below
  ``-bound`` and 1 from ``bound`` on; HardTanh: clamp to the codes of
  ``ht_min`` and ``ht_max``;
* ``c = round(f c + i g)`` and ``h = round(o * HardTanh(c))``, each sum
  at full width with one rounding; gate order ``[i, f, g, o]``;
* the dense head on the last step's ``h`` follows the ALU mode.

All arithmetic is int64 with explicit 32-bit wrapping where the
datapath wraps.  Streams are run window after window, each stream's
``(h, c)`` carried from one window to its next, many streams at once.

A reference module gives ``predict(cfg, params, stream, k, x, device,
lower)``; a configuration file names it (``"reference": "qlstm"``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

Tensor = torch.Tensor


class Fmt:
    """An ``(a, b)`` fixed-point format: ``frac`` of ``bits`` bits, signed."""

    def __init__(self, frac: int, bits: int):
        self.frac, self.bits = int(frac), int(bits)
        self.lo = -(1 << (self.bits - 1))
        self.hi = (1 << (self.bits - 1)) - 1

    def product(self) -> "Fmt":
        return Fmt(2 * self.frac, min(2 * self.bits, 31))


def _wrap32(v: Tensor) -> Tensor:
    return ((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def quantize(v: Tensor, fmt: Fmt) -> Tensor:
    """Float values -> int64 codes (float32 arithmetic, half up, clamped)."""
    v = v.to(torch.float32) * float(1 << fmt.frac)
    v = torch.floor(v + 0.5)
    return torch.clamp(v, fmt.lo, fmt.hi).to(torch.int64)


def _round(v: Tensor, src: Fmt, dst: Fmt) -> Tensor:
    """Round codes of ``src`` to ``dst`` (fewer fractional bits): half up
    with a 32-bit wrapping add, arithmetic shift, saturate."""
    s = src.frac - dst.frac
    if s > 0:
        v = _wrap32(v + (1 << (s - 1))) >> s
    return torch.clamp(v, dst.lo, dst.hi)


def quantize_params(params: Dict[str, np.ndarray], fmt: Fmt,
                    device) -> Dict[str, Tensor]:
    """Float master weights (``w_x`` (M, 4H), ``w_h`` (H, 4H), ``b``
    (4H,), ``w_d`` (H, P), ``b_d`` (P,), one layer) -> codes."""
    wide = fmt.product()
    t = lambda k: torch.as_tensor(np.asarray(params[k], np.float32),
                                  device=device)
    return {"w_x": quantize(t("w_x"), fmt), "w_h": quantize(t("w_h"), fmt),
            "b": quantize(t("b"), wide), "w_d": quantize(t("w_d"), fmt),
            "b_d": quantize(t("b_d"), wide)}


class Model:
    """The cell's settings: ``fmt``, ``alu`` (``pipelined`` |
    ``per_step``), HardSigmoid* ``slope_shift``/``bound``, HardTanh
    ``ht_min``/``ht_max``."""

    def __init__(self, fmt: Fmt, alu: str, slope_shift: int = 3,
                 bound: float = 3.0, ht_min: float = -1.0,
                 ht_max: float = 1.0):
        if alu not in ("pipelined", "per_step"):
            raise ValueError(f"alu must be pipelined or per_step, got {alu!r}")
        self.fmt, self.alu = fmt, alu
        self.slope_shift = slope_shift
        self.bound_int = int(round(bound * (1 << fmt.frac)))
        self.half, self.one = 1 << (fmt.frac - 1), 1 << fmt.frac
        code = lambda v: int(np.clip(math.floor(v * (1 << fmt.frac) + 0.5),
                                     fmt.lo, fmt.hi))
        self.ht_lo, self.ht_hi = code(ht_min), code(ht_max)

    def hsig(self, x: Tensor) -> Tensor:
        lin = torch.clamp((x >> self.slope_shift) + self.half, 0, self.one)
        y = torch.where(x < -self.bound_int, torch.zeros_like(lin),
                        torch.where(x >= self.bound_int,
                                    torch.full_like(lin, self.one), lin))
        return torch.clamp(y, self.fmt.lo, self.fmt.hi)

    def htanh(self, x: Tensor) -> Tensor:
        return torch.clamp(x, self.ht_lo, self.ht_hi)

    def mac(self, xs: Sequence[Tensor], ws: Sequence[Tensor],
            b_wide: Tensor) -> Tensor:
        """``sum_j xs[j] @ ws[j] + b`` as the ALU computes it, (B, K_j) x
        (K_j, N) codes, the operands in order."""
        fmt, wide = self.fmt, self.fmt.product()
        if self.alu == "pipelined":
            acc = b_wide.unsqueeze(0)
            for x, w in zip(xs, ws):
                acc = acc + (x.unsqueeze(-1) * w.unsqueeze(0)).sum(dim=1)
            return _round(_wrap32(acc), wide, fmt)
        acc = torch.zeros(xs[0].shape[0], ws[0].shape[1], dtype=torch.int64,
                          device=xs[0].device)
        for x, w in zip(xs, ws):
            for k in range(w.shape[0]):
                m = _wrap32(x[:, k:k + 1] * w[k].unsqueeze(0))
                acc = torch.clamp(acc + _round(m, wide, fmt), fmt.lo, fmt.hi)
        return torch.clamp(acc + _round(b_wide, wide, fmt).unsqueeze(0),
                           fmt.lo, fmt.hi)

    def window(self, q: Dict[str, Tensor], x: Tensor, h: Tensor, c: Tensor):
        """One window per row: x (B, T, M) codes, carry (B, H) -> (y (B,
        P) codes, h, c)."""
        fmt, wide = self.fmt, self.fmt.product()
        hdim = q["w_h"].shape[0]
        for t in range(x.shape[1]):
            pre = self.mac((x[:, t], h), (q["w_x"], q["w_h"]), q["b"])
            i = self.hsig(pre[:, :hdim])
            f = self.hsig(pre[:, hdim:2 * hdim])
            g = self.htanh(pre[:, 2 * hdim:3 * hdim])
            o = self.hsig(pre[:, 3 * hdim:])
            c = _round(_wrap32(f * c + i * g), wide, fmt)
            h = _round(_wrap32(o * self.htanh(c)), wide, fmt)
        return self.mac((h,), (q["w_d"],), q["b_d"]), h, c


def run_streams(model: Model, params: Dict[str, np.ndarray],
                stream: np.ndarray, k: np.ndarray, x: np.ndarray,
                device="cpu", block: int = 16384) -> np.ndarray:
    """Output codes (n, P) for ``n`` windows: window ``j`` is window
    number ``k[j]`` (0, 1, 2, ... with no gap) of stream ``stream[j]``,
    with float inputs ``x[j]`` (T, M).  Each stream starts from the zero
    carry; its windows run in the order of ``k``.  Windows of the same
    number run together, ``block`` rows at a time."""
    q = quantize_params(params, model.fmt, device)
    n = len(stream)
    hdim = q["w_h"].shape[0]
    out = np.zeros((n, q["w_d"].shape[1]), np.int64)
    ids, dense = np.unique(stream, return_inverse=True)
    h_all = torch.zeros(len(ids), hdim, dtype=torch.int64, device=device)
    c_all = torch.zeros_like(h_all)
    order = np.lexsort((dense, k))
    k_sorted = k[order]
    bounds = np.flatnonzero(np.diff(k_sorted)) + 1
    for rows in np.split(order, bounds):
        for lo in range(0, len(rows), block):
            r = rows[lo:lo + block]
            s = torch.as_tensor(dense[r], device=device)
            xq = quantize(torch.as_tensor(x[r], device=device), model.fmt)
            y, h, c = model.window(q, xq, h_all[s], c_all[s])
            h_all[s], c_all[s] = h, c
            out[r] = y.cpu().numpy()
    return out


def model_of(cfg: Dict, lower: bool = False) -> Model:
    """The reference for a configuration file's ``model`` and
    ``accelerator`` groups, in its ``(a, b)`` format, or with ``lower``
    in the format a step below it, ``(a/2, b/2)`` (int8 codes for int16
    ones, int4 for int8: the comparison's control)."""
    mc, ac = cfg["model"], cfg["accelerator"]
    if mc["num_layers"] != 1:
        raise ValueError("the reference runs one LSTM layer")
    if mc["gate"] != "hard_sigmoid_star" or mc["cell_act"] != "hard_tanh":
        raise ValueError("the reference runs HardSigmoid* and HardTanh")
    a, b = (int(v) for v in ac["fxp"])
    if lower:
        a, b = a // 2, b // 2
    return Model(Fmt(a, b), ac["alu_mode"], slope_shift=mc["hs_slope_shift"],
                 bound=mc["hs_bound"], ht_min=ac["ht_min"],
                 ht_max=ac["ht_max"])


def predict(cfg: Dict, params: Dict[str, np.ndarray], stream: np.ndarray,
            k: np.ndarray, x: np.ndarray, device="cpu", lower: bool = False):
    """``(codes, frac)``: the output codes (n, P) of the windows (as
    :func:`run_streams`) and their fractional bits, for a configuration
    (``lower``: its control, :func:`model_of`)."""
    model = model_of(cfg, lower)
    return run_streams(model, params, stream, k, x, device=device), \
        model.fmt.frac
