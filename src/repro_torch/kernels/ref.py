"""Plain-torch oracle of the quantised LSTM sequence.

Counterpart of ``repro/kernels/ref.py::qlstm_seq_ref``: the bit-exact
specification the fused kernels (``kernels/qlstm_cell.py``) and the
``ref`` engine are held to.  Integer products go through
``fixed_point.int_matmul`` (broadcast multiply, sum, narrow to int32).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig

Tensor = torch.Tensor


def qlstm_seq_ref(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
                  cfg: FixedPointConfig,
                  hs_slope_shift: int = 3, hs_bound: float = 3.0,
                  ht_min: float = -1.0, ht_max: float = 1.0,
                  h0: Optional[Tensor] = None, c0: Optional[Tensor] = None,
                  return_state: bool = False):
    """Time-major quantised LSTM sequence — the paper's pipelined datapath.

    x_int: (T, B, M) integer codes in cfg; w_x: (M, 4H), w_h: (H, 4H)
    codes, gate order [i, f, g, o]; b_wide: (4H,) int32 codes at the
    product precision; h0/c0: optional (B, H) int32 carry (zeros when
    omitted).  Returns (T, B, H) int32 codes of every hidden state; with
    ``return_state=True``, ``(hs, (h_last, c_last))``."""
    prod = fxp.product_config(cfg, cfg)
    spec = hard_act.HardSigmoidStarSpec(cfg, hs_slope_shift, hs_bound)
    t_len, bsz, _ = x_int.shape
    hdim = w_h.shape[0]
    zeros = lambda: torch.zeros(bsz, hdim, dtype=torch.int32,
                                device=x_int.device)
    h = zeros() if h0 is None else h0.to(torch.int32)
    c = zeros() if c0 is None else c0.to(torch.int32)
    b64 = b_wide.to(torch.int64)
    hs = []
    for t in range(t_len):
        acc = fxp.wrap_int32(fxp.int_matmul(x_int[t], w_x).to(torch.int64)
                             + fxp.int_matmul(h, w_h).to(torch.int64) + b64)
        pre = fxp.requantize(acc, prod, cfg)
        i = hard_act.hs_star_int_arithmetic(pre[:, :hdim], spec)
        f = hard_act.hs_star_int_arithmetic(pre[:, hdim:2 * hdim], spec)
        g = hard_act.hard_tanh_int(pre[:, 2 * hdim:3 * hdim], cfg, ht_min, ht_max)
        o = hard_act.hs_star_int_arithmetic(pre[:, 3 * hdim:], spec)
        c = fxp.requantize(f * c + i * g, prod, cfg)
        h = fxp.requantize(o * hard_act.hard_tanh_int(c, cfg, ht_min, ht_max),
                           prod, cfg)
        hs.append(h)
    out = torch.stack(hs)
    if return_state:
        return out, (h, c)
    return out
