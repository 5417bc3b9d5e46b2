"""Plain-torch oracles of the kernels — counterpart of
``repro/kernels/ref.py``.

  * ``qlstm_seq_ref`` — the quantised LSTM sequence: the bit-exact
    specification the fused kernels (``kernels/qlstm_cell.py``) and the
    ``ref`` engine are held to.  Its integer products go through
    ``fixed_point.int_matmul`` (broadcast multiply, sum, narrow to int32).
  * ``qgru_seq_ref`` / ``qrglru_seq_ref`` — the quantised GRU and RG-LRU
    sequences, the oracles of ``cells/gru.py`` and ``cells/rglru.py`` (no
    kernel computes these: the reference has none).
  * ``quant_matmul_ref`` / ``quant_matmul_requant_ref`` — the integer
    GEMM with XLA's int32 accumulator, exact at any width (see
    :func:`int_matmul_exact`), and its fused S5 requantisation.
  * ``hard_act_ref`` / ``hard_tanh_ref`` — integer HardSigmoid* (all
    three methods) and HardTanh.
  * ``attention_ref`` — fp32 softmax attention with causal, window and
    padded-kv masks.
  * ``rglru_seq_ref`` — the RG-LRU's linear recurrence, sequential, fp32.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig

Tensor = torch.Tensor


# Operands are split so that no float64 partial sum leaves the 53-bit
# mantissa: with 16-bit halves every product is below 2**32 in magnitude,
# and K is summed in chunks of 2**20.
_K_CHUNK = 1 << 20


def int_matmul_exact(x: Tensor, w: Tensor) -> Tensor:
    """Integer ``(M, K) x (K, N)`` product modulo 2**32 as int32 — XLA's
    int32 dot with ``preferred_element_type=int32`` — on any device.

    ``fixed_point.int_matmul`` broadcasts an (M, K, N) int64 tensor, too
    large at LM widths, and CUDA has no integer matmul, so the product
    runs in float64 where it is exact: each operand is split into a
    signed high and an unsigned low 16-bit half (int8/int16 codes have no
    high half), each partial product is summed in K chunks, and the
    halves are recombined in int64 and narrowed once."""
    def halves(t):
        t = t.to(torch.int64)
        lo = t & 0xFFFF
        return ((t - lo) >> 16), lo

    def mm(a, b):
        acc = torch.zeros(a.shape[0], b.shape[1], dtype=torch.int64,
                          device=a.device)
        for k0 in range(0, a.shape[1], _K_CHUNK):
            acc += torch.matmul(a[:, k0:k0 + _K_CHUNK].to(torch.float64),
                                b[k0:k0 + _K_CHUNK].to(torch.float64)
                                ).to(torch.int64)
        return acc

    if x.dtype in (torch.int8, torch.int16) and \
            w.dtype in (torch.int8, torch.int16):
        return fxp.wrap_int32(mm(x, w))
    xh, xl = halves(x)
    wh, wl = halves(w)
    # x*w = xl*wl + 2**16 * (xh*wl + xl*wh) (mod 2**32); the middle term
    # is reduced to 16 bits before the shift so nothing overflows int64.
    mid = (mm(xh, wl) + mm(xl, wh)) & 0xFFFF
    return fxp.wrap_int32(mm(xl, wl) + (mid << 16))


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


def _wide(*products) -> Tensor:
    """Sum of integer products at the wide precision, wrapping at int32 as
    the reference's int32 arithmetic does: each product is an ``(a, b)``
    pair of code tensors or Python ints."""
    i64 = lambda v: v.to(torch.int64) if isinstance(v, Tensor) else v
    return fxp.wrap_int32(sum(i64(a) * i64(b) for a, b in products))


def _seq_carry(h0: Optional[Tensor], bsz: int, hdim: int,
               device: torch.device) -> Tensor:
    if h0 is None:
        return torch.zeros(bsz, hdim, dtype=torch.int32, device=device)
    return h0.to(torch.int32)


# ---------------------------------------------------------------------------
# quantised GRU oracle (cells/gru.py general datapath must match bit-exact)
# ---------------------------------------------------------------------------

def qgru_seq_ref(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
                 cfg: FixedPointConfig,
                 hs_slope_shift: int = 3, hs_bound: float = 3.0,
                 ht_min: float = -1.0, ht_max: float = 1.0,
                 h0: Optional[Tensor] = None):
    """Time-major quantised GRU sequence — pipelined datapath, hard acts.

    x_int: (T, B, M) integer codes in cfg; w_x: (M, 3H), w_h: (H, 3H)
    codes, gate order [r, z, n]; b_wide: (3H,) int32 codes at the product
    precision; h0: optional (B, H) int32 carry (zeros when omitted).

    The candidate's recurrent half ``h W_hn`` exits its own accumulator
    (one S5 rounding), is gated by ``r`` back to the wide format, added to
    the 1.0-lifted ``x W_xn + b_n`` half, and rounded once; the state mix
    ``(1-z)*n + z*h`` likewise rounds once.  Returns ``((T, B, H) int32
    hidden codes, h_last)``."""
    prod = fxp.product_config(cfg, cfg)
    spec = hard_act.HardSigmoidStarSpec(cfg, hs_slope_shift, hs_bound)
    t_len, bsz, _ = x_int.shape
    hdim = w_h.shape[0]
    one = 1 << cfg.frac_bits
    b64 = b_wide.to(torch.int64)
    h = _seq_carry(h0, bsz, hdim, x_int.device)
    hs = []
    for t in range(t_len):
        x_t = x_int[t]
        rz_acc = fxp.wrap_int32(
            fxp.int_matmul(x_t, w_x[:, :2 * hdim]).to(torch.int64)
            + fxp.int_matmul(h, w_h[:, :2 * hdim]).to(torch.int64)
            + b64[:2 * hdim])
        rz = fxp.requantize(rz_acc, prod, cfg)
        r = hard_act.hs_star_int_arithmetic(rz[:, :hdim], spec)
        z = hard_act.hs_star_int_arithmetic(rz[:, hdim:], spec)
        nh = fxp.requantize(fxp.int_matmul(h, w_h[:, 2 * hdim:]), prod, cfg)
        nx = fxp.requantize(fxp.wrap_int32(
            fxp.int_matmul(x_t, w_x[:, 2 * hdim:]).to(torch.int64)
            + b64[2 * hdim:]), prod, cfg)
        n_pre = fxp.requantize(_wide((nx, one), (r, nh)), prod, cfg)
        n = hard_act.hard_tanh_int(n_pre, cfg, ht_min, ht_max)
        h = fxp.requantize(_wide((one - z, n), (z, h)), prod, cfg)
        hs.append(h)
    return torch.stack(hs), h


# ---------------------------------------------------------------------------
# quantised RG-LRU oracle (cells/rglru.py general datapath, bit-exact)
# ---------------------------------------------------------------------------

def qrglru_seq_ref(x_int: Tensor, w_x: Tensor, w_a: Tensor, w_i: Tensor,
                   b_x: Tensor, b_a: Tensor, b_i: Tensor, lam_q: Tensor,
                   cfg: FixedPointConfig,
                   hs_slope_shift: int = 3, hs_bound: float = 3.0,
                   h0: Optional[Tensor] = None):
    """Time-major quantised RG-LRU sequence — pipelined datapath, hard acts.

    x_int: (T, B, M) codes in cfg; w_x/w_a/w_i: (M, H) codes (value,
    recurrence-gate, input-gate paths); b_x/b_a/b_i: (H,) int32 codes at
    the product precision; lam_q: (H,) codes in cfg — the pre-gated decay
    ``quantize(gate(lambda))``, baked at quantisation time; h0: optional
    (B, H) int32 carry (zeros when omitted).

    The fixed-point redefinition of Griffin's recurrence (input-only
    gates, ``a = 1 - r*lambda`` decay, convex ``a*h + (1-a)*(i*x)`` mix)::

        xp = S5( x W_x + b_x )
        r  = gate( S5( x W_a + b_a ) )
        i  = gate( S5( x W_i + b_i ) )
        a  = 1 - S5( r * lam_q )
        gx = S5( i * xp )
        h' = S5( a*h + (1-a)*gx )

    Returns ``((T, B, H) int32 hidden codes, h_last)``."""
    prod = fxp.product_config(cfg, cfg)
    spec = hard_act.HardSigmoidStarSpec(cfg, hs_slope_shift, hs_bound)
    t_len, bsz, _ = x_int.shape
    hdim = w_x.shape[1]
    one = 1 << cfg.frac_bits
    lam32 = lam_q.to(torch.int32)

    def s5(x_t, w, b):
        return fxp.requantize(fxp.wrap_int32(
            fxp.int_matmul(x_t, w).to(torch.int64) + b.to(torch.int64)),
            prod, cfg)

    h = _seq_carry(h0, bsz, hdim, x_int.device)
    hs = []
    for t in range(t_len):
        x_t = x_int[t]
        xp = s5(x_t, w_x, b_x)
        r = hard_act.hs_star_int_arithmetic(s5(x_t, w_a, b_a), spec)
        i = hard_act.hs_star_int_arithmetic(s5(x_t, w_i, b_i), spec)
        a = one - fxp.requantize(_wide((r, lam32)), prod, cfg)
        gx = fxp.requantize(_wide((i, xp)), prod, cfg)
        h = fxp.requantize(_wide((a, h), (one - a, gx)), prod, cfg)
        hs.append(h)
    return torch.stack(hs), h


# ---------------------------------------------------------------------------
# quant_matmul kernel oracle
# ---------------------------------------------------------------------------

def quant_matmul_ref(x: Tensor, w: Tensor) -> Tensor:
    """Integer codes (M, K) x (K, N) -> int32 full-precision accumulation
    (late rounding), wrapping at int32."""
    return int_matmul_exact(x, w)


def quant_matmul_requant_ref(x: Tensor, w: Tensor,
                             cfg: FixedPointConfig) -> Tensor:
    """Fixed-point mode: accumulate wide, single round-half-up shift back
    to (a,b) — pipeline stage S5.  int32 codes, like the reference's."""
    prod = fxp.product_config(cfg, cfg)
    return fxp.requantize(quant_matmul_ref(x, w), prod, cfg)


# ---------------------------------------------------------------------------
# hard_act kernel oracle
# ---------------------------------------------------------------------------

def hard_act_ref(x_int: Tensor, cfg: FixedPointConfig,
                 method: str = "arithmetic", slope_shift: int = 3,
                 bound: float = 3.0) -> Tensor:
    """Integer HardSigmoid* oracle (all three methods, bit-identical)."""
    spec = hard_act.HardSigmoidStarSpec(cfg, slope_shift, bound)
    return hard_act.hs_star_int(x_int, spec, method)


def hard_tanh_ref(x_int: Tensor, cfg: FixedPointConfig,
                  min_val: float = -1.0, max_val: float = 1.0) -> Tensor:
    """Integer HardTanh oracle: clip at the quantised thresholds."""
    return hard_act.hard_tanh_int(x_int, cfg, min_val, max_val)


# ---------------------------------------------------------------------------
# flash_attention kernel oracle
# ---------------------------------------------------------------------------

NEG_INF = -1e30


def attention_ref(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                  window: Optional[int] = None,
                  scale: Optional[float] = None) -> Tensor:
    """fp32 softmax attention.  q: (BH, T, hd), k/v: (BH, S, hd); the
    result is in q's dtype."""
    t, hd = q.shape[1], q.shape[2]
    s = k.shape[1]
    scale = hd ** -0.5 if scale is None else scale
    sc = torch.einsum("bqh,bsh->bqs", q.to(torch.float32),
                      k.to(torch.float32)) * scale
    qpos = torch.arange(t, device=q.device)[:, None]
    kpos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones(t, s, dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kpos <= qpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    sc = torch.where(mask[None], sc, torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    return torch.einsum("bqs,bsh->bqh", p, v.to(torch.float32)).to(q.dtype)


# ---------------------------------------------------------------------------
# rglru_scan kernel oracle
# ---------------------------------------------------------------------------

def rglru_seq_ref(log_a: Tensor, b: Tensor) -> Tensor:
    """h_t = exp(log_a_t) * h_{t-1} + b_t, h_{-1} = 0, over (T, B, W),
    carried in fp32; the result is in b's dtype."""
    h = torch.zeros(b.shape[1:], dtype=torch.float32, device=b.device)
    hs = []
    for t in range(b.shape[0]):
        h = torch.exp(log_a[t].float()) * h + b[t].float()
        hs.append(h)
    if not hs:
        return torch.empty_like(b)
    return torch.stack(hs).to(b.dtype)
