"""The paper's model: quantised LSTM (+ dense head), on torch tensors.

Counterpart of ``repro/core/qlstm.py``, with its three datapaths:

  1. ``forward_float`` — the float training/eval path with selectable
     activations (exact Sigmoid/Tanh, the baseline's LUT semantics, or
     the paper's HardSigmoid*/HardTanh).
  2. ``forward_qat`` — the float path with straight-through fake-quant at
     every point the hardware rounds (quantisation-aware training, §6.1),
     differentiated by ``torch.autograd``; its clips pass half the
     gradient on a bound, as ``jnp.clip`` does (``fixed_point.clip``).
  3. ``forward_int`` / ``forward_int_stateful`` — the bit-exact integer
     simulation of the accelerator datapath: ``alu_mode="pipelined"`` is
     the 5-stage ALU with late rounding (S5), ``alu_mode="per_step"`` is
     Algorithm 1 as printed (every product rounded back to (a,b)).

Params are plain dicts of tensors with the reference's tree layout:
``{"layers": [{"w_x", "w_h", "b"}, ...], "dense": {"w", "b"}}``.
Gate order is [i, f, g, o].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig, FXP_4_8

Tensor = torch.Tensor
Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class ActivationConfig:
    """Which activation implementations the cell uses (paper §4.2).

    ``hs_method`` / ``ht_min`` / ``ht_max`` are deprecated mirrors of the
    ``AcceleratorConfig`` fields (``core.accelerator.resolve_model``)."""

    gate: str = "hard_sigmoid_star"   # sigmoid | lut_sigmoid | hard_sigmoid_star
    cell: str = "hard_tanh"           # tanh | lut_tanh | hard_tanh
    hs_method: str = "step"           # DEPRECATED -> AcceleratorConfig.hs_method
    hs_slope_shift: int = 3           # slope = 2**-3 = 0.125
    hs_bound: float = 3.0
    ht_min: float = -1.0              # DEPRECATED -> AcceleratorConfig.ht_min
    ht_max: float = 1.0               # DEPRECATED -> AcceleratorConfig.ht_max

    def hs_spec(self, cfg: FixedPointConfig) -> hard_act.HardSigmoidStarSpec:
        return hard_act.HardSigmoidStarSpec(cfg, self.hs_slope_shift, self.hs_bound)


PAPER_ACTS = ActivationConfig()
BASELINE_ACTS = ActivationConfig(gate="lut_sigmoid", cell="lut_tanh")
FLOAT_ACTS = ActivationConfig(gate="sigmoid", cell="tanh")


@dataclasses.dataclass(frozen=True)
class QLSTMConfig:
    """The paper's Table-2 functional meta-parameters (``fxp`` and
    ``alu_mode`` are deprecated mirrors of ``AcceleratorConfig``)."""

    input_size: int = 1           # M
    hidden_size: int = 20         # K
    num_layers: int = 1
    out_features: int = 1         # P
    seq_len: int = 6              # N (PeMS-4W window used by [15])
    acts: ActivationConfig = PAPER_ACTS
    fxp: FixedPointConfig = FXP_4_8   # DEPRECATED -> AcceleratorConfig.fxp
    alu_mode: str = "pipelined"   # DEPRECATED -> AcceleratorConfig.alu_mode
    # Which quantised recurrent cell the accelerator runs: an id in the
    # ``repro_torch.cells`` registry ("lstm", "gru", "rglru").
    cell: str = "lstm"

    def layer_in_dim(self, layer: int) -> int:
        return self.input_size if layer == 0 else self.hidden_size


# ---------------------------------------------------------------------------
# Parameter init / quantisation
# ---------------------------------------------------------------------------

def init_params(cfg: QLSTMConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Params:
    """Float master params, uniform in ±1/sqrt(H), forget-gate bias 1.0.

    Drawn on the host from ``generator`` and then moved to ``device``, so
    a seed gives the same weights on every device.  (The reference draws
    from ``jax.random``; to share weights across the two packages use
    ``repro_torch.convert``.)"""
    def uniform(shape, s):
        u = torch.rand(shape, generator=generator, dtype=dtype)
        return (u * 2.0 - 1.0) * s

    s = 1.0 / math.sqrt(cfg.hidden_size)
    layers = []
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        b = torch.zeros(4 * h, dtype=dtype)
        b[h:2 * h] = 1.0                     # forget-gate bias init at 1.0
        layers.append({"w_x": uniform((m, 4 * h), s),
                       "w_h": uniform((h, 4 * h), s),
                       "b": b})
    dense = {"w": uniform((cfg.hidden_size, cfg.out_features), s),
             "b": torch.zeros(cfg.out_features, dtype=dtype)}
    params = {"layers": layers, "dense": dense}
    return tree_to(params, device) if device is not None else params


def tree_to(tree, device: torch.device):
    """Move every tensor of a params dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device)


def quantize_params(params: Params, cfg: QLSTMConfig) -> Params:
    """Float master weights -> integer codes: weights in (a,b), biases at
    the wide PRODUCT format (2a frac bits) so they add into the
    accumulator before the single late rounding."""
    c = cfg.fxp
    wide = fxp.product_config(c, c)

    def q_layer(p):
        return {"w_x": fxp.quantize(p["w_x"], c),
                "w_h": fxp.quantize(p["w_h"], c),
                "b": fxp.quantize(p["b"], wide)}

    return {"layers": [q_layer(p) for p in params["layers"]],
            "dense": {"w": fxp.quantize(params["dense"]["w"], c),
                      "b": fxp.quantize(params["dense"]["b"], wide)}}


# ---------------------------------------------------------------------------
# Float / QAT forward
# ---------------------------------------------------------------------------

def _float_gate_act(acts: ActivationConfig, cfg: FixedPointConfig,
                    fq: bool = False):
    if acts.gate in ("sigmoid", "lut_sigmoid"):
        # the LUT's float semantics are the exact sigmoid it quantises;
        # QAT handles the rounding
        return torch.sigmoid
    if acts.gate == "hard_sigmoid_star":
        slope = 2.0 ** (-acts.hs_slope_shift)
        if not fq:
            return lambda x: hard_act.hard_sigmoid_star(x, slope, acts.hs_bound)

        # QAT: the hardware's TRUNCATING shift (x_int >> k) as a
        # straight-through floor, so training sees the deployed
        # nonlinearity: y = (floor(x_int / 2^k) + half) * 2^-a.
        def tq_gate(x):
            sf = float(1 << cfg.frac_bits)
            x_int = x * sf  # fake_quant already snapped x to the grid
            lin_i = torch.floor(x_int * slope)
            lin_i = x_int * slope + (lin_i - x_int * slope).detach()
            y = (lin_i + (1 << (cfg.frac_bits - 1))) / sf
            return torch.where(x < -acts.hs_bound, 0.0,
                               torch.where(x >= acts.hs_bound, 1.0, y))

        return tq_gate
    raise ValueError(acts.gate)


def _float_cell_act(acts: ActivationConfig):
    if acts.cell in ("tanh", "lut_tanh"):
        return torch.tanh
    if acts.cell == "hard_tanh":
        return lambda x: hard_act.hard_tanh(x, acts.ht_min, acts.ht_max)
    raise ValueError(acts.cell)


def _cell_step_float(p, x_t, h, c, cfg: QLSTMConfig, fq: bool):
    """One LSTM cell step; ``fq`` puts STE fake-quant at every hardware
    rounding point (QAT)."""
    fp = cfg.fxp
    q = (lambda t: fxp.fake_quant(t, fp)) if fq else (lambda t: t)
    gate = _float_gate_act(cfg.acts, fp, fq=fq)
    cellact = _float_cell_act(cfg.acts)
    pre = q(x_t @ q(p["w_x"]) + h @ q(p["w_h"]) + p["b"])  # S5: one late rounding
    i, f, g, o = torch.chunk(pre, 4, dim=-1)
    i, f, o = gate(i), gate(f), gate(o)
    g = cellact(g)
    if fq:
        i, f, g, o = map(q, (i, f, g, o))
    c_new = q(f * c + i * g)
    h_new = q(o * cellact(c_new))
    return h_new, c_new


def _forward(params: Params, x: Tensor, cfg: QLSTMConfig, fq: bool) -> Tensor:
    """x: (batch, seq, input_size) -> (batch, out_features); the
    reference's ``lax.scan`` over time is a loop here."""
    h_t, h = x, None
    for p in params["layers"]:
        h = torch.zeros(x.shape[0], cfg.hidden_size, dtype=x.dtype,
                        device=x.device)
        c = torch.zeros_like(h)
        hs = []
        for t in range(h_t.shape[1]):
            h, c = _cell_step_float(p, h_t[:, t], h, c, cfg, fq)
            hs.append(h)
        h_t = torch.stack(hs, dim=1)
    q = (lambda t: fxp.fake_quant(t, cfg.fxp)) if fq else (lambda t: t)
    return q(h @ q(params["dense"]["w"]) + params["dense"]["b"])


def forward_float(params: Params, x: Tensor, cfg: QLSTMConfig) -> Tensor:
    """x: (batch, seq, input_size) float -> (batch, out_features)."""
    return _forward(params, x, cfg, fq=False)


def forward_qat(params: Params, x: Tensor, cfg: QLSTMConfig) -> Tensor:
    """The fake-quant graph QAT trains (same shapes as ``forward_float``)."""
    return _forward(params, x, cfg, fq=True)


# ---------------------------------------------------------------------------
# Integer forward — the hardware oracle
# ---------------------------------------------------------------------------

def int_gate_act(x_int: Tensor, cfg: QLSTMConfig) -> Tensor:
    fp = cfg.fxp
    if cfg.acts.gate == "hard_sigmoid_star":
        return hard_act.hs_star_int(x_int, cfg.acts.hs_spec(fp), cfg.acts.hs_method)
    if cfg.acts.gate in ("lut_sigmoid", "sigmoid"):
        return hard_act.lut_sigmoid_int(x_int, fp)
    raise ValueError(cfg.acts.gate)


def int_cell_act(x_int: Tensor, cfg: QLSTMConfig) -> Tensor:
    fp = cfg.fxp
    if cfg.acts.cell == "hard_tanh":
        return hard_act.hard_tanh_int(x_int, fp, cfg.acts.ht_min, cfg.acts.ht_max)
    if cfg.acts.cell in ("lut_tanh", "tanh"):
        return hard_act.lut_tanh_int(x_int, fp)
    raise ValueError(cfg.acts.cell)


def _per_step_matvec(x_int: Tensor, w_int: Tensor, cfg: QLSTMConfig) -> Tensor:
    """(..., K) x (K, N) with per-product rounding and a saturating (a,b)
    accumulator — the non-pipelined baseline MAC."""
    fp = cfg.fxp
    prod = fxp.product_config(fp, fp)
    x32, w32 = x_int.to(torch.int32), w_int.to(torch.int32)
    acc = torch.zeros(x_int.shape[:-1] + (w_int.shape[-1],), dtype=torch.int32,
                      device=x_int.device)
    for k in range(w_int.shape[0]):
        m = fxp.fxp_mul(x32[..., k:k + 1], w32[k], fp, fp)
        acc = fxp.saturate(acc + fxp.requantize(m, prod, fp), fp)
    return acc


def int_mac(x_int: Tensor, w_int: Tensor, b_wide: Tensor,
            cfg: QLSTMConfig) -> Tensor:
    """Gate pre-activation MAC, by ALU mode (C3)."""
    fp = cfg.fxp
    if cfg.alu_mode == "pipelined":
        return fxp.fxp_matvec_late_rounding(x_int, w_int, b_wide, fp)
    acc = _per_step_matvec(x_int, w_int, cfg)
    prod = fxp.product_config(fp, fp)
    b8 = fxp.requantize(b_wide.to(torch.int32), prod, fp)
    return fxp.saturate(acc + b8, fp)


def elem_mul_round(a_int: Tensor, b_int: Tensor, cfg: QLSTMConfig) -> Tensor:
    fp = cfg.fxp
    prod = fxp.product_config(fp, fp)
    return fxp.requantize(fxp.fxp_mul(a_int, b_int, fp, fp), prod, fp)


def wide_sum(*products) -> Tensor:
    """Products of integer codes (tensors or Python ints), each an ``(a,
    b)`` pair, summed at the wide precision and wrapped at int32 like the
    reference's int32 arithmetic — the S5 combine before its one
    rounding."""
    i64 = lambda v: v.to(torch.int64) if isinstance(v, Tensor) else v
    return fxp.wrap_int32(sum(i64(a) * i64(b) for a, b in products))


def _cell_step_int(p, x_t, h, c, cfg: QLSTMConfig):
    fp = cfg.fxp
    prod = fxp.product_config(fp, fp)
    pre = int_mac(torch.cat([x_t, h], dim=-1),
                  torch.cat([p["w_x"], p["w_h"]], dim=-2), p["b"], cfg)
    i, f, g, o = torch.chunk(pre, 4, dim=-1)
    i, f, o = int_gate_act(i, cfg), int_gate_act(f, cfg), int_gate_act(o, cfg)
    g = int_cell_act(g, cfg)
    # c = f*c + i*g : both products at wide precision, add, round ONCE (S5).
    wide = fxp.wrap_int32(f.to(torch.int64) * c.to(torch.int64)
                          + i.to(torch.int64) * g.to(torch.int64))
    c_new = fxp.requantize(wide, prod, fp)
    h_new = elem_mul_round(o, int_cell_act(c_new, cfg), cfg)
    return h_new, c_new


# Per-layer LSTM carry on the integer datapath: a tuple over layers of
# (h, c) int32 code tensors of shape (batch, hidden_size).
IntState = Tuple[Tuple[Tensor, Tensor], ...]


def init_int_state(cfg: QLSTMConfig, batch: int,
                   device: Optional[torch.device] = None) -> IntState:
    """The reset carry: zero (h, c) int32 codes for every layer."""
    z = lambda: torch.zeros(batch, cfg.hidden_size, dtype=torch.int32,
                            device=device)
    return tuple((z(), z()) for _ in range(cfg.num_layers))


def check_int_state(state: IntState, qparams: Params) -> None:
    """Reject a carry built for a different layer count (``zip`` over
    layers would silently truncate)."""
    if len(state) != len(qparams["layers"]):
        raise ValueError(
            f"state carries {len(state)} layer(s) but the model has "
            f"{len(qparams['layers'])}; build it with "
            f"init_int_state(cfg, batch) for THIS configuration")


def forward_int_stateful(qparams: Params, x_int: Tensor, cfg: QLSTMConfig,
                         state: IntState) -> Tuple[Tensor, IntState]:
    """Bit-exact accelerator datapath with an explicit cross-window carry.

    x_int: (batch, seq, input_size) codes; ``state`` the per-layer (h, c)
    carry.  Returns ``(y_int, new_state)``; window-by-window feeding is
    bit-identical to one call on the concatenated sequence."""
    check_int_state(state, qparams)
    h_t = x_int.to(torch.int32)
    new_state = []
    h = None
    for p, (h0, c0) in zip(qparams["layers"], state):
        h, c = h0.to(torch.int32), c0.to(torch.int32)
        hs = []
        for t in range(h_t.shape[1]):
            h, c = _cell_step_int(p, h_t[:, t], h, c, cfg)
            hs.append(h)
        new_state.append((h, c))
        h_t = torch.stack(hs, dim=1)
    y = int_mac(h, qparams["dense"]["w"], qparams["dense"]["b"], cfg)
    return y, tuple(new_state)


def forward_int(qparams: Params, x_int: Tensor, cfg: QLSTMConfig) -> Tensor:
    """Bit-exact accelerator datapath: (batch, seq, M) codes -> (batch, P)."""
    y, _ = forward_int_stateful(
        qparams, x_int, cfg,
        init_int_state(cfg, x_int.shape[0], device=x_int.device))
    return y


# ---------------------------------------------------------------------------
# Operation counting (paper's GOP accounting, §4 Eq. 7)
# ---------------------------------------------------------------------------

def lstm_ops(cfg: QLSTMConfig) -> int:
    """Equivalent operations of the LSTM layers alone for one inference
    (what the fused kernels compute; the dense head is excluded)."""
    total = 0
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        per_step = 2 * 4 * h * (m + h)   # gate MACs
        per_step += 4 * h                # + bias adds
        per_step += 2 * 3 * h + h        # f*c, i*g, o*tanh(c) muls + one add
        per_step += 4 * h                # activations (1 op each)
        total += cfg.seq_len * per_step
    return total


def ops_per_inference(cfg: QLSTMConfig) -> int:
    """Equivalent operations per inference (a MAC is 2 ops) — the
    convention behind the paper's GOP/s numbers."""
    return lstm_ops(cfg) + 2 * cfg.hidden_size * cfg.out_features + cfg.out_features
