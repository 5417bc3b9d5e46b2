"""``gru`` cell spec — quantised GRU through the paper's datapath.

Counterpart of ``repro/cells/gru.py``.  Same fixed-point contract as the
LSTM (``core.qlstm``): weights in (a,b), biases at the wide PRODUCT
precision (2a frac bits), MACs by ALU mode (pipelined = accumulate wide +
ONE late S5 rounding; per_step = Algorithm 1's per-product rounding with
saturating adds), gates through the integer HardSigmoid*/LUT
activations, elementwise state updates at wide precision with a single
rounding.

Gate order is [r, z, n] over a fused ``(in, 3H)`` weight layout:

    r = gate(x W_xr + h W_hr + b_r)            (reset)
    z = gate(x W_xz + h W_hz + b_z)            (update)
    n = cellact( (x W_xn + b_n)*1 + r * (h W_hn) )
    h' = (1 - z) * n + z * h

The recurrent half ``h W_hn`` is rounded at its own accumulator exit,
then the ``r``-gating product restores the wide format — so ``x W_xn +
b_n`` is lifted to wide by the exact ``1.0`` code and the sum rounds once.

No kernel is hidden here: the reference has no fused kernel for the GRU
(``supports_fused`` is ``None``), so ``plan()`` resolves the ``xla``
engine and the ladder is ``xla`` -> ``ref``.  On the card this cell runs
the ``xla`` engine's torch ops on the device, as the reference runs
XLA's; every integer product goes through ``fixed_point.int_matmul``
(CUDA has no integer matmul).  ``kernels/ref.qgru_seq_ref`` is the
independently written oracle this module's datapath must match bit for
bit (``tests/test_torch_cells.py``).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.cells import CellSpec, paper_datapath_reason, register
from repro_torch.core import fixed_point as fxp
from repro_torch.core import qlstm
from repro_torch.core.qlstm import Params, QLSTMConfig, check_int_state, tree_to
from repro_torch.kernels import ref as _ref

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(cfg: QLSTMConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device: Optional[torch.device] = None) -> Params:
    """Float master params: per layer ``w_x (M, 3H)``, ``w_h (H, 3H)``,
    ``b (3H,)`` in gate order [r, z, n], plus the shared dense head.
    Drawn on the host from ``generator``, then moved to ``device``."""
    def uniform(shape, s):
        return (torch.rand(shape, generator=generator, dtype=dtype) * 2.0
                - 1.0) * s

    s = 1.0 / math.sqrt(cfg.hidden_size)
    layers = []
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        layers.append({"w_x": uniform((m, 3 * h), s),
                       "w_h": uniform((h, 3 * h), s),
                       "b": torch.zeros(3 * h, dtype=dtype)})
    dense = {"w": uniform((cfg.hidden_size, cfg.out_features), s),
             "b": torch.zeros(cfg.out_features, dtype=dtype)}
    params = {"layers": layers, "dense": dense}
    return tree_to(params, device) if device is not None else params


def quantize_params(params: Params, cfg: QLSTMConfig) -> Params:
    """Float masters -> integer codes: weights in (a,b), biases at the
    wide PRODUCT format — the LSTM quantisation rule, 3 gates wide."""
    return qlstm.quantize_params(params, cfg)


# ---------------------------------------------------------------------------
# Float / QAT forward
# ---------------------------------------------------------------------------

def _step_float(p, x_t, h, cfg: QLSTMConfig, fq: bool):
    fp = cfg.fxp
    q = (lambda t: fxp.fake_quant(t, fp)) if fq else (lambda t: t)
    gate = qlstm._float_gate_act(cfg.acts, fp, fq=fq)
    cellact = qlstm._float_cell_act(cfg.acts)
    hdim = cfg.hidden_size
    w_x, w_h = q(p["w_x"]), q(p["w_h"])
    rz = q(x_t @ w_x[:, :2 * hdim] + h @ w_h[:, :2 * hdim]
           + p["b"][:2 * hdim])
    r, z = gate(rz[:, :hdim]), gate(rz[:, hdim:])
    if fq:
        r, z = q(r), q(z)
    nh = q(h @ w_h[:, 2 * hdim:])
    n = cellact(q(x_t @ w_x[:, 2 * hdim:] + p["b"][2 * hdim:] + r * nh))
    if fq:
        n = q(n)
    return q((1.0 - z) * n + z * h)


def _forward(params: Params, x: Tensor, cfg: QLSTMConfig, fq: bool) -> Tensor:
    """x: (batch, seq, input_size) -> (batch, out_features); the
    reference's ``lax.scan`` over time is a loop here."""
    h_t, h = x, None
    for p in params["layers"]:
        h = torch.zeros(x.shape[0], cfg.hidden_size, dtype=x.dtype,
                        device=x.device)
        hs = []
        for t in range(h_t.shape[1]):
            h = _step_float(p, h_t[:, t], h, cfg, fq)
            hs.append(h)
        h_t = torch.stack(hs, dim=1)
    q = (lambda t: fxp.fake_quant(t, cfg.fxp)) if fq else (lambda t: t)
    return q(h @ q(params["dense"]["w"]) + params["dense"]["b"])


def forward_float(params: Params, x: Tensor, cfg: QLSTMConfig) -> Tensor:
    """Float GRU stack + dense head: (B, T, M) -> (B, P)."""
    return _forward(params, x, cfg, fq=False)


def forward_qat(params: Params, x: Tensor, cfg: QLSTMConfig) -> Tensor:
    """QAT graph: the float forward with STE fake-quant at every hardware
    rounding point."""
    return _forward(params, x, cfg, fq=True)


# ---------------------------------------------------------------------------
# Integer forward — the general (xla-engine) datapath
# ---------------------------------------------------------------------------

def _step_int(p, x_t, h, cfg: QLSTMConfig):
    fp = cfg.fxp
    prod = fxp.product_config(fp, fp)
    hdim = cfg.hidden_size
    one = 1 << fp.frac_bits            # the exact (a,b) code of 1.0
    w_x, w_h = p["w_x"], p["w_h"]
    rz = qlstm.int_mac(torch.cat([x_t, h], dim=-1),
                       torch.cat([w_x[:, :2 * hdim], w_h[:, :2 * hdim]],
                                 dim=-2),
                       p["b"][:2 * hdim], cfg)
    r = qlstm.int_gate_act(rz[:, :hdim], cfg)
    z = qlstm.int_gate_act(rz[:, hdim:], cfg)
    # Candidate: both halves MAC'd by ALU mode to (a,b); the combine is
    # S5 — lift nx by the 1.0 code, gate nh by r (both wide), round once.
    nh = qlstm.int_mac(h, w_h[:, 2 * hdim:],
                       torch.zeros(hdim, dtype=torch.int32, device=h.device),
                       cfg)
    nx = qlstm.int_mac(x_t, w_x[:, 2 * hdim:], p["b"][2 * hdim:], cfg)
    n = qlstm.int_cell_act(
        fxp.requantize(qlstm.wide_sum((nx, one), (r, nh)), prod, fp), cfg)
    # h' = (1-z)*n + z*h : both products wide, add, round ONCE (S5).
    return fxp.requantize(qlstm.wide_sum((one - z, n), (z, h)), prod, fp)


def run_int_stateful(qparams: Params, x_int: Tensor, cfg: QLSTMConfig,
                     state) -> Tuple[Tensor, tuple]:
    """Bit-exact integer GRU stack with an explicit cross-window carry
    (per layer ``(h,)``).  Window-by-window feeding is bit-identical to
    one call on the concatenated sequence — the serving contract."""
    check_int_state(state, qparams)
    h_t = x_int.to(torch.int32)
    new_state = []
    h = None
    for p, (h0,) in zip(qparams["layers"], state):
        h = h0.to(torch.int32)
        hs = []
        for t in range(h_t.shape[1]):
            h = _step_int(p, h_t[:, t], h, cfg)
            hs.append(h)
        new_state.append((h,))
        h_t = torch.stack(hs, dim=1)
    y = qlstm.int_mac(h, qparams["dense"]["w"], qparams["dense"]["b"], cfg)
    return y, tuple(new_state)


def ref_layer(x_tm: Tensor, p, model: QLSTMConfig, carry):
    """One oracle GRU layer, time-major — ``kernels/ref.qgru_seq_ref``
    resumed from ``carry = (h0,)``."""
    acts = model.acts
    (h0,) = carry
    hs, h_last = _ref.qgru_seq_ref(
        x_tm, p["w_x"], p["w_h"], p["b"], model.fxp,
        hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
        ht_min=acts.ht_min, ht_max=acts.ht_max, h0=h0)
    return hs, (h_last,)


def supports_int(model: QLSTMConfig, accel) -> Optional[str]:
    """None when the general int datapath covers the configuration (both
    ALU modes, hard or LUT activations), else the reason."""
    if model.acts.gate not in ("hard_sigmoid_star", "lut_sigmoid", "sigmoid"):
        return f"gate activation {model.acts.gate!r} has no integer datapath"
    if model.acts.cell not in ("hard_tanh", "lut_tanh", "tanh"):
        return f"cell activation {model.acts.cell!r} has no integer datapath"
    return None


def ops_per_inference(cfg: QLSTMConfig) -> int:
    """Equivalent ops per inference (MAC = 2 ops) for the GRU stack +
    dense head — the GOP/s accounting convention of ``core.qlstm``."""
    total = 0
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        per_step = 2 * 3 * h * (m + h)   # gate/candidate MACs
        per_step += 3 * h                # + bias adds
        per_step += 2 * 3 * h + h       # r*nh, (1-z)*n, z*h muls + combine
        per_step += 3 * h                # activations (1 op each)
        total += cfg.seq_len * per_step
    total += 2 * cfg.hidden_size * cfg.out_features + cfg.out_features
    return total


def weight_bytes(model: QLSTMConfig, acc) -> int:
    """Bytes of quantised GRU weights+biases the accelerator must hold."""
    itemsize = (acc.fxp.total_bits + 7) // 8
    wide_itemsize = 2 * itemsize
    total = 0
    for li in range(model.num_layers):
        m, h = model.layer_in_dim(li), model.hidden_size
        total += (m + h) * 3 * h * itemsize + 3 * h * wide_itemsize
    total += model.hidden_size * model.out_features * itemsize
    total += model.out_features * wide_itemsize
    return total


SPEC = register(CellSpec(
    name="gru",
    state_arity=1,
    state_names=("h",),
    init_params=init_params,
    quantize_params=quantize_params,
    forward_float=forward_float,
    forward_qat=forward_qat,
    run_int_stateful=run_int_stateful,
    ref_layer=ref_layer,
    supports_int=supports_int,
    supports_oracle=paper_datapath_reason,
    supports_fused=None,    # the reference has no fused kernel: auto -> xla
    ops_per_inference=ops_per_inference,
    weight_bytes=weight_bytes,
))
