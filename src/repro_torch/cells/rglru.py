"""``rglru`` cell spec — Griffin's RG-LRU re-derived for the fixed-point
datapath.

Counterpart of ``repro/cells/rglru.py``.  The float recurrence of
``models/rglru.py`` computes ``a = exp(-c * r * softplus(lam))`` and a
``sqrt(1 - a^2)`` input scale — both hostile to an integer (a,b)
pipeline.  This cell is the hardware-friendly redefinition:

  * gates are INPUT-ONLY (as in Griffin): ``r = gate(x W_a + b_a)``,
    ``i = gate(x W_i + b_i)`` — one MAC each, no recurrent matmul;
  * the decay is the bilinear ``a = 1 - r * lambda`` with
    ``lambda = gate(lam)`` baked to an (a,b) code at quantisation time;
  * the input scale is the convex complement ``(1 - a)``:
    ``h' = a*h + (1-a)*(i * (x W_x + b_x))``, whose coefficients sum to
    the exact 1.0 code.

Every product sits at the wide PRODUCT precision and rounds once (the S5
contract of ``core.qlstm``); MACs switch by ALU mode through
``qlstm.int_mac``.  ``kernels/ref.qrglru_seq_ref`` is the independently
written oracle the datapath must match bit for bit.  This integer cell
is a different recurrence from the f32 RG-LRU scan of K7
(``kernels/rglru_scan.py``): the reference has no fused kernel for it
(``supports_fused`` is ``None``), so ``plan()`` resolves the ``xla``
engine, whose torch ops run on the session's device.
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
    """Float master params: per layer three input projections ``w_x/w_a/
    w_i (M, H)`` with biases, plus the raw decay parameter ``lam (H,)``
    (gated at quantisation time), plus the shared dense head.  Drawn on
    the host from ``generator``, then moved to ``device``."""
    def uniform(shape, lo, hi):
        return lo + torch.rand(shape, generator=generator, dtype=dtype) \
            * (hi - lo)

    layers = []
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        s = 1.0 / math.sqrt(max(m, 1))
        layers.append({
            "w_x": uniform((m, h), -s, s),
            "w_a": uniform((m, h), -s, s),
            "w_i": uniform((m, h), -s, s),
            "b_x": torch.zeros(h, dtype=dtype),
            "b_a": torch.zeros(h, dtype=dtype),
            "b_i": torch.zeros(h, dtype=dtype),
            # lam in ~[0.4, 2.6]: gate(lam) spans slow-to-fast decays.
            "lam": uniform((h,), 0.4, 2.6),
        })
    s = 1.0 / math.sqrt(cfg.hidden_size)
    dense = {"w": uniform((cfg.hidden_size, cfg.out_features), -s, s),
             "b": torch.zeros(cfg.out_features, dtype=dtype)}
    params = {"layers": layers, "dense": dense}
    return tree_to(params, device) if device is not None else params


def quantize_params(params: Params, cfg: QLSTMConfig) -> Params:
    """Float masters -> integer codes.  Weights in (a,b), biases at the
    wide PRODUCT format, and the decay is BAKED: ``lam_q =
    quantize(gate(lam))`` — the gate nonlinearity on the static parameter
    runs once here, not per step on the accelerator.  (Under the float
    ``sigmoid`` gate, torch's and XLA's sigmoid may differ by an ulp,
    which can move a ``lam_q`` code by one.)"""
    c = cfg.fxp
    wide = fxp.product_config(c, c)
    gate = qlstm._float_gate_act(cfg.acts, c)

    def q_layer(p):
        return {
            "w_x": fxp.quantize(p["w_x"], c),
            "w_a": fxp.quantize(p["w_a"], c),
            "w_i": fxp.quantize(p["w_i"], c),
            "b_x": fxp.quantize(p["b_x"], wide),
            "b_a": fxp.quantize(p["b_a"], wide),
            "b_i": fxp.quantize(p["b_i"], wide),
            "lam_q": fxp.quantize(gate(p["lam"]), c),
        }

    return {"layers": [q_layer(p) for p in params["layers"]],
            "dense": {"w": fxp.quantize(params["dense"]["w"], c),
                      "b": fxp.quantize(params["dense"]["b"], wide)}}


# ---------------------------------------------------------------------------
# Float / QAT forward
# ---------------------------------------------------------------------------

def _step_float(p, x_t, h, cfg: QLSTMConfig, fq: bool):
    fp = cfg.fxp
    q = (lambda t: fxp.fake_quant(t, fp)) if fq else (lambda t: t)
    gate = qlstm._float_gate_act(cfg.acts, fp, fq=fq)
    lam = gate(p["lam"])
    if fq:
        lam = q(lam)
    xp = q(x_t @ q(p["w_x"]) + p["b_x"])
    r = gate(x_t @ q(p["w_a"]) + p["b_a"])
    i = gate(x_t @ q(p["w_i"]) + p["b_i"])
    if fq:
        r, i = q(r), q(i)
    a = 1.0 - q(r * lam)
    gx = q(i * xp)
    return q(a * h + (1.0 - a) * gx)


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
    """Float RG-LRU stack + dense head: (B, T, M) -> (B, P)."""
    return _forward(params, x, cfg, fq=False)


def forward_qat(params: Params, x: Tensor, cfg: QLSTMConfig) -> Tensor:
    """QAT graph: the float forward with STE fake-quant at every hardware
    rounding point (including the baked ``gate(lam)`` code)."""
    return _forward(params, x, cfg, fq=True)


# ---------------------------------------------------------------------------
# Integer forward — the general (xla-engine) datapath
# ---------------------------------------------------------------------------

def _step_int(p, x_t, h, cfg: QLSTMConfig):
    fp = cfg.fxp
    prod = fxp.product_config(fp, fp)
    one = 1 << fp.frac_bits            # the exact (a,b) code of 1.0
    xp = qlstm.int_mac(x_t, p["w_x"], p["b_x"], cfg)
    r = qlstm.int_gate_act(qlstm.int_mac(x_t, p["w_a"], p["b_a"], cfg), cfg)
    i = qlstm.int_gate_act(qlstm.int_mac(x_t, p["w_i"], p["b_i"], cfg), cfg)
    a = one - qlstm.elem_mul_round(r, p["lam_q"].to(torch.int32), cfg)
    gx = qlstm.elem_mul_round(i, xp, cfg)
    # Convex mix a*h + (1-a)*gx: both products wide, add, round ONCE (S5).
    return fxp.requantize(qlstm.wide_sum((a, h), (one - a, gx)), prod, fp)


def run_int_stateful(qparams: Params, x_int: Tensor, cfg: QLSTMConfig,
                     state) -> Tuple[Tensor, tuple]:
    """Bit-exact integer RG-LRU stack with an explicit cross-window carry
    (per layer ``(h,)``) — windowed feeding is bit-identical to one call
    on the concatenated sequence."""
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
    """One oracle RG-LRU layer, time-major — ``kernels/ref.qrglru_seq_ref``
    resumed from ``carry = (h0,)``."""
    acts = model.acts
    (h0,) = carry
    hs, h_last = _ref.qrglru_seq_ref(
        x_tm, p["w_x"], p["w_a"], p["w_i"],
        p["b_x"], p["b_a"], p["b_i"], p["lam_q"], model.fxp,
        hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound, h0=h0)
    return hs, (h_last,)


def supports_int(model: QLSTMConfig, accel) -> Optional[str]:
    """None when the general int datapath covers the configuration.  The
    RG-LRU uses no cell activation — only the gate nonlinearity must have
    an integer form."""
    if model.acts.gate not in ("hard_sigmoid_star", "lut_sigmoid", "sigmoid"):
        return f"gate activation {model.acts.gate!r} has no integer datapath"
    return None


def ops_per_inference(cfg: QLSTMConfig) -> int:
    """Equivalent ops per inference (MAC = 2 ops) for the RG-LRU stack +
    dense head — the GOP/s accounting convention of ``core.qlstm``."""
    total = 0
    for li in range(cfg.num_layers):
        m, h = cfg.layer_in_dim(li), cfg.hidden_size
        per_step = 2 * 3 * h * m        # three input-projection MACs
        per_step += 3 * h               # + bias adds
        per_step += 4 * h + 2 * h      # r*lam, i*xp, a*h, (1-a)*gx + mixes
        per_step += 2 * h               # gate activations
        total += cfg.seq_len * per_step
    total += 2 * cfg.hidden_size * cfg.out_features + cfg.out_features
    return total


def weight_bytes(model: QLSTMConfig, acc) -> int:
    """Bytes of quantised RG-LRU weights+biases (including the baked
    ``lam_q`` codes) the accelerator must hold."""
    itemsize = (acc.fxp.total_bits + 7) // 8
    wide_itemsize = 2 * itemsize
    total = 0
    for li in range(model.num_layers):
        m, h = model.layer_in_dim(li), model.hidden_size
        total += 3 * m * h * itemsize + 3 * h * wide_itemsize
        total += h * itemsize           # lam_q
    total += model.hidden_size * model.out_features * itemsize
    total += model.out_features * wide_itemsize
    return total


SPEC = register(CellSpec(
    name="rglru",
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
