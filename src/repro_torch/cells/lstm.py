"""``lstm`` cell spec — the paper's quantised LSTM.

Counterpart of ``repro/cells/lstm.py``: adapts ``core.qlstm`` and
``kernels/ref.py`` to the :class:`repro_torch.cells.CellSpec` contract.
The LSTM is the one cell with fused kernels
(``kernels/qlstm_cell.py``), hence its ``supports_fused`` predicate.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.cells import CellSpec, paper_datapath_reason, register
from repro_torch.core import qlstm
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.kernels import ref as _ref


def ref_layer(x_tm, p, model: QLSTMConfig, carry):
    """One oracle LSTM layer, time-major: (T, B, M) codes -> ((T, B, H),
    (h_last, c_last)) resumed from ``carry = (h0, c0)``."""
    acts = model.acts
    h0, c0 = carry
    return _ref.qlstm_seq_ref(
        x_tm, p["w_x"], p["w_h"], p["b"], model.fxp,
        hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
        ht_min=acts.ht_min, ht_max=acts.ht_max,
        h0=h0, c0=c0, return_state=True)


def supports_int(model: QLSTMConfig, accel) -> Optional[str]:
    """None when the general int datapath covers the configuration (every
    Table-2 point does), else the reason."""
    if model.acts.gate not in ("hard_sigmoid_star", "lut_sigmoid", "sigmoid"):
        return f"gate activation {model.acts.gate!r} has no integer datapath"
    if model.acts.cell not in ("hard_tanh", "lut_tanh", "tanh"):
        return f"cell activation {model.acts.cell!r} has no integer datapath"
    return None


def weight_bytes(model: QLSTMConfig, acc) -> int:
    """Bytes of quantised LSTM weights+biases the accelerator must hold."""
    itemsize = (acc.fxp.total_bits + 7) // 8
    wide_itemsize = 2 * itemsize
    total = 0
    for li in range(model.num_layers):
        m, h = model.layer_in_dim(li), model.hidden_size
        total += (m + h) * 4 * h * itemsize + 4 * h * wide_itemsize
    total += model.hidden_size * model.out_features * itemsize
    total += model.out_features * wide_itemsize
    return total


SPEC = register(CellSpec(
    name="lstm",
    state_arity=2,
    state_names=("h", "c"),
    init_params=qlstm.init_params,
    quantize_params=qlstm.quantize_params,
    forward_float=qlstm.forward_float,
    forward_qat=qlstm.forward_qat,
    run_int_stateful=qlstm.forward_int_stateful,
    ref_layer=ref_layer,
    supports_int=supports_int,
    supports_oracle=paper_datapath_reason,
    supports_fused=paper_datapath_reason,
    ops_per_inference=qlstm.ops_per_inference,
    weight_bytes=weight_bytes,
))
