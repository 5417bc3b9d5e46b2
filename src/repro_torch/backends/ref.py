"""``ref`` backend — the plain-torch oracle (``kernels/ref.py``).

Counterpart of ``repro/backends/ref.py``: explicit int32 products per
cell step, single late rounding (S5), hard activations.  The
specification the ``xla`` engine and the fused ``pallas`` engine must
match bit for bit."""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.backends import Backend, register
from repro_torch.backends.common import dense_head, run_slots_via_state
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig, check_int_state
from repro_torch.kernels import ref as _ref

Tensor = torch.Tensor


def layer(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
          model: QLSTMConfig, accel: AcceleratorConfig) -> Tensor:
    """One LSTM layer, time-major: (T, B, M) codes -> (T, B, H) codes."""
    acts = model.acts
    return _ref.qlstm_seq_ref(
        x_int, w_x, w_h, b_wide, model.fxp,
        hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
        ht_min=acts.ht_min, ht_max=acts.ht_max)


def supports(model: QLSTMConfig, accel: AcceleratorConfig) -> Optional[str]:
    """The oracle covers what the cell's ref oracle covers: the paper's
    pipelined datapath with the hard activations."""
    from repro_torch import cells
    return cells.get(model.cell).supports_oracle(model, accel)


def run_stateful(qparams, x_int: Tensor, model: QLSTMConfig,
                 accel: AcceleratorConfig, state):
    """Whole model with an explicit cross-window carry: the cell's oracle
    layer stacked over the carry tuple, then the dense head."""
    from repro_torch import cells
    spec = cells.get(model.cell)
    check_int_state(state, qparams)
    h_t = x_int.transpose(0, 1).to(torch.int32)     # time-major (T, B, M)
    new_state = []
    for p, carry in zip(qparams["layers"], state):
        h_t, carry = spec.ref_layer(h_t, p, model, carry)
        new_state.append(tuple(carry))
    return dense_head(h_t[-1], qparams, model), tuple(new_state)


def run(qparams, x_int: Tensor, model: QLSTMConfig,
        accel: AcceleratorConfig) -> Tensor:
    """Whole model, batch-major: (B, T, M) codes -> (B, P) codes."""
    from repro_torch import cells
    y, _ = run_stateful(qparams, x_int, model, accel,
                        cells.init_state(model, x_int.shape[0],
                                         device=x_int.device))
    return y


BACKEND = register(Backend(
    name="ref", run=run, supports=supports, layer=layer,
    run_stateful=run_stateful,
    run_stateful_slots=functools.partial(run_slots_via_state, run_stateful)))
