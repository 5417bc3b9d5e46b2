"""``pallas`` backend — the fused hand-written CUDA kernels.

Counterpart of ``repro/backends/pallas.py``, registered under the same
name ``"pallas"`` so configurations carry over unchanged; here it
launches the CUDA kernels of ``kernels/qlstm_cell.py``
(``csrc/qlstm_cell.cu``) on CUDA tensors and runs their plain torch
versions on CPU tensors.

The whole-model paths (``run``, ``run_stateful``) execute the entire
LSTM stack in one ``qlstm_seq_multilayer`` launch, and
``run_stateful_slots`` — the default serving path — in one
``qlstm_seq_slot`` launch that gathers and scatters each stream's carry
against the device-resident table.  The ``1to1`` HardSigmoid* method is
lowered to the bit-identical ``arithmetic`` form, as in the reference.
``prepare`` builds the kernels when a session resolves this engine, so a
kernel that cannot be built fails there."""

from __future__ import annotations

import torch

from repro_torch.backends import Backend, register
from repro_torch.backends.common import dense_head, supports_fused
from repro_torch.core.accelerator import AcceleratorConfig, sync_accelerator
from repro_torch.core.qlstm import QLSTMConfig, check_int_state, init_int_state
from repro_torch.kernels import qlstm_cell

Tensor = torch.Tensor


def _kernel_args(model: QLSTMConfig, accel: AcceleratorConfig) -> dict:
    """The static kernel configuration shared by every entry (with the
    1to1 -> arithmetic HardSigmoid* lowering applied)."""
    acts = model.acts
    acc = sync_accelerator(model, accel)
    hs_method = "arithmetic" if acc.hs_method == "1to1" else acc.hs_method
    return dict(cfg=model.fxp, hs_method=hs_method,
                hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
                ht_min=acts.ht_min, ht_max=acts.ht_max,
                compute_unit=acc.compute_unit)


def _weights(qparams, sd):
    layers = qparams["layers"]
    return (tuple(p["w_x"].to(sd) for p in layers),
            tuple(p["w_h"].to(sd) for p in layers),
            tuple(p["b"] for p in layers))


def layer(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
          model: QLSTMConfig, accel: AcceleratorConfig) -> Tensor:
    """One fused LSTM layer, time-major: (T, B, M) codes -> (T, B, H).

    The ``qlstm_seq`` entry, reached through ``kernels/ops.qlstm_seq``
    (and ``common.run_layered``); the session's ``infer`` and the serving
    tier run ``run``/``run_stateful``/``run_stateful_slots`` instead."""
    sd = model.fxp.storage_dtype
    out = qlstm_cell.qlstm_seq(x_int.to(sd), w_x.to(sd), w_h.to(sd), b_wide,
                               **_kernel_args(model, accel))
    return out.to(torch.int32)


def run_stateful(qparams, x_int: Tensor, model: QLSTMConfig,
                 accel: AcceleratorConfig, state):
    """Whole model with cross-window (h, c) carry, one fused launch —
    ``(y_int, new_state)``."""
    check_int_state(state, qparams)
    sd = model.fxp.storage_dtype
    out, new_state = qlstm_cell.qlstm_seq_multilayer(
        x_int.transpose(0, 1).to(sd), *_weights(qparams, sd),
        tuple(h for h, _ in state), tuple(c for _, c in state),
        **_kernel_args(model, accel))
    return dense_head(out[-1], qparams, model), new_state


def run_stateful_slots(qparams, x_int: Tensor, model: QLSTMConfig,
                       accel: AcceleratorConfig, table: Tensor,
                       gather_slots: Tensor, scatter_slots: Tensor):
    """Whole model with device-resident stream state, one fused launch
    that gathers and scatters the carries — ``(y_int, new_table)``."""
    sd = model.fxp.storage_dtype
    out, new_table = qlstm_cell.qlstm_seq_slot(
        x_int.transpose(0, 1).to(sd), gather_slots, scatter_slots, table,
        *_weights(qparams, sd), **_kernel_args(model, accel))
    return dense_head(out[-1], qparams, model), new_table


def run(qparams, x_int: Tensor, model: QLSTMConfig,
        accel: AcceleratorConfig) -> Tensor:
    """Whole model, batch-major, from the zero reset carry."""
    y, _ = run_stateful(qparams, x_int, model, accel,
                        init_int_state(model, x_int.shape[0],
                                       device=x_int.device))
    return y


def prepare(device: torch.device) -> None:
    """Build and bind the CUDA kernels when they will run on ``device``."""
    if device.type == "cuda":
        qlstm_cell.load_library()


BACKEND = register(Backend(name="pallas", run=run, supports=supports_fused,
                           layer=layer, run_stateful=run_stateful,
                           run_stateful_slots=run_stateful_slots,
                           prepare=prepare))
