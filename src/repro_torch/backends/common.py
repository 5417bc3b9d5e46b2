"""Shared scaffolding of the engines: the fused-kernel predicate, the
dense head with its single late rounding, layer stacking, and the generic
slot-table adapter.  Counterpart of ``repro/backends/common.py``."""

from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig

Tensor = torch.Tensor


def supports_fused(model: QLSTMConfig,
                   accel: AcceleratorConfig) -> Optional[str]:
    """Can the fused kernels run this configuration?  Delegates to the
    cell spec (a cell without fused kernels is refused outright)."""
    from repro_torch import cells
    spec = cells.get(model.cell)
    if spec.supports_fused is None:
        return f"cell {model.cell!r} has no fused kernel"
    return spec.supports_fused(model, accel)


def dense_head(h_last: Tensor, qparams, model: QLSTMConfig) -> Tensor:
    """Final-step (B, H) hidden codes -> (B, P) output codes with the
    single late rounding (S5); every engine ends here."""
    return fxp.fxp_matvec_late_rounding(
        h_last, qparams["dense"]["w"], qparams["dense"]["b"], model.fxp)


def run_layered(layer_fn: Callable, qparams, x_int: Tensor,
                model: QLSTMConfig, accel: AcceleratorConfig) -> Tensor:
    """Stack ``layer_fn`` over the layers and apply the dense head.
    x_int: (B, T, M) codes -> (B, P) codes.

    The per-layer path, kept for parity with the reference, whose
    ``kernels/ops.py`` reaches the engines' ``layer`` entries through it
    (ops is not ported yet).  ``infer`` and the serving tier never take
    it: they run the whole stack in one call."""
    h_t = x_int.transpose(0, 1).to(torch.int32)     # time-major (T, B, M)
    for p in qparams["layers"]:
        h_t = layer_fn(h_t, p["w_x"], p["w_h"], p["b"], model,
                       accel).to(torch.int32)
    return dense_head(h_t[-1], qparams, model)


def run_slots_via_state(run_stateful: Callable, qparams, x_int: Tensor,
                        model: QLSTMConfig, accel: AcceleratorConfig,
                        table: Tensor, gather_slots: Tensor,
                        scatter_slots: Tensor):
    """Generic ``run_stateful_slots`` for engines without an in-kernel
    slot path: gather the carry batch from the table, run
    ``run_stateful``, scatter the new carry into a copy of the table —
    all on the table's device, so degrading from the fused engine never
    moves the carry to the host.  Same table contract as
    ``kernels/qlstm_cell.qlstm_seq_slot``; returns ``(y_int, new_table)``."""
    nl, arity = table.shape[1], table.shape[2]
    g = gather_slots.to(torch.int64)
    s = scatter_slots.to(torch.int64)
    state = tuple(tuple(table[g, li, k] for k in range(arity))
                  for li in range(nl))
    y_int, new_state = run_stateful(qparams, x_int, model, accel, state)
    table = table.clone()
    for li, layer_carry in enumerate(new_state):
        for k, arr in enumerate(layer_carry):
            table[s, li, k] = arr
    return y_int, table
