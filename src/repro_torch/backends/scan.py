"""``xla`` backend — the general per-step integer datapath in torch.

Counterpart of ``repro/backends/xla.py`` (registered under the same name
``"xla"``, so configurations carry over unchanged): the cell spec's
``run_int_stateful``, for the LSTM ``core.qlstm.forward_int_stateful``.
Every Table-2 point runs here, including the per-step (Algorithm 1)
ALU and the 256-entry LUT activations; on the pipelined point with hard
activations it is bit-identical to ``ref`` and ``pallas``."""

from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.backends import Backend, register
from repro_torch.backends.common import run_slots_via_state
from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import QLSTMConfig

Tensor = torch.Tensor


def supports(model: QLSTMConfig, accel: AcceleratorConfig) -> Optional[str]:
    """None when the cell's general integer datapath covers the
    configuration, else the reason."""
    from repro_torch import cells
    return cells.get(model.cell).supports_int(model, accel)


def run(qparams, x_int: Tensor, model: QLSTMConfig,
        accel: AcceleratorConfig) -> Tensor:
    """Whole model, batch-major: (B, T, M) codes -> (B, P) codes."""
    from repro_torch import cells
    return cells.get(model.cell).run_int(qparams, x_int, model)


def run_stateful(qparams, x_int: Tensor, model: QLSTMConfig,
                 accel: AcceleratorConfig, state):
    """Whole model with an explicit cross-window carry."""
    from repro_torch import cells
    return cells.get(model.cell).run_int_stateful(qparams, x_int, model,
                                                  state)


BACKEND = register(Backend(
    name="xla", run=run, supports=supports, run_stateful=run_stateful,
    run_stateful_slots=functools.partial(run_slots_via_state, run_stateful)))
