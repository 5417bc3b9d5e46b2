"""The quantised recurrent cell registry — one contract, many cells.

Counterpart of ``repro/cells/__init__.py``.  A :class:`CellSpec` carries
everything a cell brings to the accelerator: parameter tree, per-layer
carry shape, the bit-exact integer datapath, the plain oracle, and an
optional fused-kernel predicate.  Every downstream layer (backends,
serving) dispatches through the spec.

Registered cells:

  * ``lstm``  — the paper's quantised LSTM (``core.qlstm``): per-layer
    (h, c) carry, fused CUDA kernels for the pipelined + hard-activation
    point.
  * ``gru``   — quantised GRU (``cells.gru``): per-layer (h,) carry, gate
    order [r, z, n], the same S5 single-late-rounding contract.
  * ``rglru`` — quantised RG-LRU (``cells.rglru``): input-only gates, a
    ``1 - r*lambda`` decay and a convex ``a*h + (1-a)*(i*x)`` mix;
    per-layer (h,) carry.

GRU and rGLRU have no fused kernel (nor has the reference), so they run
on the ``xla`` engine with ``ref`` below it.

The per-layer integer carry is a tuple of ``state_arity`` int32 tensors
of shape ``(batch, hidden)``; the whole-model state is a tuple of those
over layers (:func:`init_state` / :func:`state_shape`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.qlstm import QLSTMConfig


def paper_datapath_reason(model: QLSTMConfig, accel) -> Optional[str]:
    """``None`` when the resolved configuration is the paper's pipelined
    (late-rounding) ALU with the hard activations — the point the oracle
    and the fused kernels implement — else the reason it is not."""
    if model.alu_mode != "pipelined":
        return (f"alu_mode={model.alu_mode!r}: only the pipelined "
                "(late-rounding) ALU is implemented")
    if model.acts.gate != "hard_sigmoid_star":
        return f"gate activation {model.acts.gate!r}: needs hard_sigmoid_star"
    if model.acts.cell != "hard_tanh":
        return f"cell activation {model.acts.cell!r}: needs hard_tanh"
    return None


@dataclasses.dataclass(frozen=True)
class CellSpec:
    """Everything one recurrent cell brings to the accelerator contract
    (field meanings as in the reference's ``CellSpec``)."""

    name: str
    state_arity: int
    state_names: Tuple[str, ...]
    #: (model, generator, device=...) -> float master params.
    init_params: Callable
    #: (params, model) -> integer codes (weights (a,b), biases wide).
    quantize_params: Callable
    #: (params, x, model) -> y — float semantics.
    forward_float: Callable
    #: (params, x, model) -> y — STE fake-quant at every rounding point.
    forward_qat: Callable
    #: (qparams, x_int, model, state) -> (y_int, new_state) — the general
    #: integer datapath (both ALU modes, LUT acts); the xla engine.
    run_int_stateful: Callable
    #: (x_tm, layer_params, model, carry) -> (h_seq, new_carry) — one
    #: layer of the plain oracle (time-major); the ref engine.
    ref_layer: Callable
    supports_int: Callable
    supports_oracle: Callable
    ops_per_inference: Callable
    weight_bytes: Callable
    supports_fused: Optional[Callable] = None

    def run_int(self, qparams, x_int: torch.Tensor,
                model: QLSTMConfig) -> torch.Tensor:
        """Stateless integer forward: the stateful datapath started from
        the zero reset carry."""
        y, _ = self.run_int_stateful(
            qparams, x_int, model,
            init_state(model, x_int.shape[0], device=x_int.device))
        return y


_REGISTRY: Dict[str, CellSpec] = {}


def register(spec: CellSpec) -> CellSpec:
    """Add a cell to the registry and return it."""
    _REGISTRY[spec.name] = spec
    return spec


def get(name: str) -> CellSpec:
    """The registered cell spec under ``name``; KeyError names the known
    cells when it does not exist."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown cell {name!r}; "
                       f"registered: {sorted(_REGISTRY)}") from None


def available() -> Tuple[str, ...]:
    """Names of every registered cell, sorted."""
    return tuple(sorted(_REGISTRY))


def state_shape(model: QLSTMConfig) -> Tuple[int, int, int]:
    """The per-stream carry shape ``(num_layers, state_arity, hidden)``."""
    spec = get(model.cell)
    return (model.num_layers, spec.state_arity, model.hidden_size)


def init_state(model: QLSTMConfig, batch: int,
               device: Optional[torch.device] = None):
    """The reset integer carry: per layer, ``state_arity`` zero
    ``(batch, hidden)`` int32 tensors."""
    spec = get(model.cell)
    z = lambda: torch.zeros(batch, model.hidden_size, dtype=torch.int32,
                            device=device)
    return tuple(tuple(z() for _ in range(spec.state_arity))
                 for _ in range(model.num_layers))


# Importing the cell modules registers them.
from repro_torch.cells import gru as _gru      # noqa: E402,F401
from repro_torch.cells import lstm as _lstm    # noqa: E402,F401
from repro_torch.cells import rglru as _rglru  # noqa: E402,F401
