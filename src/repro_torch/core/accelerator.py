"""Parameterised accelerator configuration — the paper's Table 2 (C4),
with the plan resolved for an NVIDIA Hopper card.

Counterpart of ``repro/core/accelerator.py``.  The config value strings
are the reference's, so one parametrisation drives both packages:

  FPGA meta-parameter            ->  field             values
  ALU_resource_type DSP|LUT      ->  compute_unit      mxu|vpu
  weight_resource_type
      BRAM|LUTRAM|AUTO           ->  weight_memory     vmem|hbm|auto
  HardSigmoid*_method            ->  hs_method         arithmetic|1to1|step
  HardTanh_threshold             ->  ht_min/ht_max
  ALU pipelining (C3)            ->  alu_mode          pipelined|per_step
  fixed-point format (a,b)       ->  fxp
  execution engine               ->  backend           auto|ref|xla|pallas

How the TPU-named values map onto Hopper:

  * ``backend``: ``pallas`` is the engine of ``backends/fused.py``, which
    launches the hand-written CUDA kernels of ``kernels/qlstm_cell.py``;
    ``xla`` is the general per-step torch engine of ``backends/scan.py``;
    ``ref`` is the oracle of ``backends/ref.py``.
  * ``weight_memory``: ``vmem`` means the weights are staged into the
    kernel's shared memory, ``hbm`` that they stay in device memory.
    :data:`VMEM_BUDGET_BYTES` is the per-block shared-memory budget of an
    H100 (232,448 bytes, NVIDIA's data sheet), not the TPU's VMEM.
  * ``compute_unit``: ``mxu`` and ``vpu`` both run the CUDA-core int32
    MAC today; an int8 tensor-core path is later work, so
    ``plan()["mxu_fill_fraction"]`` is ``None`` (the TPU figure measured
    128x128 MXU tiles, which Hopper does not have).

``AcceleratorConfig`` is the single source of truth for the moved knobs;
``resolve_model()`` honours the legacy model-side mirrors with a
``DeprecationWarning`` exactly as the reference does.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional

from repro_torch.core.fixed_point import FixedPointConfig, FXP_4_8
from repro_torch.core.qlstm import ActivationConfig, QLSTMConfig

# Shared memory one thread block may claim on an H100 (data sheet: 227 KB
# of the SM's 256 KB).  Weights that fit stay in shared memory for the
# whole sequence; larger ones are read from device memory.
VMEM_BUDGET_BYTES = 232_448

ALU_MODES = ("pipelined", "per_step")
HS_METHODS = ("arithmetic", "1to1", "step")
BACKENDS = ("auto", "ref", "pallas", "xla")


@dataclasses.dataclass(frozen=True, init=False)
class AcceleratorConfig:
    """Table-2 implementation meta-parameters.

    ``backend`` picks the engine behind ``Accelerator.infer``: ``auto``
    (the fused CUDA kernels when the configuration supports them, else
    the general per-step engine) or an explicit ``ref`` | ``pallas`` |
    ``xla``.  ``pipelined_alu`` is a deprecated constructor alias of
    ``alu_mode``."""

    compute_unit: str = "mxu"       # mxu (DSP) | vpu (LUT)
    weight_memory: str = "auto"     # vmem (shared memory) | hbm | auto
    hs_method: str = "step"         # arithmetic | 1to1 | step
    ht_min: float = -1.0
    ht_max: float = 1.0
    alu_mode: str = "pipelined"     # C3: pipelined (late rounding) | per_step
    fxp: FixedPointConfig = FXP_4_8
    vmem_budget: int = VMEM_BUDGET_BYTES
    backend: str = "auto"           # auto | ref | pallas | xla

    def __init__(self, compute_unit: str = "mxu", weight_memory: str = "auto",
                 hs_method: str = "step", ht_min: float = -1.0,
                 ht_max: float = 1.0, alu_mode: str = "pipelined",
                 fxp: FixedPointConfig = FXP_4_8,
                 vmem_budget: int = VMEM_BUDGET_BYTES, backend: str = "auto",
                 pipelined_alu: Optional[bool] = None):
        if pipelined_alu is not None:
            warnings.warn(
                "AcceleratorConfig(pipelined_alu=...) is deprecated; use "
                "alu_mode='pipelined'|'per_step'", DeprecationWarning,
                stacklevel=2)
            alu_mode = "pipelined" if pipelined_alu else "per_step"
        if compute_unit not in ("mxu", "vpu"):
            raise ValueError(f"compute_unit must be mxu|vpu, got {compute_unit}")
        if weight_memory not in ("vmem", "hbm", "auto"):
            raise ValueError("weight_memory must be vmem|hbm|auto")
        if hs_method not in HS_METHODS:
            raise ValueError(f"hs_method must be one of {HS_METHODS}")
        if alu_mode not in ALU_MODES:
            raise ValueError(f"alu_mode must be one of {ALU_MODES}")
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}")
        for name, val in (("compute_unit", compute_unit),
                          ("weight_memory", weight_memory),
                          ("hs_method", hs_method), ("ht_min", ht_min),
                          ("ht_max", ht_max), ("alu_mode", alu_mode),
                          ("fxp", fxp), ("vmem_budget", vmem_budget),
                          ("backend", backend)):
            object.__setattr__(self, name, val)

    @property
    def pipelined_alu(self) -> bool:
        """Deprecated read alias: ``alu_mode == 'pipelined'``."""
        return self.alu_mode == "pipelined"


PAPER_DEFAULT = AcceleratorConfig()
PAPER_NO_MXU = AcceleratorConfig(compute_unit="vpu")
BASELINE_15 = AcceleratorConfig(
    compute_unit="mxu", hs_method="1to1", alu_mode="per_step",
    fxp=FixedPointConfig(8, 16))


# (field on AcceleratorConfig, owner of the legacy mirror, legacy field name)
_MOVED_KNOBS = (
    ("fxp", "model", "fxp"),
    ("alu_mode", "model", "alu_mode"),
    ("hs_method", "acts", "hs_method"),
    ("ht_min", "acts", "ht_min"),
    ("ht_max", "acts", "ht_max"),
)


def _default_of(cls, field_name):
    for f in dataclasses.fields(cls):
        if f.name == field_name:
            return f.default
    raise KeyError(field_name)


def resolve_model(model: QLSTMConfig, accel: AcceleratorConfig,
                  warn: bool = True) -> QLSTMConfig:
    """Merge legacy model-side knobs into one consistent ``QLSTMConfig``:
    a non-default accelerator value wins; a legacy value set alone wins
    with a ``DeprecationWarning``; a conflict warns and the accelerator
    wins."""
    resolved: Dict[str, object] = {}
    for acc_field, owner, legacy in _MOVED_KNOBS:
        acc_val = getattr(accel, acc_field)
        acc_dflt = _default_of(AcceleratorConfig, acc_field)
        if owner == "model":
            old_val = getattr(model, legacy)
            old_dflt = _default_of(QLSTMConfig, legacy)
        else:
            old_val = getattr(model.acts, legacy)
            old_dflt = _default_of(ActivationConfig, legacy)
        if acc_val == acc_dflt and old_val != old_dflt:
            if warn:
                warnings.warn(
                    f"setting {legacy!r} on "
                    f"{'QLSTMConfig' if owner == 'model' else 'ActivationConfig'}"
                    f" is deprecated; set AcceleratorConfig.{acc_field} "
                    f"instead (honouring the legacy value {old_val!r} for "
                    f"this release)", DeprecationWarning, stacklevel=3)
            resolved[acc_field] = old_val
        else:
            if (warn and acc_val != acc_dflt and old_val != old_dflt
                    and old_val != acc_val):
                warnings.warn(
                    f"{legacy!r} set to {old_val!r} on the model config but "
                    f"{acc_val!r} on AcceleratorConfig; the accelerator "
                    f"value wins", DeprecationWarning, stacklevel=3)
            resolved[acc_field] = acc_val

    acts = dataclasses.replace(model.acts, hs_method=resolved["hs_method"],
                               ht_min=resolved["ht_min"],
                               ht_max=resolved["ht_max"])
    return dataclasses.replace(model, acts=acts, fxp=resolved["fxp"],
                               alu_mode=resolved["alu_mode"])


def sync_accelerator(model: QLSTMConfig,
                     accel: AcceleratorConfig) -> AcceleratorConfig:
    """An AcceleratorConfig whose moved knobs match a (possibly
    legacy-style) resolved model."""
    m = resolve_model(model, accel, warn=False)
    return dataclasses.replace(accel, fxp=m.fxp, alu_mode=m.alu_mode,
                               hs_method=m.acts.hs_method,
                               ht_min=m.acts.ht_min, ht_max=m.acts.ht_max)


def weight_bytes(model: QLSTMConfig, acc: AcceleratorConfig) -> int:
    """Bytes of quantised weights+biases the accelerator must hold."""
    from repro_torch import cells  # lazy: cells imports this module's deps
    return cells.get(model.cell).weight_bytes(model, acc)


def lstm_weight_bytes(model: QLSTMConfig, acc: AcceleratorConfig) -> int:
    """Alias of :func:`weight_bytes` under its earlier name; correct for
    every cell, not just the LSTM."""
    return weight_bytes(model, acc)


def resolve_weight_memory(model: QLSTMConfig, acc: AcceleratorConfig) -> str:
    """AUTO spill decision: shared memory while the weights fit the
    per-block budget, else device memory."""
    if acc.weight_memory != "auto":
        return acc.weight_memory
    return "vmem" if weight_bytes(model, acc) <= acc.vmem_budget else "hbm"


def resolve_backend(model: QLSTMConfig, acc: AcceleratorConfig) -> str:
    """Plan-driven engine choice (an explicit override passes through):
    the fused kernels when the model's cell has them and the configuration
    is the point they implement, else the general per-step engine."""
    if acc.backend != "auto":
        return acc.backend
    from repro_torch import cells
    spec = cells.get(model.cell)
    fused_ok = (spec.supports_fused is not None
                and spec.supports_fused(model, acc) is None)
    return "pallas" if fused_ok else "xla"


def resolve_stateful_backend(model: QLSTMConfig,
                             acc: AcceleratorConfig) -> str:
    """Engine for the cross-window stateful path: every engine carries
    state, so this equals the stateless resolution."""
    return resolve_backend(model, acc)


def resolve_state_residency(model: QLSTMConfig,
                            acc: AcceleratorConfig) -> str:
    """Where serving keeps per-stream carries: ``device`` (the slot table
    the fused slot kernel gathers from and scatters to) when the fused
    engine serves the stateful path, else ``host``."""
    return ("device" if resolve_stateful_backend(model, acc) == "pallas"
            else "host")


def plan(model: QLSTMConfig, acc: AcceleratorConfig) -> Dict:
    """Resolve every implementation decision for (model, accelerator).
    Same keys as the reference; ``mxu_fill_fraction`` is ``None`` until
    the MAC runs on tensor cores (module docstring)."""
    from repro_torch import cells
    model = resolve_model(model, acc, warn=False)
    acc = sync_accelerator(model, acc)
    wmem = resolve_weight_memory(model, acc)
    return {
        "cell": model.cell,
        "state_shape": cells.state_shape(model),
        "compute_unit": acc.compute_unit,
        "weight_memory": wmem,
        "weight_bytes": weight_bytes(model, acc),
        "vmem_resident": wmem == "vmem",
        "hs_method": acc.hs_method,
        "pipelined_alu": acc.alu_mode == "pipelined",
        "alu_mode": acc.alu_mode,
        "fxp": acc.fxp,
        "backend": resolve_backend(model, acc),
        "stateful_backend": resolve_stateful_backend(model, acc),
        "state_residency": resolve_state_residency(model, acc),
        "mxu_fill_fraction": None,
    }
