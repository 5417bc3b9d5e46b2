"""Tensor-level int8 quantisation policy — counterpart of
``repro/core/quant.py``.

Only the policy is ported so far: ``QuantConfig`` and its three presets.
The quantised weight paths (W8, W8A8), fake-quant for QAT and the int8
KV cache are the work of a later slice; the model code raises where a
config asks for them.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantisation policy for a module / the whole model.

    mode:
      "none"  — full precision.
      "w8"    — weight-only int8.
      "w8a8"  — weights and activations int8.
    p2_scale: round scales to powers of two (paper-faithful; requant = shift).
    per_channel: per-output-channel weight scales.
    quantize_kv: int8 KV cache (decode shapes).
    """

    mode: str = "none"
    p2_scale: bool = True
    per_channel: bool = True
    quantize_kv: bool = False
    stochastic: bool = False

    @property
    def enabled(self) -> bool:
        return self.mode != "none"

    @property
    def act_quant(self) -> bool:
        return self.mode == "w8a8"


NO_QUANT = QuantConfig("none")
W8 = QuantConfig("w8")
W8A8 = QuantConfig("w8a8")
