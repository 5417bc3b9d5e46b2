"""The paper's own model (LSTM + dense head) behind the same framework
interface as the LM architectures — counterpart of
``repro/models/lstm_model.py``: (params, axes) init, the train forward
(MSE regression, single-step-ahead prediction on PeMS-like series), the
QAT forward, and the integer serve path that matches the accelerator bit
for bit.

The deployment surface is the session API: ``repro_torch.build(model,
accel)`` owns quantisation and backend dispatch; ``serve_int`` below is
the reference's deprecation shim over it.
"""

from __future__ import annotations

import warnings
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.accelerator import AcceleratorConfig
from repro_torch.core.qlstm import (QLSTMConfig, forward_float, forward_qat,
                                    init_params)

Tensor = torch.Tensor


def init_lstm_model(cfg: QLSTMConfig, generator: torch.Generator,
                    device: Optional[torch.device] = None) -> Tuple[Any, Any]:
    """(params, axes): float32 master params drawn from ``generator`` (on
    ``device``) and their logical axes — all ``None``: the LSTM is tiny
    and every weight is replicated."""
    params = init_params(cfg, generator, device=device)

    def axes(tree):
        if isinstance(tree, dict):
            return {k: axes(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(axes(v) for v in tree)
        return tuple(None for _ in tree.shape)

    return params, axes(params)


def forward(params, x: Tensor, cfg: QLSTMConfig, mode: str = "qat") -> Tensor:
    """x: (B, T, M) float -> (B, P).  mode: float | qat."""
    return forward_qat(params, x, cfg) if mode == "qat" \
        else forward_float(params, x, cfg)


def loss_fn(params, batch: Dict[str, Tensor], cfg: QLSTMConfig,
            mode: str = "qat") -> Tuple[Tensor, Dict[str, Tensor]]:
    y = forward(params, batch["x"], cfg, mode)
    mse = torch.mean(torch.square(y - batch["y"]))
    return mse, {"mse": mse}


def serve_int(params, x, cfg: QLSTMConfig,
              accel: Optional[AcceleratorConfig] = None,
              use_kernel: bool = True) -> Tensor:
    """Deployment path: float inputs -> integer codes -> accelerator
    datapath -> float outputs, on the params' device.

    .. deprecated:: 0.2
       Use the session API instead — it caches the quantised params and
       the datapath across calls::

           sess = repro_torch.build(cfg, accel, params=params).quantize()
           y = sess.infer(x, path="int")

    ``use_kernel=False`` forces the ``xla`` (scan oracle) backend."""
    warnings.warn("lstm_model.serve_int is deprecated; use "
                  "repro_torch.build(cfg, accel, params=params).quantize()"
                  ".infer(x, path='int')", DeprecationWarning, stacklevel=2)
    from repro_torch import api
    device = params["dense"]["w"].device
    sess = api.build(cfg, accel or AcceleratorConfig(), params=params,
                     device=device).quantize()
    return sess.infer(x, path="int", backend=None if use_kernel else "xla")
