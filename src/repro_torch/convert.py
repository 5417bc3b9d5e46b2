"""Carry weights across from the JAX reference package.

The reference draws its initial weights from ``jax.random``, which torch
cannot reproduce, so sharing a model between the two packages means
moving the numbers: take the reference session's params with numpy
arrays at the leaves (``jax.tree_util.tree_map(np.asarray,
session.params)``) and hand them here.  Then
``repro_torch.build(model, accel, params=params_from_reference(tree))``
and ``repro.build(model, accel, params=...)`` compute the same thing from
the same numbers.  This module imports neither JAX nor the reference: it
only walks dicts and lists of array-likes.
"""

from __future__ import annotations

from typing import Any, Union

import numpy as np
import torch


def _convert(tree: Any, dtype: torch.dtype, device) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dtype, device) for v in tree]
    return torch.as_tensor(np.array(tree), dtype=dtype, device=device)


def params_from_reference(tree: Any,
                          device: Union[str, torch.device, None] = None):
    """The reference's float master params -> the port's float32 params
    dict (``{"layers": [{"w_x", "w_h", "b"}, ...], "dense": {"w", "b"}}``)
    on ``device`` (default: the CPU; ``build`` moves them to the
    session's device)."""
    return _convert(tree, torch.float32, device)


def qparams_from_reference(tree: Any,
                           device: Union[str, torch.device, None] = None):
    """The reference's quantised integer codes -> the port's int32 codes
    dict on ``device``."""
    return _convert(tree, torch.int32, device)
