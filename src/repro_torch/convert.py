"""Carry weights across from the JAX reference package.

The reference draws its initial weights from ``jax.random``, which torch
cannot reproduce, so sharing a model between the two packages means
moving the numbers: take the reference session's params with numpy
arrays at the leaves (``jax.tree_util.tree_map(np.asarray,
session.params)``) and hand them here.  Then
``repro_torch.build(model, accel, params=params_from_reference(tree))``
and ``repro.build(model, accel, params=...)`` compute the same thing from
the same numbers.  For the LM side, :func:`lm_params_from_reference`
does the same for the tree of ``repro.models.transformer.init_model``,
and :func:`train_state_from_reference` /
:func:`lm_train_state_from_reference` for a whole QAT or LM train state.
This module imports neither JAX nor the reference: it
only walks dicts and lists of array-likes.
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch


def _convert(tree: Any, dtype: Optional[torch.dtype], device,
             floats_only: bool = False) -> Any:
    if isinstance(tree, dict):
        return {k: _convert(v, dtype, device, floats_only)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_convert(v, dtype, device, floats_only) for v in tree]
    arr = np.array(tree)
    if floats_only and not np.issubdtype(arr.dtype, np.floating):
        return torch.as_tensor(arr, device=device)
    return torch.as_tensor(arr, dtype=dtype, device=device)


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


def lm_params_from_reference(tree: Any,
                             device: Union[str, torch.device, None] = None,
                             dtype: Optional[torch.dtype] = torch.float32):
    """The reference LM's params (``init_model(cfg, key)[0]`` with numpy
    arrays at the leaves: dicts, and lists for ``groups``/``tail``, in the
    stacked layout) -> the port's tree for
    ``repro_torch.models.transformer``, leaf for leaf, on ``device``
    (default: the CPU).  Float leaves become ``dtype``; integer leaves —
    the int8 codes of ``quantize_model_params``' ``{"q", "s"}`` serve
    weights — keep their dtype, as they are."""
    return _convert(tree, dtype, device, floats_only=True)


def train_state_from_reference(tree: Any,
                               device: Union[str, torch.device, None] = None):
    """The reference's QAT train state (``{"params", "opt": {"mu", "nu",
    "count"}, "step"}`` with numpy arrays at the leaves) -> the port's, each
    leaf keeping its dtype (float32 params and moments, int32 counts), on
    ``device`` (default: the CPU) — a reference run continued in the port
    starts from these."""
    return _convert(tree, None, device)


# The LM's train state (``training.step.init_train_state``: params, AdamW
# moments and count, step and, under int8 gradient compression,
# ``grad_err``) converts leaf for leaf the same way.
lm_train_state_from_reference = train_state_from_reference
