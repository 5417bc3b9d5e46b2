"""Minimal module system — counterpart of ``repro/models/modules.py``.

Params are nested dicts (and lists) of tensors; every leaf is created
together with its logical-axes tuple, as in the reference, so that
``init_model`` returns the same ``(params, axes)`` twin trees.  Random
leaves come from an explicit ``torch.Generator`` and are made on its
device: the numbers cannot match ``jax.random``, only the distribution
(tests carry the reference's numbers across with
``convert.lm_params_from_reference``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch

Tensor = torch.Tensor


@dataclasses.dataclass
class Boxed:
    value: Any
    axes: Tuple[Optional[str], ...]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v) for v in tree]
    return fn(tree)


def unbox(tree):
    """Boxed tree -> (params, axes) twin trees."""
    return _map(lambda b: b.value, tree), _map(lambda b: b.axes, tree)


def tree_index(tree, i: int):
    """Slice ``[i]`` of every leaf: one layer of a stacked params tree."""
    return _map(lambda x: x[i], tree)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def param(gen: Optional[torch.Generator], shape, axes,
          scale: Optional[float] = None, dtype: torch.dtype = torch.float32,
          init: str = "normal") -> Boxed:
    """One parameter leaf on ``gen``'s device, with its logical axes.

    ``init`` "zeros" / "ones" draw nothing; "normal" is a standard normal
    times ``scale``, by default fan-in scaling on the contracting dim
    (``shape[-2]`` for two or more dims, else ``shape[-1]``).  With
    ``gen=None`` the leaf is a shape-only tensor on the ``meta`` device
    (nothing is allocated or drawn)."""
    shape = tuple(shape)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in rank")
    if gen is None:
        v = torch.empty(shape, dtype=dtype, device="meta")
    elif init == "zeros":
        v = torch.zeros(shape, dtype=dtype, device=gen.device)
    elif init == "ones":
        v = torch.ones(shape, dtype=dtype, device=gen.device)
    else:
        if scale is None:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = fan_in ** -0.5
        v = torch.randn(shape, generator=gen, dtype=dtype,
                        device=gen.device) * scale
    return Boxed(v, tuple(axes))


def count_params(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def cast_tree(params, dtype: torch.dtype):
    """Floating leaves cast to ``dtype`` (differentiably: the gradient
    flows back to the source leaf in its own dtype); others as they are."""
    return _map(lambda x: x.to(dtype) if x.is_floating_point() else x, params)
