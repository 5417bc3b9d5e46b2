"""Collective traffic per device, by kind: parsed from an optimized HLO
module's text (the reference's dumps), or counted as a torch program runs.

:func:`collective_bytes` is the reference's parser, copied as it is: for
every all-gather / all-reduce / reduce-scatter / all-to-all /
collective-permute (including async -start forms, excluding -done echoes)
it sums the RESULT buffer sizes.  SPMD modules are per-device, so these
are per-device bytes.

:class:`CollectiveCounter` is its torch-side counterpart: a dispatch mode
over the functional collectives that ``DTensor`` issues
(``_c10d_functional`` and its autograd twins, and ``DTensor``'s
shard-to-shard all-to-all), summing each one's RESULT bytes on this rank
under the same keys (``all-gather``, ``all-reduce``, ``reduce-scatter``,
``all-to-all``, ``collective-permute``, ``total``, ``count``), so
``analysis/report.py`` and ``core/energy.roofline_terms`` read either.
It lets every op on a ``DTensor`` through to ``DTensor`` first and counts
the collectives that ``DTensor`` then runs on the local shards.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# result types: everything between '=' and the op name, e.g.
#   %ag = bf16[4,128]{1,0} all-gather(...)
#   %ar = (f32[8]{0}, f32[8]{0}) all-reduce-start(...)
_LINE_RE = re.compile(
    r"=\s*(?P<types>\(?[a-z0-9]+\[[^=]*?)\s*"
    r"(?P<op>" + "|".join(_COLLECTIVES) + r")(?P<suffix>-start|-done)?\(")

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")


def _shape_bytes(types: str) -> int:
    total = 0
    for dt, dims in _SHAPE_RE.findall(types):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Per-device bytes by collective kind (+ 'total' and 'count')."""
    out: Dict[str, float] = defaultdict(float)
    count = 0
    for m in _LINE_RE.finditer(hlo_text):
        if m.group("suffix") == "-done":
            continue  # the -start already carries the payload
        b = _shape_bytes(m.group("types"))
        # async -start results are (input, output[, context]) tuples; the
        # payload moved is ~ the output. Halve the tuple double-count.
        if m.group("suffix") == "-start":
            b = b / 2
        out[m.group("op")] += b
        count += 1
    out["total"] = sum(v for k, v in out.items() if k in _COLLECTIVES)
    out["count"] = count
    return dict(out)


# functional collective op (overload packet name) -> kind; an op not named
# here is not a collective (``wait_tensor`` only waits for one).
_TORCH_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
    "broadcast": "collective-permute",
    "broadcast_": "collective-permute",
    "permute_tensor": "collective-permute",
}
_TORCH_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd",
                     "_dtensor")


def _result_bytes(out) -> int:
    if isinstance(out, torch.Tensor):
        return out.numel() * out.element_size()
    if isinstance(out, (list, tuple)):
        return sum(_result_bytes(o) for o in out)
    return 0


class CollectiveCounter(TorchDispatchMode):
    """Counts the collectives a torch program runs on this rank while the
    mode is active; :meth:`summary` gives :func:`collective_bytes`'s
    dict.  ``ops`` keeps (op name, result bytes) in issue order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # DTensor runs first, then its comms
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in _TORCH_NAMESPACES and name in _TORCH_COLLECTIVES:
            self.ops.append((f"{ns}.{name}", _result_bytes(out)))
        return out

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = defaultdict(float)
        for op, b in self.ops:
            out[_TORCH_COLLECTIVES[op.split(".")[-1]]] += b
        out["total"] = sum(v for k, v in out.items() if k in _COLLECTIVES)
        out["count"] = len(self.ops)
        return dict(out)
