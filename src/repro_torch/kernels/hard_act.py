"""Elementwise integer hard activations — the Hopper counterparts of
``repro/kernels/hard_act.py`` (the paper's C2).

  * :func:`hard_sigmoid_star` — HardSigmoid* in the three bit-identical
    methods ``arithmetic`` (shift, add, two selects, clip), ``step`` (the
    merged step table of ``hard_act.step_table``) and ``1to1`` (lookup in
    ``hard_act.one_to_one_table``) (``hard_sigmoid_star_pallas``);
  * :func:`hard_tanh` — clip at the quantised bounds of
    ``hard_act.hard_tanh_bounds`` (``hard_tanh_pallas``).

Both take codes of any shape (the reference's kernels take (rows, cols);
its ``ops`` wrappers flatten to that) and return codes of the input's
dtype.  Each takes the hand-written CUDA kernel of ``csrc/hard_act.cu``
for CUDA tensors — there is no fallback: if the kernel cannot be built or
launched, the call raises — and its plain torch version (``*_plain``)
only for tensors on the CPU.  The step and 1to1 tables are copied to the
device once per (spec, device) (``hard_act.step_table_tensors``,
``hard_act.one_to_one_table_tensor``).  ``block`` is accepted for the
reference's signature; the result cannot depend on it.

:data:`LAUNCHES` counts kernel launches by entry.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"hard_sigmoid_star": 0, "hard_tanh": 0}

_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
_METHOD_IDS = {"arithmetic": 0, "step": 1, "1to1": 2}
_HARD_TANH = 3
_ROUTE_IDS = {"bisect": 0, "words": 1, "bytes": 2}

#: Most thresholds a cascade route takes (``kCascadeCap`` in the source):
#: chunks of 32, 16, 8, 4, 2 and 1 slots at fixed offsets.
CASCADE_CAP = 63
#: Longest cascade with a bytes kernel of its own length (``kExactCap``).
EXACT_CAP = 16
_CHUNKS = ((32, 0), (16, 32), (8, 48), (4, 56), (2, 60), (1, 62))
_H = 0x80808080


def cascade_slots(route: "StepRoute") -> Tuple[int, ...]:
    """The slots of ``route``'s thresholds, in the kernel's order
    (``csrc/hard_act.cu``): slots ``0..n-1`` on the bytes route up to
    :data:`EXACT_CAP` thresholds, where it runs a kernel built for that
    length; otherwise the chunks whose length is a bit of ``n``, each at
    its fixed offset, which the kernel unrolls at compile-time slots and
    enters on one branch."""
    n = len(route.thresholds)
    if route.name == "bytes" and n <= EXACT_CAP:
        return tuple(range(n))
    return tuple(off + i for length, off in _CHUNKS if n & length
                 for i in range(length))


class HactArgs(ctypes.Structure):
    """Mirror of ``struct HactArgs`` in ``csrc/hard_act.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "out", "thr", "outs", "table")]
        + [("n", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "method", "slope_shift", "bound_int", "half_int", "one_int",
            "lo", "hi", "n_thr", "thr_smem", "table_min", "table_size",
            "vec", "step_route")])


class StepCascade(ctypes.Structure):
    """Mirror of ``struct StepCascade`` in ``csrc/hard_act.cu``."""

    _fields_ = [("n", ctypes.c_int), ("start", ctypes.c_uint)] + [
        (n, ctypes.c_uint * CASCADE_CAP) for n in ("thr", "sign", "delta")]


@dataclasses.dataclass(frozen=True)
class StepRoute:
    """How the ``step`` kernel runs one (table, code dtype): the route's
    name and the cascade it runs — the thresholds inside the dtype's
    range with their deltas, and ``start``, the output below all of them
    (the thresholds at or below the dtype's minimum folded in, those above
    its maximum dropped: no code of the dtype reaches them)."""

    name: str
    start: int
    thresholds: Tuple[int, ...]
    deltas: Tuple[int, ...]


@functools.lru_cache(maxsize=None)
def step_route(spec: hard_act.HardSigmoidStarSpec,
               dtype: torch.dtype) -> StepRoute:
    """The route of ``step`` for codes of ``dtype``: ``bisect`` past
    :data:`CASCADE_CAP` thresholds; ``bytes`` for int8 codes whose every
    partial sum of the cascade (``start`` plus deltas, none negative and
    none above 127) stays inside a byte; ``words`` otherwise."""
    thr, outs = hard_act.step_table(spec)
    info = torch.iinfo(dtype)
    kept = (thr > info.min) & (thr <= info.max)
    start = int(outs[int((thr <= info.min).sum())])
    deltas = np.diff(outs)[kept]
    if kept.sum() > CASCADE_CAP:
        name = "bisect"
    elif (dtype == torch.int8 and start >= info.min
          and start + int(deltas.sum()) <= info.max
          and bool(((deltas >= 0) & (deltas <= 127)).all())):
        name = "bytes"
    else:
        name = "words"
    return StepRoute(name, start, tuple(int(t) for t in thr[kept]),
                     tuple(int(d) for d in deltas))


@functools.lru_cache(maxsize=None)
def _cascade(route: StepRoute) -> Optional[StepCascade]:
    """``route``'s table as the kernel's parameter (None on ``bisect``).
    The bytes route's words (``csrc/hard_act.cu``'s header), each byte of
    a word alike: the start plus 128; per threshold, the low 7 bits of
    the threshold plus 128, the sign word, and the delta shifted to the
    top of a word."""
    if route.name == "bisect":
        return None
    c = StepCascade(n=len(route.thresholds))
    rep = lambda b: (b & 0xFF) * 0x01010101
    if route.name == "bytes":
        c.start = rep(route.start + 128)
    else:
        c.start = route.start & 0xFFFFFFFF
    for t, d, slot in zip(route.thresholds, route.deltas, cascade_slots(route)):
        if route.name == "bytes":
            c.thr[slot], c.sign[slot] = rep((t + 128) & 0x7F), _H if t < 0 else 0
            c.delta[slot] = d << 25
        else:
            c.thr[slot], c.delta[slot] = t & 0xFFFFFFFF, d
    return c


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/hard_act.cu``.  Raises when
    ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("hard_act")
    lib.hact_launch.argtypes = [ctypes.POINTER(HactArgs),
                                ctypes.POINTER(StepCascade), ctypes.c_int,
                                ctypes.c_void_p]
    lib.hact_launch.restype = ctypes.c_int
    lib.hact_args_size.restype = ctypes.c_int
    lib.hact_cascade_size.restype = ctypes.c_int
    lib.hact_error_string.argtypes = [ctypes.c_int]
    lib.hact_error_string.restype = ctypes.c_char_p
    if (lib.hact_args_size() != ctypes.sizeof(HactArgs)
            or lib.hact_cascade_size() != ctypes.sizeof(StepCascade)):
        raise RuntimeError("HactArgs or StepCascade layout differs between "
                           "Python and csrc/hard_act.cu")
    return lib


def _check(x: Tensor, method: str = "arithmetic"):
    if method not in _METHOD_IDS:
        raise ValueError(f"unknown HardSigmoid* method {method!r}; "
                         f"expected one of {hard_act.HARDSIGMOID_METHODS}")
    if x.dtype not in _CODE_DTYPES:
        raise ValueError(f"codes must be int8/int16/int32, got {x.dtype}")


def _check_cuda(x: Tensor):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {x.device}")


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def hard_sigmoid_star_plain(x_int: Tensor, *, cfg: FixedPointConfig,
                            method: str = "arithmetic", slope_shift: int = 3,
                            bound: float = 3.0, block: int = 1024) -> Tensor:
    """Plain torch version of :func:`hard_sigmoid_star` (same arguments,
    same result); ``1to1`` gives 0 for a code outside the table, as the
    kernels do."""
    _check(x_int, method)
    spec = hard_act.HardSigmoidStarSpec(cfg, slope_shift, bound)
    if method == "arithmetic":
        y = hard_act.hs_star_int_arithmetic(x_int, spec)
    elif method == "step":
        thr, outs = hard_act.step_table_tensors(spec, x_int.device)
        y = outs[torch.searchsorted(thr, x_int.to(torch.int32), right=True)]
    else:
        table = hard_act.one_to_one_table_tensor(spec, x_int.device)
        idx = x_int.to(torch.int64) - cfg.int_min
        inside = (idx >= 0) & (idx < table.numel())
        y = torch.where(inside, table[idx.clamp(0, table.numel() - 1)], 0)
    return y.to(x_int.dtype)


def hard_tanh_plain(x_int: Tensor, *, cfg: FixedPointConfig,
                    min_val: float = -1.0, max_val: float = 1.0,
                    block: int = 1024) -> Tensor:
    """Plain torch version of :func:`hard_tanh`."""
    _check(x_int)
    return hard_act.hard_tanh_int(x_int, cfg, min_val, max_val).to(x_int.dtype)


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _launch(x_int: Tensor, args: HactArgs, counter: str,
            cascade: Optional[StepCascade] = None) -> Tensor:
    """Fill the pointers and size of ``args`` and launch on the current
    stream (``cascade``: the step table of a cascade route)."""
    x = x_int.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    args.x, args.out, args.n = x.data_ptr(), out.data_ptr(), x.numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.hact_launch(ctypes.byref(args),
                         None if cascade is None else ctypes.byref(cascade),
                         x.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"hard_act kernel launch failed: "
                           f"{lib.hact_error_string(rc).decode()}")
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def _hs_launch(x_int: Tensor, spec: hard_act.HardSigmoidStarSpec,
               method: str, bisect: bool = False) -> Tensor:
    """Launch HardSigmoid* on CUDA codes; ``bisect`` sends ``step`` down
    the bisect route whatever the table (the earlier design, which
    ``chip_smoke.py`` times beside the route :func:`step_route` picks)."""
    cfg = spec.cfg
    args = HactArgs(method=_METHOD_IDS[method], slope_shift=spec.slope_shift,
                    bound_int=spec.bound_int, half_int=spec.half_int,
                    one_int=spec.one_int, lo=cfg.int_min, hi=cfg.int_max)
    cascade = None
    if method == "step":
        route = step_route(spec, x_int.dtype)
        cascade = None if bisect else _cascade(route)
        args.step_route = _ROUTE_IDS["bisect" if bisect else route.name]
        if cascade is None:
            thr, outs = hard_act.step_table_tensors(spec, x_int.device)
            args.thr, args.outs = thr.data_ptr(), outs.data_ptr()
            args.n_thr = thr.numel()
    elif method == "1to1":
        table = hard_act.one_to_one_table_tensor(spec, x_int.device)
        args.table, args.table_size = table.data_ptr(), table.numel()
        args.table_min = cfg.int_min
    return _launch(x_int, args, "hard_sigmoid_star", cascade)


def hard_sigmoid_star(x_int: Tensor, *, cfg: FixedPointConfig,
                      method: str = "arithmetic", slope_shift: int = 3,
                      bound: float = 3.0, block: int = 1024) -> Tensor:
    """Integer HardSigmoid* on codes of any shape -> codes (same dtype)."""
    _check(x_int, method)
    if x_int.device.type == "cpu":
        return hard_sigmoid_star_plain(x_int, cfg=cfg, method=method,
                                       slope_shift=slope_shift, bound=bound)
    _check_cuda(x_int)
    return _hs_launch(x_int, hard_act.HardSigmoidStarSpec(cfg, slope_shift, bound),
                      method)


def hard_tanh(x_int: Tensor, *, cfg: FixedPointConfig, min_val: float = -1.0,
              max_val: float = 1.0, block: int = 1024) -> Tensor:
    """Integer HardTanh on codes of any shape -> codes (same dtype)."""
    _check(x_int)
    if x_int.device.type == "cpu":
        return hard_tanh_plain(x_int, cfg=cfg, min_val=min_val, max_val=max_val)
    _check_cuda(x_int)
    lo, hi = hard_act.hard_tanh_bounds(cfg, min_val, max_val)
    return _launch(x_int, HactArgs(method=_HARD_TANH, lo=lo, hi=hi),
                   "hard_tanh")
