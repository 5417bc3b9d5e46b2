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
import functools

import torch

from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"hard_sigmoid_star": 0, "hard_tanh": 0}

_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)
_METHOD_IDS = {"arithmetic": 0, "step": 1, "1to1": 2}
_HARD_TANH = 3


class HactArgs(ctypes.Structure):
    """Mirror of ``struct HactArgs`` in ``csrc/hard_act.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "out", "thr", "outs", "table")]
        + [("n", ctypes.c_longlong)]
        + [(n, ctypes.c_int) for n in (
            "method", "slope_shift", "bound_int", "half_int", "one_int",
            "lo", "hi", "n_thr", "thr_smem", "table_min", "table_size",
            "vec")])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/hard_act.cu``.  Raises when
    ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("hard_act")
    lib.hact_launch.argtypes = [ctypes.POINTER(HactArgs), ctypes.c_int,
                                ctypes.c_void_p]
    lib.hact_launch.restype = ctypes.c_int
    lib.hact_args_size.restype = ctypes.c_int
    lib.hact_error_string.argtypes = [ctypes.c_int]
    lib.hact_error_string.restype = ctypes.c_char_p
    if lib.hact_args_size() != ctypes.sizeof(HactArgs):
        raise RuntimeError("HactArgs layout differs between Python and "
                           "csrc/hard_act.cu")
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

def _launch(x_int: Tensor, args: HactArgs, counter: str) -> Tensor:
    """Fill the pointers and size of ``args`` and launch on the current
    stream."""
    x = x_int.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = load_library()
    args.x, args.out, args.n = x.data_ptr(), out.data_ptr(), x.numel()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.hact_launch(ctypes.byref(args), x.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"hard_act kernel launch failed: "
                           f"{lib.hact_error_string(rc).decode()}")
    LAUNCHES[counter] += 1
    return out


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def hard_sigmoid_star(x_int: Tensor, *, cfg: FixedPointConfig,
                      method: str = "arithmetic", slope_shift: int = 3,
                      bound: float = 3.0, block: int = 1024) -> Tensor:
    """Integer HardSigmoid* on codes of any shape -> codes (same dtype)."""
    _check(x_int, method)
    if x_int.device.type == "cpu":
        return hard_sigmoid_star_plain(x_int, cfg=cfg, method=method,
                                       slope_shift=slope_shift, bound=bound)
    _check_cuda(x_int)
    spec = hard_act.HardSigmoidStarSpec(cfg, slope_shift, bound)
    args = HactArgs(method=_METHOD_IDS[method], slope_shift=slope_shift,
                    bound_int=spec.bound_int, half_int=spec.half_int,
                    one_int=spec.one_int, lo=cfg.int_min, hi=cfg.int_max)
    if method == "step":
        thr, outs = hard_act.step_table_tensors(spec, x_int.device)
        args.thr, args.outs = thr.data_ptr(), outs.data_ptr()
        args.n_thr = thr.numel()
    elif method == "1to1":
        table = hard_act.one_to_one_table_tensor(spec, x_int.device)
        args.table, args.table_size = table.data_ptr(), table.numel()
        args.table_min = cfg.int_min
    return _launch(x_int, args, "hard_sigmoid_star")


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
