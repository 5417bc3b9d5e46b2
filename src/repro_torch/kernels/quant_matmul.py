"""Integer GEMM with the fused S5 requantisation — the Hopper counterpart
of ``repro/kernels/quant_matmul.py`` (the paper's C1: narrow integer
arithmetic, late rounding).

:func:`quant_matmul` takes the hand-written CUDA kernel of
``csrc/quant_matmul.cu`` for CUDA tensors — there is no fallback: if the
kernel cannot be built or launched, the call raises — and its plain torch
version :func:`quant_matmul_plain` only for tensors on the CPU.  int8
codes run on the int8 tensor cores (``mma.sync`` m16n8k32, after a
transposing pass that writes w^T into a scratch the wrapper allocates);
int16/int32 codes, which Hopper's tensor cores do not take, on the CUDA
cores.  Both modes of the reference run in one kernel:

  * ``out_mode="int32"``: the raw int32 accumulator (wrapping at 2**32,
    as XLA's int32 dot does);
  * ``out_mode="requant"``: one round-half-up shift by ``cfg.frac_bits``
    and saturation after the last K tile, stored in
    ``cfg.storage_dtype``.

``block`` is accepted for the reference's signature; the kernel tiles
the product its own way and the result cannot depend on it.

:data:`LAUNCHES` counts kernel launches by ``out_mode``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import _build
from repro_torch.kernels import ref

Tensor = torch.Tensor

LAUNCHES = {"int32": 0, "requant": 0}

OUT_MODES = ("int32", "requant")
_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)


class QmmArgs(ctypes.Structure):
    """Mirror of ``struct QmmArgs`` in ``csrc/quant_matmul.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("x", "w", "out", "wt")]
                + [(n, ctypes.c_int) for n in (
                    "M", "K", "N", "requant", "shift", "lo", "hi",
                    "out_bytes")])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/quant_matmul.cu``.  Raises
    when ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("quant_matmul")
    lib.qmm_launch.argtypes = [ctypes.POINTER(QmmArgs), ctypes.c_int,
                               ctypes.c_void_p]
    lib.qmm_launch.restype = ctypes.c_int
    lib.qmm_args_size.restype = ctypes.c_int
    lib.qmm_error_string.argtypes = [ctypes.c_int]
    lib.qmm_error_string.restype = ctypes.c_char_p
    if lib.qmm_args_size() != ctypes.sizeof(QmmArgs):
        raise RuntimeError("QmmArgs layout differs between Python and "
                           "csrc/quant_matmul.cu")
    return lib


def _check(x: Tensor, w: Tensor, out_mode: str,
           cfg: Optional[FixedPointConfig]):
    if out_mode not in OUT_MODES:
        raise ValueError(f"out_mode must be one of {OUT_MODES}, got {out_mode!r}")
    if out_mode == "requant" and cfg is None:
        raise ValueError("out_mode='requant' needs a FixedPointConfig")
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"expected x (M, K) and w (K, N), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _CODE_DTYPES or w.dtype not in _CODE_DTYPES:
        raise ValueError(f"x and w must hold int8/int16/int32 codes, got "
                         f"{x.dtype} and {w.dtype}")


def quant_matmul_plain(x: Tensor, w: Tensor, *, out_mode: str = "int32",
                       cfg: Optional[FixedPointConfig] = None,
                       block: Tuple[int, int, int] = (128, 128, 128)) -> Tensor:
    """Plain torch version of :func:`quant_matmul` (same arguments, same
    result): the exact product modulo 2**32, then the S5 epilogue."""
    _check(x, w, out_mode, cfg)
    acc = ref.quant_matmul_ref(x, w)
    if out_mode == "int32":
        return acc
    prod = fxp.product_config(cfg, cfg)
    return fxp.requantize(acc, prod, cfg).to(cfg.storage_dtype)


def _launch(x: Tensor, w: Tensor, out_mode: str,
            cfg: Optional[FixedPointConfig]) -> Tensor:
    """Launch the kernel on the current stream for validated operands on
    one device; returns the (M, N) result."""
    dt = torch.promote_types(x.dtype, w.dtype)
    x = x.to(dt).contiguous()
    w = w.to(dt).contiguous()
    m, k = x.shape
    n = w.shape[1]
    requant = out_mode == "requant"
    out_dtype = cfg.storage_dtype if requant else torch.int32
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    lib = load_library()
    args = QmmArgs(x=x.data_ptr(), w=w.data_ptr(), out=out.data_ptr(),
                   M=m, K=k, N=n, requant=int(requant),
                   out_bytes=out.element_size())
    if dt == torch.int8:  # w^T, K rounded up to 16 (the kernel zero-pads it)
        wt = torch.empty((n, -(-k // 16) * 16), dtype=torch.int8,
                         device=x.device)
        args.wt = wt.data_ptr()
    if requant:       # S5: product format -> cfg, saturated
        args.shift = fxp.product_config(cfg, cfg).frac_bits - cfg.frac_bits
        args.lo, args.hi = cfg.int_min, cfg.int_max
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.qmm_launch(ctypes.byref(args), x.element_size(), stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: "
                           f"{lib.qmm_error_string(rc).decode()}")
    LAUNCHES[out_mode] += 1
    return out


def quant_matmul(x: Tensor, w: Tensor, *, out_mode: str = "int32",
                 cfg: Optional[FixedPointConfig] = None,
                 block: Tuple[int, int, int] = (128, 128, 128)) -> Tensor:
    """x: (M, K) codes, w: (K, N) codes (int8/int16/int32) -> (M, N) int32
    accumulator, or ``cfg.storage_dtype`` codes with ``out_mode="requant"``.
    Operands of different code dtypes are widened to the wider one (the
    products are the same)."""
    _check(x, w, out_mode, cfg)
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w, out_mode=out_mode, cfg=cfg, block=block)
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"the CUDA kernel takes CUDA tensors on one device, "
                         f"got {x.device} and {w.device}")
    return _launch(x, w, out_mode, cfg)
