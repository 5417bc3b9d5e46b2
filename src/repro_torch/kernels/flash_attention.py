"""Online-softmax (flash) attention — the Hopper counterpart of
``repro/kernels/flash_attention.py``.

:func:`flash_attention` takes q (BH, T, hd) and k/v (BH, S, hd), f32 or
bf16, and returns (BH, T, hd) in q's dtype, accumulated in fp32, with a
causal mask, a sliding ``window`` (key s is kept for query t when
``t - s < window``) and the padded-kv mask of the reference.  Head
grouping (GQA) is the caller's job (``ops.mha_flash``).  It takes the
hand-written CUDA kernel of ``csrc/flash_attention.cu`` (both products on
the TF32 tensor cores in 3xTF32 form) for CUDA tensors —
there is no fallback: if the kernel cannot be built or launched, the call
raises — and its plain torch version :func:`flash_attention_plain` (the
masked fp32 softmax of ``ref.attention_ref``) only for tensors on the
CPU.  ``block_q``/``block_k`` are accepted for the reference's
signature; the kernel tiles its own way.  The kernel needs hd a multiple
of 4 and at most 256.

:data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

Tensor = torch.Tensor

LAUNCHES = {"flash_attention": 0}

_DTYPES = (torch.float32, torch.bfloat16)


class FlashArgs(ctypes.Structure):
    """Mirror of ``struct FlashArgs`` in ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("q", "k", "v", "o")]
                + [(n, ctypes.c_int) for n in (
                    "BH", "T", "S", "hd", "causal", "has_window", "window")]
                + [("scale", ctypes.c_float)])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/flash_attention.cu``.  Raises
    when ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("flash_attention")
    lib.flash_launch.argtypes = [ctypes.POINTER(FlashArgs), ctypes.c_int,
                                 ctypes.c_void_p]
    lib.flash_launch.restype = ctypes.c_int
    lib.flash_args_size.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    if lib.flash_args_size() != ctypes.sizeof(FlashArgs):
        raise RuntimeError("FlashArgs layout differs between Python and "
                           "csrc/flash_attention.cu")
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor):
    if q.ndim != 3 or k.ndim != 3 or tuple(k.shape) != tuple(v.shape) \
            or k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"expected q (BH, T, hd) and k, v (BH, S, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")


def flash_attention_plain(q: Tensor, k: Tensor, v: Tensor, *,
                          causal: bool = True, window: Optional[int] = None,
                          scale: Optional[float] = None, block_q: int = 128,
                          block_k: int = 128) -> Tensor:
    """Plain torch version of :func:`flash_attention`: the masked fp32
    softmax of ``ref.attention_ref``."""
    _check(q, k, v)
    return ref.attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool = True,
                    window: Optional[int] = None,
                    scale: Optional[float] = None, block_q: int = 128,
                    block_k: int = 128) -> Tensor:
    """q: (BH, T, hd), k/v: (BH, S, hd) -> (BH, T, hd) in q's dtype."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError(f"the CUDA kernel takes CUDA tensors on one device, "
                         f"got {q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    return _launch(q, k, v, causal, window, scale)


def _launch(q: Tensor, k: Tensor, v: Tensor, causal: bool,
            window: Optional[int], scale: Optional[float]) -> Tensor:
    """Launch the kernel on the current stream for validated operands on
    one device; returns (BH, T, hd) in q's dtype."""
    bh, t, hd = q.shape
    s = k.shape[1]
    if hd % 4 or not 4 <= hd <= 256:
        raise ValueError(f"the kernel takes hd a multiple of 4 in [4, 256], "
                         f"got {hd}")
    # the kernel copies 4 elements at a time: an offset view is copied once
    q, k, v = (t.contiguous() if t.data_ptr() % (4 * t.element_size()) == 0
               else t.clone(memory_format=torch.contiguous_format)
               for t in (q, k, v))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = load_library()
    args = FlashArgs(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                     o=out.data_ptr(), BH=bh, T=t, S=s, hd=hd,
                     causal=int(causal), has_window=int(window is not None),
                     window=0 if window is None else int(window),
                     scale=hd ** -0.5 if scale is None else float(scale))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_launch(ctypes.byref(args), int(q.dtype == torch.bfloat16),
                          stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"{lib.flash_error_string(rc).decode()}")
    LAUNCHES["flash_attention"] += 1
    return out
