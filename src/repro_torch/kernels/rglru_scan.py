"""The RG-LRU's linear recurrence — the Hopper counterpart of
``repro/kernels/rglru_scan.py``.

:func:`rglru_seq` takes ``log_a`` and ``b``, each (T, B, W), f32 or bf16,
and returns h (T, B, W) in b's dtype with ``h_t = exp(log_a_t) * h_{t-1}
+ b_t`` from a zero state, carried in fp32.  It takes the hand-written
CUDA kernel of ``csrc/rglru_scan.cu`` for CUDA tensors — there is no
fallback: if the kernel cannot be built or launched, the call raises —
and its plain torch version :func:`rglru_seq_plain` (``ref.rglru_seq_ref``)
only for tensors on the CPU.  The kernel reads and writes through the
tensors' strides (w's must be 1), so transposed views go in without a
copy; the result has b's memory layout.  ``batch_block`` is accepted for
the reference's signature; the kernel tiles its own way.

The source has two routes, chosen by shape (:func:`tile_route_fits`), not
as a fallback: the tile route (``rglru_tile_kernel``: 32-channel tiles of
64 steps copied into a shared-memory ring by TMA, exp on helper warps,
the chain on one warp) wherever its tensor maps can take log_a and b,
and the lane route (``rglru_lane_kernel``: one thread per channel)
elsewhere.  Both give the same bits.

:data:`LAUNCHES` counts kernel launches by route: ``"rglru_seq"`` (tile)
and ``"rglru_seq_lane"`` (lane).

:class:`RglruSeq` (:func:`rglru_seq_grad`) gives the recurrence a
gradient for training, on both devices.  Its forward is
:func:`rglru_seq`; it saves log_a and h.  Its backward is the same
linear recurrence run backwards in time,

  g_{T-1} = dh_{T-1},   g_t = dh_t + exp(log_a_{t+1}) * g_{t+1},
  db_t = g_t,           dlog_a_t = g_t * exp(log_a_t) * h_{t-1}  (h_{-1} = 0),

so on a CUDA tensor it is one more launch of the same kernel on the
time-flipped operands (log_a shifted by one step, dh in f32), counted
apart as ``LAUNCHES["rglru_seq_bwd"]``, and one elementwise torch pass
for dlog_a; on the CPU the same steps run through the plain version.
The reference gets this gradient from ``jax.lax.associative_scan``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref

Tensor = torch.Tensor

LAUNCHES = {"rglru_seq": 0, "rglru_seq_lane": 0, "rglru_seq_bwd": 0}

_ROUTES = {"tile": (0, "rglru_seq"), "lane": (1, "rglru_seq_lane")}

_DTYPES = (torch.float32, torch.bfloat16)


class RglruArgs(ctypes.Structure):
    """Mirror of ``struct RglruArgs`` in ``csrc/rglru_scan.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in ("log_a", "b", "h")]
                + [(n, ctypes.c_longlong) for n in (
                    "T", "B", "W", "a_st", "a_sb", "b_st", "b_sb", "h_st",
                    "h_sb")])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/rglru_scan.cu``.  Raises when
    ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("rglru_scan")
    lib.rglru_launch.argtypes = [ctypes.POINTER(RglruArgs), ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rglru_launch.restype = ctypes.c_int
    lib.rglru_args_size.restype = ctypes.c_int
    lib.rglru_error_string.argtypes = [ctypes.c_int]
    lib.rglru_error_string.restype = ctypes.c_char_p
    if lib.rglru_args_size() != ctypes.sizeof(RglruArgs):
        raise RuntimeError("RglruArgs layout differs between Python and "
                           "csrc/rglru_scan.cu")
    return lib


def _check(log_a: Tensor, b: Tensor):
    if b.ndim != 3 or tuple(log_a.shape) != tuple(b.shape):
        raise ValueError(f"expected log_a and b of one (T, B, W) shape, got "
                         f"{tuple(log_a.shape)} and {tuple(b.shape)}")


def tile_route_fits(*operands: Tensor) -> bool:
    """Whether the tile route can take these (T, B, W) operands (log_a, b
    and the output h; w's stride 1): its TMA tensor maps need, for each, a
    16-byte aligned base and t and b strides that are positive multiples
    of 16 bytes."""
    for t in operands:
        es = t.element_size()
        if t.data_ptr() % 16 or any(t.stride(d) <= 0 or t.stride(d) * es % 16
                                    for d in (0, 1)):
            return False
    return True


def rglru_seq_plain(log_a: Tensor, b: Tensor, *,
                    batch_block: int = 128) -> Tensor:
    """Plain torch version of :func:`rglru_seq`: the sequential fp32
    recurrence of ``ref.rglru_seq_ref``."""
    _check(log_a, b)
    return ref.rglru_seq_ref(log_a, b)


def rglru_seq(log_a: Tensor, b: Tensor, *, batch_block: int = 128) -> Tensor:
    """log_a, b: (T, B, W) -> h: (T, B, W) in b's dtype, h_0 = b_0."""
    _check(log_a, b)
    if log_a.device.type == "cpu" and b.device.type == "cpu":
        return rglru_seq_plain(log_a, b)
    if b.device.type != "cuda" or log_a.device != b.device:
        raise ValueError(f"the CUDA kernel takes CUDA tensors on one device, "
                         f"got {log_a.device}, {b.device}")
    if log_a.dtype not in _DTYPES or b.dtype not in _DTYPES:
        raise ValueError(f"log_a and b must be float32 or bfloat16, got "
                         f"{log_a.dtype}, {b.dtype}")
    return _launch(log_a, b)


def _launch(log_a: Tensor, b: Tensor, route: Optional[str] = None,
            counter: Optional[str] = None) -> Tensor:
    """Launch the kernel on the current stream for validated operands on
    one device; returns h in b's dtype and memory layout.  ``route``
    ("tile" or "lane") overrides the choice by :func:`tile_route_fits`;
    the tile route raises on operands it cannot take.  ``counter`` names
    the :data:`LAUNCHES` entry to count in place of the route's."""
    if log_a.stride(2) != 1:
        log_a = log_a.contiguous()
    if b.stride(2) != 1:
        b = b.contiguous()
    out = torch.empty_like(b)      # keeps b's strides when b is dense
    if out.numel() == 0:
        return out
    if route is None:
        route = "tile" if tile_route_fits(log_a, b, out) else "lane"
    code, route_counter = _ROUTES[route]
    t, bsz, w = b.shape
    lib = load_library()
    args = RglruArgs(log_a=log_a.data_ptr(), b=b.data_ptr(),
                     h=out.data_ptr(), T=t, B=bsz, W=w,
                     a_st=log_a.stride(0), a_sb=log_a.stride(1),
                     b_st=b.stride(0), b_sb=b.stride(1),
                     h_st=out.stride(0), h_sb=out.stride(1))
    stream = torch.cuda.current_stream(b.device).cuda_stream
    rc = lib.rglru_launch(ctypes.byref(args),
                          int(log_a.dtype == torch.bfloat16),
                          int(b.dtype == torch.bfloat16), code, stream)
    if rc != 0:
        raise RuntimeError(f"rglru_seq kernel launch failed ({route} route): "
                           f"{lib.rglru_error_string(rc).decode()}")
    LAUNCHES[counter or route_counter] += 1
    return out


class RglruSeq(torch.autograd.Function):
    """:func:`rglru_seq` with its gradient (the module docstring gives the
    backward).  The forward saves log_a and h, nothing else, so a
    recomputation under activation checkpointing launches it again."""

    @staticmethod
    def forward(ctx, log_a: Tensor, b: Tensor) -> Tensor:
        h = rglru_seq(log_a, b)
        ctx.save_for_backward(log_a, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, dh: Tensor):
        log_a, h = ctx.saved_tensors
        # g runs backwards in time: flip, and shift log_a by one step (step
        # 0 of the flipped operand multiplies the zero start state).
        la_next = torch.cat([torch.zeros_like(log_a[:1]),
                             log_a.flip(0)[:-1]]).float()
        dh = dh.float().flip(0)
        # the forward's operands passed rglru_seq's checks
        g = (rglru_seq_plain(la_next, dh) if dh.device.type == "cpu"
             else _launch(la_next, dh, counter="rglru_seq_bwd")).flip(0)
        dla = g * torch.exp(log_a.float())
        dla[0] = 0.0
        dla[1:] *= h[:-1].float()
        return dla.to(log_a.dtype), g.to(ctx.b_dtype)


def rglru_seq_grad(log_a: Tensor, b: Tensor) -> Tensor:
    """:func:`rglru_seq` under autograd: log_a, b (T, B, W) -> h (T, B,
    W) in b's dtype, differentiable in both operands."""
    return RglruSeq.apply(log_a, b)
