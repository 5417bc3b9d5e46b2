"""Fused quantised-LSTM kernels — the Hopper counterparts of
``repro/kernels/qlstm_cell.py``.

Three entries, with the reference's argument order and validation:

  * :func:`qlstm_seq` — one layer, optionally resumed from ``(h0, c0)``
    and optionally returning the final state (``qlstm_seq_pallas``);
  * :func:`qlstm_seq_multilayer` — the whole LSTM stack fused into one
    launch, every layer's (h, c) in shared memory, layer l's step-t output
    feeding layer l+1 at the same step (``qlstm_seq_multilayer_pallas``);
  * :func:`qlstm_seq_slot` — the stack with device-resident stream state:
    a per-row gather from and scatter to the ``(n_slots + 2, L, 2, H)``
    int32 table (``qlstm_seq_slot_pallas``).  Row ``n_slots`` is ZERO
    (the reset carry, never written), row ``n_slots + 1`` is TRASH (the
    target of padding and retired rows, never read or written).  The
    table is functional: a new table is returned.

Each entry takes the hand-written CUDA kernel of ``csrc/qlstm_cell.cu``
for CUDA tensors — there is no fallback: if the kernel cannot be built or
launched, the call raises — and its plain torch version (``*_plain``,
int32 arithmetic with XLA's wraparound) only for tensors on the CPU.
The plain versions are also what the kernels are compared with on the
card.  ``compute_unit`` is accepted for the reference's signature; both
values run the same CUDA-core MAC.

:data:`LAUNCHES` counts kernel launches, one per launch, by entry:
``"multilayer"`` (:func:`qlstm_seq_multilayer`), ``"seq"``
(:func:`qlstm_seq`, the same stack kernel at one layer) and ``"slot"``
(:func:`qlstm_seq_slot`).  :data:`LAUNCH_STAMP` keeps, per thread, the
host time at which that thread's last launch call returned.  A launch
recorded into a CUDA graph is counted and stamped at each replay by
whoever replays it (:func:`note_launch`; the serving tier's
``backends/slot_graph.py``), not when it is captured.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import time
from typing import Optional, Sequence

import torch

from repro_torch.core import fixed_point as fxp
from repro_torch.core import hard_act
from repro_torch.core.fixed_point import FixedPointConfig
from repro_torch.kernels import _build

Tensor = torch.Tensor

LAUNCHES = {"multilayer": 0, "seq": 0, "slot": 0}


class _LaunchStamp(threading.local):
    """Per thread: ``t``, the ``time.perf_counter`` at which the thread's
    last launch call returned (NaN before any)."""

    t = float("nan")


LAUNCH_STAMP = _LaunchStamp()

_CODE_DTYPES = (torch.int8, torch.int16, torch.int32)


class QlstmArgs(ctypes.Structure):
    """Mirror of ``struct QlstmArgs`` in ``csrc/qlstm_cell.cu``."""

    _fields_ = ([(n, ctypes.c_void_p) for n in (
        "x", "w", "bias", "h0", "c0", "h_fin", "c_fin", "gather",
        "scatter", "table", "new_table", "out", "step_thr", "step_out")]
        + [(n, ctypes.c_int) for n in (
            "T", "B", "M", "H", "L", "n_rows", "rows_per_block", "w_smem",
            "x_smem", "shift", "lo", "hi", "hs_step", "n_thr", "slope_shift",
            "bound_int", "half_int", "one_int", "ht_lo", "ht_hi")])


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (at first use) and bind ``csrc/qlstm_cell.cu``.  Raises when
    ``nvcc`` is missing or the build fails."""
    lib = _build.load_library("qlstm_cell")
    lib.qlstm_launch.argtypes = [ctypes.POINTER(QlstmArgs), ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
    lib.qlstm_launch.restype = ctypes.c_int
    lib.qlstm_args_size.restype = ctypes.c_int
    lib.qlstm_error_string.argtypes = [ctypes.c_int]
    lib.qlstm_error_string.restype = ctypes.c_char_p
    if lib.qlstm_args_size() != ctypes.sizeof(QlstmArgs):
        raise RuntimeError("QlstmArgs layout differs between Python and "
                           "csrc/qlstm_cell.cu")
    return lib


def max_rows_per_block(hdim: int) -> int:
    """Batch rows one thread block holds at hidden size ``hdim``: a row is
    a group of whole warps with a quad of lanes per unit (4H lanes, at
    most 256), a block at most 1,024 threads, and rows that span several
    warps sync on named barriers, of which a block has 15 besides
    ``__syncthreads``'."""
    if hdim < 1:
        raise ValueError(f"the hidden size must be positive, got {hdim}")
    group = 32 * -(-min(4 * hdim, 256) // 32)
    return 32 if group == 32 else min(15, 1024 // group)


def _rows_per_block(batch_block: Optional[int], bsz: int, hdim: int,
                    device: torch.device) -> int:
    """``batch_block`` capped at :func:`max_rows_per_block`; by default the
    batch spread over the SMs, 1 to 8 rows a block."""
    if batch_block is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        batch_block = min(8, -(-bsz // sms))
    return max(1, min(batch_block, max_rows_per_block(hdim)))


def _check_layers(w_xs, w_hs, b_wides, *rest):
    n = len(w_hs)
    if not all(len(t) == n for t in (w_xs, b_wides, *rest)):
        names = ("w_xs", "w_hs", "b_wides", "h0s", "c0s")
        counts = ", ".join(f"{nm}={len(t)}" for nm, t in
                           zip(names, (w_xs, w_hs, b_wides, *rest)))
        raise ValueError(
            f"per-layer tuples disagree on the layer count: {counts}")


def _check_table(table: Tensor, n: int, hdim: int):
    if table.ndim != 4 or table.shape[0] < 3 or tuple(table.shape[1:]) != (
            n, 2, hdim):
        raise ValueError(
            f"state table must be (n_slots + 2, {n}, 2, {hdim}) with "
            f"n_slots >= 1, got {tuple(table.shape)}")


# ---------------------------------------------------------------------------
# Plain torch versions
# ---------------------------------------------------------------------------

def qlstm_seq_multilayer_plain(x_int: Tensor, w_xs: Sequence[Tensor],
                               w_hs: Sequence[Tensor],
                               b_wides: Sequence[Tensor],
                               h0s: Sequence[Tensor], c0s: Sequence[Tensor],
                               *, cfg: FixedPointConfig,
                               hs_method: str = "arithmetic",
                               hs_slope_shift: int = 3, hs_bound: float = 3.0,
                               ht_min: float = -1.0, ht_max: float = 1.0,
                               compute_unit: str = "mxu",
                               batch_block: Optional[int] = None):
    """Plain torch version of :func:`qlstm_seq_multilayer` (same
    arguments, same result): the kernel's step and layer order in int32
    with wraparound."""
    _check_layers(w_xs, w_hs, b_wides, h0s, c0s)
    prod = fxp.product_config(cfg, cfg)
    spec = hard_act.HardSigmoidStarSpec(cfg, hs_slope_shift, hs_bound)
    hs_fn = (hard_act.hs_star_int_step_unrolled if hs_method == "step"
             else hard_act.hs_star_int_arithmetic)
    ht = lambda v: hard_act.hard_tanh_int(v, cfg, ht_min, ht_max)
    rq = lambda v: fxp.requantize(fxp.wrap_int32(v), prod, cfg)
    i64 = lambda v: v.to(torch.int64)
    hdim = w_hs[0].shape[0]
    h = [t.to(torch.int32) for t in h0s]
    c = [t.to(torch.int32) for t in c0s]
    outs = []
    for t in range(x_int.shape[0]):
        inp = x_int[t]
        for li in range(len(w_hs)):
            acc = (i64(fxp.int_matmul(inp, w_xs[li]))
                   + i64(fxp.int_matmul(h[li], w_hs[li])) + i64(b_wides[li]))
            pre = rq(acc)
            i = hs_fn(pre[:, :hdim], spec)
            f = hs_fn(pre[:, hdim:2 * hdim], spec)
            g = ht(pre[:, 2 * hdim:3 * hdim])
            o = hs_fn(pre[:, 3 * hdim:], spec)
            c[li] = rq(i64(f) * i64(c[li]) + i64(i) * i64(g))
            h[li] = rq(i64(o) * i64(ht(c[li])))
            inp = h[li]
        outs.append(inp)
    return torch.stack(outs).to(x_int.dtype), tuple(zip(h, c))


def qlstm_seq_plain(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor,
                    *, cfg: FixedPointConfig, h0: Optional[Tensor] = None,
                    c0: Optional[Tensor] = None, return_state: bool = False,
                    **kw):
    """Plain torch version of :func:`qlstm_seq`."""
    h0, c0 = _zero_carry(x_int, w_h, h0, c0)
    out, ((h_f, c_f),) = qlstm_seq_multilayer_plain(
        x_int, (w_x,), (w_h,), (b_wide,), (h0,), (c0,), cfg=cfg, **kw)
    return (out, (h_f, c_f)) if return_state else out


def qlstm_seq_slot_plain(x_int: Tensor, gather_slots: Tensor,
                         scatter_slots: Tensor, table: Tensor,
                         w_xs: Sequence[Tensor], w_hs: Sequence[Tensor],
                         b_wides: Sequence[Tensor], *,
                         cfg: FixedPointConfig, **kw):
    """Plain torch version of :func:`qlstm_seq_slot`: gather the carries
    (ids outside the live rows and ZERO read ZERO), run the stack, scatter
    into a copy of the table (only live rows are written)."""
    _check_layers(w_xs, w_hs, b_wides)
    n, hdim = len(w_hs), w_hs[0].shape[0]
    _check_table(table, n, hdim)
    rows = table.shape[0]
    table = table.to(torch.int32)
    g = gather_slots.reshape(-1).to(torch.int64)
    g = torch.where((g >= 0) & (g <= rows - 2), g, rows - 2)
    carry = table[g]                                    # (B, L, 2, H)
    out, state = qlstm_seq_multilayer_plain(
        x_int, w_xs, w_hs, b_wides,
        tuple(carry[:, li, 0] for li in range(n)),
        tuple(carry[:, li, 1] for li in range(n)), cfg=cfg, **kw)
    new_table = table.clone()
    s = scatter_slots.reshape(-1).to(torch.int64)
    live = (s >= 0) & (s < rows - 2)
    for li, (h, c) in enumerate(state):
        new_table[s[live], li, 0] = h[live]
        new_table[s[live], li, 1] = c[live]
    return out, new_table


# ---------------------------------------------------------------------------
# Kernel launch
# ---------------------------------------------------------------------------

def _zero_carry(x_int, w_h, h0, c0):
    z = lambda: torch.zeros(x_int.shape[1], w_h.shape[0], dtype=torch.int32,
                            device=x_int.device)
    return (z() if h0 is None else h0), (z() if c0 is None else c0)


def _ptr(t: Optional[Tensor]):
    return None if t is None else t.data_ptr()


def _launch(x_int: Tensor, w_xs, w_hs, b_wides, *, cfg: FixedPointConfig,
            hs_method: str, hs_slope_shift: int, hs_bound: float,
            ht_min: float, ht_max: float, batch_block: Optional[int],
            h0s=None, c0s=None, gather=None, scatter=None, table=None,
            weights_in_smem: bool = True, counter: Optional[str] = None,
            packed=None):
    """Launch the stack kernel (slot variant when ``table`` is given) on
    the current stream; returns ``(out, h_fin, c_fin | new_table, args)``
    where ``args.w_smem`` and ``args.x_smem`` report whether the weights
    and the x codes were staged in shared memory and
    ``args.rows_per_block`` the batch rows a block took
    (:func:`_rows_per_block`).  ``packed`` is :func:`pack_weights` of
    the weights, made once by a caller that launches them many times.
    The launch is counted under ``counter`` (default: the entry the
    variant serves, ``"slot"`` or ``"multilayer"``), except while the
    stream is capturing a CUDA graph."""
    dev = x_int.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel takes CUDA tensors, got {dev}")
    sd = x_int.dtype
    if sd not in _CODE_DTYPES:
        raise ValueError(f"x_int must hold int8/int16/int32 codes, got {sd}")
    t_len, bsz, m = x_int.shape
    n, hdim = len(w_hs), w_hs[0].shape[0]
    for li in range(n):
        k_in = m if li == 0 else hdim
        if (tuple(w_xs[li].shape) != (k_in, 4 * hdim)
                or tuple(w_hs[li].shape) != (hdim, 4 * hdim)
                or tuple(b_wides[li].shape) != (4 * hdim,)):
            raise ValueError(f"layer {li}: expected w_x ({k_in}, {4 * hdim}), "
                             f"w_h ({hdim}, {4 * hdim}), b ({4 * hdim},)")
    operands = [x_int, *w_xs, *w_hs, *b_wides,
                *(t for t in (gather, scatter, table) if t is not None),
                *(h0s or ()), *(c0s or ())]
    if any(t.device != dev for t in operands):
        raise ValueError("all operands must be on the device of x_int")
    lib = load_library()
    x = x_int.contiguous()
    w, bias = packed if packed is not None else pack_weights(
        w_xs, w_hs, b_wides, sd)
    out = torch.empty((t_len, bsz, hdim), dtype=sd, device=dev)
    prod = fxp.product_config(cfg, cfg)
    shift = prod.frac_bits - cfg.frac_bits
    spec = hard_act.HardSigmoidStarSpec(cfg, hs_slope_shift, hs_bound)
    ht_lo, ht_hi = hard_act.hard_tanh_bounds(cfg, ht_min, ht_max)
    step = hs_method == "step"
    thr, outs = hard_act.step_table_tensors(spec, dev) if step else (None, None)
    args = QlstmArgs(
        x=_ptr(x), w=_ptr(w), bias=_ptr(bias), out=_ptr(out),
        step_thr=_ptr(thr), step_out=_ptr(outs),
        T=t_len, B=bsz, M=m, H=hdim, L=n,
        rows_per_block=_rows_per_block(batch_block, bsz, hdim, dev),
        w_smem=int(weights_in_smem), shift=shift, lo=cfg.int_min,
        hi=cfg.int_max, hs_step=int(step),
        n_thr=0 if thr is None else thr.numel(),
        slope_shift=hs_slope_shift, bound_int=spec.bound_int,
        half_int=spec.half_int, one_int=spec.one_int, ht_lo=ht_lo,
        ht_hi=ht_hi)
    if table is not None:
        g = gather.reshape(-1).to(torch.int32).contiguous()
        s = scatter.reshape(-1).to(torch.int32).contiguous()
        tbl = table.to(torch.int32).contiguous()
        new_table = tbl.clone()
        args.gather, args.scatter = _ptr(g), _ptr(s)
        args.table, args.new_table = _ptr(tbl), _ptr(new_table)
        args.n_rows = tbl.shape[0]
        results = (out, new_table)
    else:
        h0 = torch.stack([t.to(torch.int32) for t in h0s]).contiguous()
        c0 = torch.stack([t.to(torch.int32) for t in c0s]).contiguous()
        h_fin, c_fin = torch.empty_like(h0), torch.empty_like(c0)
        args.h0, args.c0 = _ptr(h0), _ptr(c0)
        args.h_fin, args.c_fin = _ptr(h_fin), _ptr(c_fin)
        results = (out, h_fin, c_fin)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.qlstm_launch(ctypes.byref(args), x.element_size(),
                          int(table is not None), stream)
    t_ret = time.perf_counter()
    if rc != 0:
        raise RuntimeError(f"qlstm kernel launch failed: "
                           f"{lib.qlstm_error_string(rc).decode()}")
    if not torch.cuda.is_current_stream_capturing():
        # A launch recorded into a CUDA graph runs at each replay, which
        # its replayer counts and stamps.
        note_launch(counter or ("slot" if table is not None
                                else "multilayer"), t_ret)
    return (*results, args)


def note_launch(counter: str, t_ret: float) -> None:
    """Count one launch under ``counter`` and stamp this thread with
    ``t_ret``, the host time at which the launch call returned."""
    LAUNCHES[counter] += 1
    LAUNCH_STAMP.t = t_ret


def pack_weights(w_xs, w_hs, b_wides, sd: torch.dtype):
    """The kernel's weight operands: every layer's w_x then w_h, flat, in
    the code dtype ``sd``, and the int32 biases, flat."""
    w = torch.cat([t.to(sd).reshape(-1) for li in range(len(w_hs))
                   for t in (w_xs[li], w_hs[li])])
    bias = torch.cat([b.to(torch.int32).reshape(-1) for b in b_wides])
    return w, bias


# ---------------------------------------------------------------------------
# Public entries
# ---------------------------------------------------------------------------

def qlstm_seq_multilayer(x_int: Tensor, w_xs: Sequence[Tensor],
                         w_hs: Sequence[Tensor], b_wides: Sequence[Tensor],
                         h0s: Sequence[Tensor], c0s: Sequence[Tensor], *,
                         cfg: FixedPointConfig, hs_method: str = "arithmetic",
                         hs_slope_shift: int = 3, hs_bound: float = 3.0,
                         ht_min: float = -1.0, ht_max: float = 1.0,
                         compute_unit: str = "mxu",
                         batch_block: Optional[int] = None):
    """The whole LSTM stack, fused and stateful, in one launch.

    x_int: (T, B, M) codes; per-layer tuples ``w_xs`` (layer 0 (M, 4H),
    deeper (H, 4H)), ``w_hs`` (H, 4H), ``b_wides`` (4H,) int32, and the
    (B, H) int32 carries ``h0s``/``c0s``.  ``batch_block`` is the number
    of batch rows per thread block (default: the batch spread over the
    SMs; at most :func:`max_rows_per_block`).  Returns ``(out, ((h_last, c_last), ...))`` with out the last
    layer's (T, B, H) codes in ``x_int``'s dtype — bit-exact with
    threading ``kernels/ref.qlstm_seq_ref`` through the stack."""
    return _stack(x_int, w_xs, w_hs, b_wides, h0s, c0s, "multilayer",
                  cfg=cfg, hs_method=hs_method, hs_slope_shift=hs_slope_shift,
                  hs_bound=hs_bound, ht_min=ht_min, ht_max=ht_max,
                  compute_unit=compute_unit, batch_block=batch_block)


def _stack(x_int, w_xs, w_hs, b_wides, h0s, c0s, counter, *,
           compute_unit, **kw):
    """The stack kernel for CUDA tensors (counted under ``counter``), its
    plain version for CPU tensors."""
    _check_layers(w_xs, w_hs, b_wides, h0s, c0s)
    if x_int.device.type == "cpu":
        return qlstm_seq_multilayer_plain(x_int, w_xs, w_hs, b_wides, h0s,
                                          c0s, compute_unit=compute_unit, **kw)
    out, h_fin, c_fin, _ = _launch(x_int, w_xs, w_hs, b_wides, h0s=h0s,
                                   c0s=c0s, counter=counter, **kw)
    return out, tuple(zip(h_fin.unbind(0), c_fin.unbind(0)))


def qlstm_seq(x_int: Tensor, w_x: Tensor, w_h: Tensor, b_wide: Tensor, *,
              cfg: FixedPointConfig, hs_method: str = "arithmetic",
              hs_slope_shift: int = 3, hs_bound: float = 3.0,
              ht_min: float = -1.0, ht_max: float = 1.0,
              compute_unit: str = "mxu", batch_block: Optional[int] = None,
              h0: Optional[Tensor] = None, c0: Optional[Tensor] = None,
              return_state: bool = False):
    """One fused layer: x_int (T, B, M) codes, w_x (M, 4H), w_h (H, 4H),
    b_wide (4H,) int32; optional (B, H) int32 carry ``h0``/``c0`` (zeros
    when omitted).  Returns (T, B, H) codes in ``x_int``'s dtype; with
    ``return_state=True``, ``(out, (h_last, c_last))``."""
    h0, c0 = _zero_carry(x_int, w_h, h0, c0)
    out, ((h_f, c_f),) = _stack(
        x_int, (w_x,), (w_h,), (b_wide,), (h0,), (c0,), "seq", cfg=cfg,
        hs_method=hs_method, hs_slope_shift=hs_slope_shift,
        hs_bound=hs_bound, ht_min=ht_min, ht_max=ht_max,
        compute_unit=compute_unit, batch_block=batch_block)
    return (out, (h_f, c_f)) if return_state else out


def qlstm_seq_slot(x_int: Tensor, gather_slots: Tensor,
                   scatter_slots: Tensor, table: Tensor,
                   w_xs: Sequence[Tensor], w_hs: Sequence[Tensor],
                   b_wides: Sequence[Tensor], *, cfg: FixedPointConfig,
                   hs_method: str = "arithmetic", hs_slope_shift: int = 3,
                   hs_bound: float = 3.0, ht_min: float = -1.0,
                   ht_max: float = 1.0, compute_unit: str = "mxu",
                   packed=None):
    """The fused stack with device-resident stream state.

    ``table``: the ``(n_slots + 2, L, 2, H)`` int32 carry table (axis 2 is
    (h, c)); ``gather_slots``/``scatter_slots``: (B,) int32 row ids.  Row
    i's carry is gathered from ``table[gather_slots[i]]`` before the first
    step and its final (h, c) scattered into ``scatter_slots[i]`` of the
    returned copy.  Returns ``(out, new_table)``; bit-exact with gathering
    the carries on the host and calling :func:`qlstm_seq_multilayer`.
    ``packed``: :func:`pack_weights` of the weights, made once (CUDA)."""
    _check_layers(w_xs, w_hs, b_wides)
    _check_table(table, len(w_hs), w_hs[0].shape[0])
    kw = dict(cfg=cfg, hs_method=hs_method, hs_slope_shift=hs_slope_shift,
              hs_bound=hs_bound, ht_min=ht_min, ht_max=ht_max)
    if x_int.device.type == "cpu":
        return qlstm_seq_slot_plain(x_int, gather_slots, scatter_slots, table,
                                    w_xs, w_hs, b_wides,
                                    compute_unit=compute_unit, **kw)
    out, new_table, _ = _launch(x_int, w_xs, w_hs, b_wides, gather=gather_slots,
                                scatter=scatter_slots, table=table,
                                batch_block=None, packed=packed, **kw)
    return out, new_table
