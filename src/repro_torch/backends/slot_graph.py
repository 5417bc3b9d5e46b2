"""The fused engine's slot datapath replayed from CUDA graphs — the
serving wave's path on a CUDA session whose engine is ``pallas``.

A serving wave is a few microseconds of device work (K3 and a handful of
small kernels) behind some thirty eager torch calls, each a round trip
through the interpreter.  :class:`SlotGraphs` runs the wave as one
replay of a CUDA graph instead:

  1. the wave's inputs, x (B, T, M) float32 and the gather and scatter
     ids (B,) int32, are written by the host into one pinned buffer,
     which the graph's first node copies to the device;
  2. ``fxp.quantize``;
  3. K3 on weights cast and packed once, at capture
     (``fused.slot_datapath``);
  4. the copy of the table handed in into the graph's own output table,
     and the scatter into it (the kernel's functional contract: the
     table handed in is only read);
  5. the dense head and ``fxp.dequantize``, and the copy of y into a
     pinned host buffer.

After the replay the host waits for the stream and copies y out of the
pinned buffer, so no result aliases a buffer a later replay writes.

A graph replays fixed addresses, so one is captured per (thread, live
table, wave shape): a table the engine has not seen (a new server on the
session, a fresh ``init_state_table``) gets its own capture, keyed by
its address and shape, and the cache holds the table it keys, so the
address cannot be reused under it.  Two servers on one session never
share an output table.  The thread is in the key because an attempt
that ``ExecutionGuard`` abandoned at its timeout may still replay on its
worker thread; with a graph of its own it writes only its own output
table, never the one a later wave hands to ``DeviceStateStore.commit``.
Graphs of finished threads are dropped at the next capture, and
``release`` drops a table's graphs when its server closes.

The call that meets a new key runs the wave eagerly on the staged
inputs (its one K3 launch counted in ``qlstm_cell.LAUNCHES``; the same
call warms every lazily made operand), then captures; every later call
with that key replays, each replay one ``LAUNCHES["slot"]`` and one
``LAUNCH_STAMP`` when ``replay()`` returns.  Waves given as device
tensors run the session's eager slot path.  :meth:`SlotGraphs.stats` counts
``captures``, ``replays`` and ``eager`` calls; :data:`ROUTE` says, per
thread, which the thread's last call took.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.backends import fused
from repro_torch.core import fixed_point as fxp
from repro_torch.kernels import qlstm_cell

Tensor = torch.Tensor


class _Route(threading.local):
    """Per thread: ``last``, what the thread's last slot call took —
    ``"replay"``, ``"capture"`` or ``"eager"`` (None before any)."""

    last: Optional[str] = None


ROUTE = _Route()


def _host_wave(x, table: Tensor, gather, scatter) -> Optional[Tuple]:
    """The (B, T, M) shape of a wave given as host arrays against a CUDA
    table, else None."""
    if not table.is_cuda or any(isinstance(a, Tensor) and a.is_cuda
                                for a in (x, gather, scatter)):
        return None
    shape = tuple(np.shape(x))
    if (len(shape) != 3 or np.shape(gather) != shape[:1]
            or np.shape(scatter) != shape[:1]):
        return None
    return shape


class _Graph:
    """One captured wave shape against one live table, owned by the
    thread that captured it: its pinned staging buffer, its device
    inputs, its output table and y's pinned host buffer."""

    def __init__(self, datapath, table: Tensor, shape: Tuple[int, int, int]):
        b, t, m = shape
        n = b * t * m
        self.thread = threading.current_thread()
        self.table = table
        self._datapath = datapath
        # x's float32 codes and the two id vectors in one pinned buffer:
        # one H2D copy a wave.
        self._host = torch.empty(n + 2 * b, dtype=torch.int32,
                                 pin_memory=True)
        buf = self._host.numpy()
        self._x = buf[:n].view(np.float32).reshape(shape)
        self._g, self._s = buf[n:n + b], buf[n + b:]
        self._dev = torch.empty_like(self._host, device=table.device)
        self._args = (self._dev[:n].view(torch.float32).view(shape), table,
                      self._dev[n:n + b], self._dev[n + b:])
        self._graph = torch.cuda.CUDAGraph()
        self.out_table: Optional[Tensor] = None
        self._y_host: Optional[Tensor] = None
        self._y: Optional[np.ndarray] = None

    def _stage(self, x, gather, scatter) -> None:
        np.copyto(self._x, np.asarray(x))
        np.copyto(self._g, np.asarray(gather))
        np.copyto(self._s, np.asarray(scatter))

    def first(self, x, gather, scatter) -> Tuple[Tensor, Tensor]:
        """The wave run eagerly on the staged inputs — its result, and the
        warm-up of everything the capture will record."""
        self._stage(x, gather, scatter)
        self._dev.copy_(self._host, non_blocking=True)
        y, new_table = self._datapath(*self._args)
        y = y.cpu()
        self._y_host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
        self._y = self._y_host.numpy()
        return y, new_table

    def capture(self) -> None:
        """Record the wave (H2D, datapath, D2H) on a side stream."""
        dev = self.table.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            self._graph.capture_begin(capture_error_mode="thread_local")
            try:
                self._dev.copy_(self._host, non_blocking=True)
                y, self.out_table = self._datapath(*self._args)
                self._y_host.copy_(y, non_blocking=True)
            finally:
                self._graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(side)

    def replay(self, x, gather, scatter) -> Tensor:
        """Stage, replay, wait: the wave's y, a fresh host tensor."""
        self._stage(x, gather, scatter)
        self._graph.replay()
        qlstm_cell.note_launch("slot", time.perf_counter())
        torch.cuda.current_stream(self.table.device).synchronize()
        # A numpy copy, not a torch op: one release of the interpreter
        # lock fewer, each of which the serving threads may take.
        return torch.from_numpy(self._y.copy())


class SlotGraphs:
    """The slot datapath of a CUDA session's fused engine: ``(x, table,
    gather_slots, scatter_slots) -> (y, new_table)``, as the session's
    eager slot path, with a wave given as host arrays replayed from a
    CUDA graph (the module docstring).  ``y`` is then a host tensor and
    ``new_table`` the graph's output table, which the next replay of the
    same graph overwrites."""

    def __init__(self, eager, qparams, model, accel):
        """``eager``: the session's eager slot path, for the calls that
        do not replay; ``qparams``, ``model``, ``accel``: what the fused
        datapath is built from."""
        self._eager = eager
        run_slots = fused.slot_datapath(qparams, model, accel)
        cfg = model.fxp

        def datapath(x, table, gather, scatter):
            y_int, new_table = run_slots(fxp.quantize(x, cfg), table, gather,
                                         scatter)
            return fxp.dequantize(y_int, cfg), new_table

        self._datapath = datapath
        self._graphs: Dict[Tuple, _Graph] = {}
        self._lock = threading.Lock()
        self._counts = {"capture": 0, "replay": 0, "eager": 0}

    def __call__(self, x, table: Tensor, gather_slots, scatter_slots):
        shape = _host_wave(x, table, gather_slots, scatter_slots)
        if shape is None:
            self._note("eager")
            return self._eager(x, table, gather_slots, scatter_slots)
        key = (threading.get_ident(), table.data_ptr(), tuple(table.shape),
               shape)
        graph = self._graphs.get(key)
        if graph is None:
            graph = _Graph(self._datapath, table, shape)
            out = graph.first(x, gather_slots, scatter_slots)
            graph.capture()
            with self._lock:
                for k in [k for k, g in self._graphs.items()
                          if not g.thread.is_alive()]:
                    del self._graphs[k]
                self._graphs[key] = graph
            self._note("capture")
            return out
        y = graph.replay(x, gather_slots, scatter_slots)
        self._note("replay")
        return y, graph.out_table

    def _note(self, route: str) -> None:
        ROUTE.last = route
        with self._lock:
            self._counts[route] += 1

    def release(self, table: Tensor) -> None:
        """Drop the graphs captured against ``table`` (its server is
        closing)."""
        with self._lock:
            for k in [k for k, g in self._graphs.items() if g.table is table]:
                del self._graphs[k]

    def stats(self) -> Dict[str, int]:
        """Lifetime ``captures``, ``replays`` and ``eager`` calls, and the
        ``graphs`` held now."""
        with self._lock:
            c = self._counts
            return {"captures": c["capture"], "replays": c["replay"],
                    "eager": c["eager"], "graphs": len(self._graphs)}
