"""Chat sessions served as streams: each session's turns prefilled against
its carried state, one turn per session per wave, the state held in a
device session table between turns.

:class:`SessionServer` is to an LM with carried state what
``StreamServer`` is to the LSTM's sensor streams, on the same parts: the
:class:`~repro_torch.serving.scheduler.WaveScheduler` (pending list,
deadline flush, wave queue, compute thread; ``one_per_stream`` so a
session's next turn sees the state its last turn left), a
:class:`~repro_torch.serving.device_state.SlotAllocator` from session to
table row, and a :class:`~repro_torch.serving.metrics.MetricsSink` with
the same stage stamps.  The table is the model's decode cache
(``transformer.init_cache``) with ``max_sessions`` rows of
``max_positions`` positions: for LFM2 the KV of its attention layers and
the conv state of its short-conv layers side by side.

A wave is one ``transformer.forward_extend`` call: each turn's tokens
appended to its session's row at the session's own position, in place,
and each turn answered with the logits at its last token (the turn's
time to first token).  A turn that would take its session past
``max_positions`` starts the session over from position 0, as a new chat
of the same client (counted as ``restarts``); so does a session's first
turn, and the first turn after its row was taken by another session
(least recently used, when more than ``max_sessions`` sessions live).

Its record: the sink's stamps (``t_submit``, ``t_selected``, ``t_exec``,
``t_launch`` when the extend call returned with its work enqueued,
``t_host``, ``t_emitted``, ``t_polled``) and lifetime counters, and
:meth:`SessionServer.counters`: ``tokens``, ``padded_tokens`` (none: a
wave packs its turns), ``attn_ctx_tokens`` (each attended token's
context summed), ``restarts`` and the claims of every MoE layer's
experts (accumulated on the device, copied only when read).  Its
profiler ranges: ``lfm2.extend`` around a wave's extend call, within it
``lfm2.conv``, ``lfm2.attn``, ``lfm2.moe`` and ``lfm2.mlp``; with
``probe.marks`` on, marker kernels around each ``lfm2.moe`` on the
card (:class:`_Probe`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import threading
import time
from typing import Dict, Hashable, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.serving.device_state import SlotAllocator
from repro_torch.serving.metrics import (MetricsSink, WaveRecord,
                                         new_server_id, publish)
from repro_torch.serving.scheduler import Wave, WaveScheduler


@dataclasses.dataclass(frozen=True)
class SessionResult:
    """One answered turn: ``y`` its last token's logits (at the server's
    ``report_ids``, then their row's max and argmax, where it has them),
    or ``error``; ``record`` its row in the sink's stage record."""

    stream_id: Hashable
    seq: int
    y: Optional[np.ndarray]
    error: Optional[str] = None
    record: int = -1


class _Probe(T.ExtendProbe):
    """The server's view into ``forward_extend``: the MoE claims on the
    device, and with ``marks`` each ``lfm2.moe`` section put on the
    card's own timeline: a one-element int16 tensor filled before the
    section's first operation and a complex64 one after its last (fill
    kernels of types nothing else on the path fills), so that a device
    trace tells the MoE's operations from the rest (the benchmark's
    ``moe_share``).  Nothing is marked on the CPU."""

    def __init__(self, claims: torch.Tensor):
        self.claims = claims
        self.marks = False
        self.on_card = claims.is_cuda
        self._begin = torch.zeros(1, dtype=torch.int16, device=claims.device)
        self._end = torch.zeros(1, dtype=torch.complex64,
                                device=claims.device)

    @contextlib.contextmanager
    def section(self, name: str):
        mark = self.marks and self.on_card and name == "lfm2.moe"
        with T._range(name):
            if mark:
                self.begin()
            yield
            if mark:
                self.end()

    def begin(self) -> None:
        self._begin.fill_(1)

    def end(self) -> None:
        self._end.fill_(1)


class SessionServer:
    """Chat sessions of one LM (configs with ``layer_types``: LFM2) on
    ``device``; see the module docstring."""

    def __init__(self, params, cfg: ModelConfig, *, max_sessions: int,
                 max_positions: int, batch: int,
                 deadline_s: Optional[float], device,
                 report_ids: Optional[torch.Tensor] = None):
        if cfg.layer_types is None:
            raise ValueError(f"{cfg.name}: sessions run configs with "
                             f"layer_types (forward_extend)")
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.max_positions = max_positions
        self.table = T.init_cache(cfg, max_sessions, max_positions,
                                  device=self.device)
        self.report_ids = (None if report_ids is None else
                           torch.as_tensor(report_ids, device=self.device))
        self.slots = SlotAllocator(max_sessions)
        n_moe = sum(cfg.moe_layer(i) for i in range(cfg.n_layers))
        self.probe = _Probe(torch.zeros(
            (n_moe, cfg.moe.num_experts if cfg.moe else 0), dtype=torch.int64,
            device=self.device))
        self._pos: Dict[Hashable, int] = {}
        self._seq: Dict[Hashable, int] = {}
        self._seq_lock = threading.Lock()
        self._results: "queue.Queue" = queue.Queue()
        self._server_id = new_server_id()
        self.reset_metrics()
        self.batch = batch
        self._sched = WaveScheduler(batch, self._execute, one_per_stream=True,
                                    deadline_s=deadline_s, assemble=list)

    # -- client surface -----------------------------------------------------

    def submit(self, session: Hashable, turn_tokens) -> int:
        """Enqueue a turn (1-D token ids, 1 to ``max_positions`` of them)
        of ``session``; returns its number within the session."""
        t = np.asarray(turn_tokens)
        if t.ndim != 1 or not 1 <= len(t) <= self.max_positions:
            raise ValueError(f"a turn is 1 to {self.max_positions} token "
                             f"ids, got shape {t.shape}")
        if t.dtype.kind not in "iu" or t.min() < 0 \
                or t.max() >= self.cfg.vocab_size:
            raise ValueError(f"token ids must be integers in [0, "
                             f"{self.cfg.vocab_size})")

        def alloc_seq() -> int:
            with self._seq_lock:
                seq = self._seq.get(session, 0)
                self._seq[session] = seq + 1
                return seq

        self.metrics.note_submit(time.perf_counter())
        return self._sched.submit(session, t.astype(np.int64), alloc_seq)

    def poll(self, timeout: float = 0.0) -> List[SessionResult]:
        """Answered turns, in wave order; waits up to ``timeout`` for the
        first.  Re-raises a compute-thread failure."""
        out: List[SessionResult] = []
        try:
            out.append(self._results.get(timeout=timeout) if timeout > 0
                       else self._results.get_nowait())
            while True:
                out.append(self._results.get_nowait())
        except queue.Empty:
            pass
        if out:
            self.metrics.note_polled(out, time.perf_counter())
        elif self._sched.error is not None:
            raise self._sched.error
        return out

    def flush(self, timeout: Optional[float] = None) -> None:
        """Wait until every turn submitted before the call is answered."""
        self._sched.flush(timeout=timeout)

    def restart_numbering(self) -> None:
        """Flush, then number every session's next turn 0 again and start
        a fresh record and counters; the sessions keep their state (a
        client's history prefilled, then its turns)."""
        self.flush()
        with self._seq_lock:
            self._seq.clear()
        self.reset_metrics()

    def reset_sessions(self) -> None:
        """Flush, then forget every session: each one's next turn starts
        it over at position 0 and is numbered 0."""
        self.flush()
        with self._seq_lock:
            self._seq.clear()
        self._pos.clear()
        self.slots = SlotAllocator(self.slots.capacity)

    def reset_metrics(self) -> None:
        """A fresh sink (this server's in ``metrics.current_sinks()``) and
        zeroed counters."""
        self.metrics = MetricsSink()
        publish(self._server_id, self.metrics)
        self.probe.claims.zero_()
        self._counts = {"tokens": 0, "padded_tokens": 0,
                        "attn_ctx_tokens": 0, "restarts": 0}

    def counters(self) -> Dict:
        """The lifetime counters (see the module docstring)."""
        snap = self.metrics.snapshot()
        return {"waves": snap["n_waves"], "samples": snap["n_samples"],
                "padded_slots": snap["n_padded_slots"],
                "deadline_flushes": snap["n_deadline_flushes"],
                "compute_s_total": snap["compute_s_total"],
                **self._counts,
                "expert_claims": self.probe.claims.cpu().tolist()}

    def close(self, timeout: float = 30.0) -> List[str]:
        """Answer what was submitted, stop, and drop the table and the
        weights (the server's threads hold it in a reference cycle, which
        only the collector would free); the names of threads left
        running."""
        leaked = self._sched.close(timeout=timeout)
        self.table, self.params = {}, None
        return leaked

    # -- compute thread -----------------------------------------------------

    def _execute(self, wave: Wave) -> None:
        t0 = time.perf_counter()
        traced = torch.autograd.profiler._is_profiler_enabled
        try:
            with T._range("serving.prepare") if traced \
                    else contextlib.nullcontext():
                rows, starts, lens, fresh = self._place(wave)
                tokens = torch.as_tensor(np.concatenate(wave.x),
                                         device=self.device)
                if fresh:
                    self.table["conv"][:, fresh] = 0
                y = self._forward(tokens, rows, starts, lens)
            t_launch = time.perf_counter()
            y = y.cpu().numpy()
        except Exception as e:  # the wave's turns fail, the thread goes on
            self._fail(wave, t0, f"compute_failed: {type(e).__name__}: {e}")
            return
        t_host = time.perf_counter()
        for slot, s0, n in zip(wave.slots, starts, lens):
            self._pos[slot.stream_id] = s0 + n
        lens_a, starts_a = np.asarray(lens), np.asarray(starts)
        self._counts["tokens"] += int(lens_a.sum())
        self._counts["attn_ctx_tokens"] += int(
            (lens_a * starts_a + lens_a * (lens_a + 1) // 2).sum())
        t1 = time.perf_counter()
        first = self.metrics.record_wave(WaveRecord(
            t_done=t1, compute_s=t1 - t0, occupancy=wave.occupancy,
            batch=self.batch, deadline_flush=wave.deadline_flush,
            t_selected=wave.t_selected, t_exec=t0, t_launch=t_launch,
            t_host=t_host), wave.slots)
        self._emit(first, [SessionResult(s.stream_id, s.seq, y[i],
                                         record=first + i)
                           for i, s in enumerate(wave.slots)])

    def _forward(self, tokens: torch.Tensor, rows, starts, lens):
        """The wave's datapath: one extend call over the session table,
        and the answers (left on the device)."""
        with self.probe.section("lfm2.extend"):
            logits = T.forward_extend(self.params, self.table, {
                "tokens": tokens, "rows": rows, "starts": starts,
                "lens": lens}, self.cfg, self.probe)
            return self._answers(logits)

    def _place(self, wave: Wave):
        """Each turn's table row, first position and length, and the rows
        that start over (their conv state to be zeroed)."""
        rows, starts, lens, fresh = [], [], [], []
        for slot, turn in zip(wave.slots, wave.x):
            sid = slot.stream_id
            row = self.slots.lookup(sid)
            if row is None:
                row, evicted = self.slots.assign(sid)
                for victim in evicted:
                    self._pos.pop(victim, None)
                self._pos.pop(sid, None)
            pos = self._pos.get(sid, 0)
            if pos + len(turn) > self.max_positions:
                pos = 0
                self._counts["restarts"] += 1
            if pos == 0:
                fresh.append(row)
            rows.append(row)
            starts.append(pos)
            lens.append(len(turn))
        return rows, starts, lens, fresh

    def _answers(self, logits: torch.Tensor) -> torch.Tensor:
        if self.report_ids is None:
            return logits
        top = logits.max(-1)
        return torch.cat([logits[:, self.report_ids], top.values[:, None],
                          top.indices[:, None].float()], 1)

    def _fail(self, wave: Wave, t0: float, err: str) -> None:
        """Every turn of a failed wave is answered with ``err``, and its
        session starts over at its next turn (its state may be torn)."""
        for slot in wave.slots:
            self._pos.pop(slot.stream_id, None)
            self.slots.release(slot.stream_id)
        self.metrics.count("stream_errors", wave.occupancy)
        t1 = time.perf_counter()
        first = self.metrics.record_wave(WaveRecord(
            t_done=t1, compute_s=t1 - t0, occupancy=wave.occupancy,
            batch=self.batch, deadline_flush=wave.deadline_flush,
            t_selected=wave.t_selected, t_exec=t0), wave.slots)
        self._emit(first, [SessionResult(s.stream_id, s.seq, None, err,
                                         first + i)
                           for i, s in enumerate(wave.slots)])

    def _emit(self, first: int, results: List[SessionResult]) -> None:
        stamps = []
        for r in results:
            stamps.append(time.perf_counter())
            self._results.put(r)
        self.metrics.note_emitted(first, stamps)
