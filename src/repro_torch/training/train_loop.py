"""Fault-tolerant training loop.

Counterpart of ``repro/training/train_loop.py``:

  * resume from the latest checkpoint on start (bit-reproducible with a
    step-keyed batch function);
  * SIGTERM/SIGINT => synchronous checkpoint-and-exit (preemption);
  * async keep-k checkpoints off the step path;
  * a straggler watchdog: an EMA of the step time flags slow steps.

A step's time is taken after ``torch.cuda.synchronize`` when its loss
lies on a CUDA device, so it is the step's device work, not its enqueue.
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.training import checkpoint as ckpt_lib


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 200
    keep: int = 3
    log_every: int = 20
    straggler_factor: float = 2.0   # step > factor * EMA => straggler
    ema_alpha: float = 0.1


class StragglerWatchdog:
    """EMA step-time monitor; ``on_straggler`` is the remediation hook."""

    def __init__(self, factor: float, alpha: float,
                 on_straggler: Optional[Callable[[int, float, float], None]] = None):
        self.factor = factor
        self.alpha = alpha
        self.ema: Optional[float] = None
        self.events = []
        self.on_straggler = on_straggler

    def observe(self, step: int, dt: float) -> bool:
        is_straggler = False
        if self.ema is not None and dt > self.factor * self.ema:
            is_straggler = True
            self.events.append((step, dt, self.ema))
            if self.on_straggler:
                self.on_straggler(step, dt, self.ema)
        # stragglers don't poison the EMA
        if self.ema is None:
            self.ema = dt
        elif not is_straggler:
            self.ema = (1 - self.alpha) * self.ema + self.alpha * dt
        return is_straggler


def _wait(t: torch.Tensor):
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


class Trainer:
    def __init__(self, train_step, state, batch_fn, loop: LoopConfig,
                 log: Callable[[str], None] = print):
        """train_step: (state, batch) -> (state, metrics), the metrics a
        dict of tensors with a ``"loss"``; batch_fn(step) -> batch."""
        self.train_step = train_step
        self.state = state
        self.batch_fn = batch_fn
        self.loop = loop
        self.log = log
        self.watchdog = StragglerWatchdog(loop.straggler_factor, loop.ema_alpha)
        self.ckpt = (ckpt_lib.AsyncCheckpointer(loop.ckpt_dir, loop.keep)
                     if loop.ckpt_dir else None)
        self._preempted = False
        self.history: list = []

    # --- preemption --------------------------------------------------------
    def _install_signals(self):
        def handler(signum, frame):
            self.log(f"[trainer] signal {signum}: checkpoint-and-exit")
            self._preempted = True

        self._old = {s: signal.signal(s, handler)
                     for s in (signal.SIGTERM, signal.SIGINT)}

    def _restore_signals(self):
        for s, h in getattr(self, "_old", {}).items():
            signal.signal(s, h)

    # --- resume ------------------------------------------------------------
    def maybe_resume(self, shardings=None) -> int:
        """Restore the latest checkpoint, if any (``shardings``: see
        ``checkpoint.restore``); returns the step to start from."""
        if not self.loop.ckpt_dir:
            return 0
        last = ckpt_lib.latest_step(self.loop.ckpt_dir)
        if last is None:
            return 0
        self.state = ckpt_lib.restore(self.loop.ckpt_dir, self.state,
                                      step=last, shardings=shardings)
        self.log(f"[trainer] resumed from step {last}")
        return last

    # --- main loop ---------------------------------------------------------
    def run(self, start_step: Optional[int] = None) -> Dict[str, Any]:
        self._install_signals()
        step = int(self.state["step"]) if start_step is None else start_step
        try:
            while step < self.loop.total_steps and not self._preempted:
                batch = self.batch_fn(step)
                t0 = time.perf_counter()
                self.state, metrics = self.train_step(self.state, batch)
                _wait(metrics["loss"])
                dt = time.perf_counter() - t0
                step += 1
                self.watchdog.observe(step, dt)
                if step % self.loop.log_every == 0 or step == 1:
                    m = {k: float(v) for k, v in metrics.items()}
                    self.history.append({"step": step, "dt": dt, **m})
                    self.log(f"[step {step}] loss={m['loss']:.5f} "
                             f"lr={m.get('lr', 0):.2e} {dt*1e3:.0f}ms")
                if self.ckpt and step % self.loop.ckpt_every == 0:
                    self.ckpt.save_async(self.state, step)
            if self.ckpt:
                # final/preemption checkpoint is synchronous — must land
                self.ckpt.wait()
                ckpt_lib.save(self.loop.ckpt_dir, self.state, step,
                              self.loop.keep)
        finally:
            self._restore_signals()
        return {"step": step, "preempted": self._preempted,
                "stragglers": self.watchdog.events, "history": self.history}
