"""Host data pipeline: step-keyed, deterministic, prefetching —
counterpart of ``repro/data/pipeline.py``.

Contract: ``source(step) -> dict[str, np.ndarray]`` is a pure function of
the step index, so a job restarted from a step-K checkpoint replays the
exact same batches.  A background thread keeps ``prefetch`` batches
ahead and moves each to ``device``, the CUDA card unless the caller
passes ``device="cpu"``: for a CUDA device it
copies from pinned host memory on a side stream and waits for the copy
before handing the batch out, so the consumer never sees a tensor whose
copy is in flight.  ``shardings`` maps a key to a
``sharding.partition.ParamSharding`` on a mesh of ``device``'s type: that
key leaves the pipeline as a ``DTensor`` in those placements, each rank
keeping its own shard of the batch every rank made (nothing is sent).
An error in ``source`` surfaces in the consumer's ``next()``;
``close()`` stops the thread and drains the queue.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Optional, Union

import numpy as np
import torch
from torch.distributed.tensor import DTensor, distribute_tensor


class Pipeline:
    def __init__(self, source: Callable[[int], Dict[str, np.ndarray]],
                 device: Union[str, torch.device] = "cuda",
                 start_step: int = 0, prefetch: int = 2,
                 shardings: Optional[Dict] = None):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to feed the CPU")
        self.shardings = shardings or {}
        for k, sh in self.shardings.items():
            if sh.mesh.device_type != self.device.type:
                raise ValueError(f"{k}: a {sh.mesh.device_type} mesh cannot "
                                 f"take a batch on {self.device}")
        self.source = source
        self.step = start_step
        self.prefetch = prefetch
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="pipeline-prefetch")
        self._thread.start()

    def _put_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        if self._stream is None:
            out = {k: torch.as_tensor(v, device=self.device)
                   for k, v in batch.items()}
        else:
            with torch.cuda.stream(self._stream):
                out = {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory()
                       .to(self.device, non_blocking=True)
                       for k, v in batch.items()}
                done = torch.cuda.Event()
                done.record(self._stream)
            done.synchronize()
        for k, sh in self.shardings.items():
            out[k] = distribute_tensor(out[k], sh.mesh, sh.placements,
                                       src_data_rank=None)
        return out

    def _put(self, item) -> bool:
        """Queue ``item`` unless the pipeline closes first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            try:
                item = (step, self._put_device(self.source(step)))
            except Exception as e:  # surfaced in the consumer's next()
                self._put(e)
                return
            if not self._put(item):
                return
            step += 1

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if isinstance(item, Exception):
            raise item
        step, batch = item
        self.step = step + 1
        if self._stream is not None:
            # the tensors were allocated on the side stream: tell the
            # caching allocator they are used on the consumer's stream
            for v in batch.values():
                v = v.to_local() if isinstance(v, DTensor) else v
                v.record_stream(torch.cuda.current_stream(self.device))
        return batch

    def close(self, timeout: float = 10.0):
        """Stop the prefetch thread and drop the batches it queued."""
        self._stop.set()
        self._thread.join(timeout)
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
