"""Fault-tolerant checkpointing, in the reference's on-disk layout.

Counterpart of ``repro/training/checkpoint.py``:

  * ATOMIC: written to ``<dir>/tmp.<step>``, then renamed to
    ``<dir>/step_<step:010d>`` — a crash mid-save never corrupts the
    latest good checkpoint.
  * ASYNC: ``AsyncCheckpointer.save_async`` copies the state to host
    memory on the step path and writes it to disk on a thread.
  * KEEP-K: bounded retention.

Each checkpoint holds ``arrays.npz`` (one array per leaf, named by its
tree path joined with ``$``: ``params$layers$0$w_x``, ``opt$count``,
``step``) and ``meta.json``.  The names and the layout are the
reference's, so a checkpoint written by either package restores in the
other.  ``restore`` places each leaf on the device of the matching leaf
of ``like_state``, with its dtype.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.training.tree import tree_leaves_with_path

_SEP = "$"  # path separator inside npz keys ('/' is not portable in npz)


def _host(state) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host numpy array, keyed by its path."""
    return {_SEP.join(path): (leaf.detach().cpu().numpy()
                              if isinstance(leaf, torch.Tensor) else np.asarray(leaf))
            for path, leaf in tree_leaves_with_path(state)}


def _write(ckpt_dir: str, host: Dict[str, np.ndarray], step: int,
           keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "keys": sorted(host)}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomicity boundary
    _cleanup(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, state, step: int, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final checkpoint path."""
    return _write(ckpt_dir, _host(state), step, keep)


class AsyncCheckpointer:
    """Snapshot on the step path, write off it."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[Exception] = None

    def save_async(self, state, step: int):
        self.wait()
        host = _host(state)

        def _run():
            try:
                _write(self.ckpt_dir, host, step, self.keep)
            except Exception as e:  # raised by the next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_run, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error:
            raise self.last_error


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := re.fullmatch(r"step_(\d+)", d))]
    return max(steps) if steps else None


def restore(ckpt_dir: str, like_state, step: Optional[int] = None):
    """Restore into the structure of ``like_state``: each leaf with the
    dtype and on the device of its counterpart there."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}

    def fill(like, prefix):
        if isinstance(like, dict):
            return {k: fill(v, prefix + (str(k),)) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(fill(v, prefix + (str(i),))
                              for i, v in enumerate(like))
        key = _SEP.join(prefix)
        if key not in host:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = host[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        return torch.as_tensor(arr, device=like.device).to(like.dtype)

    return fill(like_state, ())


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
