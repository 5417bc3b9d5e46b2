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

Under a mesh a leaf may be a ``DTensor``: ``save`` writes its full tensor
(gathered on every rank, written by rank 0, then a barrier), so the file
is the same whatever the mesh, and ``restore(..., shardings=)`` lays each
leaf out on the CURRENT mesh — the elastic path: a state saved on 4 x 2
ranks restores onto 2 x 1.
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
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.training.tree import tree_leaves, tree_leaves_with_path

_SEP = "$"  # path separator inside npz keys ('/' is not portable in npz)


def _host_array(leaf) -> np.ndarray:
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()          # a collective: every rank calls it
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _host(state) -> Dict[str, np.ndarray]:
    """Every leaf of ``state`` as a host numpy array, keyed by its path."""
    return {_SEP.join(path): _host_array(leaf)
            for path, leaf in tree_leaves_with_path(state)}


def _sharded(state) -> bool:
    return any(isinstance(x, DTensor) for x in tree_leaves(state))


def _writes(state) -> bool:
    """Whether this process writes ``state``: always, unless it is a
    ``DTensor`` state, which rank 0 writes for every rank."""
    return not _sharded(state) or dist.get_rank() == 0


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
    """Synchronous atomic save.  Returns the final checkpoint path; a
    ``DTensor`` state has landed for every rank when it returns."""
    host = _host(state)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    if _writes(state):
        _write(ckpt_dir, host, step, keep)
    if _sharded(state):
        dist.barrier()
    return final


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
        if not _writes(state):
            return

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


def restore(ckpt_dir: str, like_state, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``like_state``: each leaf with the
    dtype of its counterpart there, on its device, or on its mesh in its
    placements when it is a ``DTensor``.  ``shardings`` (a tree of
    ``sharding.partition.ParamSharding`` over ``like_state``'s paths; a
    subtree it leaves out, or None, keeps the counterpart's placement)
    lays the leaves out on the CURRENT mesh — the elastic-resize path."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(path, "arrays.npz")) as z:
        host = {k: z[k] for k in z.files}

    def fill(like, sh, prefix):
        if isinstance(like, dict):
            return {k: fill(v, sh.get(k) if isinstance(sh, dict) else None,
                            prefix + (str(k),)) for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return type(like)(
                fill(v, sh[i] if isinstance(sh, (list, tuple)) else None,
                     prefix + (str(i),)) for i, v in enumerate(like))
        key = _SEP.join(prefix)
        if key not in host:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = host[key]
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(f"shape mismatch for {key}: "
                             f"{arr.shape} vs {tuple(like.shape)}")
        if sh is not None:
            mesh, placements = sh.mesh, sh.placements
        elif isinstance(like, DTensor):
            mesh, placements = like.device_mesh, like.placements
        else:
            return torch.as_tensor(arr, device=like.device).to(like.dtype)
        # every rank read the same file: each keeps its own shard
        full = torch.as_tensor(arr, device=mesh.device_type).to(like.dtype)
        return distribute_tensor(full, mesh, placements, src_data_rank=None)

    return fill(like_state, shardings, ())


def _cleanup(ckpt_dir: str, keep: int):
    steps = sorted(int(m.group(1)) for d in os.listdir(ckpt_dir)
                   if (m := re.fullmatch(r"step_(\d+)", d)))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)
