"""Per-replica placement — counterpart of ``repro/sharding/partition.py``.

Only :func:`pin_to_device` is ported.  The serving cluster's params are
small (the paper's model is a few KB), so every replica holds a full copy
on its own device rather than one copy sharded across devices.
"""

from __future__ import annotations

import torch

from repro_torch.training.tree import tree_map


def pin_to_device(tree, device):
    """Every tensor leaf of ``tree`` (dicts and lists of tensors, as the
    params and their integer codes are) moved to ``device``, the structure
    kept.  A session whose params and codes live on replica *i*'s device
    runs its datapath there, which keeps a stream's carry replica-local
    in the serving cluster."""
    device = torch.device(device)
    return tree_map(lambda t: t.to(device), tree)
