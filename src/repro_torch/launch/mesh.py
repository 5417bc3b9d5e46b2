"""Device lists for the serving cluster — counterpart of
``repro/launch/mesh.py``, with ``torch.device``s.

Only :func:`serving_devices` is ported: the LM side's production meshes
(``make_production_mesh``, ``make_host_mesh``, ``make_serving_mesh``)
wait for the sharded LM.  Torch has no mesh object: each replica's
session is pinned to its device directly
(``sharding.partition.pin_to_device``).
"""

from __future__ import annotations

from typing import List, Optional

import torch


def serving_devices(n: int, devices=None, *, oversubscribe: bool = True,
                    kind: Optional[str] = None) -> List[torch.device]:
    """The device list for an ``n``-replica serving cluster.

    ``devices`` pins an explicit list (must hold at least ``n``; the first
    ``n`` are used — the caller controls placement).  With the default
    ``devices=None`` the visible devices of type ``kind`` (a session's
    ``device.type``: a CUDA session is dealt only cards, never the CPU;
    ``None`` takes CUDA when a card is visible, else the CPU) are dealt
    out round-robin; when ``n`` exceeds their count,
    ``oversubscribe`` (default, the CPU-test posture and one card's
    replicas) reuses devices cyclically, while ``oversubscribe=False``
    raises — the production posture, where a "replica" that silently
    shares a device is a capacity-planning bug."""
    if n < 1:
        raise ValueError(f"need n >= 1 replicas, got {n}")
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) < n:
            raise ValueError(
                f"need {n} devices for {n} replicas, got {len(devices)} "
                f"explicit devices")
        return devices[:n]
    if kind is None:
        kind = "cuda" if torch.cuda.is_available() else "cpu"
    if kind == "cuda":
        avail = [torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
    elif kind == "cpu":
        avail = [torch.device("cpu")]
    else:
        raise ValueError(
            f"unknown device type {kind!r}; expected 'cuda' or 'cpu'")
    if not avail:
        raise RuntimeError(f"no {kind} device is visible")
    if len(avail) < n and not oversubscribe:
        raise RuntimeError(
            f"need {n} devices for {n} replicas, have {len(avail)} "
            f"{avail[0].type} device(s) — pass oversubscribe=True to share "
            f"devices")
    return [avail[i % len(avail)] for i in range(n)]
