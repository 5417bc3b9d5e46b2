"""Device meshes — counterpart of ``repro/launch/mesh.py``.

The LM side's meshes are ``torch.distributed.DeviceMesh``es with the
reference's axis names: :func:`make_host_mesh` spans the ranks of the
process group (``("data", "model")``), :func:`make_production_mesh` the
``(16, 16)`` / ``(2, 16, 16)`` production layouts.  Both need a process
group; :func:`make_host_mesh` opens a one-rank group itself when none
exists, so a single card needs no launcher (under ``torchrun`` each rank
takes the card ``LOCAL_RANK`` names).  The default device type is
``cuda``, and it raises without a card; the CPU runs on ``gloo``.

The serving cluster runs every replica in one process, which a
``DeviceMesh`` (one rank per device) cannot describe, so
:func:`make_serving_mesh` returns a :class:`ServingMesh`: the replicas'
distinct devices along one ``"replica"`` axis.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def _check_device_type(device_type: str):
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass "
                               "device_type='cpu' to build a mesh on gloo")
    elif device_type != "cpu":
        raise ValueError(f"unknown device type {device_type!r}; expected "
                         f"'cuda' or 'cpu'")


def ensure_process_group(device_type: str = "cuda"):
    """The default process group: the one that exists, the ``torchrun``
    environment's (``RANK``/``WORLD_SIZE``/``MASTER_ADDR``), or a
    one-rank group in this process — NCCL on ``cuda`` (after selecting
    the card ``LOCAL_RANK`` names, 0 by default), gloo on ``cpu``."""
    _check_device_type(device_type)
    kw = {}
    if device_type == "cuda":
        card = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(card)
        kw["device_id"] = card       # NCCL binds the card, not a guess
    if dist.is_initialized():
        return
    backend = "nccl" if device_type == "cuda" else "gloo"
    if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
        dist.init_process_group(backend, **kw)
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1, **kw)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    """16x16 = 256 ranks per pod; 2 pods = 512 ranks multi-pod.

    Axes: pod = pure DP across pods; data = FSDP; model = TP(+EP).  Takes
    the first ranks of the existing process group and raises when it is
    short."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have < n:
        raise RuntimeError(
            f"need {n} ranks for mesh {shape}, have {have} — launch one "
            "rank per device (torchrun) before building the production mesh")
    ranks = torch.arange(n).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=axes)


def make_host_mesh(model_parallel: int = 1,
                   device_type: str = "cuda") -> DeviceMesh:
    """``(world // model_parallel, model_parallel)`` over ``("data",
    "model")``, across every rank of the process group (opened by
    :func:`ensure_process_group` when none exists)."""
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if n % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide "
                         f"the {n} ranks")
    ranks = torch.arange(n).reshape(n // model_parallel, model_parallel)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))


def serving_devices(n: int, devices=None, *, oversubscribe: bool = True,
                    kind: Optional[str] = None) -> List[torch.device]:
    """The device list for an ``n``-replica serving cluster.

    ``devices`` pins an explicit list (must hold at least ``n``; the first
    ``n`` are used — the caller controls placement).  With the default
    ``devices=None`` the visible devices of type ``kind`` (a session's
    ``device.type``: a CUDA session is dealt only cards, never the CPU;
    ``None`` means the cards, and raises when none is visible) are dealt
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
    kind = "cuda" if kind is None else kind
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


@dataclasses.dataclass(frozen=True)
class ServingMesh:
    """A 1-D ``("replica",)`` mesh: one distinct device per replica."""
    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = ("replica",)


def make_serving_mesh(n: int, devices=None, *, oversubscribe: bool = True,
                      kind: Optional[str] = None) -> ServingMesh:
    """1-D ``("replica",)`` mesh over the serving cluster's devices.

    Each coordinate along the ``replica`` axis is one serving replica's
    device (:func:`serving_devices` picks them); per-replica placement
    then falls out of ``sharding.partition.replica_shardings``.  Requires
    ``n`` DISTINCT devices — a mesh cannot repeat a device, so the
    oversubscribed posture skips the mesh and pins each replica directly
    (``sharding.partition.pin_to_device``)."""
    devs = serving_devices(n, devices, oversubscribe=oversubscribe,
                           kind=kind)
    if len(set(devs)) != len(devs):
        raise RuntimeError(
            f"make_serving_mesh needs {n} distinct devices (a mesh cannot "
            "repeat one); oversubscribed replicas are pinned directly via "
            "sharding.partition.pin_to_device instead")
    return ServingMesh(tuple(devs))
