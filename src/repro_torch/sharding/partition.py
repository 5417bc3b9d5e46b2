"""Logical-axis sharding rules — FSDP(data) x TP(model) x DP(pod) — and
per-replica placement; counterpart of ``repro/sharding/partition.py``.

Parameters and activations are annotated with LOGICAL axis names; the rules
below map them onto the axes of a ``torch.distributed.DeviceMesh``
(MaxText-style).  A spec is a tuple with one entry per tensor dim: ``None``,
a mesh-axis name, or a tuple of names — a ``PartitionSpec``'s entries — and
:func:`spec_to_placements` turns it into the ``DTensor`` placements that
hold a parameter or an activation on the mesh.

:func:`constrain` is a contextvar-scoped ``redistribute`` so model code can
annotate activations without threading a mesh through every call.  Outside
a rules context it does nothing (single-device runs); inside one it takes
only ``DTensor``s: a plain tensor there means the model dropped out of
``DTensor``, and it raises rather than let that pass.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication


# TP width of the production mesh (launch/mesh.py); used for static layout
# decisions that must be made where the mesh isn't in scope (cache specs).
PRODUCTION_TP = 16

# logical axis -> mesh axis (or tuple of mesh axes)
DEFAULT_RULES: Dict[str, Optional[Tuple[str, ...]]] = {
    "batch": ("pod", "data"),      # DP across pods, FSDP-data within
    "seq": None,
    "embed": ("data",),            # FSDP: shard the non-TP weight dim
    "heads": ("model",),
    "kv_heads": ("model",),
    "head_dim": None,
    "mlp": ("model",),
    "vocab": ("model",),
    "experts": None,               # TP-MoE default; EP overrides to model
    "expert_mlp": ("model",),
    "lru": ("model",),             # RG-LRU width
    "heads_d": ("model",),         # rwkv fused heads*head_dim projection dim
    "mlp2": ("model",),            # rwkv channel-mix receptance dim
    "kv_seq": ("model",),          # decode KV-cache seq dim (sequence-
                                   # parallel attention when kv_heads can't
                                   # use the model axis)
    "layers": None,
    "act_embed": None,             # activation d_model dim
    "act_heads": ("model",),       # activation heads dim
}

Rules = Dict[str, Optional[Tuple[str, ...]]]
Spec = Tuple[Any, ...]


def _axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def _axis_size(mesh, name: str) -> int:
    return mesh.size(_axis_names(mesh).index(name))


def resolve_rules(mesh, overrides: Sequence[Tuple[str, Optional[str]]] = ()
                  ) -> Rules:
    """Filter the rules to the axes present in ``mesh`` and apply per-arch
    overrides."""
    names = _axis_names(mesh)
    rules = dict(DEFAULT_RULES)
    for k, v in overrides:
        rules[k] = (v,) if isinstance(v, str) else v
    out = {}
    for k, v in rules.items():
        if v is None:
            out[k] = None
            continue
        axes = tuple(a for a in v if a in names)
        out[k] = axes if axes else None
    return out


def logical_to_spec(axes: Tuple[Optional[str], ...], rules: Rules,
                    shape: Optional[Tuple[int, ...]] = None,
                    mesh=None) -> Spec:
    """Logical axes tuple -> spec tuple (a ``PartitionSpec``'s entries).

    Guards: (1) a mesh axis is used at most once per spec; (2) when
    ``shape`` is given, mesh axes that do not DIVIDE the dim are dropped
    (8 KV heads over 16-way TP, or batch=1 decode, fall back to
    replication; the longest dividing PREFIX of the rule's axes is
    kept)."""
    used = set()
    parts = []
    for i, a in enumerate(axes):
        m = rules.get(a) if a else None
        if m:
            m = tuple(x for x in m if x not in used)
        if m and shape is not None and mesh is not None:
            kept = []
            prod = 1
            for x in m:
                prod *= _axis_size(mesh, x)
                if shape[i] % prod == 0:
                    kept.append(x)
                else:
                    break
            m = tuple(kept)
        if m:
            used.update(m)
            parts.append(m if len(m) > 1 else m[0])
        else:
            parts.append(None)
    return tuple(parts)


def spec_to_placements(spec: Spec, mesh) -> Tuple[Placement, ...]:
    """Spec tuple -> one placement per mesh dim: ``Shard(d)`` where tensor
    dim ``d`` is split over that mesh axis, else ``Replicate()``.  A tuple
    entry splits one tensor dim over several mesh axes, which must come in
    the mesh's dim order (DTensor's major-to-minor, as GSPMD's).  An axis
    of size 1 replicates: a split into one piece is the whole tensor, and
    DTensor refuses to reshape a dim split that way."""
    names = _axis_names(mesh)
    out: list = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"mesh axes {group} of dim {d} are not in the "
                             f"mesh's order {names}")
        for i in idx:
            if mesh.size(i) > 1:
                out[i] = Shard(d)
    return tuple(out)


class ParamSharding(NamedTuple):
    """Where one leaf lives: its mesh, its spec and the DTensor
    placements that spec gives."""
    mesh: Any
    spec: Spec
    placements: Tuple[Placement, ...]


def _map_tree(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists (and the matching
    leaves of ``rest``): a tensor, an axes tuple or a
    :class:`ParamSharding` is a leaf."""
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_shardings(axes_tree, mesh, overrides=(), shapes_tree=None):
    """axes tree (+ optional twin tree of tensors whose shapes drive the
    divisibility guard) -> twin tree of :class:`ParamSharding`."""
    rules = resolve_rules(mesh, overrides)

    def one(axes, like=None):
        shape = None if like is None else tuple(like.shape)
        spec = logical_to_spec(axes, rules, shape, mesh)
        return ParamSharding(mesh, spec, spec_to_placements(spec, mesh))

    if shapes_tree is None:
        return _map_tree(one, axes_tree)
    return _map_tree(one, axes_tree, shapes_tree)


def distribute(tree, shardings):
    """Every tensor leaf of ``tree`` as a ``DTensor`` on its twin
    :class:`ParamSharding`'s mesh and placements.  Every rank must hold
    the same full tensor (params drawn from one seed, a step-keyed batch):
    each keeps its own shard of it and nothing is sent."""
    return _map_tree(
        lambda t, s: distribute_tensor(t, s.mesh, s.placements,
                                       src_data_rank=None),
        tree, shardings)


# --- activation constraints (contextvar-scoped) -----------------------------

_RULES: contextvars.ContextVar = contextvars.ContextVar("partition_rules",
                                                        default=None)


@contextlib.contextmanager
def rules_context(mesh, overrides=()):
    """Activate the rules on ``mesh`` for :func:`constrain`.  Inside it a
    plain tensor meeting a ``DTensor`` in an op is taken as replicated
    (``implicit_replication``): the constants the model builds from global
    shapes (positions, masks, the online-softmax state) hold the same
    values on every rank."""
    token = _RULES.set((mesh, resolve_rules(mesh, overrides)))
    try:
        with implicit_replication():
            yield
    finally:
        _RULES.reset(token)


def place(x: DTensor, placements) -> DTensor:
    """``x`` redistributed to ``placements`` on its mesh (``x`` itself
    when it is laid out so already)."""
    placements = tuple(placements)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def constrain(x, *axes: Optional[str]):
    """Place an activation by its logical axes (a no-op without rules).
    Inside a rules context ``x`` must be a ``DTensor``; it is
    redistributed to the spec's placements."""
    ctx = _RULES.get()
    if ctx is None:
        return x
    if not isinstance(x, DTensor):
        raise TypeError(
            f"constrain{axes}: got a plain {type(x).__name__} inside a "
            "rules context; the model left DTensor upstream of this point")
    mesh, rules = ctx
    spec = logical_to_spec(tuple(axes), rules, tuple(x.shape), mesh)
    return place(x, spec_to_placements(spec, mesh))


# --- per-replica placement (serving cluster) --------------------------------


def replica_shardings(mesh) -> list:
    """One device per coordinate of a ``("replica",)`` serving mesh
    (``launch.mesh.make_serving_mesh``): "this whole tree lives on replica
    *i*'s device", which :func:`pin_to_device` takes.  Per-replica params
    are small (the paper's model is KBs), so every replica holds a full
    copy pinned to its own device rather than sharding one copy."""
    if "replica" not in tuple(mesh.axis_names):
        raise ValueError(f"expected a ('replica',) serving mesh, got axes "
                         f"{tuple(mesh.axis_names)}")
    return list(mesh.devices)


def pin_to_device(tree, device):
    """Every tensor leaf of ``tree`` (dicts and lists of tensors, as the
    params and their integer codes are) moved to ``device``, the structure
    kept.  A session whose params and codes live on replica *i*'s device
    runs its datapath there, which keeps a stream's carry replica-local
    in the serving cluster."""
    from repro_torch.training.tree import tree_map  # it imports the models
    device = torch.device(device)
    return tree_map(lambda t: t.to(device), tree)
