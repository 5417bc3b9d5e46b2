"""Step builders: train_step (microbatched gradient accumulation + AdamW
+ optional gradient compression) and the serve steps (prefill / decode)
— counterpart of ``repro/training/step.py``.

The reference's steps are jitted and lowered by its multi-pod dry-run;
here they run eagerly on the params' device.  ``train_step`` takes each
microbatch's gradient with ``torch.autograd.grad`` on fresh leaves, so the
train state stays a plain tree of tensors (no ``.grad`` attributes) that
``training.checkpoint`` saves and ``Trainer`` carries.

Under a mesh the params, the optimizer state and the batch are
``DTensor``s: the accumulator is made in each param's placements, each
microbatch stays split over the mesh axes that split the batch (each rank
takes chunk ``i`` of its own rows, so with data parallelism the step's
rows are the same but grouped otherwise), and each gradient is
redistributed to its param's placements before the update.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import local_map

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.modules import cast_tree
from repro_torch.sharding.partition import place
from repro_torch.training import compress as C
from repro_torch.training.optimizer import OptConfig, apply_updates, init_opt_state
from repro_torch.training.tree import tree_leaves, tree_map

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class TrainPlan:
    opt: OptConfig = OptConfig()
    microbatches: int = 1
    grad_compress: str = "none"   # none | bf16 | int8
    accum_dtype: str = "float32"  # cross-microbatch accumulator
    # Cast the f32 master params to the compute dtype once per step,
    # before use (the reference does it so FSDP all-gathers move bf16).
    cast_params_once: bool = True


def init_train_state(params, plan: TrainPlan) -> Dict[str, Any]:
    dev = tree_leaves(params)[0].device
    state = {"params": params, "opt": init_opt_state(params, plan.opt),
             "step": torch.zeros((), dtype=torch.int32, device=dev)}
    if plan.grad_compress == "int8":
        state["grad_err"] = C.init_error_state(params)
    return state


def _chunk(v: torch.Tensor, axis: int, nm: int, i: int) -> torch.Tensor:
    """Chunk ``i`` of ``nm`` along ``axis``; a ``DTensor`` split along
    ``axis`` gives chunk ``i`` of every rank's own rows, so it stays split
    (a slice of the global rows would gather them)."""
    if isinstance(v, DTensor) and Shard(axis) in v.placements:
        pl = tuple(v.placements)
        return local_map(lambda t: _chunk(t, axis, nm, i),
                         out_placements=(pl,), in_placements=(pl,),
                         device_mesh=v.device_mesh)(v)
    n = v.shape[axis] // nm
    return v.narrow(axis, i * n, n)


def _micro(batch: Dict[str, torch.Tensor], nm: int, i: int):
    """Microbatch ``i`` of ``nm``: a chunk of the leading axis (axis 1 of
    ``position_ids``, which leads with the M-RoPE streams)."""
    return {k: _chunk(v, 1 if k == "position_ids" else 0, nm, i)
            for k, v in batch.items()}


def _placed_like(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``g`` in ``p``'s placements: autograd leaves a ``DTensor``
    gradient in whatever placements propagation chose (a ``Partial`` sum
    where the forward contracted a split dim)."""
    return place(g, p.placements) if isinstance(g, DTensor) else g


def make_train_step(cfg: ModelConfig, plan: TrainPlan):
    """Returns train_step(state, batch) -> (state, metrics): metrics holds
    ``loss`` (the mean over microbatches), the optimizer's ``lr`` and
    ``grad_norm``, and the mean ``ce`` and ``aux``, as plain tensors (on
    every rank under a mesh).  The state passed in is left as it was."""
    # The accumulator follows the compression dtype (bf16), as the
    # reference's deferred reduce must see bf16 values.
    acc_dtype = (torch.bfloat16 if plan.grad_compress == "bf16"
                 else _DTYPES[plan.accum_dtype])
    nm = plan.microbatches

    def grads_of(params, micro):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        if plan.cast_params_once:
            live = cast_tree(live, _DTYPES[cfg.dtype])
        loss, metrics = T.forward_train(live, micro, cfg)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        gs = iter([torch.zeros_like(p) if g is None else _placed_like(g, p)
                   for p, g in zip(leaves, gs)])
        return loss.detach(), metrics, tree_map(lambda _: next(gs), params)

    def train_step(state, batch):
        params = state["params"]
        gsum = tree_map(lambda p: torch.zeros_like(p, dtype=acc_dtype), params)
        lsum = torch.zeros((), dtype=torch.float32,
                           device=tree_leaves(params)[0].device)
        ces, auxs = [], []
        for i in range(nm):
            loss, metrics, grads = grads_of(params, _micro(batch, nm, i))
            if plan.grad_compress == "bf16":
                grads = tree_map(lambda g: g.to(torch.bfloat16), grads)
            gsum = tree_map(lambda a, g: a + g.to(acc_dtype), gsum, grads)
            lsum = lsum + loss
            ces.append(metrics["ce"].detach())
            auxs.append(metrics["aux"].detach())
        grads = tree_map(lambda g: g / nm, gsum)

        new_err = None
        if plan.grad_compress == "int8":
            grads, new_err = C.compress(grads, "int8", state["grad_err"])

        new_params, new_opt, opt_metrics = apply_updates(
            params, grads, state["opt"], plan.opt)
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        if new_err is not None:
            new_state["grad_err"] = new_err
        metrics = {"loss": lsum / nm, **opt_metrics,
                   "ce": torch.stack(ces).mean(),
                   "aux": torch.stack(auxs).mean()}
        # a metric summed over split rows is a DTensor partial on each
        # rank: reduced here, every rank reports the whole value
        return new_state, {k: v.full_tensor() if isinstance(v, DTensor) else v
                           for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return T.forward_prefill(params, batch, cfg)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, cache, batch):
        logits, cache = T.forward_decode(params, cache, batch, cfg)
        return torch.argmax(logits[:, -1], dim=-1), cache
    return decode_step
