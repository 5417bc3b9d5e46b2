"""Training launcher — counterpart of ``repro/launch/train.py``.

  python -m repro_torch.launch.train --arch lstm-pems --steps 400        # the paper
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset tiny --steps 50
  python -m repro_torch.launch.train --arch gemma2-2b --preset tiny --quant w8a8 --hard-acts
  python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset tiny --device cpu

``--arch lstm-pems`` trains the paper's model through the session API
(``build`` -> ``train_qat`` -> ``quantize``) and prints the test MSE of
the float, QAT and integer paths (the integer path runs the fused LSTM
kernel on the card).  Other archs train on ``SyntheticLM`` tokens through
``training.step.make_train_step`` and the fault-tolerant ``Trainer``:
``--preset tiny`` is the reduced config, ``100m`` a 6-layer 512-wide
model, ``full`` the published one; the f32 master weights are drawn from
a ``torch.Generator`` seeded with ``--seed`` on the device.  ``--remat``
overrides the config's activation checkpointing; ``--log-every`` sets
how often a step's metrics are logged and kept.  Checkpoints land in
``--ckpt-dir``; rerun the same command to resume; SIGTERM checkpoints and
exits.  It runs on the CUDA card unless ``--device cpu`` is given, and
raises where there is no card.

As in the reference, an LM trains under the host mesh
(``launch.mesh.make_host_mesh``: every rank of the process group over
``("data", "model")``, a one-rank group opened here when none exists —
NCCL on the card, gloo with ``--device cpu``) and the config's sharding
rules (``sharding.partition.rules_context``): the params, the optimizer
state and each batch are ``DTensor``s laid out by ``param_shardings``
and :func:`batch_shardings`, and a resumed state is laid out on the
current mesh.  Under ``torchrun`` each rank takes its card.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.configs.base import batch_axes
from repro_torch.core.quant import QuantConfig
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.data.timeseries import pems_like_dataset
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import _device
from repro_torch.models import transformer as T
from repro_torch.sharding.partition import (distribute, param_shardings,
                                           rules_context)
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.step import TrainPlan, init_train_state, make_train_step
from repro_torch.training.train_loop import LoopConfig, Trainer


def train_lstm(args, dev: torch.device, log=print):
    """The paper's model: QAT on PeMS-like data (§6.1), through the session
    API: build -> train_qat -> quantize -> infer."""
    import repro_torch
    cfg = ARCH_CONFIGS["lstm-pems"]
    data = pems_like_dataset(seq_len=cfg.seq_len, seed=0)

    acc = repro_torch.build(cfg, seed=args.seed, device=dev)
    acc.train_qat(data, steps=args.steps, batch=args.batch,
                  lr=args.lr or 3e-3, seed=args.seed, ckpt_dir=args.ckpt_dir,
                  log=log)
    acc.quantize()

    # Evaluation: float vs QAT vs the bit-exact integer (accelerator) path.
    xte, yte = (torch.as_tensor(a, device=dev) for a in data["test"])
    mse = {}
    for name, path in [("float", "float"), ("qat", "qat"),
                       ("int8-kernel", "int")]:
        mse[name] = float(torch.mean((acc.infer(xte, path=path) - yte) ** 2))
        log(f"  test MSE [{name:12s}] = {mse[name]:.5f}")
    return {**acc.train_summary, "test_mse": mse}


def batch_shardings(batch, mesh, overrides=()):
    """{key: ParamSharding} for a training batch on ``mesh``: tokens,
    labels and input embeddings split their batch dim by the ``"batch"``
    rule, M-RoPE's (3, B, S) position ids their second; a batch dim the
    mesh cannot divide stays whole."""
    axes = {k: ((None,) + batch_axes() if k == "position_ids"
                else batch_axes() + (None,) * (v.ndim - 2))
            for k, v in batch.items()}
    return param_shardings(axes, mesh, overrides, batch)


def train_lm(args, dev: torch.device, log=print):
    base = ARCH_CONFIGS[args.arch]
    cfg = base if args.preset == "full" else reduce_config(base)
    if args.preset == "100m":
        cfg = base.replace(n_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
                           head_dim=64, d_ff=2048, vocab_size=32768,
                           remat="none")
    if args.quant:
        cfg = cfg.replace(quant=QuantConfig(args.quant))
    if args.hard_acts:
        cfg = cfg.replace(hard_acts=True)
    if args.remat:
        cfg = cfg.replace(remat=args.remat)

    mesh = make_host_mesh(device_type=dev.type)
    with rules_context(mesh, cfg.sharding_overrides):
        params, axes = T.init_model(
            cfg, torch.Generator(device=dev).manual_seed(args.seed))
        shard = param_shardings(axes, mesh, cfg.sharding_overrides, params)
        params = distribute(params, shard)
        plan = TrainPlan(opt=OptConfig(lr=args.lr or 3e-4, warmup_steps=10,
                                       total_steps=args.steps),
                         microbatches=args.microbatches,
                         grad_compress=args.grad_compress)
        state = init_train_state(params, plan)
        step_fn = make_train_step(cfg, plan)
        src = SyntheticLM(cfg.vocab_size, seed=args.seed)

        def batch_fn(step):
            b = src.batch(step, args.batch, args.seq)
            out = {"tokens": torch.as_tensor(b["tokens"], device=dev),
                   "labels": torch.as_tensor(b["labels"], device=dev)}
            if cfg.attn and cfg.attn.mrope_sections:
                pos = torch.arange(args.seq, device=dev).expand(args.batch,
                                                                args.seq)
                out["position_ids"] = torch.stack([pos] * 3)
            if not cfg.embed_inputs:
                rng = np.random.default_rng((args.seed, step))
                out["inputs_embeds"] = torch.as_tensor(
                    rng.normal(0, 1, (args.batch, args.seq, cfg.d_model))
                    .astype(np.float32), device=dev).to(torch.bfloat16)
                del out["tokens"]
            return distribute(out, batch_shardings(out, mesh,
                                                   cfg.sharding_overrides))

        trainer = Trainer(step_fn, state, batch_fn,
                          LoopConfig(total_steps=args.steps,
                                     ckpt_dir=args.ckpt_dir,
                                     ckpt_every=args.ckpt_every,
                                     log_every=args.log_every),
                          log=log)
        trainer.maybe_resume(shardings={"params": shard,
                                        "opt": {"mu": shard, "nu": shard}})
        out = trainer.run()
    out["state"] = trainer.state
    return out


def main(argv=None, log=print):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="lstm-pems", choices=sorted(ARCH_CONFIGS))
    ap.add_argument("--preset", default="tiny", choices=["tiny", "100m", "full"])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", default="none",
                    choices=["none", "bf16", "int8"])
    ap.add_argument("--quant", default=None, choices=[None, "w8", "w8a8"])
    ap.add_argument("--hard-acts", action="store_true")
    ap.add_argument("--remat", default=None, choices=[None, "none", "full"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = _device(args.device)
    if args.arch == "lstm-pems":
        return train_lstm(args, dev, log)
    opened = not dist.is_initialized()
    try:
        return train_lm(args, dev, log)
    finally:
        if opened and dist.is_initialized():   # the host mesh's own group
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
