"""Quickstart: the paper's pipeline end to end through the PyTorch port's
session API (``repro_torch``), on the CUDA card unless ``--device cpu``.

1. ``repro_torch.build`` the paper's accelerator (hidden 20, (4,8) fixed
   point, HardSigmoid* 'step' + HardTanh, pipelined ALU).
2. ``train_qat`` briefly on synthetic PeMS-like traffic data.
3. ``quantize`` and run the deployment path — the plan picks the fused
   LSTM kernel (K1) on the card — and check that it matches QAT and is
   bit-identical across every backend engine.
4. ``report()`` the accelerator plan and the energy model's figures.

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu] [--steps 150]
"""
import argparse

import torch

import repro_torch
from repro_torch.core.accelerator import PAPER_DEFAULT
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.data.timeseries import pems_like_dataset


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=150)
    args = ap.parse_args(argv)

    cfg = QLSTMConfig()  # the paper's model
    data = pems_like_dataset(seq_len=cfg.seq_len)
    xte, yte = data["test"]

    acc = repro_torch.build(cfg, PAPER_DEFAULT, seed=0, device=args.device)
    acc.train_qat(data, steps=args.steps, batch=64, lr=3e-3).quantize()

    x = torch.as_tensor(xte[:512], device=acc.device)
    y = torch.as_tensor(yte[:512], device=acc.device)
    mse_qat = float(torch.mean((acc.infer(x, path="qat") - y) ** 2))
    pred_hw = acc.infer(x, path="int")            # the plan's engine
    mse_hw = float(torch.mean((pred_hw - y) ** 2))
    print(f"\ntest MSE: QAT={mse_qat:.5f}  int8-accelerator={mse_hw:.5f} "
          f"(paper reports 0.040 on real PeMS-4W)")

    # Every execution engine produces the SAME integer codes (the paper's
    # point: one parameterised design, many implementations).
    for backend in ("ref", "pallas", "xla"):
        same = bool(torch.equal(acc.infer(x, path="int", backend=backend),
                                pred_hw))
        print(f"  backend {backend:6s}: bit-identical = {same}")

    rep = acc.report()
    print(f"\nAccelerator plan ({acc.device}):", rep["plan"])
    print("Energy report (modelled, core/energy.py):", rep["energy"])
    return {"mse_qat": mse_qat, "mse_int": mse_hw}


if __name__ == "__main__":
    main()
