"""The paper's §6.1 experiment, end to end, through the PyTorch port's
training launcher (``repro_torch.launch.train --arch lstm-pems``): QAT on
PeMS-like traffic data through the session API (``build`` ->
``train_qat`` -> ``quantize`` -> ``infer``), then the test MSE of the
float, QAT and integer datapaths (the integer path runs the fused LSTM
kernel on the card).  Checkpoints land in ``build/torch_lstm_ckpt`` under
the repository (``--ckpt-dir`` moves them): rerun to resume; SIGTERM
checkpoints and exits.  On the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/train_lstm_pems.py [--steps 400] [--device cpu]
"""
import os
import sys

from repro_torch.launch.train import main

CKPT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "build", "torch_lstm_ckpt")

if __name__ == "__main__":
    args = sys.argv[1:]
    if "--ckpt-dir" not in args:
        args += ["--ckpt-dir", os.path.normpath(CKPT)]
    main(["--arch", "lstm-pems"] + args)
