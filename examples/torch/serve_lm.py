"""Batched LM serving demo through the PyTorch port: greedy decode with a
KV cache, optionally with the paper's quantisation at LM scale (int8
weights, w8a8's int8 products on the card's integer GEMM kernel, and an
int8 KV cache).  ``--preset tiny`` (the default) serves the reduced
config; on the CUDA card unless ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/serve_lm.py [--device cpu]
      PYTHONPATH=src python examples/torch/serve_lm.py --arch rwkv6-7b
      PYTHONPATH=src python examples/torch/serve_lm.py --quant w8a8 --kv-int8
"""
from repro_torch.launch.serve import main

if __name__ == "__main__":
    main()
