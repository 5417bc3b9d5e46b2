"""Serving launcher — batched decode with a KV/recurrent-state cache;
counterpart of ``repro/launch/serve.py``.

  python -m repro_torch.launch.serve --arch recurrentgemma-2b --preset full
  python -m repro_torch.launch.serve --preset tiny --device cpu

It prefeeds a random prompt (numpy, ``--seed``) through decode steps
(cache warm-up), then generates greedily, and prints tokens/s with the
device's name.  The weights are random, drawn from a ``torch.Generator``
seeded with ``--seed`` on the device.  ``--preset tiny`` runs the reduced
config, ``full`` the published one; ``--arch`` defaults to the one
architecture the port runs.  It runs on the CUDA card unless ``--device
cpu`` is given, and raises where there is no card.
``--quant`` and ``--kv-int8`` are not ported yet and raise.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.models import transformer as T


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to serve on the CPU")
    return dev


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b")
    ap.add_argument("--preset", default="tiny", choices=["tiny", "full"])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=64)
    ap.add_argument("--quant", default=None, choices=[None, "w8", "w8a8"])
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.quant or args.kv_int8:
        raise NotImplementedError(
            "--quant / --kv-int8 are not ported yet to repro_torch "
            "(ROADMAP.md: quantize_model_params, int8 KV cache)")
    dev = _device(args.device)
    base = ARCH_CONFIGS[args.arch]
    cfg = base if args.preset == "full" else reduce_config(base)

    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params, _ = T.init_model(cfg, gen)
        b = args.batch
        cache = T.init_cache(cfg, b, args.max_seq, device=dev)

        def decode(cache, tokens, pos):
            logits, cache = T.forward_decode(
                params, cache, {"tokens": tokens, "cache_pos": pos}, cfg)
            return logits[:, -1:].argmax(-1), cache

        rng = np.random.default_rng(args.seed)
        prompt = torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (b, args.prompt_len)), device=dev)

        # prefill via decode steps (cache warm-up)
        tok = prompt[:, :1]
        for t in range(args.prompt_len):
            tok, cache = decode(cache, prompt[:, t:t + 1], t)

        out = []
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for t in range(args.prompt_len, args.prompt_len + args.gen):
            tok, cache = decode(cache, tok, t)
            out.append(tok)
        gen_tokens = torch.cat(out, 1).cpu().numpy()   # waits for the device
        dt = time.perf_counter() - t0
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "CPU host")
    toks = b * args.gen
    print(f"[serve] {args.arch} ({cfg.n_layers}L d={cfg.d_model}) generated "
          f"{toks} tokens in {dt:.3f}s = {toks / dt:.3f} tok/s "
          f"(batch={b}, {name})")
    print("[serve] sample:", gen_tokens[0][:12], "...")
    return gen_tokens


if __name__ == "__main__":
    main()
