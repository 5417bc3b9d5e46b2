"""Serving launcher — batched decode with a KV/recurrent-state cache;
counterpart of ``repro/launch/serve.py``.

  python -m repro_torch.launch.serve --arch qwen1.5-0.5b --preset full
  python -m repro_torch.launch.serve --arch rwkv6-7b --quant w8 --kv-int8
  python -m repro_torch.launch.serve --preset tiny --device cpu

It prefeeds a random prompt (numpy, ``--seed``) through decode steps
(cache warm-up), then generates greedily, and prints tokens/s with the
device's name and the quantisation mode.  The weights are random, drawn
from a ``torch.Generator`` seeded with ``--seed`` on the device.
``--preset tiny`` runs the reduced config, ``full`` the published one.
``--quant w8|w8a8`` serves int8 weights (``quantize_model_params``; w8a8
runs every quantised ``linear``'s int8 product on the card's integer GEMM
kernel), ``--kv-int8`` an int8 KV cache.  Archs without an embedding
input (musicgen) get their frames from the frontend stub: the token ids
embedded through the table (``q * s`` when it is quantised); M-RoPE archs
(qwen2-vl) get the step's position on all three streams.  It runs on the
CUDA card unless ``--device cpu`` is given, and raises where there is no
card.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.core.quant import QuantConfig
from repro_torch.models import transformer as T


def _device(name: str) -> torch.device:
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu "
                           "to run on the CPU")
    return dev


def cache_shardings(cfg, batch: int, seq_len: int, mesh, overrides=None):
    """{key: ParamSharding} of ``T.cache_spec``'s entries on ``mesh``: each
    entry's logical axes through the config's rules (``overrides`` in
    their place when given), a dim the mesh cannot divide left whole."""
    from repro_torch.sharding.partition import param_shardings
    spec = T.cache_spec(cfg, batch, seq_len)
    return param_shardings(
        {k: ax for k, (_, _, ax) in spec.items()}, mesh,
        cfg.sharding_overrides if overrides is None else overrides,
        {k: torch.empty(shp, device="meta") for k, (shp, _, _) in spec.items()})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
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

    dev = _device(args.device)
    base = ARCH_CONFIGS[args.arch]
    cfg = base if args.preset == "full" else reduce_config(base)
    if args.quant or args.kv_int8:
        cfg = cfg.replace(quant=QuantConfig(args.quant or "w8",
                                            quantize_kv=args.kv_int8))

    with torch.inference_mode():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params, axes = T.init_model(cfg, gen)
        if cfg.quant.enabled:
            params, axes = T.quantize_model_params(params, axes, cfg)
            print(f"[serve] weights quantised: mode={cfg.quant.mode} "
                  f"int8-KV={cfg.quant.quantize_kv}")
        b = args.batch
        cache = T.init_cache(cfg, b, args.max_seq, device=dev)
        mrope = bool(cfg.attn and cfg.attn.mrope_sections)

        def decode(cache, tokens, pos):
            batch = {"tokens": tokens, "cache_pos": pos}
            if not cfg.embed_inputs:
                # frontend stub: embed token ids through the embedding table
                emb = params["embed"]
                e = (emb["q"][tokens].to(torch.bfloat16)
                     * emb["s"].to(torch.bfloat16)) if isinstance(emb, dict) \
                    else emb[tokens].to(torch.bfloat16)
                batch = {"inputs_embeds": e, "cache_pos": pos}
            if mrope:
                batch["position_ids"] = torch.full((3, b, 1), pos, device=dev)
            logits, cache = T.forward_decode(params, cache, batch, cfg)
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
          f"(batch={b}, quant={cfg.quant.mode}, int8-KV={cfg.quant.quantize_kv}, "
          f"{name})")
    print("[serve] sample:", gen_tokens[0][:12], "...")
    return gen_tokens


if __name__ == "__main__":
    main()
