#!/usr/bin/env python3
"""Time RWKV-6's chunked WKV (``models/rwkv6.py::wkv_chunked``) of one or
more checkouts on one CUDA card, in the order given.

    python3 tools/wkv_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); a tree named
twice is measured twice, so ``parent . . parent`` alternates two commits
on one card.  Every tree runs in its own Python process, which imports
``repro_torch`` from ``TREE/src``.  Each process prints one JSON line: the
card's name and power limit, then for every case its mean device time
(``ms``, CUDA events around the calls, one synchronize at the end), the
peak device memory the case allocated above what it started from
(``peak_gib``) and whether every output is finite (``finite``).

Cases, at rwkv6-7b's published widths (64 heads of 64 channels, chunk
128):
  * ``wkv prefill``: ``wkv_chunked`` alone, B=1, T=2048, f32, under
    ``torch.inference_mode`` (5 calls);
  * ``wkv forward+backward``: the same, with the gradient of every input
    (3 calls);
  * ``rwkv6-7b prefill``: ``transformer.forward_prefill`` of the model cut
    to 2 layers, B=1, a 2048-token prompt (3 calls);
  * ``rwkv6-7b train step``: where the tree has ``training.step``, one
    ``make_train_step`` step of the same cut model at B=1, S=512 (four
    chunks; 3 steps after one to warm up).
Inputs are numpy normals from seed 0 (decay logits N(0, 0.5), so a chunk's
decay sums past exp's f32 range); weights come from a ``torch.Generator``
seeded 0.  Exits 2 without a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

B, T, H, N = 1, 2048, 64, 64
TRAIN_S = 512


def _timed(torch, fn, iters):
    """(mean ms over ``iters`` calls after one warm call, peak GiB above the
    start, the last call's result)."""
    out = fn()
    torch.cuda.synchronize()
    del out
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    return start.elapsed_time(end) / iters, peak, out


def _finite(torch, out):
    if isinstance(out, torch.Tensor):
        return bool(torch.isfinite(out).all())
    return all(_finite(torch, o) for o in out)


def measure(tree: Path) -> dict:
    import numpy as np
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.models import rwkv6 as RW
    from repro_torch.models import transformer as TF

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    on = lambda a: torch.as_tensor(a.astype(np.float32), device=dev)  # noqa: E731
    r, k, v = (on(rng.normal(0, 1, (B, T, H, N))) for _ in range(3))
    w = on(rng.normal(0, 0.5, (B, T, H, N)))
    u = on(rng.normal(0, 1, (H, N)))
    out = {"tree": str(tree), "card": card, "cases": {}}

    def record(name, fn, iters):
        ms, peak, res = _timed(torch, fn, iters)
        out["cases"][name] = {"ms": ms, "peak_gib": peak, "finite": _finite(torch, res)}
        del res
        torch.cuda.empty_cache()

    def prefill_wkv():
        with torch.inference_mode():
            return RW.wkv_chunked(r, k, v, w, u)

    ins = [a.clone().requires_grad_(True) for a in (r, k, v, w, u)]

    def train_wkv():
        y, s = RW.wkv_chunked(*ins)
        return torch.autograd.grad(y.square().sum() + s.sum(), ins)

    record(f"wkv prefill ({B}, {T}, {H}, {N}) f32", prefill_wkv, 5)
    record(f"wkv forward+backward ({B}, {T}, {H}, {N}) f32", train_wkv, 3)
    del ins

    cfg = ARCH_CONFIGS["rwkv6-7b"].replace(n_layers=2)
    params, _ = TF.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, T)), device=dev)

    def prefill():
        with torch.inference_mode():
            return TF.forward_prefill(params, {"tokens": tokens}, cfg)

    record(f"rwkv6-7b prefill 2 layers B={B} T={T}", prefill, 3)
    try:
        from repro_torch.training import step as TS
    except ImportError:
        return out
    plan = TS.TrainPlan()
    holder = [TS.init_train_state(params, plan)]
    del params
    step_fn = TS.make_train_step(cfg, plan)
    batch = {"tokens": tokens[:, :TRAIN_S],
             "labels": torch.roll(tokens[:, :TRAIN_S], -1, 1)}

    def step():
        holder[0], m = step_fn(holder[0], batch)
        return m["loss"]

    record(f"rwkv6-7b train step 2 layers B={B} S={TRAIN_S}", step, 3)
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("wkv_ab: no CUDA device is available", file=sys.stderr)
            return 2
        print(json.dumps(measure(Path(argv[1]).resolve())), flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    rc = 0
    for tree in argv:
        proc = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        print(proc.stdout.strip() or json.dumps({"tree": tree, "rc": proc.returncode}),
              flush=True)
        rc = rc or proc.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
