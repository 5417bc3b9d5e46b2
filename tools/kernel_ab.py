#!/usr/bin/env python3
"""Time the port's LSTM kernels (K1-K3), HardSigmoid* ``step`` (K5) and
the RG-LRU scan (K7) of one or more checkouts on one CUDA card, in the
order given.

    python3 tools/kernel_ab.py TREE [TREE ...]

Each TREE is the root of a checkout (``.`` for this one); a tree named
twice is measured twice, so ``parent . . parent`` alternates two commits
on one card.  Every tree runs in its own Python process, which imports
``repro_torch`` from ``TREE/src`` and builds that tree's kernels into
``TREE/build``.  Each process prints one JSON line: the card's name and
power limit, then for every case the kernel alone (``kernel_ms``, the
profiler's device time of the kernels whose name holds ``qlstm``,
``hard_act``, ``hact`` or ``rglru``, 50 calls), everything the wrapper enqueues (``ms``, one call
replayed from a CUDA graph, 500 calls) and one eager call (``call_ms``,
CUDA events, 500 calls).

Cases, at the shapes of ``chip_smoke.py``: K1 (``qlstm_seq_multilayer``)
and K2 (``qlstm_seq``) at T=6, B=256, M=1, H=20, L=1, (4,8) codes, the
``step`` HardSigmoid*; K3 (``qlstm_seq_slot``) at B=64 against a (1026,
1, 2, 20) table, also at T=1 and with the weights read from device
memory (``weights_in_smem=False``); K5 (``hard_sigmoid_star``, the
``step`` method) on (2048, 2816) int8 (4,8) codes in [-64, 64); K7 (``rglru_seq``) at (4096, 2, 2560)
f32 on (T, B, W) views of (B, T, W) tensors, and, where the tree has a
second route, the same inputs forced onto it.  Inputs are random codes
and normals from numpy seed 0.  Exits 2 without a CUDA card.
"""

import json
import subprocess
import sys
from pathlib import Path

PROFILE_CALLS = 50
REPLAYS = 500


def _cuda_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(torch, fn, iters):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return _cuda_ms(torch, graph.replay, iters)


def _kernel_ms(torch, fn):
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_CALLS):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    names = set()
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA") and (
                any(k in e.key for k in ("qlstm", "hard_act", "hact", "rglru"))):
            total += float(getattr(e, "self_device_time_total",
                                   getattr(e, "self_cuda_time_total", 0.0)))
            names.add(e.key)
    return total / PROFILE_CALLS / 1e3, sorted(names)


def measure(tree: Path) -> dict:
    """All cases on ``tree``'s kernels; returns the readings."""
    import numpy as np
    import torch
    sys.path.insert(0, str(tree / "src"))
    from repro_torch.core import fixed_point as fxp
    from repro_torch.kernels import hard_act as ha
    from repro_torch.kernels import qlstm_cell as qc
    from repro_torch.kernels import rglru_scan as rg

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    rng = np.random.default_rng(0)
    cfg = fxp.FixedPointConfig(4, 8)
    kw = dict(cfg=cfg, hs_method="step")
    lo, hi = cfg.int_min, cfg.int_max + 1

    def codes(shape, a=lo, b=hi, dt=torch.int8):
        return torch.as_tensor(rng.integers(a, b, shape), device=dev).to(dt)

    H = 20
    wx, wh = codes((1, 4 * H), lo // 4, hi // 4), codes((H, 4 * H), lo // 8, hi // 8)
    bias = codes((4 * H,), -200, 200, torch.int32)
    x256, x64, x64_1 = codes((6, 256, 1)), codes((6, 64, 1)), codes((1, 64, 1))
    zeros = torch.zeros(256, H, dtype=torch.int32, device=dev)
    table = torch.zeros(1026, 1, 2, H, dtype=torch.int32, device=dev)
    g = torch.as_tensor(rng.permutation(1024)[:64], dtype=torch.int32, device=dev)
    s = torch.as_tensor(rng.permutation(1024)[:64], dtype=torch.int32, device=dev)
    slot_kw = dict(batch_block=None, hs_slope_shift=3, hs_bound=3.0, ht_min=-1.0,
                   ht_max=1.0, **kw)
    la = -torch.as_tensor(np.abs(rng.normal(0, 1, (2, 4096, 2560))),
                          dtype=torch.float32, device=dev)
    bb = torch.as_tensor(rng.normal(0, 1, (2, 4096, 2560)), dtype=torch.float32,
                         device=dev)
    la_v, b_v = la.transpose(0, 1), bb.transpose(0, 1)
    act_codes = codes((2048, 2816), -64, 64)

    cases = {
        "K1 multilayer B=256": lambda: qc.qlstm_seq_multilayer(
            x256, [wx], [wh], [bias], [zeros], [zeros], **kw),
        "K2 seq B=256": lambda: qc.qlstm_seq(
            x256, wx, wh, bias, h0=zeros, c0=zeros, return_state=True, **kw),
        "K3 slot B=64 T=6": lambda: qc.qlstm_seq_slot(
            x64, g, s, table, [wx], [wh], [bias], **kw),
        "K3 slot B=64 T=1": lambda: qc.qlstm_seq_slot(
            x64_1, g, s, table, [wx], [wh], [bias], **kw),
        "K3 slot B=64 T=6 weights in device memory": lambda: qc._launch(
            x64, [wx], [wh], [bias], gather=g, scatter=s, table=table,
            weights_in_smem=False, **slot_kw),
        "K5 step (2048, 2816) int8": lambda: ha.hard_sigmoid_star(
            act_codes, cfg=cfg, method="step"),
        "K7 rglru (4096, 2, 2560) f32 views": lambda: rg.rglru_seq(la_v, b_v),
    }
    if "route" in rg._launch.__code__.co_varnames:
        cases["K7 rglru (4096, 2, 2560) f32 views, lane route"] = (
            lambda: rg._launch(la_v, b_v, route="lane"))
    out = {"tree": str(tree), "card": card, "cases": {}}
    for name, fn in cases.items():
        k_ms, names = _kernel_ms(torch, fn)
        out["cases"][name] = {"kernel_ms": k_ms, "ms": _graph_ms(torch, fn, REPLAYS),
                              "call_ms": _cuda_ms(torch, fn, REPLAYS),
                              "kernels": names}
    return out


def main(argv) -> int:
    if len(argv) == 2 and argv[0] == "--one":
        import torch
        if not torch.cuda.is_available():
            print("kernel_ab: no CUDA device is available", file=sys.stderr)
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
