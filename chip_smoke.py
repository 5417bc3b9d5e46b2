#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/csrc`` (one ``nvcc`` per
source, all started together) and drives the port's two paths: the
paper's integer LSTM — ``build`` -> ``quantize`` -> ``infer(path="int")``
and a stateful ``StreamServer`` — at the full width of the paper's model
(``QLSTMConfig()``: M=1, H=20, L=1, T=6, (4,8) codes), the
``kernels.ops`` entry point at the published widths of qwen1.5-0.5B
(``configs/qwen15_05b.py``: d_model 1024, d_ff 2816, 16 heads of 64, a
2048-token prefill), and RecurrentGemma-2B's prefill and decode
(``repro_torch.models``, ``repro_torch.launch.serve``) at its published
widths, nothing cut (``configs/recurrentgemma_2b.py``: 26 layers, d_model
and lru_width 2560, 10 heads of 256 on 1 KV head, window 2048, d_ff 7680,
vocab 256,000; bf16 activations over f32 master params, random init from
a ``torch.Generator`` seeded 0), quantisation-aware training of the
paper's model (``train_qat``) on the card, and the serving tier (the
seeded fault injector, the GRU and rGLRU cells, the four-replica
cluster), in phases:

  1. the card, torch/CUDA versions and the kernels' build time;
  2. every kernel against its plain torch version on the card: the LSTM
     kernels bit for bit (tolerance 0) across (4,8)/(6,8)/(8,16)/(8,24),
     arithmetic/step, mxu/vpu, 1-3 layers, batches of 1, 37 and 256,
     hidden sizes 20, 40 and 64 (a row is 3, 5 or 8 warps, a quad of lanes
     per unit),
     weights in shared and in device memory, and slot permutations with
     ZERO/TRASH rows; quant_matmul in both modes (tolerance 0) at shapes
     that are no multiple of a tile, with int8, int16 and int32 codes
     whose sums wrap int32, at the edges of the int8 kernel's 128 x 128 x
     64 tiles, with x rows off 16-byte alignment, and an int8 wrap case
     (16 x 135,168 x 8, every code -128: -2,080,374,784 everywhere);
     HardSigmoid* (three methods) and HardTanh over every code of
     (4,8)/(6,8)/(8,10)/(8,16) (tolerance 0); HardSigmoid* ``step`` on
     each of its routes (bytes, words, bisect): every code of those widths
     that int8, int16 and int32 storage hold, int16 codes outside (4,8)'s
     range, (6,16) codes in int8 (thresholds beyond -128 and 127), each on
     a view off 16-byte alignment and on a size that leaves a tail
     (tolerance 0); flash attention on the
     reference's five shape cases, hd 128 and 256, rows with no key in
     their window, the full (16, 2048, 64) causal prefill, T no multiple
     of the 64-row q tile, hd 4 and 12, GQA through ``mha_flash`` (2e-5
     abs/rel in f32) and bf16 (1e-2); the RG-LRU scan (K7) on the reference's
     three shapes, a zero-decay running sum, a 4096-step long-memory
     chain, bf16 (one bf16 ulp), strided (B, T, W) views, and the
     full-width (4096, 2, 2560) inputs of the model's layer 0 (1e-5
     relative + 1e-6 absolute in f32), which must take the tile route and
     equal the lane route bit for bit;
  3. ``infer`` on 256 windows through the fused kernel, equal to the
     ``ref`` engine, with every kernel's launch count read;
  4. a ``StreamServer`` (batch 64, device-resident state) serving 128
     streams x 6 windows, each stream equal to its stateful ``ref`` run
     and to one concatenated run, one slot-kernel launch per wave, no
     degradation, and no plain engine below the kernel on its ladder;
  4b. the ``ops`` path: ``quant_matmul`` and ``quant_matmul_requant`` on a
     (2048, 1024) x (1024, 2816) int8 product, the three HardSigmoid*
     methods and HardTanh on the (2048, 2816) requantised codes, causal
     ``mha_flash`` on (1, 2048, 16, 64) f32 q/k/v, and ``qlstm_seq`` at
     the paper's model width; each result equal to its plain version
     (attention within 2e-5), each kernel launched, K2 exactly once;
  5. the count of tensor-core instructions (IMMA in quant_matmul, HMMA in
     flash attention) in the built SASS, then CUDA-event timings of each
     kernel, its plain version and, where one
     PyTorch call computes the same function, that call, at the shapes
     of phases 3, 4, 4b and 6 (K7's lane route on the same inputs as its
     earlier reading; K3's latency floor: its launch at T = 0 plus T x L
     of its marginal steps, and its probes at T = 1 and with the weights
     in device memory), the server's per-wave latency, the
     RecurrentGemma-2B prefill's wall time and device idle share, and its
     decode tokens/s; the same 128 x 6 traffic through ``build_cluster``
     warm (1 replica at batch 16, 4 at batch 16 and at 64); HardSigmoid*
     ``step`` beside its earlier design (the
     bisect route on the same codes) and ``arithmetic``/``1to1`` kernel
     alone; a ``train_qat`` step's wall time, device busy time and idle
     share;
  6. RecurrentGemma-2B: ``forward_prefill`` at B=2, T=4096 (twice the
     window) with finite last-token logits and K7 launched exactly 18
     times (one per rec layer, all on the tile route); ``serve.main`` at
     ``--preset full`` (batch 4, 16 prompt + 16 generated tokens, a 2048-slot KV ring); and
     a 32-token prompt decoded step by step at B=2 whose last logits equal
     the prefill's within 0.3 (the reference's bound) with f32
     activations, and in bf16 within the distance between the bf16 and
     the f32 prefill;
  7. ``train_qat`` on the card at the paper's model (``QLSTMConfig()``,
     seed 0) on ``pems_like_dataset(seq_len=6, n_days=28)``, 200 steps of
     batch 64: finite losses whose last 20 average below the first 20; 10
     straight steps equal, bit for bit, 5 steps ended by SIGTERM
     (checkpoint-and-exit), a restore onto the card, an
     ``AsyncCheckpointer`` save, and 5 more steps resumed from it; after
     training, ``infer(path="qat")`` within one LSB of the dequantised
     ``infer(path="int")`` (``tests/test_qlstm.py``'s bound) and the int
     path through K1 equal to the ``ref`` engine;
  8. the serving tier at the paper's model: (a) the reference's fault
     drill (``tests/test_resilience.py``'s acceptance scenario: 64
     streams x 2 windows, ``wave_fault_rate=0.2``, seed 17) on a
     device-resident server at batch 4 and 64 — every window answered,
     equal to the ``ref`` engine, the injected counters in the metrics,
     K3 launched once per attempt past the injector, and no plain engine
     below the kernel; (b) state loss and corruption on the device store,
     each lost carry's next window flagged ``state_reset`` as the replayed
     schedule says, every other row bit for bit up to its fault; (c) the
     GRU and rGLRU cells (no kernel: the ``xla`` engine on the card) on
     256 windows, equal to their ``ref`` engine and to the CPU, and their
     ``StreamServer`` carries at both residencies; (d) ``build_cluster``
     with four replicas on the card, 128 streams x 6 windows, each row
     equal to the ``ref`` engine and on the replica ``HashRing`` names, K1
     on each replica's ``infer``, then r3 drained (a warm handoff, bit
     for bit) and r2 abandoned (its streams flagged ``state_reset``).

Any failure raises and exits non-zero.  The second-to-last line of
output is the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""

import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; int8
# tensor-core rate 1,979 TOP/s, the card's peak for 8-bit integer codes;
# fp32 on the CUDA cores 67 TFLOP/s; TF32 on the tensor cores 495 TFLOP/s.
# One TF32 product cannot hold attention's 2e-5 tolerance, but three can
# (3xTF32: hi*hi + hi*lo + lo*hi), so K8's bound counts three products at
# the TF32 rate.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
FP32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12

# qwen1.5-0.5B (configs/qwen15_05b.py) at a 2048-token prefill.
PREFILL, D_MODEL, D_FF, HEADS, HEAD_DIM = 2048, 1024, 2816, 16, 64
# RecurrentGemma-2B: a prefill of twice its 2048 window, decode steps timed.
LM_BATCH, LM_PREFILL, LM_DECODE = 2, 4096, 16
HS_METHODS = ("arithmetic", "step", "1to1")


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def log(*parts):
    print(*parts, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0].strip()


def cuda_ms(fn, iters):
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters):
    """Mean device time of the work ``fn()`` enqueues, with the host's
    Python overhead taken out: one call captured into a CUDA graph,
    replayed ``iters`` times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters)


def profile(fn, iters):
    """Run ``fn`` under torch.profiler; returns (key_averages, wall ms)."""
    from torch.profiler import ProfilerActivity, profile as _profile
    fn()
    torch.cuda.synchronize()
    with _profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    return prof.key_averages(), wall_ms


def device_us(evt):
    """Total device time of a profiler entry in microseconds."""
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def rand_stack(rng, T, B, M, H, L, cfg, dev):
    lo, hi = cfg.int_min, cfg.int_max + 1
    sd = cfg.storage_dtype
    t = lambda a, dt=sd: torch.as_tensor(a, device=dev).to(dt)
    x = t(rng.integers(lo, hi, (T, B, M)))
    wxs = [t(rng.integers(lo // 4, hi // 4, (M if li == 0 else H, 4 * H)))
           for li in range(L)]
    whs = [t(rng.integers(lo // 8, hi // 8, (H, 4 * H))) for _ in range(L)]
    bs = [t(rng.integers(-200, 200, (4 * H,)), torch.int32) for _ in range(L)]
    carry = [t(rng.integers(-90, 90, (B, H)), torch.int32) for _ in range(2 * L)]
    return x, wxs, whs, bs, carry[:L], carry[L:]


def max_err(a, b):
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def close_err(got, want, tol, rtol=None, what="attention"):
    """max |got - want| after checking |got - want| <= tol + rtol * |want|
    (rtol defaults to tol)."""
    rtol = tol if rtol is None else rtol
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    check(bool(torch.isfinite(got).all()), f"non-finite {what} output")
    check(bool((diff <= tol + rtol * want.abs()).all()),
          f"{what} differs from its plain version by {float(diff.max())}"
          f" (tolerance {tol} + {rtol} relative)")
    return float(diff.max())


def bound(nbytes, ops, ops_per_s):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def sass_count(build, name, opcode):
    """Instructions of ``opcode`` (e.g. ``HMMA``) in the SASS of the built
    library for ``csrc/<name>.cu``, from ``cuobjdump -sass``."""
    tool = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return len(re.findall(rf"\b{opcode}\.", sass))


def reset_counts(mods):
    for mod in mods:
        for k in mod.LAUNCHES:
            mod.LAUNCHES[k] = 0


def read_counts(mods):
    return {k: v for mod in mods for k, v in mod.LAUNCHES.items()}


def codes(rng, shape, bits, dev, lo=None, hi=None):
    lo = -(1 << (bits - 1)) if lo is None else lo
    hi = (1 << (bits - 1)) if hi is None else hi
    dt = torch.int8 if bits <= 8 else torch.int16 if bits <= 16 else torch.int32
    return torch.as_tensor(rng.integers(lo, hi, shape), device=dev).to(dt)


def phase2_kernels_vs_plain(qc, fxp, dev):
    """Each kernel against its plain version on the card; returns the
    largest absolute difference seen per kernel (must be 0)."""
    rng = np.random.default_rng(0)
    errs = {"multilayer": 0, "seq": 0, "slot": 0}
    n = 0
    for (a, b), method, unit, L, B, H in itertools.product(
            ((4, 8), (6, 8), (8, 16), (8, 24)),        # (8,24): int32 codes
            ("arithmetic", "step"), ("mxu", "vpu"), (1, 2, 3), (1, 37, 256),
            (20, 40, 64)):                             # rows of 3, 5, 8 warps
        cfg = fxp.FixedPointConfig(a, b)
        x, wxs, whs, bs, h0s, c0s = rand_stack(rng, 6, B, 1, H, L, cfg, dev)
        kw = dict(cfg=cfg, hs_method=method, compute_unit=unit)
        want, wstate = qc.qlstm_seq_multilayer_plain(x, wxs, whs, bs, h0s, c0s,
                                                     **kw)
        got, state = qc.qlstm_seq_multilayer(x, wxs, whs, bs, h0s, c0s, **kw)
        torch.cuda.synchronize()
        errs["multilayer"] = max(
            errs["multilayer"], max_err(got, want),
            *(max_err(p, q) for s1, s2 in zip(state, wstate)
              for p, q in zip(s1, s2)))
        g_out, g_h, g_c, args = qc._launch(
            x, wxs, whs, bs, h0s=h0s, c0s=c0s, batch_block=None,
            hs_slope_shift=3, hs_bound=3.0, ht_min=-1.0, ht_max=1.0,
            weights_in_smem=False, cfg=cfg, hs_method=method)
        torch.cuda.synchronize()
        check(args.w_smem == 0, "device-memory weights path not taken")
        errs["multilayer"] = max(
            errs["multilayer"], max_err(g_out, want),
            *(max_err(g_h[li], wstate[li][0]) for li in range(L)),
            *(max_err(g_c[li], wstate[li][1]) for li in range(L)))
        if L == 1:
            o1, (h1, c1) = qc.qlstm_seq(x, wxs[0], whs[0], bs[0], h0=h0s[0],
                                        c0=c0s[0], return_state=True, **kw)
            p1, (ph, pc) = qc.qlstm_seq_plain(x, wxs[0], whs[0], bs[0], h0=h0s[0],
                                              c0=c0s[0], return_state=True, **kw)
            torch.cuda.synchronize()
            errs["seq"] = max(errs["seq"], max_err(o1, p1), max_err(h1, ph),
                              max_err(c1, pc))
        rows = 2 * B + 2
        table = torch.as_tensor(rng.integers(-90, 90, (rows, L, 2, H)),
                                dtype=torch.int32, device=dev)
        table[rows - 2] = 0
        g = torch.as_tensor(rng.permutation(2 * B)[:B], dtype=torch.int32,
                            device=dev)
        s = torch.as_tensor(rng.permutation(2 * B)[:B], dtype=torch.int32,
                            device=dev)
        g[0], s[-1] = rows - 2, rows - 1                  # ZERO gather, TRASH scatter
        got, new_table = qc.qlstm_seq_slot(x, g, s, table, wxs, whs, bs, **kw)
        torch.cuda.synchronize()
        want, want_table = qc.qlstm_seq_slot_plain(x, g, s, table, wxs, whs, bs,
                                                   **kw)
        errs["slot"] = max(errs["slot"], max_err(got, want),
                           max_err(new_table, want_table))
        check(not new_table[rows - 2].any(), "ZERO row written")
        check(torch.equal(new_table[rows - 1], table[rows - 1]), "TRASH row written")
        n += 1
    for name, e in errs.items():
        check(e == 0, f"kernel {name} differs from its plain version by {e}")
    return errs, n


def phase2_ops_kernels(qm, ha, fa, ops, fxp, dev):
    """quant_matmul, HardSigmoid*/HardTanh and flash attention against
    their plain versions on the card; returns (max error by kernel, case
    count).  Raises past a tolerance."""
    rng = np.random.default_rng(3)
    errs = {"quant_matmul_int32": 0, "quant_matmul_requant": 0,
            "hard_sigmoid_star": 0, "hard_tanh": 0, "flash_attention": 0.0}
    n = 0
    for bits, shapes in ((8, [(1, 1, 1), (67, 129, 45), (130, 64, 257),
                              (300, 1000, 77)]),
                         (16, [(33, 1000, 17), (65, 96, 130)]),
                         (24, [(7, 300, 70)])):
        for m, k, nn in shapes:
            x, w = codes(rng, (m, k), bits, dev), codes(rng, (k, nn), bits, dev)
            if bits > 8 and k >= 300:        # these sums leave int32
                exact = x.double() @ w.double()
                check(float(exact.abs().max()) > 2 ** 31, "no int32 wrap exercised")
            for mode, cfg in (("int32", None),
                              ("requant", fxp.FixedPointConfig(4, bits))):
                got = qm.quant_matmul(x, w, out_mode=mode, cfg=cfg)
                torch.cuda.synchronize()
                want = qm.quant_matmul_plain(x, w, out_mode=mode, cfg=cfg)
                check(got.dtype == want.dtype, f"quant_matmul dtype {got.dtype}")
                key = f"quant_matmul_{mode}"
                errs[key] = max(errs[key], max_err(got, want))
                n += 1
    # int8 on the tensor cores: the edges of the 128 x 128 x 64 tiles; x
    # rows that are not 16-byte aligned (a column slice, so K % 16 != 0,
    # and a contiguous view at an offset base pointer); and the int32 wrap:
    # 135,168 products of -128 * -128 sum to 2,214,592,512, which leaves
    # int32 and wraps to -2,080,374,784.
    flat = codes(rng, (5 + 37 * 1000,), 8, dev)
    offset = flat[5:].view(37, 1000)
    check(offset.data_ptr() % 16 != 0, "the offset view is 16-byte aligned")
    sliced = codes(rng, (129, 1100), 8, dev)[:, 3:1000]
    wrap_x = torch.full((16, 135168), -128, dtype=torch.int8, device=dev)
    wrap_w = torch.full((135168, 8), -128, dtype=torch.int8, device=dev)
    exact = int((wrap_x[0].long() * wrap_w[:, 0].long()).sum())
    check(exact > 2 ** 31 - 1, f"the wrap case's sum {exact} stays in int32")
    pairs = [(codes(rng, (m, k), 8, dev), codes(rng, (k, nn), 8, dev))
             for m, k, nn in ((127, 16, 129), (129, 48, 127), (257, 1040, 257),
                              (129, 1040, 127))]
    pairs += [(x, codes(rng, (x.shape[1], 70), 8, dev)) for x in (sliced, offset)]
    pairs.append((wrap_x, wrap_w))
    for x, w in pairs:
        for mode, cfg in (("int32", None), ("requant", fxp.FixedPointConfig(4, 8))):
            got = qm.quant_matmul(x, w, out_mode=mode, cfg=cfg)
            torch.cuda.synchronize()
            want = qm.quant_matmul_plain(x, w, out_mode=mode, cfg=cfg)
            check(got.dtype == want.dtype, f"quant_matmul dtype {got.dtype}")
            key = f"quant_matmul_{mode}"
            errs[key] = max(errs[key], max_err(got, want))
            n += 1
    wrapped = qm.quant_matmul(wrap_x, wrap_w)
    torch.cuda.synchronize()
    check(bool((wrapped == -2080374784).all()),
          f"the int8 wrap case gave {wrapped.unique().tolist()}, not -2080374784")
    for a, b in ((4, 8), (6, 8), (8, 10), (8, 16)):
        cfg = fxp.FixedPointConfig(a, b)
        xs = torch.arange(cfg.int_min, cfg.int_max + 1, device=dev).to(
            cfg.storage_dtype)
        for view in (xs, xs[3:], xs.reshape(-1, 16)):
            for method in HS_METHODS:
                got = ha.hard_sigmoid_star(view, cfg=cfg, method=method)
                torch.cuda.synchronize()
                want = ha.hard_sigmoid_star_plain(view, cfg=cfg, method=method)
                check(got.dtype == view.dtype and got.shape == view.shape,
                      "HardSigmoid* changed dtype or shape")
                errs["hard_sigmoid_star"] = max(errs["hard_sigmoid_star"],
                                                max_err(got, want))
                n += 1
            got = ha.hard_tanh(view, cfg=cfg)
            torch.cuda.synchronize()
            errs["hard_tanh"] = max(errs["hard_tanh"],
                                    max_err(got, ha.hard_tanh_plain(view, cfg=cfg)))
            n += 1
    # The reference's five cases, then hd 128 and 256 (T != S, a window),
    # a window that leaves the last rows no key (the softmax's mean), the
    # full qwen1.5-0.5B prefill shape, T no multiple of the 64-row q tile,
    # and hd 4 and 12 (padded to 8 and 16 in the kernel); the full shape and
    # every case with T or hd off those multiples also in bf16.
    bf16_err = 0.0
    for bh, t, s_len, hd, causal, window in ((3, 64, 64, 32, True, None),
                                             (3, 64, 64, 32, False, None),
                                             (3, 96, 96, 16, True, 24),
                                             (3, 40, 72, 32, False, None),
                                             (3, 128, 128, 64, True, None),
                                             (3, 300, 300, 128, True, None),
                                             (3, 100, 257, 256, False, 40),
                                             (3, 100, 40, 32, False, 10),
                                             (HEADS, PREFILL, PREFILL, HEAD_DIM,
                                              True, None),
                                             (3, 200, 200, 64, True, None),
                                             (3, 130, 130, 4, True, None),
                                             (3, 100, 90, 12, False, 30)):
        q, k, v = (torch.as_tensor(rng.normal(0, 1, (bh, ln, hd)),
                                   dtype=torch.float32, device=dev)
                   for ln in (t, s_len, s_len))
        got = fa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = fa.flash_attention_plain(q, k, v, causal=causal, window=window)
        errs["flash_attention"] = max(errs["flash_attention"],
                                      close_err(got, want, 2e-5))
        n += 1
        if t == PREFILL or t % 64 or hd % 8:
            qb, kb, vb = (x.bfloat16() for x in (q, k, v))
            got = fa.flash_attention(qb, kb, vb, causal=causal, window=window)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"bf16 attention returned {got.dtype}")
            bf16_err = max(bf16_err, close_err(got, fa.flash_attention_plain(
                qb, kb, vb, causal=causal, window=window), 1e-2))
            n += 1
    q = torch.as_tensor(rng.normal(0, 1, (2, 128, 8, 64)), dtype=torch.float32,
                        device=dev)
    k, v = (torch.as_tensor(rng.normal(0, 1, (2, 128, 2, 64)),
                            dtype=torch.float32, device=dev) for _ in range(2))
    got = ops.mha_flash(q, k, v, causal=True)          # GQA: 8 heads on 2
    torch.cuda.synchronize()
    errs["flash_attention"] = max(errs["flash_attention"], close_err(
        got, ops.mha_flash(q, k, v, causal=True, use_kernel=False), 2e-5))
    qb, kb, vb = (t.bfloat16() for t in (q, k, v))
    got = ops.mha_flash(qb, kb, vb, causal=True, window=50)
    torch.cuda.synchronize()
    check(got.dtype == torch.bfloat16, f"bf16 attention returned {got.dtype}")
    bf16_err = max(bf16_err, close_err(got, ops.mha_flash(
        qb, kb, vb, causal=True, window=50, use_kernel=False), 1e-2))
    n += 2
    for name, e in errs.items():
        check(name == "flash_attention" or e == 0,
              f"kernel {name} differs from its plain version by {e}")
    return errs, bf16_err, n


def phase2_step_routes(ha, fxp, dev):
    """HardSigmoid* ``step`` on each of its routes against its plain
    version (tolerance 0); returns (max error, case count, cases by
    route).  Raises when a route is left untried."""
    err, n, routes = 0, 0, {"bytes": 0, "words": 0, "bisect": 0}

    def case(xs, cfg):
        nonlocal err, n
        routes[ha.step_route(ha.hard_act.HardSigmoidStarSpec(cfg), xs.dtype).name] += 1
        for view in (xs, xs[3:], xs[: xs.numel() - 5]):  # off 16 bytes; a tail
            got = ha.hard_sigmoid_star(view, cfg=cfg, method="step")
            torch.cuda.synchronize()
            want = ha.hard_sigmoid_star_plain(view, cfg=cfg, method="step")
            check(got.dtype == view.dtype and got.shape == view.shape,
                  "HardSigmoid* step changed dtype or shape")
            err = max(err, max_err(got, want))
            n += 1

    for (a, b), dtype in itertools.product(((4, 8), (6, 8), (8, 10), (8, 16), (6, 16)),
                                           (torch.int8, torch.int16, torch.int32)):
        cfg, info = fxp.FixedPointConfig(a, b), torch.iinfo(dtype)
        lo, hi = max(cfg.int_min, info.min), min(cfg.int_max, info.max)
        case(torch.arange(lo, hi + 1, device=dev).to(dtype).repeat(3), cfg)
    case(torch.arange(-400, 400, device=dev).to(torch.int16), fxp.FXP_4_8)
    check(all(routes.values()), f"a step route was left untried: {routes}")
    check(err == 0, f"HardSigmoid* step differs from its plain version by {err}")
    return err, n, routes


def phase_ops(ops, qm, ha, fa, qc, fxp, QLSTMConfig, dev, mods):
    """The ``kernels.ops`` path at qwen1.5-0.5B widths and the paper's
    LSTM width; returns (inputs, launch counts, max errors)."""
    rng = np.random.default_rng(4)
    cfg = fxp.FXP_4_8
    # Activation codes of a (4,8) layer and small weights, so that the
    # requantised codes land in HardSigmoid*'s linear region and not only
    # in saturation; both operands are int8.
    x = codes(rng, (PREFILL, D_MODEL), 8, dev, -16, 16)
    w = codes(rng, (D_MODEL, D_FF), 8, dev, -2, 3)
    q, k, v = (torch.as_tensor(rng.normal(0, 1, (1, PREFILL, HEADS, HEAD_DIM)),
                               dtype=torch.float32, device=dev) for _ in range(3))
    model = QLSTMConfig()
    lstm = rand_stack(rng, model.seq_len, 256, model.input_size,
                      model.hidden_size, 1, model.fxp, dev)
    lstm_args = (lstm[0], lstm[1][0], lstm[2][0], lstm[3][0], model)

    reset_counts(mods)
    acc = ops.quant_matmul(x, w)
    pre = ops.quant_matmul_requant(x, w, cfg)
    hs = {m: ops.hard_sigmoid_star_int(pre, cfg, method=m) for m in HS_METHODS}
    ht = ops.hard_tanh_int(pre, cfg)
    att = ops.mha_flash(q, k, v, causal=True)
    h_seq = ops.qlstm_seq(*lstm_args)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    want = {"int32": 1, "requant": 1, "hard_sigmoid_star": 3, "hard_tanh": 1,
            "flash_attention": 1, "multilayer": 0, "seq": 1, "slot": 0,
            "rglru_seq": 0, "rglru_seq_lane": 0}
    check(launches == want, f"the ops path launched {launches}")

    errs = {"quant_matmul_int32": max_err(acc, qm.quant_matmul_plain(x, w)),
            "quant_matmul_requant": max_err(pre, qm.quant_matmul_plain(
                x, w, out_mode="requant", cfg=cfg)),
            "hard_sigmoid_star": max(max_err(hs[m], ha.hard_sigmoid_star_plain(
                pre, cfg=cfg, method=m)) for m in HS_METHODS),
            "hard_tanh": max_err(ht, ha.hard_tanh_plain(pre, cfg=cfg)),
            "qlstm_seq": max(max_err(h_seq, ops.qlstm_seq(*lstm_args,
                                                          use_kernel=False)),
                             max_err(h_seq, qc.qlstm_seq_plain(
                                 lstm[0], lstm[1][0], lstm[2][0], lstm[3][0],
                                 cfg=model.fxp, hs_method="step")))}
    for name, e in errs.items():
        check(e == 0, f"ops path: {name} differs from its plain version by {e}")
    errs["flash_attention"] = close_err(
        att, ops.mha_flash(q, k, v, causal=True, use_kernel=False), 2e-5)
    check(tuple(acc.shape) == tuple(pre.shape) == (PREFILL, D_FF) and
          acc.dtype == torch.int32 and pre.dtype == torch.int8,
          f"quant_matmul gave {tuple(acc.shape)} {acc.dtype} / {pre.dtype}")
    check(tuple(att.shape) == (1, PREFILL, HEADS, HEAD_DIM), f"attention {att.shape}")
    inside = float((pre.abs() < cfg.int_max).float().mean())
    check(inside > 0.5, f"only {inside:.3f} of the requantised codes unsaturated")
    check(len(torch.unique(hs["step"])) > 8, "HardSigmoid* never left saturation")
    check(tuple(h_seq.shape) == (model.seq_len, 256, model.hidden_size) and
          bool(h_seq.abs().sum() > 0), "qlstm_seq output empty or zero")
    return dict(x=x, w=w, pre=pre, q=q, k=k, v=v, lstm=lstm_args,
                unsaturated=inside), launches, errs


def layer0_scan_inputs(T, L, RG, params, cfg, tokens):
    """K7's inputs in the model's layer 0 (a rec layer) during the
    prefill of ``tokens``: (T, B, W) views of (B, T, W) f32 tensors."""
    from repro_torch.models.modules import tree_index
    p0 = tree_index(params["groups"][0], 0)
    x = L.norm_apply(p0["ln1"], T._embed(params, {"tokens": tokens}, cfg), cfg)
    cx = RG._causal_conv(p0["mixer"], L.linear(x, p0["mixer"]["w_x"], cfg.quant),
                         cfg)
    log_a, mult, i = RG._decay(p0["mixer"], cx, cfg)
    return log_a.transpose(0, 1), (mult * (i * cx)).transpose(0, 1)


def phase2_rglru(rg, full_inputs, dev):
    """K7 against its plain version on the card; returns (max |err| in
    f32, max |err| in bf16, case count, launches by route).  Raises past
    1e-5 relative + 1e-6 absolute in f32 or one bf16 ulp in bf16 (the
    kernel rounds the multiply and the add one at a time, as torch does;
    the margin is for exp's last bit), when the full-width inputs do not
    take the tile route, or when the tile route's bits differ from the
    lane route's on them."""
    rng = np.random.default_rng(5)
    before = dict(rg.LAUNCHES)

    def inputs(t, b, w, scale=1.0, zero_decay=False):
        la = -np.abs(rng.normal(0, scale, (t, b, w)))
        if zero_decay:
            la[:] = 0.0
        return (torch.as_tensor(la, dtype=torch.float32, device=dev),
                torch.as_tensor(rng.normal(0, 1, (t, b, w)), dtype=torch.float32,
                                device=dev))

    cases = [inputs(5, 3, 8), inputs(16, 7, 32), inputs(9, 128, 16),  # the reference's
             inputs(33, 3, 70, zero_decay=True),                       # running sum
             inputs(4096, 2, 64, scale=0.01),                          # long memory
             full_inputs]
    err = err16 = 0.0
    n = 0
    for la, b in cases:
        got = rg.rglru_seq(la, b)
        torch.cuda.synchronize()
        err = max(err, close_err(got, rg.rglru_seq_plain(la, b), 1e-6, 1e-5, "K7"))
        n += 1
        if la.shape[0] <= 64:
            la16, b16 = la.bfloat16(), b.bfloat16()
            got = rg.rglru_seq(la16, b16)
            torch.cuda.synchronize()
            check(got.dtype == torch.bfloat16, f"bf16 K7 returned {got.dtype}")
            err16 = max(err16, close_err(got, rg.rglru_seq_plain(la16, b16), 1e-6,
                                         2 ** -7, "K7 bf16"))
            # the same data as (T, B, W) views of (B, T, W) tensors
            la_v, b_v = (t.transpose(0, 1).contiguous().transpose(0, 1)
                         for t in (la, b))
            got_v = rg.rglru_seq(la_v, b_v)
            torch.cuda.synchronize()
            check(got_v.transpose(0, 1).is_contiguous(), "K7 output layout")
            err = max(err, close_err(got_v, rg.rglru_seq_plain(la, b), 1e-6, 1e-5,
                                     "K7 strided"))
            n += 2
    check(not full_inputs[0].is_contiguous(), "layer-0 inputs are not views")
    check(rg.tile_route_fits(*full_inputs), "the layer-0 inputs miss the tile route")
    tiles = rg.LAUNCHES["rglru_seq"]
    got = rg.rglru_seq(*full_inputs)
    lane = rg._launch(*full_inputs, route="lane")
    torch.cuda.synchronize()
    check(rg.LAUNCHES["rglru_seq"] == tiles + 1, "the full-width case left the tile route")
    check(torch.equal(got, lane), "K7's tile and lane routes differ on the layer-0 inputs")
    return err, err16, n, {k: v - before[k] for k, v in rg.LAUNCHES.items()}


def phase_lm(T, serve, mods, params, cfg, tokens, dev):
    """RecurrentGemma-2B's prefill, the serving entry and prefill against
    step-by-step decode.  Returns the launch counts of the prefill."""
    reset_counts(mods)
    logits = T.forward_prefill(params, {"tokens": tokens}, cfg)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    check(launches == {**{k: 0 for k in launches}, "rglru_seq": n_rec},
          f"the prefill launched {launches}, not K7's tile route {n_rec} times")
    check(tuple(logits.shape) == (tokens.shape[0], 1, cfg.vocab_size) and
          bool(torch.isfinite(logits).all()), f"prefill logits {logits.shape}")
    log(f"phase 6: forward_prefill {tuple(tokens.shape)} -> {tuple(logits.shape)} "
        f"finite; launches {launches}")

    reset_counts(mods)
    t0 = time.perf_counter()
    gen = serve.main(["--arch", "recurrentgemma-2b", "--preset", "full",
                      "--batch", "4", "--prompt-len", "16", "--gen", "16",
                      "--max-seq", "4096"])
    serve_s = time.perf_counter() - t0
    serve_launches = read_counts(mods)
    check(gen.shape == (4, 16) and ((0 <= gen) & (gen < cfg.vocab_size)).all(),
          f"serve returned {gen.shape}")
    check(not any(serve_launches.values()), f"decode launched {serve_launches}")
    log(f"phase 6: serve.main --preset full -> {gen.shape} tokens in "
        f"{serve_s:.3f} s (init included); launches {serve_launches}")

    # Prefill against step-by-step decode, on the same weights in f32 and in
    # bf16 activations.  The reference's bound (0.3) is set at its reduced
    # config (d 64, vocab 128); at full width bf16 rounding alone moves the
    # largest of the 2 x 256,000 last logits by more than that, so bf16 is
    # held to the distance between its own prefill and the f32 one.
    prompt = tokens[:, :32]

    def last_logits(c):
        pre = T.forward_prefill(params, {"tokens": prompt}, c)
        cache = T.init_cache(c, prompt.shape[0], prompt.shape[1], device=dev)
        for t in range(prompt.shape[1]):
            step, cache = T.forward_decode(params, cache, {
                "tokens": prompt[:, t:t + 1], "cache_pos": t}, c)
        return pre[:, -1], step[:, 0]

    pre16, dec16 = last_logits(cfg)
    pre32, dec32 = last_logits(cfg.replace(dtype="float32"))
    maxdiff = lambda a, b: float((a - b).abs().max())
    err32, err16, floor = maxdiff(pre32, dec32), maxdiff(pre16, dec16), \
        maxdiff(pre16, pre32)
    check(err32 < 0.3, f"f32 prefill and decode differ by {err32} (bound 0.3)")
    check(err16 <= floor, f"bf16 prefill and decode differ by {err16}, more "
          f"than bf16 differs from f32 ({floor})")
    log(f"phase 6: a 32-token prompt decoded step by step against the prefill's "
        f"last logits: f32 max |err| {err32} (bound 0.3), bf16 {err16} (bound: "
        f"bf16 prefill vs f32 prefill, {floor})")
    return launches


def phase7_train(repro_torch, model, accel, mods, dev, card):
    """QAT training on the card; returns the trained int path's launches."""
    from repro_torch.data import pems_like_dataset
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.tree import tree_leaves

    data = pems_like_dataset(seq_len=6, n_days=28)
    params0 = repro_torch.build(model, accel, seed=0).params
    fresh = lambda: repro_torch.build(model, accel, params=params0)
    quiet = lambda *_: None
    t0 = time.perf_counter()
    sess = fresh().train_qat(data, steps=200, batch=64, log_every=1, log=quiet)
    train_s = time.perf_counter() - t0
    losses = [h["loss"] for h in sess.train_summary["history"]]
    first, last = float(np.mean(losses[:20])), float(np.mean(losses[-20:]))
    check(len(losses) == 200 and all(np.isfinite(losses)), "train_qat losses")
    check(last < first, f"the QAT loss did not fall: first 20 {first}, last 20 {last}")
    check(all(p.device.type == "cuda" for p in tree_leaves(sess.params)),
          "trained params left the card")
    log(f"phase 7: train_qat 200 steps batch 64 in {train_s:.3f} s; mean loss of "
        f"the first 20 steps {first}, of the last 20 {last}")

    # 10 straight steps == 5 steps + SIGTERM checkpoint + restore onto the
    # card + AsyncCheckpointer save + 5 resumed steps, bit for bit.
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=10, batch=64, log_every=5)

    def preempt_at_5(msg):
        if msg.startswith("[step 5]"):
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        full = fresh().train_qat(data, log=quiet, **kw)
        cut = fresh().train_qat(data, ckpt_dir=str(root / "a"), log=preempt_at_5, **kw)
        check(cut.train_summary["preempted"] and cut.train_summary["step"] == 5,
              f"SIGTERM did not end the run at step 5: {cut.train_summary['step']}")
        like = {"params": params0, "opt": init_opt_state(params0, OptConfig()),
                "step": torch.zeros((), dtype=torch.int32, device=dev)}
        state = ck.restore(str(root / "a"), like)
        check(all(t.device.type == "cuda" for t in tree_leaves(state)) and
              int(state["step"]) == 5, "the restored state is not step 5 on the card")
        saver = ck.AsyncCheckpointer(str(root / "b"))
        saver.save_async(state, 5)
        saver.wait()
        resumed = fresh().train_qat(data, ckpt_dir=str(root / "b"), log=quiet, **kw)
        check(resumed.train_summary["step"] == 10, "the resumed run did not reach 10")
        same = all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(full.params), tree_leaves(resumed.params)))
        check(same, "10 straight steps differ from 5 + checkpoint + restore + 5")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("phase 7: 10 straight steps equal 5 steps + SIGTERM checkpoint + restore "
        "+ AsyncCheckpointer save + 5 resumed steps, bit for bit on the card")

    sess.quantize()
    xte = data["test"][0]
    yq, yi = sess.infer(xte, path="qat"), sess.infer(xte, path="int")
    qat_err = float((yq - yi).abs().max())
    lsb = model.fxp.scale
    log(f"phase 7: after training, |qat - int| on {len(xte)} test windows: max "
        f"{qat_err}, {int(((yq - yi).abs() > lsb + 1e-7).sum())} above one LSB ({lsb})")
    check(qat_err <= lsb + 1e-7, f"qat and int differ by {qat_err} (bound {lsb})")
    reset_counts(mods)
    y = sess.infer(xte, path="int")
    torch.cuda.synchronize()
    launches = read_counts(mods)
    check(launches == {**{k: 0 for k in launches}, "multilayer": 1},
          f"the trained int path launched {launches}")
    check(torch.equal(y, sess.infer(xte, path="int", backend="ref")),
          "the trained int path differs from the ref engine")
    check(bool(torch.isfinite(y).all()) and tuple(y.shape) == (len(xte), 1),
          f"int outputs {tuple(y.shape)}")
    log(f"phase 7: the trained int path equals the ref engine; launches {launches}")

    steps = 10
    avgs, wall_ms = profile(lambda: fresh().train_qat(
        data, steps=steps, batch=64, log_every=1000, log=quiet), 1)
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")
    busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / steps / 1e3
    step_ms = wall_ms / steps
    log(f"phase 7: a train_qat step (batch 64): {step_ms:.6f} ms wall under the "
        f"profiler ({train_s * 1e3 / 200:.6f} ms unprofiled, 200 steps), "
        f"{busy_ms:.6f} ms device busy, idle share {1 - busy_ms / step_ms:.4f} on {card}")
    log(avgs.table(sort_by="self_device_time_total", row_limit=10))
    return launches


def stream_windows(n_streams, k, seed, T, M):
    """(n_streams, k, T, M) float windows, stream i from seed + i (the
    reference's chaos windows: uniform in [0, 1))."""
    return np.stack([np.random.default_rng(seed + i).uniform(
        0.0, 1.0, (k, T, M)).astype(np.float32) for i in range(n_streams)])


def ref_rows(session, xs):
    """{(stream id, window): y} of each stream run window by window through
    the session's ``ref`` engine — the concatenated-sequence oracle."""
    fn = session.compiled_stateful("ref")
    state, out = session.init_state(xs.shape[0]), {}
    for w in range(xs.shape[1]):
        y, state = fn(xs[:, w], state)
        y = y.cpu().numpy()
        for i in range(xs.shape[0]):
            out[(f"s{i}", w)] = y[i]
    return out


def serve_all(server, xs, windows):
    """Submit ``windows`` of every stream (window-major), drain, and
    return {(stream id, seq): row}."""
    for w in windows:
        for i in range(xs.shape[0]):
            server.submit(f"s{i}", xs[i, w])
    return {(r.stream_id, r.seq): r for r in server.drain(timeout=300)}


def phase8_fault_drill(session, mods, batch):
    """The reference's acceptance drill (``tests/test_resilience.py``):
    64 streams x 2 windows through the fused engine at a 20% per-attempt
    wave-fault rate, seed 17, on a device-resident server.  On the card
    the ladder is the kernel alone, so a fault is retried, never
    degraded: every window comes back ok and equal to the ``ref`` engine,
    or as a counted error row."""
    from repro_torch.serving import (FaultInjector, ResiliencePolicy,
                                     ServingConfig, StreamServer)
    m = session.model
    xs = stream_windows(64, 2, 50, m.seq_len, m.input_size)
    oracle = ref_rows(session, xs)
    inj = FaultInjector(seed=17, wave_fault_rate=0.2)
    # deadline_s=None: waves form full or at drain, so the wave
    # composition, and with it the seeded schedule, is the same every run.
    cfg = ServingConfig(batch=batch, backend="pallas", deadline_s=None,
                        resilience=ResiliencePolicy(max_retries=3,
                                                    backoff_base_s=0.0))
    reset_counts(mods)
    with StreamServer(session, cfg, fault_injector=inj) as srv:
        check(srv.state_residency == "device", "drill residency not device")
        check(srv.health()["ladder"] == ["pallas"],
              f"a plain engine stands below the kernel: {srv.health()['ladder']}")
        rows = serve_all(srv, xs, range(2))
        summary = srv.metrics_summary()
    torch.cuda.synchronize()
    launches = read_counts(mods)
    stats, f = inj.stats(), summary["faults"]
    check(len(rows) == 128, f"drill answered {len(rows)} of 128 windows")
    check(f["injected"] == stats, f"injected {f['injected']} != {stats}")
    errors = 0
    for i in range(64):
        sid = f"s{i}"
        got = [rows[(sid, q)] for q in range(2)]
        flagged = [q for q, r in enumerate(got) if not r.ok or r.state_reset]
        first = flagged[0] if flagged else 2
        for q in range(first):
            check(got[q].backend == "pallas" and
                  np.array_equal(got[q].y, oracle[(sid, q)]),
                  f"drill stream {sid} window {q} differs from the ref engine")
        for r in got:
            if not r.ok:
                errors += 1
                check(r.y is None and r.error.startswith("compute_failed"),
                      f"an error row carries a prediction: {r}")
    check(f["stream_errors"] == errors == 0,
          f"{errors} windows failed every attempt ({f['stream_errors']} counted)")
    if stats["wave_faults"]:
        check(f["retries"] >= 1, "faults were injected but nothing retried")
    check(f["degradations"] == 0, "the drill degraded off the kernel")
    passed = stats["attempts"] - stats["wave_faults"]
    check(launches == {**{k: 0 for k in launches}, "slot": passed},
          f"launches {launches} for {passed} attempts past the injector")
    return launches, stats, summary


def phase8_state_faults(session, mods):
    """State loss and corruption against one device store: 64 streams x 4
    windows at batch 64 (one wave a window, streams in order), so the
    seeded schedule replays on the host draw for draw.  A lost carry's
    next window is flagged ``state_reset``; corrupted streams are
    recorded; every stream in neither set stays bit for bit, the others
    up to the window their fault landed after."""
    from repro_torch.serving import (FaultInjector, ResiliencePolicy,
                                     ServingConfig, StreamServer)
    m = session.model
    n, k = 64, 4
    rates = dict(state_loss_rate=0.15, state_corrupt_rate=0.15)
    xs = stream_windows(n, k, 300, m.seq_len, m.input_size)
    oracle = ref_rows(session, xs)
    inj = FaultInjector(seed=3, **rates)
    cfg = ServingConfig(batch=n, backend="pallas", deadline_s=None,
                        resilience=ResiliencePolicy(max_retries=3,
                                                    backoff_base_s=0.0))
    reset_counts(mods)
    with StreamServer(session, cfg, fault_injector=inj) as srv:
        check(srv.state_residency == "device", "state drill not on the device")
        rows = serve_all(srv, xs, range(k))
        summary = srv.metrics_summary()
    torch.cuda.synchronize()
    launches = read_counts(mods)
    replay = FaultInjector(seed=3, **rates)
    expect_reset, first_fault = set(), {}
    for w in range(k):
        for i in range(n):
            fault = replay.draw_put_fault(f"s{i}")
            if fault != "none":
                first_fault.setdefault(f"s{i}", w)
            if fault == "lose" and w + 1 < k:
                expect_reset.add((f"s{i}", w + 1))
    puts = lambda st: (st["state_losses"], st["state_corruptions"])
    check(puts(replay.stats()) == puts(inj.stats()),
          f"schedule {inj.stats()} != replay {replay.stats()}")
    check(replay.lost_streams == inj.lost_streams
          and replay.corrupted_streams == inj.corrupted_streams,
          "lost/corrupted streams differ from the replayed schedule")
    check(inj.lost_streams and inj.corrupted_streams, "the drill hit nothing")
    for (sid, q), r in rows.items():
        check(r.ok, f"{sid} window {q} failed")
        check(r.state_reset == ((sid, q) in expect_reset),
              f"{sid} window {q}: state_reset {r.state_reset}")
        if q <= first_fault.get(sid, k):
            check(np.array_equal(r.y, oracle[(sid, q)]),
                  f"{sid} window {q} differs from the ref engine")
    t = summary["state_transfer"]
    check(t["to_device_bytes"] == 0 and t["from_device_bytes"] == 0,
          f"carries crossed to the host: {t}")
    check(launches == {**{kk: 0 for kk in launches}, "slot": summary["waves"]},
          f"launches {launches} for {summary['waves']} waves")
    return launches, inj


def phase8_cells(repro_torch, model, accel, mods):
    """GRU and rGLRU at the paper's width: no fused kernel (the reference
    has none), so the ``xla`` engine's torch ops run on the card; bit for
    bit with the same session's ``ref`` engine, with the port's CPU run
    from the same seed, and with their concatenated runs through a
    ``StreamServer`` at both residencies."""
    import dataclasses
    from repro_torch.serving import StreamServer
    out = {}
    for cell in ("gru", "rglru"):
        m = dataclasses.replace(model, cell=cell)
        s = repro_torch.build(m, accel, seed=0).quantize()
        cpu = repro_torch.build(m, accel, seed=0, device="cpu").quantize()
        check(s.plan["backend"] == "xla", f"{cell} plan {s.plan['backend']}")
        check(s.degradation_ladder() == ("xla", "ref"),
              f"{cell} ladder {s.degradation_ladder()}")
        x = (np.random.default_rng(11).normal(0.0, 1.0, (256, m.seq_len,
                                                         m.input_size))
             * 0.7).astype(np.float32)
        reset_counts(mods)
        y = s.infer(x, path="int")
        torch.cuda.synchronize()
        launches = read_counts(mods)
        check(not any(launches.values()), f"{cell} launched {launches}")
        check(y.device.type == "cuda" and bool(torch.isfinite(y).all()),
              f"{cell} output not finite on the card")
        check(torch.equal(y, s.infer(x, path="int", backend="ref")),
              f"{cell}: xla differs from ref on the card")
        check(np.array_equal(y.cpu().numpy(), cpu.infer(x, path="int").numpy()),
              f"{cell}: the card differs from the CPU")
        xs = stream_windows(32, 3, 700, m.seq_len, m.input_size)
        want = s.infer(xs.reshape(32, -1, m.input_size), path="int",
                       backend="ref").cpu().numpy()
        for residency in ("host", "device"):
            with StreamServer(s, batch=16, deadline_s=0.005,
                              state_residency=residency) as srv:
                check(srv.state_residency == residency, f"{cell} {residency}")
                rows = serve_all(srv, xs, range(3))
            for i in range(32):
                r = rows[(f"s{i}", 2)]
                check(r.ok and not r.state_reset and r.backend == "xla"
                      and np.array_equal(r.y, want[i]),
                      f"{cell} {residency}: stream s{i} differs from its "
                      f"concatenated run")
        out[cell] = float(np.abs(y.cpu().numpy()).sum())
        check(out[cell] > 0, f"{cell}: all outputs are zero")
    return out


def phase8_cluster(repro_torch, session, mods, card):
    """``build_cluster(session, 4)`` on the one card: 128 streams x 6
    windows, every row equal to the ``ref`` engine on its stream's
    concatenated sequence and served by the replica the hash ring names;
    K1 on each replica's ``infer``; then a planned drain of r3 (a warm
    handoff of its streams' carries, bit for bit) and an abandoned r2
    (its streams restart flagged ``state_reset``)."""
    from repro_torch.serving import HashRing
    m = session.model
    n, k = 128, 6
    xs = stream_windows(n, k + 2, 900, m.seq_len, m.input_size)
    oracle = ref_rows(session, xs)
    ring = HashRing([f"r{i}" for i in range(4)])
    reps = session.replicate(4)
    x = xs[:, 0]
    want = session.infer(x, path="int")
    reset_counts(mods)
    for rep in reps:
        check(rep.device == torch.device("cuda", 0), f"replica on {rep.device}")
        check(torch.equal(rep.infer(x, path="int"), want),
              "a replica differs from its session")
    torch.cuda.synchronize()
    infer_launches = read_counts(mods)
    check(infer_launches == {**{kk: 0 for kk in infer_launches}, "multilayer": 4},
          f"replica infers launched {infer_launches}")
    cluster = repro_torch.build_cluster(session, 4, batch=16, deadline_s=0.005)
    try:
        check(all(srv.state_residency == "device"
                  and srv.health()["ladder"] == ["pallas"]
                  for srv in cluster._servers.values()),
              "a replica is not device-resident on the kernel alone")
        reset_counts(mods)
        t0 = time.perf_counter()
        rows = serve_all(cluster, xs, range(k))
        wall_s = time.perf_counter() - t0
        summary = cluster.metrics_summary()
        torch.cuda.synchronize()
        serve_launches = read_counts(mods)
        check(len(rows) == n * k, f"cluster answered {len(rows)} of {n * k}")
        for (sid, q), r in rows.items():
            check(r.ok and not r.state_reset and r.backend == "pallas",
                  f"cluster row {sid}/{q} failed, reset or left the kernel")
            check(r.routed_replica == ring.route(sid),
                  f"{sid} served by {r.routed_replica}, ring says "
                  f"{ring.route(sid)}")
            check(np.array_equal(r.y, oracle[(sid, q)]),
                  f"cluster row {sid}/{q} differs from the ref engine")
        check(serve_launches == {**{kk: 0 for kk in serve_launches},
                                 "slot": summary["waves"]},
              f"launches {serve_launches} for {summary['waves']} waves")
        per = {name: p["waves"] for name, p in summary["replicas"].items()}
        log(f"phase 8d: build_cluster(session, 4) on cuda:0: {n} streams x {k} "
            f"windows, batch 16, equal to the ref engine, each on its ring "
            f"replica; waves (one K3 launch each) by replica {per}, K3 "
            f"launches {serve_launches['slot']}; {summary['samples_per_s']:.3f} "
            f"samples/s merged ({n * k / wall_s:.3f} by submit-to-drain wall), "
            f"p50 {summary['latency_ms']['p50']:.6f} ms p99 "
            f"{summary['latency_ms']['p99']:.6f} ms per wave; replica infers "
            f"{infer_launches} on {card}")
        # A planned drain: r3's carries are read back and seeded at their
        # new ring homes, so their next window continues bit for bit.
        sids = [f"s{i}" for i in range(n)]
        homes = {sid: ring.route(sid) for sid in sids}
        moved = cluster.remove_replica("r3")
        check(sorted(moved) == sorted(s for s in sids if homes[s] == "r3"),
              "remove_replica('r3') moved other streams than r3's")
        ring.remove("r3")
        rows = serve_all(cluster, xs, [k])
        for sid in sids:
            r = rows[(sid, 0 if sid in moved else k)]
            check(r.ok and not r.state_reset
                  and r.routed_replica == ring.route(sid)
                  and np.array_equal(r.y, oracle[(sid, k)]),
                  f"{sid} after r3's drain: not a bit-exact continuation")
        # A dead replica: nothing to read back; its streams restart cold.
        on_r2 = sorted(s for s in sids if ring.route(s) == "r2")
        lost = cluster.remove_replica("r2", abandon=True)
        check(sorted(lost) == on_r2, "remove_replica('r2') moved other streams")
        ring.remove("r2")
        fresh = session.infer(xs[:, k + 1], path="int",
                              backend="ref").cpu().numpy()
        rows = serve_all(cluster, xs, [k + 1])
        for i, sid in enumerate(sids):
            rs = [r for (s2, _), r in rows.items() if s2 == sid]
            check(len(rs) == 1 and rs[0].ok, f"{sid}: {rs}")
            r = rs[0]
            if sid in lost:
                check(r.seq == 0 and r.state_reset
                      and np.array_equal(r.y, fresh[i]),
                      f"{sid} after r2 died: not a flagged fresh start")
            else:
                check(not r.state_reset
                      and np.array_equal(r.y, oracle[(sid, k + 1)]),
                      f"{sid} after r2 died: its carry did not survive")
        log(f"phase 8d: remove_replica('r3') moved {len(moved)} streams (r3's), "
            f"each continuing bit for bit from its handed-off carry; "
            f"remove_replica('r2', abandon=True) moved {len(lost)}, each "
            f"restarting flagged state_reset; replicas left "
            f"{cluster.replicas}")
    finally:
        check(cluster.close(timeout=60) == [], "cluster threads leaked")
    torch.cuda.synchronize()
    return {kk: infer_launches[kk] + serve_launches[kk] for kk in infer_launches}


def phase8(repro_torch, session, model, accel, mods, card):
    """Phase 8: the serving tier — the seeded fault drill at batch 4 and 64,
    state faults on the device store, the GRU and rGLRU cells, and the
    four-replica cluster.  Returns the launches of its main-path runs."""
    totals = {}

    def add(launches):
        for kk, v in launches.items():
            totals[kk] = totals.get(kk, 0) + v

    for batch in (4, 64):
        t0 = time.perf_counter()
        launches, stats, summary = phase8_fault_drill(session, mods, batch)
        add(launches)
        log(f"phase 8a: fault drill, 64 streams x 2 windows, batch {batch}, "
            f"wave_fault_rate 0.2 seed 17: injected {stats}; {summary['waves']} "
            f"waves, retries {summary['faults']['retries']}, errors "
            f"{summary['faults']['stream_errors']}; all 128 windows equal the "
            f"ref engine; K3 launches {launches['slot']} = attempts past the "
            f"injector; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, inj = phase8_state_faults(session, mods)
    add(launches)
    log(f"phase 8b: device store, state_loss_rate 0.15 + state_corrupt_rate "
        f"0.15 seed 3, 64 streams x 4 windows: injected {inj.stats()}; lost "
        f"{len(inj.lost_streams)}, corrupted {len(inj.corrupted_streams)} "
        f"streams; every lost carry's next window flagged state_reset, the "
        f"rest bit for bit; K3 launches {launches['slot']}; "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    sums = phase8_cells(repro_torch, model, accel, mods)
    log(f"phase 8c: gru and rglru at H={model.hidden_size} L={model.num_layers} "
        f"T={model.seq_len} {model.fxp}: infer on 256 windows on the card equals "
        f"its ref engine and the CPU run bit for bit (sum |y| {sums}); "
        f"StreamServer carries equal the concatenated runs at host and device "
        f"residency; no kernel launched; {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    add(phase8_cluster(repro_torch, session, mods, card))
    log(f"phase 8d: done in {time.perf_counter() - t0:.1f} s")
    return totals


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.qlstm import QLSTMConfig, lstm_ops
    from repro_torch.kernels import _build, ops
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import hard_act as ha
    from repro_torch.kernels import qlstm_cell as qc
    from repro_torch.kernels import quant_matmul as qm
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.launch import serve
    from repro_torch.models import layers as lm_layers
    from repro_torch.models import rglru as lm_rglru
    from repro_torch.models import transformer as lm
    from repro_torch.models.modules import count_params
    from repro_torch.serving import StreamServer
    mods = (qc, qm, ha, fa, rg)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # -- phase 1: card, versions, build ------------------------------------
    t0 = time.perf_counter()
    names = ("qlstm_cell", "quant_matmul", "hard_act", "flash_attention",
             "rglru_scan")
    with ThreadPoolExecutor(len(names)) as pool:     # one nvcc per source
        for fut in [pool.submit(_build.load_library, nm) for nm in names]:
            fut.result()
    for mod in mods:
        mod.load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 1: card: {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
        f"kernel build+load {build_s:.3f} s ({len(names)} sources)")
    for nm in names:
        ptxas = _build.library_path(nm).with_suffix(".log")
        if ptxas.exists():
            for line in ptxas.read_text().splitlines():
                if "registers" in line or "Compiling entry" in line:
                    log(f"  ptxas {nm}:", line.strip())

    # -- phase 2: kernels vs plain versions --------------------------------
    t0 = time.perf_counter()
    errs, n_cases = phase2_kernels_vs_plain(qc, fxp, dev)
    log(f"phase 2: {n_cases} cases, max |kernel - plain| = {errs} "
        f"(tolerance 0) in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs2, bf16_err, n2 = phase2_ops_kernels(qm, ha, fa, ops, fxp, dev)
    errs.update(errs2)
    log(f"phase 2: {n2} cases, max |kernel - plain| = {errs2} (tolerance 0; "
        f"flash_attention 2e-5 abs/rel), bf16 attention {bf16_err} (1e-2) "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    step_err, n_step, step_routes = phase2_step_routes(ha, fxp, dev)
    errs["hard_sigmoid_star"] = max(errs["hard_sigmoid_star"], step_err)
    log(f"phase 2: {n_step} HardSigmoid* step cases, cases by route {step_routes}, "
        f"max |kernel - plain| = {step_err} (tolerance 0) in "
        f"{time.perf_counter() - t0:.1f} s")
    # RecurrentGemma-2B at its published widths: K7's full-width case takes
    # the inputs of the model's layer 0; phase 6 drives the model.
    t0 = time.perf_counter()
    lm_cfg = ARCH_CONFIGS["recurrentgemma-2b"]
    lm_params, _ = lm.init_model(lm_cfg, torch.Generator(device=dev).manual_seed(0))
    n_params = count_params(lm_params)
    lm_tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, lm_cfg.vocab_size, (LM_BATCH, LM_PREFILL)), device=dev)
    with torch.inference_mode():
        k7_in = layer0_scan_inputs(lm, lm_layers, lm_rglru, lm_params, lm_cfg,
                                   lm_tokens)
    log(f"phase 2: RecurrentGemma-2B: {n_params} f32 parameters drawn in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    errs["rglru_seq"], k7_bf16_err, n7, k7_routes = phase2_rglru(rg, k7_in, dev)
    log(f"phase 2: {n7} K7 cases incl. the full-width {tuple(k7_in[0].shape)} "
        f"layer-0 inputs, max |kernel - plain| = {errs['rglru_seq']} (1e-6 + "
        f"1e-5 relative), bf16 {k7_bf16_err} (one bf16 ulp); launches by route "
        f"{k7_routes}; the full-width case on the tile route, equal to the lane "
        f"route bit for bit, in {time.perf_counter() - t0:.1f} s")

    # -- phase 3: the session at full width --------------------------------
    model = QLSTMConfig()
    session = repro_torch.build(model, AcceleratorConfig(), seed=0).quantize()
    check(session.plan["backend"] == "pallas", f"plan {session.plan['backend']}")
    check(session.plan["state_residency"] == "device", "residency not device")
    rng = np.random.default_rng(1)
    x = (rng.normal(0.0, 1.0, (256, model.seq_len, model.input_size)) * 0.7
         ).astype(np.float32)
    reset_counts(mods)
    y = session.infer(x, path="int")
    torch.cuda.synchronize()
    infer_launches = read_counts(mods)
    check(infer_launches == {**{k: 0 for k in infer_launches}, "multilayer": 1},
          f"infer launched {infer_launches}")
    y_ref = session.infer(x, path="int", backend="ref")
    check(tuple(y.shape) == (256, model.out_features), f"shape {tuple(y.shape)}")
    check(bool(torch.isfinite(y).all()), "non-finite outputs")
    check(torch.equal(y, y_ref), "fused infer differs from the ref engine")
    check(float(y.abs().sum()) > 0, "all outputs are zero")
    log(f"phase 3: infer on {x.shape} -> {tuple(y.shape)} equals ref; "
        f"launches {infer_launches}")

    # -- phase 4: the stateful StreamServer --------------------------------
    n_streams, n_windows = 128, 6
    xs = (rng.normal(0.0, 1.0, (n_streams, n_windows, model.seq_len,
                                model.input_size)) * 0.7).astype(np.float32)
    reset_counts(mods)
    with StreamServer(session, batch=64, deadline_s=0.005,
                      max_streams=1024) as server:
        check(server.state_residency == "device", "server residency not device")
        check(server.health()["ladder"] == ["pallas"],
              f"a plain engine stands below the kernel: {server.health()['ladder']}")
        for w in range(n_windows):
            for i in range(n_streams):
                server.submit(f"s{i}", xs[i, w])
        rows = server.drain(timeout=600)
        summary = server.metrics_summary()
    torch.cuda.synchronize()
    serve_launches = read_counts(mods)
    check(len(rows) == n_streams * n_windows, f"{len(rows)} results")
    check(all(r.ok and r.backend == "pallas" and not r.state_reset for r in rows),
          "a result failed, reset or ran off the fused engine")
    check(summary["faults"]["degradations"] == 0, "the server degraded")
    check(serve_launches == {**{k: 0 for k in serve_launches},
                             "slot": summary["waves"]},
          f"launches {serve_launches} for {summary['waves']} waves")
    got = {(r.stream_id, r.seq): r.y for r in rows}
    ref_fn = session.compiled_stateful("ref")
    state = session.init_state(n_streams)
    for w in range(n_windows):
        y_w, state = ref_fn(xs[:, w], state)
        y_w = y_w.cpu().numpy()
        for i in range(n_streams):
            check(np.array_equal(got[(f"s{i}", w)], y_w[i]),
                  f"stream s{i} window {w} differs from the stateful ref run")
    concat = session.infer(xs.reshape(n_streams, -1, model.input_size),
                           path="int", backend="ref").cpu().numpy()
    for i in range(n_streams):
        check(np.array_equal(got[(f"s{i}", n_windows - 1)], concat[i]),
              f"stream s{i} differs from its concatenated run")
    log(f"phase 4: {len(rows)} results over {summary['waves']} waves equal the "
        f"ref runs; launches {serve_launches}; p50 "
        f"{summary['latency_ms']['p50']:.3f} ms p99 "
        f"{summary['latency_ms']['p99']:.3f} ms {summary['samples_per_s']:.1f} "
        f"samples/s (first run, cold)")

    # -- phase 4b: the kernels.ops path --------------------------------------
    t0 = time.perf_counter()
    ins, ops_launches, ops_errs = phase_ops(ops, qm, ha, fa, qc, fxp, QLSTMConfig,
                                            dev, mods)
    log(f"phase 4b: ops path (quant_matmul {PREFILL}x{D_MODEL}x{D_FF} int8, "
        f"requant (4,8) -> HardSigmoid* x3 + HardTanh on {PREFILL}x{D_FF} "
        f"({ins['unsaturated']:.4f} of the codes unsaturated), causal mha_flash "
        f"(1, {PREFILL}, {HEADS}, {HEAD_DIM}) f32, qlstm_seq T=6 B=256 H=20) "
        f"equals the plain versions, max |err| {ops_errs}; launches "
        f"{ops_launches} in {time.perf_counter() - t0:.1f} s")

    # -- phase 6: RecurrentGemma-2B prefill, serve, prefill vs decode --------
    t0 = time.perf_counter()
    with torch.inference_mode():
        lm_launches = phase_lm(lm, serve, mods, lm_params, lm_cfg, lm_tokens, dev)
    log(f"phase 6: done in {time.perf_counter() - t0:.1f} s")

    # -- phase 7: QAT training on the card -----------------------------------
    t0 = time.perf_counter()
    train_launches = phase7_train(repro_torch, model, AcceleratorConfig(), mods,
                                     dev, card)
    log(f"phase 7: done in {time.perf_counter() - t0:.1f} s")

    # -- phase 8: the serving tier: faults, cells, cluster -------------------
    t0 = time.perf_counter()
    serving_launches = phase8(repro_torch, session, model, AcceleratorConfig(),
                              mods, card)
    log(f"phase 8: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{serving_launches}")

    # -- phase 5: timings ----------------------------------------------------
    sass = {op: sass_count(_build, name, op)
            for name, op in (("quant_matmul", "IMMA"), ("flash_attention", "HMMA"))}
    log(f"phase 5: tensor-core instructions in the built SASS (cuobjdump -sass; "
        f"IMMA in quant_matmul, HMMA in flash_attention): {sass}")
    check(all(sass.values()), f"a tensor-core kernel has no MMA instruction: {sass}")
    acts, sd = session.model.acts, session.model.fxp.storage_dtype
    kw = dict(cfg=session.model.fxp, hs_method=session.accel.hs_method,
              hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
              ht_min=acts.ht_min, ht_max=acts.ht_max)
    layers = session.qparams["layers"]
    wxs = [p["w_x"].to(sd) for p in layers]
    whs = [p["w_h"].to(sd) for p in layers]
    bs = [p["b"] for p in layers]
    L, H, M, T = model.num_layers, model.hidden_size, model.input_size, model.seq_len

    def x_codes(arr):
        return fxp.quantize(torch.as_tensor(arr, device=dev), session.model.fxp
                            ).to(sd).transpose(0, 1).contiguous()

    x3 = x_codes(x)                                       # (6, 256, 1)
    zeros = [torch.zeros(256, H, dtype=torch.int32, device=dev) for _ in range(L)]
    table = session.init_state_table(1024)
    g = torch.as_tensor(rng.permutation(1024)[:64], dtype=torch.int32, device=dev)
    s = torch.as_tensor(rng.permutation(1024)[:64], dtype=torch.int32, device=dev)
    x4 = x_codes(xs[:64, 0])                              # (6, 64, 1)
    w_bytes = sum(w.numel() * w.element_size() for w in wxs + whs) + \
        sum(b.numel() * 4 for b in bs)

    state_bytes = lambda b: 2 * L * b * H * 4
    k1_bytes = x3.numel() + w_bytes + 2 * state_bytes(256) + T * 256 * H
    k3_bytes = (x4.numel() + w_bytes + 2 * 64 * 4 + 2 * table.numel() * 4
                + T * 64 * H)
    launches = {k: infer_launches[k] + serve_launches[k] + ops_launches[k]
                + lm_launches[k] + train_launches[k] + serving_launches.get(k, 0)
                for k in infer_launches}
    lstm_src = "src/repro_torch/csrc/qlstm_cell.cu"
    specs = [
        dict(name="qlstm_seq_multilayer", replaces="src/repro/kernels/qlstm_cell.py:348",
             source=lstm_src, symbol=("qlstm_rows_kernel",), counter="multilayer",
             err=errs["multilayer"],
             kern=lambda: qc.qlstm_seq_multilayer(x3, wxs, whs, bs, zeros, zeros, **kw),
             plain=lambda: qc.qlstm_seq_multilayer_plain(x3, wxs, whs, bs, zeros,
                                                         zeros, **kw),
             bound=bound(k1_bytes, lstm_ops(model) * 256, INT8_OPS_PER_S)),
        # K2 is K1's kernel at one layer behind the ``qlstm_seq`` entry, which
        # only ``ops.qlstm_seq`` calls (phase 4b).
        dict(name="qlstm_seq", replaces="src/repro/kernels/qlstm_cell.py:305",
             source=lstm_src, symbol=("qlstm_rows_kernel",), counter="seq",
             err=max(errs["seq"], ops_errs["qlstm_seq"]),
             kern=lambda: qc.qlstm_seq(x3, wxs[0], whs[0], bs[0], h0=zeros[0],
                                       c0=zeros[0], return_state=True, **kw),
             plain=lambda: qc.qlstm_seq_plain(x3, wxs[0], whs[0], bs[0], h0=zeros[0],
                                              c0=zeros[0], return_state=True, **kw),
             bound=bound(k1_bytes, lstm_ops(model) * 256, INT8_OPS_PER_S)),
        dict(name="qlstm_seq_slot", replaces="src/repro/kernels/qlstm_cell.py:401",
             source=lstm_src, symbol=("qlstm_rows_kernel",), counter="slot",
             err=errs["slot"],
             kern=lambda: qc.qlstm_seq_slot(x4, g, s, table, wxs, whs, bs, **kw),
             plain=lambda: qc.qlstm_seq_slot_plain(x4, g, s, table, wxs, whs, bs, **kw),
             bound=bound(k3_bytes, lstm_ops(model) * 64, INT8_OPS_PER_S)),
    ]

    # The ops path's shapes (phase 4b).
    cfg48 = fxp.FXP_4_8
    xq, wq, pre = ins["x"], ins["w"], ins["pre"]
    mm_ops = 2 * PREFILL * D_MODEL * D_FF
    mm_in = xq.numel() + wq.numel()
    qmm_src = "src/repro_torch/csrc/quant_matmul.cu"
    hact_src = "src/repro_torch/csrc/hard_act.cu"
    spec48 = ha.hard_act.HardSigmoidStarSpec(cfg48)
    thr, outs = ha.hard_act.step_table_tensors(spec48, dev)
    ht_lo, ht_hi = ha.hard_act.hard_tanh_bounds(cfg48)
    ew_bytes = 2 * pre.numel()                       # codes in, codes out
    # Attention on the kernel's (BH, T, hd) layout; the library call takes
    # the same data as (B, H, T, hd).
    q2, k2, v2 = (ins[n].transpose(1, 2).reshape(HEADS, PREFILL, HEAD_DIM)
                  .contiguous() for n in ("q", "k", "v"))
    q4, k4, v4 = (t.view(1, HEADS, PREFILL, HEAD_DIM) for t in (q2, k2, v2))
    kept_pairs = HEADS * PREFILL * (PREFILL + 1) // 2   # causal (q, k) pairs
    specs += [
        dict(name="quant_matmul_int32", replaces="src/repro/kernels/quant_matmul.py:66",
             source=qmm_src, symbol=("qmm_imma_kernel", "qmm_wt_kernel"),
             counter="int32",
             err=max(errs["quant_matmul_int32"], ops_errs["quant_matmul_int32"]),
             kern=lambda: qm.quant_matmul(xq, wq),
             plain=lambda: qm.quant_matmul_plain(xq, wq),
             library=lambda: torch._int_mm(xq, wq),
             bound=bound(mm_in + 4 * PREFILL * D_FF, mm_ops, INT8_OPS_PER_S)),
        dict(name="quant_matmul_requant", replaces="src/repro/kernels/quant_matmul.py:66",
             source=qmm_src, symbol=("qmm_imma_kernel", "qmm_wt_kernel"),
             counter="requant",
             err=max(errs["quant_matmul_requant"], ops_errs["quant_matmul_requant"]),
             kern=lambda: qm.quant_matmul(xq, wq, out_mode="requant", cfg=cfg48),
             plain=lambda: qm.quant_matmul_plain(xq, wq, out_mode="requant", cfg=cfg48),
             bound=bound(mm_in + PREFILL * D_FF, mm_ops, INT8_OPS_PER_S)),
        # Timed at the paper's method (step); the other two are logged.
        dict(name="hard_sigmoid_star", replaces="src/repro/kernels/hard_act.py:74",
             source=hact_src, symbol=("hact_step",), counter="hard_sigmoid_star",
             err=max(errs["hard_sigmoid_star"], ops_errs["hard_sigmoid_star"]),
             kern=lambda: ha.hard_sigmoid_star(pre, cfg=cfg48, method="step"),
             # earlier reading: the first design, kept as the bisect route
             earlier=(lambda: ha._hs_launch(pre, spec48, "step", bisect=True),
                      "hard_act_kernel"),
             plain=lambda: ha.hard_sigmoid_star_plain(pre, cfg=cfg48, method="step"),
             # at least one operation per code, on the CUDA cores
             bound=bound(ew_bytes + 4 * (thr.numel() + outs.numel()), pre.numel(),
                         FP32_OPS_PER_S)),
        dict(name="hard_tanh", replaces="src/repro/kernels/hard_act.py:105",
             source=hact_src, symbol=("hard_act_kernel",), counter="hard_tanh",
             err=max(errs["hard_tanh"], ops_errs["hard_tanh"]),
             kern=lambda: ha.hard_tanh(pre, cfg=cfg48),
             plain=lambda: ha.hard_tanh_plain(pre, cfg=cfg48),
             library=lambda: torch.clamp(pre, ht_lo, ht_hi),
             bound=bound(ew_bytes, pre.numel(), FP32_OPS_PER_S)),
        dict(name="flash_attention", replaces="src/repro/kernels/flash_attention.py:88",
             source="src/repro_torch/csrc/flash_attention.cu", symbol=("flash_tc_kernel",),
             counter="flash_attention",
             err=max(errs["flash_attention"], ops_errs["flash_attention"]),
             kern=lambda: fa.flash_attention(q2, k2, v2, causal=True),
             plain=lambda: fa.flash_attention_plain(q2, k2, v2, causal=True),
             library=lambda: F.scaled_dot_product_attention(q4, k4, v4, is_causal=True),
             # 3xTF32: three products for each of QK^T and PV
             bound=bound(4 * q2.numel() * 4, 3 * 4 * HEAD_DIM * kept_pairs,
                         TF32_OPS_PER_S)),
        # K7 at the prefill's shape on layer 0's inputs: (T, B, W) views.  No
        # single PyTorch call computes it: the cumprod/cumsum form underflows
        # over 4096 steps.  Its plain version is 4096 small steps: 3 calls.
        dict(name="rglru_seq", replaces="src/repro/kernels/rglru_scan.py:48",
             source="src/repro_torch/csrc/rglru_scan.cu", symbol=("rglru_tile_kernel",),
             counter="rglru_seq", err=errs["rglru_seq"], plain_iters=3,
             kern=lambda: rg.rglru_seq(*k7_in),
             # earlier reading: the first design, kept as the lane route
             earlier=(lambda: rg._launch(*k7_in, route="lane"), "rglru_lane_kernel"),
             plain=lambda: rg.rglru_seq_plain(*k7_in),
             # one exp, one multiply, one add per element, on the CUDA cores
             bound=bound(3 * 4 * k7_in[1].numel(), 3 * k7_in[1].numel(),
                         FP32_OPS_PER_S)),
    ]
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")
    kernels = []
    for sp in specs:
        # ms: device time of the wrapper's work (graph replay); call_ms:
        # one eager call as Python issues it; kernel_ms: the CUDA kernel
        # alone, from the profiler.
        kern, (b_ms, b_by) = sp["kern"], sp["bound"]
        ms, call_ms = graph_ms(kern, 500), cuda_ms(kern, 500)
        plain_ms = cuda_ms(sp["plain"], sp.get("plain_iters", 20))
        avgs, _ = profile(kern, 50)
        part_us = {sym: sum(device_us(e) for e in avgs
                            if is_cuda(e) and sym in e.key) / 50
                   for sym in sp["symbol"]}
        k_us = sum(part_us.values())
        if len(part_us) > 1:
            log(f"phase 5: {sp['name']}: kernel alone by kernel (ms): "
                f"{ {sym: us / 1e3 for sym, us in part_us.items()} }")
        lib_ms = None
        if "library" in sp:
            lib_ms = cuda_ms(sp["library"], 200)
            lib_avgs, _ = profile(sp["library"], 5)
            log(f"phase 5: {sp['name']}: the library call ran "
                f"{sorted({e.key for e in lib_avgs if is_cuda(e)})}")
        kernels.append({
            "name": sp["name"], "route": "cuda", "source": sp["source"],
            "replaces": sp["replaces"], "launches": launches[sp["counter"]],
            "max_abs_err": sp["err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "counter": sp["counter"], "call_ms": call_ms,
            "kernel_ms": k_us / 1e3 if k_us else None})
        log(f"phase 5: {sp['name']}: {ms:.6f} ms device (eager call {call_ms:.6f} ms, "
            f"kernel alone {k_us / 1e3:.6f} ms, plain {plain_ms:.6f} ms, library "
            f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}, bound "
            f"{b_ms:.6f} ms by {b_by}) on {card}")
        if "earlier" in sp:
            fn, sym = sp["earlier"]
            e_avgs, _ = profile(fn, 50)
            e_ms = sum(device_us(e) for e in e_avgs if is_cuda(e) and sym in e.key) / 50e3
            kernels[-1].update(earlier_kernel_ms=e_ms, earlier_ms=graph_ms(fn, 500))
            log(f"phase 5: {sp['name']}: earlier design ({sym}) on the same inputs: "
                f"kernel alone {e_ms:.6f} ms, {kernels[-1]['earlier_ms']:.6f} ms "
                f"device; now {k_us / 1e3 / e_ms:.4f} of it on {card}")
    # K3's latency floor: one round trip (its launch at T = 0: the prologue's
    # loads and the scatter, nothing else) plus T x L steps at its marginal
    # step time (T = 6 against T = 48); then the probes of the round-trip
    # diagnosis, T = 1 and the weights read from device memory.
    def k3_alone(xc, weights_in_smem=True):
        fn = lambda: qc._launch(xc, wxs, whs, bs, gather=g, scatter=s, table=table,
                                batch_block=None, weights_in_smem=weights_in_smem,
                                **kw)
        avgs, _ = profile(fn, 50)
        return sum(device_us(e) for e in avgs
                   if is_cuda(e) and "qlstm_rows_kernel" in e.key) / 50e3
    k3 = next(k for k in kernels if k["name"] == "qlstm_seq_slot")
    t0_ms, t6_ms, t48_ms = (k3_alone(x4.repeat(n, 1, 1)[:t]) for n, t in
                            ((1, 0), (1, T), (8, 8 * T)))
    step_ms = (t48_ms - t6_ms) / (7 * T * L)
    k3["latency_floor_ms"] = t0_ms + T * L * step_ms
    log(f"phase 5: qlstm_seq_slot latency floor {k3['latency_floor_ms']:.6f} ms = "
        f"T=0 launch {t0_ms:.6f} ms + {T * L} steps x {step_ms:.6f} ms (T={8 * T}: "
        f"{t48_ms:.6f} ms); the kernel at T={T} is {t6_ms:.6f} ms alone here, "
        f"{k3['kernel_ms']:.6f} ms above; probes: T=1 {k3_alone(x4[:1]):.6f} ms, "
        f"weights in device memory {k3_alone(x4, weights_in_smem=False):.6f} ms "
        f"on {card}")
    k5 = next(k for k in kernels if k["name"] == "hard_sigmoid_star")
    k5["step_route"] = ha.step_route(spec48, pre.dtype).name
    for method in ("arithmetic", "1to1"):
        fn = lambda: ha.hard_sigmoid_star(pre, cfg=cfg48, method=method)
        m_ms = graph_ms(fn, 500)
        avgs, _ = profile(fn, 50)
        k_ms = sum(device_us(e) for e in avgs
                   if is_cuda(e) and "hard_act_kernel" in e.key) / 50e3
        k5[f"{method}_kernel_ms"] = k_ms
        log(f"phase 5: hard_sigmoid_star ({method}): kernel alone {k_ms:.6f} ms, "
            f"{m_ms:.6f} ms device (bound {k5['bound_ms']:.6f} ms) on {card}")
    log(f"phase 5: hard_sigmoid_star (step) took the {k5['step_route']} route")

    slot_fn = session.compiled_stateful_slots()
    xw = xs[:64, 0]
    avgs, wall_ms = profile(lambda: slot_fn(xw, table, g, s)[0].cpu(), 20)
    busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 20 / 1e3
    log(f"phase 5: one serving wave's datapath (quantize, slot kernel, dense "
        f"head, copy back; batch 64): {wall_ms / 20:.6f} ms wall, "
        f"{busy_ms:.6f} ms device busy, idle share "
        f"{1 - busy_ms / (wall_ms / 20):.4f} on {card}")
    log(avgs.table(sort_by="cpu_time_total", row_limit=14))

    with StreamServer(session, batch=64, deadline_s=0.005,
                      max_streams=1024) as server:
        for i in range(64):                       # warm-up wave
            server.submit(f"w{i}", xs[i, 0])
        server.drain(timeout=120)
        server.reset_streams()
        server.reset_metrics()
        for w in range(n_windows):
            for i in range(n_streams):
                server.submit(f"s{i}", xs[i, w])
        server.drain(timeout=600)
        warm = server.metrics_summary()
    log(f"phase 5: StreamServer warm: {warm['waves']} waves, per-wave latency "
        f"p50 {warm['latency_ms']['p50']:.6f} ms p99 "
        f"{warm['latency_ms']['p99']:.6f} ms, compute mean "
        f"{warm['compute_ms_mean']:.6f} ms, {warm['samples_per_s']:.3f} "
        f"samples/s on {card}")
    # The same traffic through build_cluster, warm: replicas x batch, to
    # tell the cost of more replicas on one card from that of smaller waves.
    for n_rep, batch in ((1, 16), (4, 16), (4, 64)):
        cluster = repro_torch.build_cluster(session, n_rep, batch=batch,
                                            deadline_s=0.005)
        try:
            cluster.warmup(xs[0, 0])
            t0 = time.perf_counter()
            for w in range(n_windows):
                for i in range(n_streams):
                    cluster.submit(f"s{i}", xs[i, w])
            cluster.drain(timeout=600)
            wall_s = time.perf_counter() - t0
            cw = cluster.metrics_summary()
        finally:
            check(cluster.close(timeout=60) == [], "cluster threads leaked")
        log(f"phase 5: cluster warm, {n_rep} replica(s) on the card, batch "
            f"{batch}: {cw['waves']} waves, {cw['samples_per_s']:.3f} samples/s "
            f"merged ({n_streams * n_windows / wall_s:.3f} by submit-to-drain "
            f"wall), per-wave p50 {cw['latency_ms']['p50']:.6f} ms p99 "
            f"{cw['latency_ms']['p99']:.6f} ms, compute mean "
            f"{cw['compute_ms_mean']:.6f} ms on {card}")

    with torch.inference_mode():
        prefill = lambda: lm.forward_prefill(lm_params, {"tokens": lm_tokens}, lm_cfg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2):
            prefill()
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3 / 2
        avgs, wall_ms = profile(prefill, 2)
        busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 2 / 1e3
        log(f"phase 5: RecurrentGemma-2B forward_prefill B={LM_BATCH} "
            f"T={LM_PREFILL}: {pre_ms:.6f} ms wall ({LM_BATCH * LM_PREFILL / pre_ms * 1e3:.3f}"
            f" tokens/s); under the profiler {wall_ms / 2:.6f} ms wall, "
            f"{busy_ms:.6f} ms device busy, idle share "
            f"{1 - busy_ms / (wall_ms / 2):.4f} on {card}")
        log(avgs.table(sort_by="self_device_time_total", row_limit=12))
        cache = lm.init_cache(lm_cfg, 4, 4096, device=dev)     # a 2048-slot ring
        tok = lm_tokens[:, :2].reshape(4, 1)
        for t in range(4):                                    # warm-up
            logits, cache = lm.forward_decode(lm_params, cache, {
                "tokens": tok, "cache_pos": t}, lm_cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in range(4, 4 + LM_DECODE):
            logits, cache = lm.forward_decode(lm_params, cache, {
                "tokens": tok, "cache_pos": t}, lm_cfg)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / LM_DECODE
        avgs, wall_ms = profile(lambda: lm.forward_decode(lm_params, cache, {
            "tokens": tok, "cache_pos": 4 + LM_DECODE}, lm_cfg), 3)
        busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 3 / 1e3
        log(f"phase 5: RecurrentGemma-2B decode, batch 4, 2048-slot ring: "
            f"{step_ms:.6f} ms per step, {4e3 / step_ms:.3f} tokens/s; one step "
            f"{wall_ms / 3:.6f} ms wall under the profiler, {busy_ms:.6f} ms "
            f"device busy, idle share {1 - busy_ms / (wall_ms / 3):.4f} on {card}")

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
