#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

(``python3 chip_smoke.py lfm2`` runs phase 14 alone.)

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
paper's model (``train_qat``) on the card, the serving tier (the
seeded fault injector, the GRU and rGLRU cells, the four-replica
cluster), the explorer with the energy model, and the LM side's dense,
MoE, RWKV-6, VLM and audio families with w8/w8a8 weights and an int8 KV
cache (qwen1.5-0.5B at its published width and depth), LM training
and, on the host mesh, the sharded LM's training, prefill and decode,
with the LM dry run held against the card and the port's quickstart, in
phases:

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
     for bit) and r2 abandoned (its streams flagged ``state_reset``);
  9. the explorer and the energy model at the paper's model: (a)
     ``explore.sweep(paper_space(batch=256))`` on the card (24 points:
     both formats, three HardSigmoid* methods, both compute units, both
     ALU modes), each row's wave time, samples/s and modelled GOP/s/W,
     every pipelined point's int path equal to its ``ref`` engine and
     every per_step point's to the CPU's on the sweep's windows, K1
     launched 21 times per fused point, and one fused point's wave under
     the profiler; (b) a serving halving sweep (host/device residency x
     batch 16/64) on phase 4's traffic, ``autotune`` on its payload, and
     the winner re-measured by ``measure_scenario`` within its SLO, K3 (or
     K1 for host residency) launched once per wave plus the warm-up; (c)
     the board's power (``nvidia-smi -lms 100``): idle, under K1 ``infer``
     at batch 256 beside the model's ``total_w`` and the measured GOP/s/W,
     and the sustained loops whose fits are ``core/energy.py``'s constants
     (K6 on 1 GiB, K1 at a batch of 2^20, K4 and a bf16 ``torch.matmul``
     on 8192^3 products; 9c's loops are measurements and stay out of the
     launch counts);
 10. the LM side's other families (``repro_torch.models``, random weights
     from a ``torch.Generator`` seeded 0, f32 master params): (a)
     qwen1.5-0.5B at its published width and depth (24 layers, d_model
     1024, 16 heads of 64, d_ff 2816, vocab 151,936), ``forward_prefill``
     at B=1, T=2048 in f32 and bf16 (finite, no kernel launched, wall time
     and idle share), a 32-token prompt decoded step by step against the
     prefill (f32 within 0.3, bf16 within its distance from f32), and
     ``serve.main --preset full`` unquantised, ``--quant w8``, ``--quant
     w8a8`` and ``--quant w8a8 --kv-int8`` (tokens/s; K4 launched only by
     the w8a8 modes); (b) K4 on the w8a8 path: one w8a8 + int8-KV decode
     step launches K4 once per quantised ``linear`` it runs, its int32
     accumulators equal the plain product's on the card (tolerance 0) and
     the logits are identical; the step's device time by kernel (K4's
     w^T rebuild beside its products), and K4 timed at the decode (M = 4)
     and prefill (M = 2048) shapes beside its bound and ``torch._int_mm``
     where that call takes the shape; (c) gemma2-2b, mixtral-8x7b,
     phi3.5-moe, rwkv6-7b, qwen2-vl-2b and musicgen-medium at their
     published widths, depth cut to 2 layers (gemma2: one local, one
     global), each: prefill against step-by-step decode of a 16-token
     prompt (dropless MoE capacity) in f32 and bf16, then a w8a8 + int8-KV
     decode, finite, through K4;
 11. LM training, after phase 5's timings once RecurrentGemma-2B's
     weights are freed: (a) qwen1.5-0.5B at its published width and depth
     through ``launch.train.main`` (B=8, S=512, bf16 over f32 master
     weights, remat "full"): a step's wall waited for, back to back
     and under the profiler, each beside the profiler's device-busy time
     (idle shares), then 20
     steps without and with ``remat="full"`` under deterministic
     algorithms (a falling loss, equal losses bit for bit, a lower peak),
     and 10 straight steps equal to 5 + a SIGTERM checkpoint + a resume,
     bit for bit; (b) RecurrentGemma-2B at published widths cut to one
     period (rec, rec, attn), trained at B=1, T=4096: K7 twice a rec
     block a step (forward and the remat recompute) and its backward once,
     the backward against the plain recurrence's autograd on layer 0's
     scan inputs (1e-5 relative), timed alone (over three operand sets
     in turn, so its bytes come from HBM) and as a whole Function
     backward; (c) one step of each other family at published widths
     (phase 10c's two layers, the MoE archs one), w8a8 fake-quant on
     qwen2-vl, hard activations on gemma2, int8 compression with two
     microbatches on rwkv6 at S=512 (four wkv chunks, after the chunked
     wkv is held against the sequential recurrence's autograd across
     four chunks): finite loss, gradient norm above 0; (d)
     ``launch.train --arch lstm-pems``: the int path's test MSE within the
     reference's bound, through K1; (e) the ``WaveBatcher`` on qwen1.5-0.5B
     at full width in f32, every slot equal to its batch-of-one run, then
     with w8a8 weights (K4 once per quantised linear), and
     ``for_accelerator`` on the paper's session (K1), rows equal to
     ``infer(path="int")``;
 12. the sharded LM on the host mesh (``launch.mesh.make_host_mesh``: one
     card, a one-rank NCCL group opened before phase 11 — whose
     ``launch.train`` runs on the mesh too — and destroyed before the
     result lines; params, optimizer state and batches are ``DTensor``s
     laid out by the logical-axis rules): (a) qwen1.5-0.5B at its
     published width and depth through ``launch.train.main`` on the 1 x 1
     mesh (B=8, S=512, remat full, deterministic algorithms), loss and
     gradient norm of two steps and the whole state equal to the
     unsharded ``make_train_step`` bit for bit (and within the reference's
     2e-3 / 5e-2), then a step's wall, device busy, idle share and peak
     memory without and with the mesh; (b)
     RecurrentGemma-2B's period at B=1, T=4096 on the mesh: K7's forward,
     remat recompute and backward through ``local_map`` on the local
     shards, counted, the loss and gradient norm equal to the unsharded
     step's; (c) qwen1.5-0.5B at full width cut to 2 layers: a state saved
     on the mesh restores through ``restore(..., shardings=)`` into a state
     drawn from another seed bit for bit, and one resumed step equals the
     step never interrupted;
 13. serving on the host mesh, the dry run and the examples (after phase
     12, on its 1 x 1 mesh): (a) qwen1.5-0.5B at its published width and
     depth, the bf16 prefill at B=1, T=2048, then 4 decode steps at batch 4
     against a 2048-deep cache (filled from a seeded generator), float and
     w8a8 with the int8 KV cache: logits and tokens equal the unsharded
     steps' bit for bit, K4 once per quantised linear of a w8a8 step (168),
     each through ``local_map``, and each step's wall with and without the
     mesh; (b) RecurrentGemma-2B's prefill at B=2, T=4096 on the mesh with
     K7 through ``local_map`` 18 times, then 16 decode steps, both equal to
     phase 6's unsharded results bit for bit; (c) the dry run
     (``launch/dryrun.py``, a child process on a one-rank fake world) of
     (a)'s float prefill and decode against the same steps on the card: its
     ``flops_global`` within 1% of ``FlopCounterMode`` on the card, its
     peak within 25% of ``max_memory_allocated`` over the step (the eager
     step donates nothing, so the record's undonated peak); (d) four
     production cells of ``python -m repro_torch.launch.dryrun`` on the
     card's host CPU, processes that run from phase 11's start on
     (qwen1.5-0.5b ``train_4k`` and recurrentgemma-2b ``long_500k`` on
     16x16, qwen1.5-0.5b ``long_500k`` skipped by the reference's rule,
     mixtral-8x7b ``decode_32k --quant-serve --multi-pod``), rendered by
     ``analysis.report``; (e) ``examples/torch/quickstart.py`` (K1).  The
     dry run's numbers are modelled with the H100 data sheet's rates, not
     measured;
 14. LFM2-8B-A1B at its published widths and depth (``configs/
     lfm2_8b_a1b.py``: 24 layers, 18 short-conv and 6 GQA blocks, 22 MoE
     layers of 32 experts top 4; bf16 weights drawn from seed 0 by the
     benchmark's ``perfbench/systems/lfm2_sessions.py``):
     the MoE's grouped expert products against one product per expert, a
     2048-token prefill, ragged extend chunks into a 3-row session table
     and decode steps through ``forward_decode``, each row's last logits
     against the plain reference (``perfbench/reference/lfm2.py``, f32,
     TF32 off, layer by layer) as a relative L2 gap; waves of 32 turns
     through ``SessionServer``, timed; and
     ``launch.serve --arch lfm2-8b-a1b --preset full`` (decode through the
     cache over f32 master weights).

Any failure raises and exits non-zero.  The second-to-last line of
output is the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""

import contextlib
import io
import itertools
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
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


def quiet(*_):
    pass


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
            "rglru_seq": 0, "rglru_seq_lane": 0, "rglru_seq_bwd": 0}
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
    step-by-step decode.  Returns the launch counts of the prefill and the
    unsharded results phase 13b holds the mesh to: the prefill's logits
    and the first ``LM_DECODE`` steps' logits of the bf16 prompt decode."""
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
    kept = []

    def last_logits(c, keep=False):
        pre = T.forward_prefill(params, {"tokens": prompt}, c)
        cache = T.init_cache(c, prompt.shape[0], prompt.shape[1], device=dev)
        for t in range(prompt.shape[1]):
            step, cache = T.forward_decode(params, cache, {
                "tokens": prompt[:, t:t + 1], "cache_pos": t}, c)
            if keep and t < LM_DECODE:
                kept.append(step)
        return pre[:, -1], step[:, 0]

    pre16, dec16 = last_logits(cfg, keep=True)
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
    return launches, {"prefill": logits, "prompt": prompt, "decode": kept}


def phase7_train(repro_torch, model, accel, mods, dev, card):
    """QAT training on the card; returns the trained int path's launches."""
    from repro_torch.data import pems_like_dataset
    from repro_torch.training import checkpoint as ck
    from repro_torch.training.optimizer import OptConfig, init_opt_state
    from repro_torch.training.tree import tree_leaves

    data = pems_like_dataset(seq_len=6, n_days=28)
    params0 = repro_torch.build(model, accel, seed=0).params
    fresh = lambda: repro_torch.build(model, accel, params=params0)
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
            f"{summary['latency_ms']['p99']:.6f} ms per window; replica infers "
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


def phase9_sweep(repro_torch, explore, mods, dev, card):
    """Phase 9a: the offline design-space sweep of the paper's Table-4 axes
    (``paper_space(batch=256)``, 24 points) on the card; every ok point's
    int path on the sweep's windows equal to its ``ref`` engine; K1
    launched (1 warm-up + ``iters``) times per fused point.  Returns the
    sweep's launches."""
    iters = 20
    rng = np.random.default_rng(19)
    eval_x = (rng.normal(0.0, 1.0, (256, 6, 1)) * 0.7).astype(np.float32)
    t0 = time.perf_counter()
    reset_counts(mods)
    payload = explore.sweep(explore.paper_space(batch=256), eval_x=eval_x,
                            iters=iters, seed=0, device=dev)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    sweep_s = time.perf_counter() - t0
    rows = payload["points"]
    ok = [r for r in rows if r["status"] == "ok"]
    fused = [r for r in ok if r["plan"]["backend"] == "pallas"]
    check(len(rows) == 24 and len(ok) == 24,
          f"{len(ok)} of {len(rows)} sweep points ok: "
          f"{[(r['label'], r.get('reason')) for r in rows if r['status'] != 'ok']}")
    check(launches == {**{k: 0 for k in launches},
                       "multilayer": len(fused) * (iters + 1)},
          f"the sweep launched {launches} for {len(fused)} fused points x "
          f"{iters + 1} calls")
    for r in rows:
        m = r["metrics"]
        check(all(np.isfinite(v) for v in m.values()), f"{r['label']}: {m}")
        log(f"phase 9a: {r['label']} ({r['plan']['backend']}): "
            f"{m['us_per_wave']:.3f} us a wave, {m['samples_per_s']:.1f} samples/s, "
            f"{m['throughput_gops']:.6f} GOP/s, modelled {m['gops_per_watt']:.6f} "
            f"GOP/s/W at {m['total_w']:.3f} W, int-vs-float MSE "
            f"{m['int_float_mse']:.3e}{' (front)' if r['pareto'] else ''}")
    # The check: each point rebuilt from its record and seed; the ref
    # engine runs only the pipelined ALU, so a per_step point (the xla
    # engine's torch ops on the card) is held against the same session on
    # the CPU.
    for r in ok:
        model, accel = explore.point_from_config(r["config"]).configs()
        sess = repro_torch.build(model, accel, seed=payload["seed"],
                                 device=dev).quantize()
        y = sess.infer(eval_x, path="int")
        if r["config"]["alu_mode"] == "per_step":
            want = repro_torch.build(model, accel, seed=payload["seed"],
                                     device="cpu").quantize().infer(eval_x, path="int")
        else:
            want = sess.infer(eval_x, path="int", backend="ref")
        check(torch.equal(y.cpu(), want.cpu()),
              f"{r['label']}: the int path differs from its oracle")
    # Where a fused point's wave goes: the front's first point, its int
    # path under the profiler (20 calls, as the sweep times them).
    front = next(r for r in rows if r["label"] == payload["front"][0])
    model, accel = explore.point_from_config(front["config"]).configs()
    fn = repro_torch.build(model, accel, seed=payload["seed"],
                           device=dev).quantize().compiled("int")
    xd = torch.as_tensor(eval_x, device=dev)
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")
    avgs, wall_ms = profile(lambda: fn(xd), 20)
    busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 20 / 1e3
    log(f"phase 9a: {front['label']}'s wave: {wall_ms / 20:.6f} ms wall under the "
        f"profiler, {busy_ms:.6f} ms device busy, idle share "
        f"{1 - busy_ms / (wall_ms / 20):.4f} on {card}")
    log(avgs.table(sort_by="cpu_time_total", row_limit=12))
    log(f"phase 9a: sweep of {len(rows)} points in {sweep_s:.1f} s, front "
        f"{payload['front']}; {len(fused)} fused points, K1 launches "
        f"{launches['multilayer']} = {len(fused)} x (1 warm-up + {iters}); every "
        f"pipelined point's int path equals its ref engine, every per_step "
        f"point's equals the CPU's, on the sweep's {len(eval_x)} windows on {card}")
    return launches


def phase9_serving(explore, mods, dev, card):
    """Phase 9b: a serving halving sweep (host/device residency x batch 16/64)
    on phase 4's traffic, ``autotune`` on its payload, and the winner
    re-measured by ``measure_scenario`` against the SLO it was chosen
    under.  Returns the sweep's launches."""
    slo = "p99_ms<=500"
    space = explore.SearchSpace(state_residency=("host", "device"), batch=(16, 64))
    scenario = explore.ServingScenario(streams=128, windows_per_stream=6,
                                       deadline_ms=5.0, name="phase4")
    t0 = time.perf_counter()
    reset_counts(mods)
    payload = explore.sweep(space, scenario=scenario, strategy="halving",
                            objective="samples_per_s", constraint=slo, seed=0,
                            device=dev)
    torch.cuda.synchronize()
    launches = read_counts(mods)
    tr = payload["halving"]
    check(tr["sizes"] == [4, 2, 1] and tr["total_measurements"] == 7,
          f"halving schedule {tr['sizes']}, {tr['total_measurements']} runs")
    check(launches["slot"] > 0 and launches["multilayer"] > 0,
          f"the serving sweep launched {launches}")
    for r in payload["points"]:
        m, op = r["metrics"], r["operating_point"]
        log(f"phase 9b: {r['label']} ({r['plan']['state_residency']}, rung "
            f"{op['rung']} at {op['fraction']:g}): {m['samples_per_s']:.1f} "
            f"samples/s, p50 {m['p50_ms']:.3f} p99 {m['p99_ms']:.3f} ms, "
            f"{m['waves']:.0f} waves, modelled {m['gops_per_watt']:.6f} GOP/s/W")
    winner = explore.autotune(payload=payload, objective="samples_per_s",
                              constraint=slo, device=dev)
    best = winner.autotune_summary["best"]
    cfg = best["config"]
    reset_counts(mods)
    m = winner.measure_scenario(explore.ServingScenario.from_dict(payload["scenario"]),
                                batch=cfg["batch"], state_residency=cfg["state_residency"])
    torch.cuda.synchronize()
    re_launches = read_counts(mods)
    counter = "slot" if cfg["state_residency"] == "device" else "multilayer"
    check(re_launches[counter] == m["waves"] + 1,
          f"re-measure launched {re_launches} for {m['waves']} waves + a warm-up")
    check(explore.parse_constraint(slo).ok(m), f"the winner misses {slo}: {m}")
    log(f"phase 9b: halving {tr['sizes']} over {tr['total_measurements']} runs in "
        f"{time.perf_counter() - t0:.1f} s, launches {launches}; autotune picked "
        f"{best['label']} ({best['metrics']['samples_per_s']:.1f} samples/s); "
        f"measure_scenario: {m['samples_per_s']:.1f} samples/s, p99 "
        f"{m['p99_ms']:.3f} ms meets {slo}, {m['waves']:.0f} waves, "
        f"{counter} launches {re_launches[counter]}, modelled "
        f"{m['gops_per_watt']:.6f} GOP/s/W on {card}")
    return launches


class PowerSampler:
    """The board's ``power.draw`` (W) from ``nvidia-smi -lms 100`` (~10 Hz)
    in a child process, each reading stamped on the host's clock; a
    ``with`` block starts and stops the child."""

    def __init__(self):
        self.samples = []

    def __enter__(self):
        import threading
        self.proc = subprocess.Popen(
            ["nvidia-smi", "-i", "0", "--query-gpu=power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)

        def read():
            for line in self.proc.stdout:
                try:
                    self.samples.append((time.perf_counter(), float(line)))
                except ValueError:
                    pass

        self.reader = threading.Thread(target=read, daemon=True)
        self.reader.start()
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait(timeout=10)
        self.reader.join(timeout=10)

    def median(self, t0, t1):
        """Median of the readings between host times ``t0`` and ``t1``."""
        got = [w for t, w in self.samples if t0 <= t <= t1]
        check(len(got) >= 5, f"{len(got)} power readings in {t1 - t0:.1f} s")
        return float(np.median(got)), len(got)


def busy_watts(sampler, fn, seconds, settle=1.0):
    """Run ``fn`` back to back for ``seconds``; returns (median W after
    ``settle`` s — nvidia-smi's reading averages over about a second —,
    readings, calls, wall s)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() - t0 < seconds:
        fn()
        calls += 1
        if calls % 8 == 0:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    watts, n = sampler.median(t0 + settle, t1)
    return watts, n, calls, t1 - t0


def phase9_power(session, qc, qm, ha, fxp, lstm_ops, dev, card):
    """Phase 9c: the board's idle draw, its draw under K1 ``infer`` at batch
    256 beside the energy model's ``total_w`` at the same operating point,
    and the fits behind ``core/energy.py``'s constants (each loop's draw
    above idle over its operations or bytes a second)."""
    from repro_torch.core import energy
    model = session.model
    rng = np.random.default_rng(9)
    x = (rng.normal(0.0, 1.0, (256, model.seq_len, model.input_size)) * 0.7
         ).astype(np.float32)
    ops = session.cell.ops_per_inference(model)
    out = {}
    with PowerSampler() as ps:
        torch.cuda.synchronize()
        time.sleep(2.0)
        t0 = time.perf_counter()
        time.sleep(2.5)
        out["idle_w"], n_idle = ps.median(t0, time.perf_counter())
        busy_w, n_busy, calls, wall = busy_watts(
            ps, lambda: session.infer(x, path="int"), 5.0)
        lat = wall / calls
        rep = session.report(latency_s=lat, batch=256)["energy"]
        out.update(busy_w=busy_w, infer_ms=lat * 1e3,
                   model_total_w=rep["total_w"],
                   model_gops_per_watt=rep["gops_per_watt"],
                   measured_gops_per_watt=256 * ops / lat / 1e9 / busy_w)
        log(f"phase 9c: board power idle {out['idle_w']:.2f} W (median of {n_idle} "
            f"readings), busy {busy_w:.2f} W ({n_busy} readings) during {calls} K1 "
            f"infer calls at batch 256 ({lat * 1e3:.6f} ms a call, "
            f"{256 * ops / lat / 1e9:.3f} GOP/s); the model's total_w there "
            f"{rep['total_w']:.2f} W ({rep['total_w'] / busy_w:.4f} of the busy "
            f"reading), its GOP/s/W {rep['gops_per_watt']:.6f}; measured GOP/s/W "
            f"{out['measured_gops_per_watt']:.6f} (ops/s over busy W) on {card}")

        # Calibration loops, each sustained for a few seconds: K6 on 1 GiB
        # of int8 codes (bytes), K1 at a large batch (CUDA-core int32), K4
        # and a bf16 torch.matmul on 8192^3 products (tensor cores).
        n6 = 1 << 30
        codes6 = torch.randint(-128, 128, (n6,), dtype=torch.int8, device=dev)
        w6, _, c6, s6 = busy_watts(ps, lambda: ha.hard_tanh(codes6, cfg=fxp.FXP_4_8),
                                   4.0)
        del codes6
        e_hbm = (w6 - out["idle_w"]) / (2 * n6 * c6 / s6)
        acts, sd = model.acts, model.fxp.storage_dtype
        kw = dict(cfg=model.fxp, hs_method=session.accel.hs_method,
                  hs_slope_shift=acts.hs_slope_shift, hs_bound=acts.hs_bound,
                  ht_min=acts.ht_min, ht_max=acts.ht_max)
        layers = session.qparams["layers"]
        wxs = [p["w_x"].to(sd) for p in layers]
        whs = [p["w_h"].to(sd) for p in layers]
        bs = [p["b"] for p in layers]
        B1 = 1 << 20
        x1 = torch.randint(-8, 8, (model.seq_len, B1, model.input_size),
                           dtype=torch.int8, device=dev)
        z1 = [torch.zeros(B1, model.hidden_size, dtype=torch.int32, device=dev)]
        w1, _, c1, s1 = busy_watts(
            ps, lambda: qc.qlstm_seq_multilayer(x1, wxs, whs, bs, z1, z1, **kw), 4.0)
        o1 = lstm_ops(model) * B1 * c1 / s1
        b1 = (x1.numel() + 4 * 4 * B1 * model.hidden_size
              + model.seq_len * B1 * model.hidden_size) * c1 / s1
        del x1, z1
        e_vpu = (w1 - out["idle_w"] - e_hbm * b1) / o1
        N = 8192
        a8 = torch.randint(-128, 128, (N, N), dtype=torch.int8, device=dev)
        w4, _, c4, s4 = busy_watts(ps, lambda: qm.quant_matmul(a8, a8), 4.0)
        o4, b4 = 2 * N ** 3 * c4 / s4, 6 * N * N * c4 / s4
        e_int8 = (w4 - out["idle_w"] - e_hbm * b4) / o4
        del a8
        ab = torch.randn(N, N, dtype=torch.bfloat16, device=dev)
        wb, _, cb, sb = busy_watts(ps, lambda: ab @ ab, 4.0)
        ob, bb = 2 * N ** 3 * cb / sb, 6 * N * N * cb / sb
        e_bf16 = (wb - out["idle_w"] - e_hbm * bb) / ob
        del ab
    out.update(e_hbm=e_hbm, e_vpu=e_vpu, e_int8=e_int8, e_bf16=e_bf16)
    log(f"phase 9c: calibration: K6 1 GiB int8 {w6:.2f} W at {2 * n6 * c6 / s6 / 1e12:.4f}"
        f" TB/s -> E_HBM_J_PER_BYTE {e_hbm:.6e}; K1 B={B1} {w1:.2f} W at "
        f"{o1 / 1e12:.4f} TOP/s -> E_VPU_J_PER_FLOP {e_vpu:.6e}; K4 {N}^3 int8 "
        f"{w4:.2f} W at {o4 / 1e12:.4f} TOP/s -> E_MXU_INT8_J_PER_OP {e_int8:.6e}; "
        f"bf16 matmul {N}^3 {wb:.2f} W at {ob / 1e12:.4f} TFLOP/s -> "
        f"E_MXU_BF16_J_PER_FLOP {e_bf16:.6e}; P_STATIC_W {out['idle_w']:.2f} "
        f"(the package's constants: P_STATIC_W {energy.P_STATIC_W}, E_VPU "
        f"{energy.E_VPU_J_PER_FLOP:.3e}, E_HBM {energy.E_HBM_J_PER_BYTE:.3e}, "
        f"E_INT8 {energy.E_MXU_INT8_J_PER_OP:.3e}, E_BF16 "
        f"{energy.E_MXU_BF16_J_PER_FLOP:.3e}) on {card}")
    check(out["busy_w"] > 0 and out["idle_w"] > 0, "no board power read")
    return out


def phase9(repro_torch, session, mods, qc, qm, ha, fxp, lstm_ops, dev, card):
    """Phase 9: the offline sweep (9a), the serving halving sweep, autotune
    and ``measure_scenario`` (9b), and board power (9c).  Returns the
    launches of 9a and 9b (9c's are measurement loops)."""
    from repro_torch import explore
    totals = dict(phase9_sweep(repro_torch, explore, mods, dev, card))
    for k, v in phase9_serving(explore, mods, dev, card).items():
        totals[k] = totals.get(k, 0) + v
    phase9_power(session, qc, qm, ha, fxp, lstm_ops, dev, card)
    return totals


# ---------------------------------------------------------------------------
# phase 10: the LM side's dense, MoE, RWKV-6, VLM and audio families
# ---------------------------------------------------------------------------

QWEN, QWEN_T, QWEN_PROMPT, FAMILY_PROMPT = "qwen1.5-0.5b", 2048, 32, 16
SERVE_MODES = ((), ("--quant", "w8"), ("--quant", "w8a8"),
               ("--quant", "w8a8", "--kv-int8"))
# The other families at their published widths, depth cut to two layers
# (gemma2: one local layer and one global).
CUT_ARCHS = ("gemma2-2b", "mixtral-8x7b", "phi3.5-moe", "rwkv6-7b",
             "qwen2-vl-2b", "musicgen-medium")
CUT_LAYERS = 2


def lm_inputs(params, cfg, tokens):
    """The model batch for ``tokens`` (B, T) as ``launch/serve.py`` builds
    it: token ids, or for an arch without an embedding input the frontend
    stub's frames (the ids through the table, bf16).  ``lm_step`` and
    ``lm_prefill_batch`` add M-RoPE's positions."""
    if cfg.embed_inputs:
        batch = {"tokens": tokens}
    else:
        emb = params["embed"]
        e = (emb["q"][tokens].to(torch.bfloat16) * emb["s"].to(torch.bfloat16)
             if isinstance(emb, dict) else emb[tokens].to(torch.bfloat16))
        batch = {"inputs_embeds": e}
    return batch


def lm_step(cfg, batch, t, b, dev):
    """Decode step t's slice of ``lm_inputs``' batch."""
    out = {k: v[:, t:t + 1] for k, v in batch.items()}
    out["cache_pos"] = t
    if cfg.attn and cfg.attn.mrope_sections:
        out["position_ids"] = torch.full((3, b, 1), t, device=dev)
    return out


def lm_prefill_batch(cfg, batch, dev):
    out = dict(batch)
    if cfg.attn and cfg.attn.mrope_sections:
        x = next(iter(batch.values()))
        pos = torch.arange(x.shape[1], device=dev)
        out["position_ids"] = pos.expand(3, x.shape[0], x.shape[1])
    return out


def lm_decode(T, params, cfg, batch, dev, cache_len=None, kv_dtype=None):
    """Decode ``batch``'s steps one by one; returns (last logits, cache).
    ``kv_dtype`` replaces the cache's bf16 KV dtype (f32: the f32 path
    with nothing stored in bf16)."""
    x = next(iter(batch.values()))
    b, t_len = x.shape[:2]
    cache = T.init_cache(cfg, b, cache_len or t_len, device=dev)
    if kv_dtype is not None:
        cache = {k: v.to(kv_dtype) if k in ("k", "v") else v
                 for k, v in cache.items()}
    for t in range(t_len):
        logits, cache = T.forward_decode(params, cache,
                                         lm_step(cfg, batch, t, b, dev), cfg)
    return logits, cache


def prefill_vs_decode(T, params, cfg, batch, dev):
    """The prefill's last logits against a step-by-step decode of the same
    prompt, in f32 and bf16 activations on the same weights.  Returns
    (f32 |err| with an f32 KV cache, f32 |err| with the bf16 KV cache the
    model keeps, bf16 |err|, bf16 decode's |err| against the f32 prefill,
    |bf16 prefill - f32 prefill|).

    The reference's bound (0.3) is set at its reduced config; it holds the
    f32 path, where prefill and decode differ only in summation order.
    The decode cache stores KV in bf16 whatever the activation dtype; at
    full width (logits of ~100 from a tied, unit-scale embedding, where a
    bf16 ulp is 0.5) that rounding alone moves the largest logit past 0.3,
    so an f32 decode over the bf16 cache is held to the distance between
    the bf16 and the f32 prefill, and the bf16 decode to twice that
    distance from the f32 prefill (it rounds as often as the bf16 prefill
    does, in another order)."""
    maxdiff = lambda a, b: float((a - b).abs().max())  # noqa: E731
    out = {}
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        pre = T.forward_prefill(params, lm_prefill_batch(c, batch, dev), c)[:, -1]
        step, _ = lm_decode(T, params, c, batch, dev)
        check(bool(torch.isfinite(pre).all() and torch.isfinite(step).all()),
              f"{cfg.name} {dtype}: non-finite logits")
        out[dtype] = pre, step[:, 0]
    c32 = cfg.replace(dtype="float32")
    step32, _ = lm_decode(T, params, c32, batch, dev, kv_dtype=torch.float32)
    pre32 = out["float32"][0]
    err32 = maxdiff(pre32, step32[:, 0])
    err32kv = maxdiff(*out["float32"])
    err16 = maxdiff(*out["bfloat16"])
    err16_32 = maxdiff(out["bfloat16"][1], pre32)
    floor = maxdiff(out["bfloat16"][0], pre32)
    check(err32 < 0.3, f"{cfg.name}: f32 prefill and decode (f32 KV) differ by "
          f"{err32} (bound 0.3)")
    check(err32kv <= floor, f"{cfg.name}: f32 prefill and decode over the bf16 "
          f"KV cache differ by {err32kv}, more than bf16 differs from f32 "
          f"({floor})")
    check(err16_32 <= 2 * floor, f"{cfg.name}: the bf16 decode is {err16_32} "
          f"from the f32 prefill, more than twice the bf16 prefill ({floor})")
    return err32, err32kv, err16, err16_32, floor


class QuantLinearCount:
    """Counts the ``linear`` calls on ``{"q", "s"}`` weights while active
    (``models.layers.linear`` and the modules that imported it)."""

    def __init__(self, mods):
        self.mods, self.n = mods, 0

    def __enter__(self):
        self.real = self.mods[0].linear

        def counting(x, w, *a, **kw):
            self.n += isinstance(w, dict)
            return self.real(x, w, *a, **kw)
        for m in self.mods:
            m.linear = counting
        return self

    def __exit__(self, *exc):
        for m in self.mods:
            m.linear = self.real


def run_serve(serve, argv):
    """``serve.main(argv)`` with its report captured; returns (tokens,
    tokens/s, report lines)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        gen = serve.main(argv)
    lines = buf.getvalue().strip().splitlines()
    tps = float(re.search(r"= ([0-9.]+) tok/s", buf.getvalue()).group(1))
    return gen, tps, lines


def phase10_qwen(T, ARCH_CONFIGS, serve, mods, dev, card):
    """10a: qwen1.5-0.5B at its published width and depth.  Returns the
    serve runs' kernel launches."""
    from repro_torch.models.modules import count_params
    cfg = ARCH_CONFIGS[QWEN]
    params, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(10)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, QWEN_T)), device=dev)
    log(f"phase 10a: {QWEN}: {count_params(params)} f32 parameters, "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size} (nothing cut)")
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")  # noqa: E731
    for dtype in ("float32", "bfloat16"):
        c = cfg.replace(dtype=dtype)
        prefill = lambda: T.forward_prefill(params, {"tokens": tokens}, c)  # noqa: E731
        reset_counts(mods)
        logits = prefill()
        torch.cuda.synchronize()
        launches = read_counts(mods)
        check(not any(launches.values()), f"the float prefill launched {launches}")
        check(tuple(logits.shape) == (1, 1, cfg.vocab_size) and
              bool(torch.isfinite(logits).all()), f"prefill logits {logits.shape}")
        t0 = time.perf_counter()
        for _ in range(2):
            prefill()
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3 / 2
        avgs, wall_ms = profile(prefill, 2)
        busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 2 / 1e3
        log(f"phase 10a: {QWEN} forward_prefill B=1 T={QWEN_T} {dtype}: finite "
            f"(1, 1, {cfg.vocab_size}); {pre_ms:.6f} ms wall "
            f"({QWEN_T / pre_ms * 1e3:.3f} tokens/s); under the profiler "
            f"{wall_ms / 2:.6f} ms wall, {busy_ms:.6f} ms device busy, idle share "
            f"{1 - busy_ms / (wall_ms / 2):.4f} on {card}")
        log(avgs.table(sort_by="cpu_time_total", row_limit=10))

    prompt = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, QWEN_PROMPT)),
                             device=dev)
    err32, err32kv, err16, err16_32, floor = prefill_vs_decode(
        T, params, cfg, {"tokens": prompt}, dev)
    log(f"phase 10a: a {QWEN_PROMPT}-token prompt (B=2) decoded step by step "
        f"against the prefill's last logits: f32 max |err| {err32} with an f32 "
        f"KV cache (bound 0.3), {err32kv} over the bf16 KV cache (bound: bf16 "
        f"prefill vs f32 prefill, {floor}); bf16 decode vs bf16 prefill "
        f"{err16}, vs f32 prefill {err16_32} (bound {2 * floor})")
    del params
    torch.cuda.empty_cache()

    totals = {}
    for mode in SERVE_MODES:
        reset_counts(mods)
        gen, tps, lines = run_serve(serve, [
            "--arch", QWEN, "--preset", "full", "--batch", "4", "--prompt-len",
            "16", "--gen", "32", "--max-seq", "64", *mode])
        launches = read_counts(mods)
        check(gen.shape == (4, 32) and ((0 <= gen) & (gen < cfg.vocab_size)).all(),
              f"serve {mode} returned {gen.shape}")
        w8a8 = "w8a8" in mode
        check((launches["int32"] > 0) == w8a8 and
              sum(launches.values()) == launches["int32"],
              f"serve {mode or 'float'} launched {launches}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"phase 10a: serve.main --arch {QWEN} --preset full "
            f"{' '.join(mode) or '(float)'}: {tps} tokens/s (batch 4, 16 prompt "
            f"+ 32 generated tokens, decode steps only); K4 launches "
            f"{launches['int32']} on {card}")
        for line in lines:
            log("  " + line)
        torch.cuda.empty_cache()
    return totals


def phase10_k4(T, ARCH_CONFIGS, QuantConfig, layer_mods, qm, mods, dev, card):
    """10b: K4 on the w8a8 path of qwen1.5-0.5B: launches per decode step
    against the quantised ``linear``s the step runs, the kernel's int32
    accumulators against its plain product on the card (tolerance 0), its
    share of a step's device time, and its times at the decode and the
    prefill shapes.  Returns (the counted step's launches, timing rows)."""
    cfg = ARCH_CONFIGS[QWEN].replace(quant=QuantConfig("w8a8", quantize_kv=True))
    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    params, _ = T.quantize_model_params(params, axes, cfg)
    rng = np.random.default_rng(11)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 5)), device=dev)
    _, cache = lm_decode(T, params, cfg, {"tokens": tokens[:, :4]}, dev, 64)
    batch = {"tokens": tokens[:, 4:5], "cache_pos": 4}

    real = qm.quant_matmul
    accs = {"kernel": [], "plain": []}

    def recording(route):
        def mm(x, w, **kw):
            out = real(x, w, **kw) if route == "kernel" else \
                qm.quant_matmul_plain(x, w, **kw)
            accs[route].append(out)
            return out
        return mm

    reset_counts(mods)
    with QuantLinearCount(layer_mods) as n_lin:
        qm.quant_matmul = recording("kernel")
        try:
            logits_k, _ = T.forward_decode(params, cache, batch, cfg)
            torch.cuda.synchronize()
        finally:
            qm.quant_matmul = real
    launches = read_counts(mods)
    check(launches["int32"] == n_lin.n == len(accs["kernel"]) and
          sum(launches.values()) == n_lin.n,
          f"a w8a8 decode step ran {n_lin.n} quantised linears and launched "
          f"{launches}")
    qm.quant_matmul = recording("plain")
    try:
        logits_p, _ = T.forward_decode(params, cache, batch, cfg)
        torch.cuda.synchronize()
    finally:
        qm.quant_matmul = real
    check(len(accs["plain"]) == len(accs["kernel"]) and
          all(torch.equal(a, b) for a, b in zip(accs["kernel"], accs["plain"])),
          "K4's int32 accumulators differ from the plain product")
    check(torch.equal(logits_k, logits_p), "the w8a8 logits differ between K4 "
          "and the plain product")
    log(f"phase 10b: one w8a8 + int8-KV decode step of {QWEN} (batch 4): "
        f"{n_lin.n} quantised linears, K4 launches {launches['int32']}; "
        f"{len(accs['kernel'])} int32 accumulators equal the plain product's "
        f"on the card (tolerance 0), logits identical")

    is_cuda = lambda e: str(e.device_type).endswith("CUDA")  # noqa: E731
    step = lambda: T.forward_decode(params, cache, batch, cfg)  # noqa: E731
    avgs, wall_ms = profile(step, 3)
    by = {sym: sum(device_us(e) for e in avgs if is_cuda(e) and sym in e.key) / 3e3
          for sym in ("qmm_wt_kernel", "qmm_imma_kernel")}
    busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 3e3
    wt_bytes = sum(2 * x.numel() for x in _quant_weights(params))
    log(f"phase 10b: one w8a8 decode step under the profiler: {wall_ms / 3:.6f} "
        f"ms wall, {busy_ms:.6f} ms device busy (idle share "
        f"{1 - busy_ms / (wall_ms / 3):.4f}); K4's w^T rebuild (qmm_wt_kernel) "
        f"{by['qmm_wt_kernel']:.6f} ms, its products (qmm_imma_kernel) "
        f"{by['qmm_imma_kernel']:.6f} ms; the rebuild moves {wt_bytes} bytes a "
        f"step (each quantised weight read and w^T written), "
        f"{wt_bytes / HBM_BYTES_PER_S * 1e3:.6f} ms at the memory rate, on {card}")

    rows = {}
    for name, m in (("decode", 4), ("prefill", QWEN_T)):
        x = codes(rng, (m, D_MODEL), 8, dev)
        w = codes(rng, (D_MODEL, D_FF), 8, dev)
        ms = graph_ms(lambda: qm.quant_matmul(x, w), 500)
        plain_ms = cuda_ms(lambda: qm.quant_matmul_plain(x, w), 20)
        check(torch.equal(qm.quant_matmul(x, w), qm.quant_matmul_plain(x, w)),
              f"K4 differs from its plain version at M={m}")
        try:
            lib_ms = cuda_ms(lambda: torch._int_mm(x, w), 200)
        except RuntimeError as e:
            lib_ms, why = None, str(e).splitlines()[0]
        b_ms, b_by = bound(x.numel() + w.numel() + 4 * m * D_FF,
                           2 * m * D_MODEL * D_FF, INT8_OPS_PER_S)
        rows[name] = dict(M=m, K=D_MODEL, N=D_FF, ms=ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        log(f"phase 10b: K4 at the {name} shape ({m}, {D_MODEL}) x ({D_MODEL}, "
            f"{D_FF}) int8: {ms:.6f} ms device (plain {plain_ms:.6f} ms, bound "
            f"{b_ms:.6f} ms by {b_by}, torch._int_mm "
            f"{'rejects it: ' + why if lib_ms is None else f'{lib_ms:.6f} ms'}) "
            f"on {card}")
    return launches, rows


def _quant_weights(tree):
    """The int8 codes of every ``{"q", "s"}`` leaf of a params tree that a
    decode step multiplies through K4 (the embedding is only gathered)."""
    out = []
    for k, v in tree.items() if isinstance(tree, dict) else enumerate(tree):
        if isinstance(v, dict) and set(v) == {"q", "s"}:
            if k != "embed":
                out.append(v["q"])
        elif isinstance(v, (dict, list)):
            out += _quant_weights(v)
    return out


def phase10_families(T, ARCH_CONFIGS, QuantConfig, mods, dev, card):
    """10c: the other families at their published widths, two layers each:
    prefill, prefill against step-by-step decode (f32 and bf16) and a
    w8a8 + int8-KV decode.  Returns the w8a8 decodes' launches."""
    totals = {}
    for arch in CUT_ARCHS:
        t0 = time.perf_counter()
        full = ARCH_CONFIGS[arch]
        cfg = full.replace(n_layers=CUT_LAYERS)
        params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(12)
        tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, FAMILY_PROMPT)),
                                 device=dev)
        batch = lm_inputs(params, cfg, tokens)
        reset_counts(mods)
        err32, err32kv, err16, err16_32, floor = prefill_vs_decode(
            T, params, cfg, batch, dev)
        check(not any(read_counts(mods).values()), f"{arch}: the float path "
              f"launched {read_counts(mods)}")
        qcfg = cfg.replace(quant=QuantConfig("w8a8", quantize_kv=True))
        qparams, _ = T.quantize_model_params(params, axes, qcfg)
        del params
        reset_counts(mods)
        logits, cache = lm_decode(T, qparams, qcfg, lm_inputs(qparams, qcfg, tokens),
                                  dev)
        torch.cuda.synchronize()
        launches = read_counts(mods)
        check(bool(torch.isfinite(logits).all()), f"{arch}: non-finite w8a8 logits")
        check(launches["int32"] > 0 and sum(launches.values()) == launches["int32"],
              f"{arch}: the w8a8 decode launched {launches}")
        kv = {k: str(v.dtype) for k, v in cache.items() if k in ("k", "v")}
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        windows = cfg.layer_windows(1 << 20) if cfg.attn else ()
        log(f"phase 10c: {arch} at published widths (d_model {cfg.d_model}, "
            f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
            f"{f', {cfg.moe.num_experts} experts top-{cfg.moe.top_k}' if cfg.moe else ''}"
            f"), cut: {full.n_layers} -> {CUT_LAYERS} layers"
            f"{f' (windows {windows})' if windows else ''}; B=2 "
            f"{FAMILY_PROMPT}-token prompt: prefill vs decode f32 |err| {err32} "
            f"(0.3; {err32kv} over bf16 KV, bound {floor}), bf16 {err16} (vs f32 "
            f"prefill {err16_32}, bound {2 * floor}); w8a8 "
            f"+ int8-KV decode finite, "
            f"KV {kv or 'none (rwkv state)'}, K4 launches {launches['int32']}; "
            f"{time.perf_counter() - t0:.1f} s")
        del qparams, cache
        torch.cuda.empty_cache()
    return totals


# ---------------------------------------------------------------------------
# phase 11: LM training, the paper's model through the training launcher,
# and the wave batcher
# ---------------------------------------------------------------------------

TRAIN_B, TRAIN_S = 8, 512
TRAIN_ARGV = ["--arch", QWEN, "--preset", "full", "--batch", str(TRAIN_B), "--seq",
              str(TRAIN_S), "--device", "cuda"]
# RecurrentGemma-2B cut to one period of its pattern, trained at T=4096 (the
# prefill's length).  B is cut from the prefill's 2 to 1: at B=2 the f32
# logits (2 x 4096 x 256,000) and their softcap and softmax chain peak at
# 65.9 GiB, and the third step failed to find 7.8 GiB in the 16 GiB the
# allocator had left fragmented.
RG_TRAIN_B, RG_TRAIN_T = 1, 4096
BWD_SETS = 3     # operand sets K7's backward is timed over
# The other archs' training cut: phase 10c's two layers, one for the MoE archs,
# whose two-layer AdamW state alone (params, gradients, two moments and the
# step's new copies, ~7 x 12.5 GB for mixtral) exceeds the card.
# rwkv6 trains on four of its 128-token wkv chunks, so the chunks chain.
TRAIN_SEQ = {"rwkv6-7b": 512}
TRAIN_CUT = {"gemma2-2b": 2, "mixtral-8x7b": 1, "phi3.5-moe": 1, "rwkv6-7b": 2,
             "qwen2-vl-2b": 2, "musicgen-medium": 2}


def step_profile(step_fn, state, batch_fn, steps, warm=2):
    """``warm`` steps, then ``steps`` steps under each of three clocks:
    each step waited for, without the profiler; back to back without the
    profiler, one synchronize at the end (as ``Trainer`` runs between its
    logs); each step waited for, under the profiler.  Every batch is on
    the card before the first clock starts.  Returns ms per step under
    each clock (``wait_ms``, ``b2b_ms``, ``prof_ms``), the device-busy ms
    per step under the profiler (``busy_ms``) and its table (``avgs``)."""
    first = int(state["step"])
    batches = iter([batch_fn(first + i) for i in range(warm + 3 * steps + 1)])
    holder = [state]

    def one(wait=True):
        holder[0], m = step_fn(holder[0], next(batches))
        if wait:
            float(m["loss"])                   # waits for the step

    def clock(wait):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            one(wait)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / steps
    for _ in range(warm):
        one()
    out = dict(wait_ms=clock(True), b2b_ms=clock(False))
    avgs, wall_ms = profile(one, steps)
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")  # noqa: E731
    busy = sum(device_us(e) for e in avgs if is_cuda(e)) / steps / 1e3
    return dict(out, prof_ms=wall_ms / steps, busy_ms=busy, avgs=avgs)


def step_clocks(sp, card):
    """One log line's worth of ``step_profile``'s clocks and idle shares."""
    idle = lambda ms: 1 - sp["busy_ms"] / ms  # noqa: E731
    return (f"{sp['busy_ms']:.6f} ms device busy (the profiler's kernels) against "
            f"{sp['wait_ms']:.6f} ms wall waited for step by step (idle share "
            f"{idle(sp['wait_ms']):.4f}), {sp['b2b_ms']:.6f} ms back to back "
            f"(idle share {idle(sp['b2b_ms']):.4f}), {sp['prof_ms']:.6f} ms under "
            f"the profiler (idle share {idle(sp['prof_ms']):.4f}), on {card}")


def phase11_qwen(train, mods, dev, card):
    """11a: qwen1.5-0.5B at full width trains 20 steps (no remat, then
    remat="full": equal losses, lower peak), a profiled step, and a
    SIGTERM restart bit for bit.  The comparisons run under
    ``torch.use_deterministic_algorithms(True)`` (the embedding's and the
    gather's backward accumulate with atomics otherwise)."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig
    from repro_torch.training.tree import tree_leaves, tree_leaves_with_path

    cfg = ARCH_CONFIGS[QWEN]
    # A step outside deterministic mode, as a user runs it: wall, busy, idle.
    plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=10, total_steps=20))
    params, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    src = SyntheticLM(cfg.vocab_size, seed=0)
    batch_fn = lambda i: {k: torch.as_tensor(v, device=dev)  # noqa: E731
                          for k, v in src.batch(i, 8, 512).items()}
    sp = step_profile(TS.make_train_step(cfg, plan),
                      TS.init_train_state(params, plan), batch_fn, 3)
    log(f"phase 11a: {QWEN} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, bf16 activations over f32 "
        f"master weights, remat {cfg.remat}) train step B=8 S=512: "
        f"{8 * 512 / sp['b2b_ms'] * 1e3:.3f} tokens/s back to back; "
        + step_clocks(sp, card))
    log(sp["avgs"].table(sort_by="self_device_time_total", row_limit=12))
    del params, sp
    torch.cuda.empty_cache()

    torch.use_deterministic_algorithms(True)
    try:
        runs = {}
        for remat in ("none", "full"):
            reset_counts(mods)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            out = train.main(TRAIN_ARGV + ["--steps", "20", "--remat", remat],
                             log=quiet)
            wall_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated(dev)
            launches = read_counts(mods)
            hist = {h["step"]: h for h in out["history"]}
            check(out["step"] == 20 and sorted(hist) == [1, 10, 20],
                  f"remat {remat}: steps {out['step']}, logged {sorted(hist)}")
            check(all(np.isfinite(h["loss"]) for h in hist.values()),
                  f"remat {remat}: non-finite loss")
            check(hist[20]["loss"] < hist[1]["loss"],
                  f"remat {remat}: the loss did not fall: {hist[1]['loss']} -> "
                  f"{hist[20]['loss']}")
            check(not any(launches.values()), f"LM training launched {launches}")
            runs[remat] = (hist, peak)
            log(f"phase 11a: launch.train.main --arch {QWEN} --preset full "
                f"--steps 20 --batch 8 --seq 512 --remat {remat} (deterministic "
                f"algorithms): loss step 1 {hist[1]['loss']}, step 10 "
                f"{hist[10]['loss']}, step 20 {hist[20]['loss']}; a step "
                f"{hist[10]['dt'] * 1e3:.3f} / {hist[20]['dt'] * 1e3:.3f} ms (steps "
                f"10 / 20, wall after synchronize); peak device memory "
                f"{peak / 2**30:.3f} GiB; {wall_s:.1f} s with init on {card}")
            del out
            torch.cuda.empty_cache()
        (h0, p0), (h1, p1) = runs["none"], runs["full"]
        check(all(h0[s]["loss"] == h1[s]["loss"] for s in h0),
              "remat full and none give different losses")
        check(p1 < p0, f"remat full does not lower the peak: {p1} >= {p0}")
        log(f"phase 11a: remat full equals none at steps 1/10/20 bit for bit; "
            f"peak {p1 / 2**30:.3f} GiB against {p0 / 2**30:.3f} GiB")

        root = Path(__file__).resolve().parent / "build" / "chip_smoke_lm_ckpt"
        shutil.rmtree(root, ignore_errors=True)

        def preempt_at_5(msg):
            if msg.startswith("[step 5]"):
                os.kill(os.getpid(), signal.SIGTERM)

        argv = TRAIN_ARGV + ["--steps", "10", "--log-every", "5"]
        try:
            t0 = time.perf_counter()
            full = train.main(argv, log=quiet)["state"]
            cut = train.main(argv + ["--ckpt-dir", str(root)], log=preempt_at_5)
            check(cut["preempted"] and cut["step"] == 5,
                  f"SIGTERM did not end the run at step 5: {cut['step']}")
            del cut
            resumed = train.main(argv + ["--ckpt-dir", str(root)], log=quiet)
            check(resumed["step"] == 10, "the resumed run did not reach step 10")
            check(all(t.device.type == dev.type for t in tree_leaves(resumed["state"])),
                  "the resumed state left the card")
            for (p, a), (_, b) in zip(tree_leaves_with_path(full),
                                      tree_leaves_with_path(resumed["state"])):
                check(torch.equal(a, b), f"restart differs at {'/'.join(p)}")
            restart_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
        log(f"phase 11a: 10 straight steps equal 5 steps + SIGTERM checkpoint + "
            f"resume + 5 steps, bit for bit ({len(tree_leaves(full))} leaves: "
            f"params, AdamW moments, step), in {restart_s:.1f} s with two "
            f"checkpoints of the state written")
        del full, resumed
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()


def phase11_rgemma(rg, mods, dev, card):
    """11b: RecurrentGemma-2B at published widths, cut to one period (rec,
    rec, attn), trains at B=1, T=4096 through K7 forward and backward.
    Returns (launches of the counted steps, K7 backward's record parts)."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models import layers as L
    from repro_torch.models import rglru as RG
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import count_params
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig

    full = ARCH_CONFIGS["recurrentgemma-2b"]
    cfg = full.replace(n_layers=len(full.recurrent.block_pattern))
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    params, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    step_fn = TS.make_train_step(cfg, plan)
    src = SyntheticLM(cfg.vocab_size, seed=1)
    batch_fn = lambda i: {k: torch.as_tensor(v, device=dev)  # noqa: E731
                          for k, v in src.batch(i, RG_TRAIN_B, RG_TRAIN_T).items()}
    state = TS.init_train_state(params, plan)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts(mods)
    losses = []
    steps = 2
    t0 = time.perf_counter()
    for i in range(steps):
        state, m = step_fn(state, batch_fn(i))
        losses.append(float(m["loss"]))
        check(np.isfinite(losses[-1]) and float(m["grad_norm"]) > 0,
              f"RecurrentGemma-2B step {i}: loss {losses[-1]}, grad norm "
              f"{float(m['grad_norm'])}")
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(mods)
    peak = torch.cuda.max_memory_allocated(dev)
    # remat "full" checkpoints the period: each rec block's scan runs in the
    # forward and again in the backward's recompute, then its backward.
    want = {**{k: 0 for k in launches}, "rglru_seq": 2 * n_rec * steps,
            "rglru_seq_bwd": n_rec * steps}
    check(launches == want, f"training launched {launches}, not {want}")
    log(f"phase 11b: RecurrentGemma-2B at published widths, cut {full.n_layers} -> "
        f"{cfg.n_layers} layers (one period {cfg.recurrent.block_pattern}; "
        f"{count_params(params)} f32 params): {steps} train steps B={RG_TRAIN_B} "
        f"T={RG_TRAIN_T}, losses {losses}, {wall_s:.3f} s; K7 launches {launches} "
        f"({n_rec} rec blocks x (forward + remat recompute) and one backward "
        f"launch each a step); peak device memory {peak / 2**30:.3f} GiB on {card}")
    del m
    sp = step_profile(step_fn, state, batch_fn, 2, warm=0)
    log(f"phase 11b: a train step (remat {cfg.remat}): " + step_clocks(sp, card))
    log(sp["avgs"].table(sort_by="self_device_time_total", row_limit=10))
    del state, sp

    # K7's backward against the plain recurrence's autograd, on layer 0's
    # scan inputs.
    tokens = batch_fn(0)["tokens"]
    with torch.no_grad():
        la, b = (x.contiguous() for x in layer0_scan_inputs(T, L, RG, params, cfg,
                                                            tokens))
    del params
    torch.cuda.empty_cache()
    dh = torch.randn(b.shape, generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    la_g, b_g = la.clone().requires_grad_(True), b.clone().requires_grad_(True)
    before = dict(rg.LAUNCHES)
    got = torch.autograd.grad(rg.rglru_seq_grad(la_g, b_g), (la_g, b_g), dh)
    torch.cuda.synchronize()
    check(rg.LAUNCHES["rglru_seq_bwd"] == before["rglru_seq_bwd"] + 1,
          "the backward did not launch K7 once")
    la_p, b_p = la.clone().requires_grad_(True), b.clone().requires_grad_(True)
    want = torch.autograd.grad(rg.rglru_seq_plain(la_p, b_p), (la_p, b_p), dh)
    errs = []
    for what, g, w in zip(("dlog_a", "db"), got, want):
        scale = float(w.abs().max())
        errs.append(close_err(g, w, 1e-5 * scale, 1e-5, f"K7 backward {what}"))
    log(f"phase 11b: K7's backward on layer 0's {tuple(b.shape)} scan inputs "
        f"against the plain recurrence's autograd: max |err| dlog_a {errs[0]}, "
        f"db {errs[1]} (1e-5 relative + 1e-5 of the largest value)")

    # The backward's launch alone, on its flipped operands; the whole
    # Function backward beside the plain autograd backward.
    la_next = torch.cat([torch.zeros_like(la[:1]), la.flip(0)[:-1]])
    dhf = dh.flip(0).contiguous()
    check(rg.tile_route_fits(la_next, dhf), "K7's backward misses the tile route")
    # Timed over BWD_SETS copies of its operands in turn: one launch moves
    # 126 MB, so the others' traffic clears the 50 MB L2 between a set's
    # launches and each launch reads its inputs from HBM.
    sets = [(la_next.clone(), dhf.clone()) for _ in range(BWD_SETS)]

    def kern():
        for a, d in sets:
            rg._launch(a, d, counter="rglru_seq_bwd")
    h = rg.rglru_seq_grad(la_g, b_g)
    fn_bwd_ms = cuda_ms(lambda: torch.autograd.grad(h, (la_g, b_g), dh,
                                                    retain_graph=True), 20)
    hp = rg.rglru_seq_plain(la_p, b_p)
    plain_bwd_ms = cuda_ms(lambda: torch.autograd.grad(hp, (la_p, b_p), dh,
                                                       retain_graph=True), 2)
    log(f"phase 11b: K7 Function backward (flips, one launch, dlog_a pass) "
        f"{fn_bwd_ms:.6f} ms; the plain recurrence's autograd backward "
        f"{plain_bwd_ms:.6f} ms on {card}")
    n = dhf.numel()
    return launches, dict(
        name="rglru_seq_bwd", replaces="src/repro/kernels/rglru_scan.py:48",
        source="src/repro_torch/csrc/rglru_scan.cu", symbol=("rglru_tile_kernel",),
        counter="rglru_seq_bwd", err=max(errs), plain_iters=3, kern=kern,
        per_call=BWD_SETS,
        plain=lambda: rg.rglru_seq_plain(la_next, dhf),
        # read la and dh, write g; one exp, one multiply, one add per element
        bound=bound(3 * 4 * n, 3 * n, FP32_OPS_PER_S),
        extra=dict(function_backward_ms=fn_bwd_ms,
                   plain_autograd_backward_ms=plain_bwd_ms))


def wkv_chunked_check(dev):
    """RWKV-6's chunked wkv across four chunks at rwkv6-7b's head widths
    (64 x 64), decays summing past exp's f32 range within a chunk, a state
    carried in: output, final state and every input's gradient against
    the sequential recurrence's autograd, to 2e-4 of the largest value
    (f32 sums over a chunk in another order)."""
    from repro_torch.models import rwkv6 as RW
    g = torch.Generator(device=dev).manual_seed(5)
    shape = (1, 512, 64, 64)
    r, k, v = (torch.randn(shape, generator=g, device=dev) for _ in range(3))
    w = 0.5 * torch.randn(shape, generator=g, device=dev)
    u = torch.randn(shape[2:], generator=g, device=dev)
    s0 = torch.randn((1, 64, 64, 64), generator=g, device=dev)
    runs = []
    for fn in (RW.wkv_chunked, RW.wkv_sequential):
        ins = [a.clone().requires_grad_(True) for a in (r, k, v, w, u, s0)]
        y, st = fn(*ins)
        runs.append([y, st, *torch.autograd.grad(y.square().sum() + st.sum(), ins)])
    errs = {}
    for name, got, want in zip(("y", "state", "dr", "dk", "dv", "dw", "du", "ds0"),
                               *runs):
        scale = float(want.detach().abs().max())
        errs[name] = close_err(got.detach(), want.detach(), 2e-4 * scale, 0,
                               f"wkv_chunked {name}") / scale
    log(f"phase 11c: wkv_chunked {shape} over 4 chunks against wkv_sequential's "
        f"autograd, max |err| / max |value|: {errs} (tolerance 2e-4)")


def phase11_families(mods, dev, card):
    """11c: one ``make_train_step`` per other arch at published widths
    (phase 10c's depth cut; the MoE archs at one layer): finite loss and a
    gradient norm above 0; w8a8 fake-quant on qwen2-vl, hard activations on
    gemma2, int8 compression with two microbatches on rwkv6, whose step
    runs S=512 (four wkv chunks) after a check of the chunked wkv."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.models import transformer as T
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig

    variants = {"gemma2-2b": (dict(hard_acts=True), {}),
                "qwen2-vl-2b": (dict(quant=QuantConfig("w8a8")), {}),
                "rwkv6-7b": ({}, dict(grad_compress="int8", microbatches=2))}
    b = 2
    for arch, layers in TRAIN_CUT.items():
        t0 = time.perf_counter()
        s = TRAIN_SEQ.get(arch, 128)
        if arch == "rwkv6-7b":
            wkv_chunked_check(dev)
        cfg_kw, plan_kw = variants.get(arch, ({}, {}))
        cfg = ARCH_CONFIGS[arch].replace(n_layers=layers, **cfg_kw)
        params, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
        plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10),
                            **plan_kw)
        state = TS.init_train_state(params, plan)
        del params
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 SyntheticLM(cfg.vocab_size, seed=2).batch(0, b, s).items()}
        if cfg.attn and cfg.attn.mrope_sections:
            pos = torch.arange(s, device=dev).expand(b, s)
            batch["position_ids"] = torch.stack([pos, pos // 2, pos % 3])
        if not cfg.embed_inputs:
            batch["inputs_embeds"] = torch.randn(
                (b, s, cfg.d_model), generator=torch.Generator(device=dev).manual_seed(3),
                device=dev).to(torch.bfloat16)
            del batch["tokens"]
        reset_counts(mods)
        torch.cuda.reset_peak_memory_stats(dev)
        step_fn = TS.make_train_step(cfg, plan)
        state, m = step_fn(state, batch)
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        peak = torch.cuda.max_memory_allocated(dev)
        check(np.isfinite(loss) and gn > 0, f"{arch}: loss {loss}, grad norm {gn}")
        check(not any(read_counts(mods).values()),
              f"{arch}: training launched {read_counts(mods)}")
        check(("grad_err" in state) == (plan.grad_compress == "int8"),
              f"{arch}: int8 error state")
        log(f"phase 11c: {arch} at published widths, {layers} layer(s) "
            f"{cfg_kw or ''}{plan_kw or ''}: one train step B={b} S={s}, loss "
            f"{loss}, grad norm {gn}, aux {float(m['aux'])}; peak "
            f"{peak / 2**30:.3f} GiB; {time.perf_counter() - t0:.1f} s")
        del state, m, step_fn
        torch.cuda.empty_cache()


def phase11_lstm(train, mods, dev, card):
    """11d: ``launch.train --arch lstm-pems`` on the card: the int path's
    test MSE within the reference's bound (``tests/test_system.py``: below
    twice the QAT MSE, or 0.05), through K1."""
    reset_counts(mods)
    t0 = time.perf_counter()
    out = train.main(["--arch", "lstm-pems", "--steps", "200", "--batch", "64",
                      "--device", dev.type], log=quiet)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = read_counts(mods)
    mse = out["test_mse"]
    check(mse["int8-kernel"] < max(2 * mse["qat"], 0.05),
          f"int path MSE {mse['int8-kernel']} against QAT {mse['qat']}")
    check(launches == {**{k: 0 for k in launches}, "multilayer": 1},
          f"the int evaluation launched {launches}")
    log(f"phase 11d: launch.train.main --arch lstm-pems --steps 200: test MSE "
        f"{mse}; K1 launches {launches['multilayer']}; {wall_s:.1f} s on {card}")
    return launches


def phase11_batcher(session, layer_mods, mods, qm, dev, card):
    """11e: the ``WaveBatcher`` on qwen1.5-0.5B at full width (f32, so that
    the greedy tokens of a slot cannot flip with the batch's GEMM shape):
    six mixed requests at batch 4, each equal to its batch-of-one run; the
    same requests with w8a8 weights, K4 once per quantised linear a step
    (w8a8 quantises each activation per tensor, over the whole wave, so a
    slot's codes depend on its wave and are not held to its batch-of-one
    run); and ``for_accelerator`` on the paper's session (K1), rows equal
    to ``infer(path="int")``.  Returns the launches."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.batcher import WaveBatcher
    from repro_torch.models import transformer as T

    cfg = ARCH_CONFIGS[QWEN].replace(dtype="float32")
    rng = np.random.default_rng(13)
    reqs = [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in ((3, 6), (7, 4), (2, 8), (5, 5), (4, 3), (6, 7))]
    totals = {}

    def run(b, rs):
        rids = [b.submit(p, m) for p, m in rs]
        out = b.run()
        return [out[r] for r in rids]

    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    for quant in (None, "w8a8"):
        t0 = time.perf_counter()
        c, p = cfg, params
        if quant:
            c = cfg.replace(quant=QuantConfig(quant))
            p, _ = T.quantize_model_params(params, axes, c)
        reset_counts(mods)
        with QuantLinearCount(layer_mods) as n_lin:
            got = run(WaveBatcher(p, c, batch_size=4, max_seq=32), reqs)
            torch.cuda.synchronize()
        launches = read_counts(mods)
        check(launches["int32"] == n_lin.n and
              sum(launches.values()) == launches["int32"] and
              (n_lin.n > 0) == bool(quant),
              f"batcher {quant or 'float'}: {n_lin.n} quantised linears, "
              f"launches {launches}")
        batched_s = time.perf_counter() - t0
        check([len(g) for g in got] == [m for _, m in reqs] and
              all(0 <= x < c.vocab_size for g in got for x in g),
              f"batcher {quant or 'float'}: tokens {got}")
        if not quant:
            singles = [run(WaveBatcher(p, c, batch_size=1, max_seq=32), [r])[0]
                       for r in reqs]
            check(got == singles, f"batched slots differ from their "
                  f"batch-of-one runs: {got} vs {singles}")
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v
        log(f"phase 11e: WaveBatcher {QWEN} full width f32 "
            f"{quant or 'float'}, batch 4, 6 requests (2 waves): {batched_s:.2f} s"
            f"{'' if quant else ', each slot equal to its batch-of-one run'}; "
            f"quantised linears "
            f"{n_lin.n} = K4 launches {launches['int32']} on {card}")
        del p
    del params
    torch.cuda.empty_cache()

    windows = np.random.default_rng(14).normal(0, 0.7, (37, 6, 1)).astype(np.float32)
    reset_counts(mods)
    b = WaveBatcher.for_accelerator(session, batch_size=16)
    rids = [b.submit_window(w) for w in windows]
    out = b.run()
    torch.cuda.synchronize()
    launches = read_counts(mods)
    want = session.infer(windows, path="int").cpu().numpy()
    check(all(np.array_equal(out[r], want[i]) for i, r in enumerate(rids)),
          "for_accelerator rows differ from infer(path='int')")
    check(launches["multilayer"] >= 3 and
          sum(launches.values()) == launches["multilayer"],
          f"for_accelerator launched {launches}")
    for k, v in launches.items():
        totals[k] = totals.get(k, 0) + v
    log(f"phase 11e: for_accelerator (batch 16) on 37 windows: rows equal "
        f"infer(path='int'); launches {launches}")
    return totals


# ---------------------------------------------------------------------------
# phase 12: the sharded LM — training under the host mesh (DTensor params,
# the logical-axis rules, K7 through local_map) and resharding checkpoints
# ---------------------------------------------------------------------------

LOSS_RTOL, GNORM_RTOL = 2e-3, 5e-2      # tests/test_distributed.py's bounds


def held(name, got, want):
    """``got`` against ``want``: the run fails beyond the reference's
    distributed bounds (2e-3 relative on the loss, 5e-2 on the gradient
    norm), then on any difference (deterministic algorithms on one card)."""
    for k, rtol in (("loss", LOSS_RTOL), ("grad_norm", GNORM_RTOL)):
        rel = abs(got[k] - want[k]) / max(abs(want[k]), 1e-9)
        check(rel <= rtol, f"{name}: {k} {got[k]} against {want[k]} "
                           f"({rel:.3e} > {rtol})")
        check(got[k] == want[k], f"{name}: {k} {got[k]} != {want[k]} under "
                                 f"deterministic algorithms")


def mesh_train(cfg, mesh, seed, plan, dev):
    """(step_fn, state, shardings) of ``cfg`` on ``mesh``, params from a
    ``torch.Generator`` seeded ``seed`` on ``dev``, laid out by the
    config's rules as ``launch.train`` lays them out."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding import partition as P
    from repro_torch.training import step as TS
    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(seed))
    shard = P.param_shardings(axes, mesh, cfg.sharding_overrides, params)
    state = TS.init_train_state(P.distribute(params, shard), plan)
    return TS.make_train_step(cfg, plan), state, shard


def plain_train(cfg, seed, plan, dev):
    """(step_fn, state) of ``cfg`` with no mesh: plain tensors on ``dev``."""
    from repro_torch.models import transformer as T
    from repro_torch.training import step as TS
    params, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(seed))
    return TS.make_train_step(cfg, plan), TS.init_train_state(params, plan)


def lm_batches(vocab, b, s, seed, dev, mesh=None, overrides=()):
    """A step-keyed ``SyntheticLM`` batch on ``dev``; on ``mesh``, laid
    out by ``launch.train.batch_shardings``."""
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.launch.train import batch_shardings
    from repro_torch.sharding.partition import distribute
    src = SyntheticLM(vocab, seed=seed)

    def fn(i):
        out = {k: torch.as_tensor(v, device=dev)
               for k, v in src.batch(i, b, s).items()}
        if mesh is None:
            return out
        return distribute(out, batch_shardings(out, mesh, overrides))
    return fn


def metrics_of(m):
    return {k: float(m[k]) for k in ("loss", "grad_norm")}


def same_leaves(a, b, what):
    """Every leaf of two train states equal bit for bit (a DTensor's by its
    full tensor)."""
    from repro_torch.training.tree import tree_leaves_with_path
    full = lambda t: t.full_tensor() if hasattr(t, "full_tensor") else t  # noqa: E731
    pa, pb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    check([p for p, _ in pa] == [p for p, _ in pb], f"{what}: the trees differ")
    for (p, x), (_, y) in zip(pa, pb):
        check(torch.equal(full(x), full(y)), f"{what}: {'/'.join(p)} differs")
    return len(pa)


def phase12_qwen(train, mesh, dev, card):
    """12a: qwen1.5-0.5B at full width through ``launch.train.main`` on the
    1 x 1 host mesh (remat full, deterministic algorithms) against the
    unsharded ``make_train_step`` on the same params and batches; then
    a step's wall, device busy, idle share and peak memory without and
    with the mesh, outside deterministic mode."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.sharding.partition import rules_context
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig

    cfg = ARCH_CONFIGS[QWEN]
    steps = 2
    torch.use_deterministic_algorithms(True)
    try:
        out = train.main(TRAIN_ARGV + ["--steps", str(steps), "--remat", "full",
                                       "--log-every", "1"], log=quiet)
        sharded = out["state"]
        check(all(type(x).__name__ == "DTensor"
                  for x in [sharded["params"]["embed"],
                            sharded["opt"]["mu"]["blocks"]["mlp"]["w_up"]]),
              "launch.train's state is not on the mesh")
        # launch.train's plan and batches, with no mesh
        plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=10,
                                          total_steps=steps))
        step_fn, state = plain_train(cfg, 0, plan, dev)
        batch_fn = lm_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, 0, dev)
        for i in range(steps):
            state, m = step_fn(state, batch_fn(i))
            held(f"12a step {i + 1}", {k: out["history"][i][k]
                                       for k in ("loss", "grad_norm")},
                 metrics_of(m))
        n = same_leaves(sharded, state, "12a: the mesh's state")
        log(f"phase 12a: launch.train.main --arch {QWEN} --preset full --batch "
            f"{TRAIN_B} --seq {TRAIN_S} --remat full on the 1 x 1 host mesh ({mesh}): losses "
            f"{[h['loss'] for h in out['history']]}, grad norms "
            f"{[h['grad_norm'] for h in out['history']]}, equal to the unsharded "
            f"step bit for bit, and the {n} leaves of the state after {steps} "
            f"steps (deterministic algorithms)")
        del out, sharded, state, m
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()

    plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=10, total_steps=20))
    reads = {}
    for name in ("unsharded", "mesh"):
        torch.cuda.reset_peak_memory_stats(dev)
        if name.startswith("mesh"):
            with rules_context(mesh, cfg.sharding_overrides):
                step_fn, state, _ = mesh_train(cfg, mesh, 0, plan, dev)
                sp = step_profile(step_fn, state, lm_batches(
                    cfg.vocab_size, TRAIN_B, TRAIN_S, 0, dev, mesh,
                    cfg.sharding_overrides), 2)
        else:
            step_fn, state = plain_train(cfg, 0, plan, dev)
            sp = step_profile(step_fn, state,
                              lm_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, 0, dev), 2)
        peak = torch.cuda.max_memory_allocated(dev)
        reads[name] = (sp["wait_ms"], sp["b2b_ms"], sp["busy_ms"], peak)
        log(f"phase 12a: {QWEN} B={TRAIN_B} S={TRAIN_S} remat full, {name}: "
            + step_clocks(sp, card) + f"; peak device memory {peak / 2**30:.3f} GiB")
        if name == "mesh":
            log(sp["avgs"].table(sort_by="self_cpu_time_total", row_limit=8))
        del step_fn, state, sp
        torch.cuda.empty_cache()
    ratio = reads["mesh"][0] / reads["unsharded"][0]
    log(f"phase 12a: the 1 x 1 mesh's step waited for is {ratio:.4f} x the "
        f"unsharded step's, its device busy {reads['mesh'][2]:.6f} against "
        f"{reads['unsharded'][2]:.6f} ms, on {card}")
    return ratio


def phase12_rgemma(mesh, mods, dev, card):
    """12b: RecurrentGemma-2B's period at B=1, T=4096 on the 1 x 1 mesh:
    K7's forward, remat recompute and backward on the local shards through
    ``local_map``, counted; loss and gradient norm equal to the unsharded
    step's (deterministic algorithms).  Returns the mesh step's launches."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.sharding.partition import rules_context
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig

    full = ARCH_CONFIGS["recurrentgemma-2b"]
    cfg = full.replace(n_layers=len(full.recurrent.block_pattern))
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    torch.use_deterministic_algorithms(True)
    try:
        step_fn, state = plain_train(cfg, 0, plan, dev)
        _, m = step_fn(state, lm_batches(cfg.vocab_size, RG_TRAIN_B, RG_TRAIN_T,
                                         1, dev)(0))
        want = metrics_of(m)
        del step_fn, state, m
        torch.cuda.empty_cache()
        with rules_context(mesh, cfg.sharding_overrides):
            step_fn, state, _ = mesh_train(cfg, mesh, 0, plan, dev)
            batch = lm_batches(cfg.vocab_size, RG_TRAIN_B, RG_TRAIN_T, 1, dev,
                               mesh, cfg.sharding_overrides)(0)
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts(mods)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, m = step_fn(state, batch)
            got = metrics_of(m)
            wall_ms = (time.perf_counter() - t0) * 1e3
            launches = read_counts(mods)
        peak = torch.cuda.max_memory_allocated(dev)
        del step_fn, state, m, batch
    finally:
        torch.use_deterministic_algorithms(False)
    torch.cuda.empty_cache()
    expect = {**{k: 0 for k in launches}, "rglru_seq": 2 * n_rec,
              "rglru_seq_bwd": n_rec}
    check(launches == expect, f"the mesh step launched {launches}, not {expect}")
    held("12b", got, want)
    log(f"phase 12b: RecurrentGemma-2B's period ({cfg.n_layers} layers) B={RG_TRAIN_B} "
        f"T={RG_TRAIN_T} on the 1 x 1 mesh: loss {got['loss']}, grad norm "
        f"{got['grad_norm']}, equal to the unsharded step bit for bit; K7 through "
        f"local_map {launches} ({n_rec} rec blocks x forward + remat recompute, "
        f"one backward each); the step {wall_ms:.3f} ms wall waited for (its "
        f"first, deterministic algorithms), peak device memory "
        f"{peak / 2**30:.3f} GiB on {card}")
    return launches


def phase12_checkpoint(mesh, dev, card):
    """12c: qwen1.5-0.5B at full width cut to 2 layers on the mesh: a state
    saved after one step restores into a freshly initialised state through
    ``restore(..., shardings=)`` bit for bit, and one resumed step equals
    the step never interrupted (deterministic algorithms)."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.sharding.partition import rules_context
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig

    cfg = ARCH_CONFIGS[QWEN].replace(n_layers=2)
    plan = TS.TrainPlan(opt=OptConfig(lr=3e-4, warmup_steps=1, total_steps=10))
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_mesh_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    torch.use_deterministic_algorithms(True)
    try:
        with rules_context(mesh, cfg.sharding_overrides):
            step_fn, state, shard = mesh_train(cfg, mesh, 0, plan, dev)
            batch_fn = lm_batches(cfg.vocab_size, TRAIN_B, TRAIN_S, 2, dev, mesh,
                                  cfg.sharding_overrides)
            state, _ = step_fn(state, batch_fn(0))
            t0 = time.perf_counter()
            ckpt.save(str(root), state, 1)
            save_s = time.perf_counter() - t0
            straight, m_straight = step_fn(state, batch_fn(1))
            _, fresh, _ = mesh_train(cfg, mesh, 99, plan, dev)
            t0 = time.perf_counter()
            restored = ckpt.restore(str(root), fresh, shardings={
                "params": shard, "opt": {"mu": shard, "nu": shard}})
            restore_s = time.perf_counter() - t0
            n = same_leaves(restored, state, "12c: the restored state")
            check(all(type(x).__name__ == "DTensor" for x in
                      [restored["params"]["embed"], restored["opt"]["nu"]["embed"]]),
                  "12c: the restored state is not on the mesh")
            resumed, m_resumed = step_fn(restored, batch_fn(1))
            held("12c resumed step", metrics_of(m_resumed), metrics_of(m_straight))
            same_leaves(resumed, straight, "12c: the resumed step's state")
        del state, straight, fresh, restored, resumed
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log(f"phase 12c: {QWEN} full width, 2 layers, on the mesh: saved after a "
        f"step ({save_s:.3f} s), restored with shardings= into a state drawn "
        f"from another seed ({restore_s:.3f} s), {n} leaves bit for bit; the "
        f"resumed step equals the straight one bit for bit (loss "
        f"{float(m_resumed['loss'])}) on {card}")


# ---------------------------------------------------------------------------
# phase 13: prefill and decode on the host mesh (K4 and K7 through local_map),
# the dry run against the card, the production dry-run cells and the port's
# quickstart
# ---------------------------------------------------------------------------

SERVE_B, SERVE_S, SERVE_STEPS = 4, 2048, 4   # decode batch, cache depth, steps
# 13d: production cells of the dry run, each run as the CLI runs it
SWEEP_CELLS = (("qwen1.5-0.5b", "train_4k"), ("recurrentgemma-2b", "long_500k"),
               ("qwen1.5-0.5b", "long_500k"),
               ("mixtral-8x7b", "decode_32k", "--quant-serve", "--multi-pod"))
SWEEP_STATUS = ("ok", "ok", "skipped", "ok")     # the reference's long_500k rule
ROOT = Path(__file__).resolve().parent
DRYRUN_DIR = ROOT / "build" / "chip_smoke_dryrun"
# 13c: the dry run's cells on a one-rank fake world at 13a's shapes, in a
# child process (a fake process group cannot share this one's)
DRYRUN_CHILD = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
D.make_production_mesh = lambda *, multi_pod=False, device_type="cpu": \
    DeviceMesh(device_type, torch.arange(1).reshape(1, 1),
               mesh_dim_names=("data", "model"))
recs = [D.run_cell(arch, ShapeSpec(*spec), False)
        for arch, spec in json.loads(sys.argv[1])]
dist.destroy_process_group()
print(json.dumps(recs))
"""
DRY_FLOPS_RTOL, DRY_PEAK_RTOL = 0.01, 0.25


def child_env():
    """The environment of a CPU-only child process of the port."""
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
                OMP_NUM_THREADS="1")


def start_sweep():
    """13d's cells, one CPU process each, all started at once: they need no
    card and run beside phases 11-13.  Returns [(cell, process, record
    path)]."""
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    DRYRUN_DIR.mkdir(parents=True)
    procs = []
    for i, cell in enumerate(SWEEP_CELLS):
        out = DRYRUN_DIR / f"cell{i}.json"
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               cell[0], "--shape", cell[1], *cell[2:], "--out", str(out)]
        with open(out.with_suffix(".log"), "w") as f:
            procs.append((cell, subprocess.Popen(
                cmd, env=child_env(), cwd=ROOT, stdout=f,
                stderr=subprocess.STDOUT), out))
    return procs


def mesh_batch(batch, mesh, cfg):
    """A model batch on ``mesh`` (``launch.train.batch_shardings``);
    ``cache_pos`` stays a Python int."""
    from repro_torch.launch.train import batch_shardings
    from repro_torch.sharding.partition import distribute
    t = {k: v for k, v in batch.items() if k != "cache_pos"}
    out = distribute(t, batch_shardings(t, mesh, cfg.sharding_overrides))
    if "cache_pos" in batch:
        out["cache_pos"] = batch["cache_pos"]
    return out


def full(t):
    check(type(t).__name__ == "DTensor", f"a mesh result is a plain {type(t)}")
    return t.full_tensor()


def filled_cache(T, cfg, dev, seed):
    """``T.init_cache(cfg, SERVE_B, SERVE_S)`` filled from a seeded
    generator: bf16 KV in N(0, 1), int8 codes in [-127, 127] with scales in
    [0.001, 0.021)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}
    for k, v in T.init_cache(cfg, SERVE_B, SERVE_S, device=dev).items():
        if v.dtype == torch.int8:
            v = torch.randint(-127, 128, v.shape, generator=gen, device=dev,
                              dtype=torch.int8)
        elif k.endswith("_scale"):
            v = torch.rand(v.shape, generator=gen, device=dev) * 0.02 + 0.001
        else:
            v = torch.randn(v.shape, generator=gen, device=dev).to(v.dtype)
        out[k] = v
    return out


def phase13_qwen(mesh, mods, layer_mods, dev, card):
    """13a: qwen1.5-0.5B at full width on the 1 x 1 mesh: the bf16 prefill
    at B=1, T=2048, then SERVE_STEPS decode steps at batch SERVE_B against
    a SERVE_S-deep cache, float and w8a8 with the int8 KV cache; every
    result equal to the unsharded step's bit for bit, K4 once per
    quantised linear of a w8a8 step, each through ``local_map``.  Returns
    the mesh runs' launches and the steps' walls."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.serve import cache_shardings
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import (distribute, param_shardings,
                                                rules_context)
    from repro_torch.training.step import make_decode_step

    cfg = ARCH_CONFIGS[QWEN]
    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(13)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, QWEN_T)), device=dev)
    total = {}
    with torch.no_grad():
        want = T.forward_prefill(params, {"tokens": tokens}, cfg)
        with rules_context(mesh, cfg.sharding_overrides):
            sp = distribute(params, param_shardings(axes, mesh,
                                                   cfg.sharding_overrides, params))
            got = full(T.forward_prefill(sp, mesh_batch({"tokens": tokens}, mesh,
                                                        cfg), cfg))
        check(torch.equal(got, want), "13a: the mesh prefill's logits differ")
        log(f"phase 13a: {QWEN} forward_prefill B=1 T={QWEN_T} bf16 on the 1 x 1 "
            f"mesh: logits equal the unsharded prefill's bit for bit")
        del sp, got, want
        walls = {}
        for mode, quant in (("float", None),
                            ("w8a8", QuantConfig("w8a8", quantize_kv=True))):
            c = cfg if quant is None else cfg.replace(quant=quant)
            p, a = (params, axes) if quant is None else \
                T.quantize_model_params(params, axes, c)
            cache = filled_cache(T, c, dev, 13)
            toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_B, 1)),
                                   device=dev)
            runs = {}
            for where in ("unsharded", "mesh"):
                ctx = (rules_context(mesh, c.sharding_overrides) if where == "mesh"
                       else contextlib.nullcontext())
                with ctx:
                    if where == "mesh":
                        pp = distribute(p, param_shardings(a, mesh,
                                                          c.sharding_overrides, p))
                        ch = distribute(cache, cache_shardings(c, SERVE_B, SERVE_S,
                                                              mesh))
                    else:
                        pp, ch = p, cache
                    tk, out, ms = toks, [], []
                    for i in range(SERVE_STEPS):
                        batch = {"tokens": tk, "cache_pos": SERVE_S - SERVE_STEPS + i}
                        if where == "mesh":
                            batch = mesh_batch(batch, mesh, c)
                        calls = []
                        real = L._local_int8_matmul

                        def counting(*args):
                            calls.append(1)
                            return real(*args)
                        L._local_int8_matmul = counting
                        reset_counts(mods)
                        try:
                            with QuantLinearCount(layer_mods) as n_lin:
                                torch.cuda.synchronize()
                                t0 = time.perf_counter()
                                logits, ch = T.forward_decode(pp, ch, batch, c)
                                torch.cuda.synchronize()
                                ms.append((time.perf_counter() - t0) * 1e3)
                        finally:
                            L._local_int8_matmul = real
                        launches = read_counts(mods)
                        lg = full(logits) if where == "mesh" else logits
                        tk = lg[:, -1].argmax(-1, keepdim=True)
                        out.append((lg, tk))
                        k4 = n_lin.n if quant is not None else 0
                        check(launches == {**{k: 0 for k in launches}, "int32": k4},
                              f"13a {mode} {where} step {i}: launches {launches}, "
                              f"{n_lin.n} quantised linears")
                        check(len(calls) == (k4 if where == "mesh" else 0),
                              f"13a {mode} {where}: {len(calls)} int8 products "
                              f"through local_map, {k4} quantised linears")
                        if where == "mesh":
                            for k, v in launches.items():
                                total[k] = total.get(k, 0) + v
                    if where == "mesh":
                        tok_step, _ = make_decode_step(c)(pp, ch, batch)
                        check(torch.equal(full(tok_step)[:, None], tk),
                              f"13a {mode}: make_decode_step's tokens differ")
                    runs[where] = (out, ms, k4)
                    del pp, ch
            for i, ((lu, tu), (lm_, tm)) in enumerate(zip(runs["unsharded"][0],
                                                          runs["mesh"][0])):
                check(torch.equal(lu, lm_) and torch.equal(tu, tm),
                      f"13a {mode} decode step {i}: the mesh differs from the "
                      f"unsharded step")
            walls[mode] = {w: r[1] for w, r in runs.items()}
            log(f"phase 13a: {QWEN} {mode} decode, batch {SERVE_B}, a {SERVE_S}-deep "
                f"cache, {SERVE_STEPS} steps: logits and tokens equal the unsharded "
                f"steps' bit for bit; K4 {runs['mesh'][2]} launches a step through "
                f"local_map; step walls (ms) unsharded {walls[mode]['unsharded']}, "
                f"mesh {walls[mode]['mesh']}; the mesh's mean over steps 2-"
                f"{SERVE_STEPS} is {np.mean(walls[mode]['mesh'][1:]) / np.mean(walls[mode]['unsharded'][1:]):.4f}"
                f" x the unsharded's on {card}")
            del p, a, cache, runs
            torch.cuda.empty_cache()
    del params
    torch.cuda.empty_cache()
    return total, walls


def phase13_rgemma(mesh, mods, ref6, dev, card):
    """13b: RecurrentGemma-2B at full width on the 1 x 1 mesh: the prefill
    at B=2, T=4096 with K7 once per rec layer through ``local_map``, then
    LM_DECODE steps of phase 6's bf16 prompt decode; each result equal to
    phase 6's unsharded one bit for bit.  Returns the launches."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.launch.serve import cache_shardings
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import (distribute, param_shardings,
                                                rules_context)

    cfg = ARCH_CONFIGS["recurrentgemma-2b"]
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    tokens = torch.as_tensor(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (LM_BATCH, LM_PREFILL)), device=dev)   # phase 2's
    prompt = ref6["prompt"]
    check(torch.equal(tokens[:, :prompt.shape[1]], prompt), "13b: another prompt")
    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    with torch.no_grad(), rules_context(mesh, cfg.sharding_overrides):
        sp = distribute(params, param_shardings(axes, mesh, cfg.sharding_overrides,
                                               params))
        reset_counts(mods)
        t0 = time.perf_counter()
        logits = full(T.forward_prefill(sp, mesh_batch({"tokens": tokens}, mesh,
                                                       cfg), cfg))
        torch.cuda.synchronize()
        pre_ms = (time.perf_counter() - t0) * 1e3
        launches = read_counts(mods)
        check(launches == {**{k: 0 for k in launches}, "rglru_seq": n_rec},
              f"13b: the mesh prefill launched {launches}, not K7 {n_rec} times")
        check(torch.equal(logits, ref6["prefill"]),
              "13b: the mesh prefill differs from phase 6's")
        b, t_len = prompt.shape
        cache = distribute(T.init_cache(cfg, b, t_len, device=dev),
                          cache_shardings(cfg, b, t_len, mesh))
        reset_counts(mods)
        for t, want in enumerate(ref6["decode"]):
            lg, cache = T.forward_decode(sp, cache, mesh_batch(
                {"tokens": prompt[:, t:t + 1], "cache_pos": t}, mesh, cfg), cfg)
            check(torch.equal(full(lg), want),
                  f"13b: mesh decode step {t} differs from phase 6's")
        dec = read_counts(mods)
        check(not any(dec.values()), f"13b: decode launched {dec}")
    log(f"phase 13b: RecurrentGemma-2B forward_prefill B={LM_BATCH} T={LM_PREFILL} "
        f"on the 1 x 1 mesh ({pre_ms:.3f} ms wall, its first): K7 through "
        f"local_map {launches['rglru_seq']} times, logits equal phase 6's bit for "
        f"bit; {len(ref6['decode'])} decode steps of phase 6's prompt equal its "
        f"bf16 decode's bit for bit, on {card}")
    del params, sp, cache, logits
    torch.cuda.empty_cache()
    return launches


def card_step_reads(step, args, arg_tensors, dev):
    """FLOPs (``FlopCounterMode``) and peak device bytes of ``step(*args)``
    on the card with its arguments resident: ``max_memory_allocated`` over
    the step, less what else the card held before it."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad():
        with FlopCounterMode(display=False) as fc:
            step(*args)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        arg_bytes = sum(t.untyped_storage().nbytes() for t in
                        {id(t): t for t in arg_tensors}.values())
        other = torch.cuda.memory_allocated(dev) - arg_bytes
        torch.cuda.reset_peak_memory_stats(dev)
        out = step(*args)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - other
    del out
    return float(fc.get_total_flops()), peak / 2**30


def phase13_dryrun(dev, card):
    """13c: the dry run's qwen1.5-0.5B float prefill (B=1, T=2048) and float
    decode (batch SERVE_B, a SERVE_S-deep cache) on a one-rank fake world
    (a child process), against the same steps on the card: FLOPs within
    DRY_FLOPS_RTOL of ``FlopCounterMode`` over the card's run and the peak
    within DRY_PEAK_RTOL of the card's."""
    from repro_torch.configs import ARCH_CONFIGS
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import cast_tree
    from repro_torch.training.step import make_decode_step, make_prefill_step
    from repro_torch.training.tree import tree_leaves

    cells = [(QWEN, ["prefill_2k", "prefill", QWEN_T, 1]),
             (QWEN, ["decode_2k", "decode", SERVE_S, SERVE_B])]
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-c", DRYRUN_CHILD, json.dumps(cells)],
                         env=child_env(), cwd=ROOT, capture_output=True, text=True,
                         timeout=600)
    check(res.returncode == 0, f"13c: the dry run failed:\n{res.stderr[-3000:]}")
    recs = json.loads(res.stdout.strip().splitlines()[-1])
    child_s = time.perf_counter() - t0

    cfg = ARCH_CONFIGS[QWEN]
    master, _ = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    params = cast_tree(master, torch.bfloat16)     # the dry run's serve cast
    del master
    torch.cuda.empty_cache()
    rng = np.random.default_rng(14)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (1, QWEN_T)),
                             dtype=torch.int32, device=dev)
    cache = T.init_cache(cfg, SERVE_B, SERVE_S, device=dev)
    dec_tok = torch.as_tensor(rng.integers(0, cfg.vocab_size, (SERVE_B, 1)),
                              dtype=torch.int32, device=dev)
    reads = {
        "prefill_2k": card_step_reads(
            make_prefill_step(cfg), (params, {"tokens": tokens}),
            tree_leaves(params) + [tokens], dev),
        "decode_2k": card_step_reads(
            make_decode_step(cfg), (params, cache, {"tokens": dec_tok,
                                                    "cache_pos": SERVE_S - 1}),
            tree_leaves(params) + list(cache.values()) + [dec_tok], dev)}
    del params, cache
    torch.cuda.empty_cache()
    for rec in recs:
        check(rec["status"] == "ok" and rec["modelled"], f"13c: {rec}")
        flops, peak = reads[rec["shape"]]
        mem = rec["memory"]
        f_err = abs(rec["flops_global"] - flops) / flops
        p_err = abs(mem["peak_undonated_gb"] - peak) / peak
        log(f"phase 13c: {QWEN} {rec['shape']} (modelled, {rec['device_model']}, "
            f"1 x 1 fake world): flops_global {rec['flops_global']:.6e} against "
            f"FlopCounterMode on the card {flops:.6e} ({f_err:.3e}); peak "
            f"{mem['peak_undonated_gb']:.6f} GiB undonated (the record's peak_gb "
            f"{mem['peak_gb']:.6f} after its donated alias {mem['alias_gb']:.6f}) "
            f"against the card's {peak:.6f} GiB ({p_err:.4f}); trace_s "
            f"{rec['trace_s']} on {card}")
        check(f_err <= DRY_FLOPS_RTOL, f"13c {rec['shape']}: FLOPs {f_err:.3e} off")
        check(p_err <= DRY_PEAK_RTOL, f"13c {rec['shape']}: peak {p_err:.4f} off")
    log(f"phase 13c: the dry run's child process took {child_s:.1f} s")
    return recs


def finish_sweep(procs, card):
    """13d: wait for the production cells; each exits 0 with its status as
    the reference's rule says, and ``analysis.report`` renders them."""
    from repro_torch.analysis.report import dryrun_table, roofline_table
    recs = []
    for (cell, proc, out), want in zip(procs, SWEEP_STATUS):
        proc.wait(timeout=900)
        rec = json.loads(out.read_text())[-1] if out.exists() else {}
        check(proc.returncode == 0, f"13d {' '.join(cell)} exited "
              f"{proc.returncode}:\n{out.with_suffix('.log').read_text()[-2000:]}"
              f"\n{rec.get('traceback', '')}")
        check(rec["status"] == want and rec.get("modelled") is True,
              f"13d {' '.join(cell)}: {rec.get('status')} ({rec.get('error', '')})")
        recs.append(rec)
        log(f"phase 13d: dryrun {' '.join(cell)}: {rec['status']} on "
            f"{rec['mesh']}, trace_s {rec.get('trace_s', '-')}" + (
                f", flops/device {rec['flops_per_device']:.6e}, peak "
                f"{rec['memory']['peak_gb']:.6f} GiB, collectives "
                f"{rec['collectives']['total']:.6e} B, bound "
                f"{rec['roofline']['bound']} (modelled, {rec['device_model']})"
                if rec["status"] == "ok" else f" ({rec['reason']})"))
    for mesh in ("16x16", "2x16x16"):
        log(dryrun_table(recs, mesh))
    log(roofline_table(recs))
    return recs


def phase13_quickstart(mods, card):
    """13e: ``examples/torch/quickstart.py`` on the card: its run, with
    K1's launches counted."""
    import runpy
    reset_counts(mods)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / "torch" / "quickstart.py"),
                       run_name="__main__")
    launches = read_counts(mods)
    text = buf.getvalue()
    check(launches["multilayer"] > 0, f"13e: the quickstart launched {launches}")
    check("bit-identical = False" not in text and "bit-identical = True" in text,
          f"13e: the quickstart's engines differ:\n{text[-2000:]}")
    for line in text.strip().splitlines():
        log("  " + line)
    log(f"phase 13e: examples/torch/quickstart.py on {card}: launches {launches}")
    return launches


def phase13(mesh, mods, layer_mods, ref6, procs, dev, card):
    """Phase 13 on phase 12's mesh; 13d's CPU processes (``procs``, started
    by :func:`start_sweep`) have run since phase 11.  Returns the launches
    of 13a, 13b and 13e."""
    t0 = time.perf_counter()
    total = {}
    for name, part in (
            ("13a", lambda: phase13_qwen(mesh, mods, layer_mods, dev, card)[0]),
            ("13b", lambda: phase13_rgemma(mesh, mods, ref6, dev, card)),
            ("13c", lambda: phase13_dryrun(dev, card) and {}),
            ("13e", lambda: phase13_quickstart(mods, card)),
            ("13d", lambda: finish_sweep(procs, card) and {})):
        t1 = time.perf_counter()
        for k, v in part().items():
            total[k] = total.get(k, 0) + v
        torch.cuda.empty_cache()
        log(f"phase {name}: done in {time.perf_counter() - t1:.1f} s")
    log(f"phase 13: done in {time.perf_counter() - t0:.1f} s; launches {total}")
    return total


def stop(procs):
    for _, proc, _ in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def kernel_record(sp, launches, card):
    """One kernel's entry of the ``{"kernels": [...]}`` record from its spec
    (``kern``, ``plain`` and optional ``library``/``earlier`` callables, its
    ``bound``, the profiler ``symbol``s of its CUDA kernels): ``ms`` the
    device time of the wrapper's work (graph replay), ``call_ms`` one eager
    call as Python issues it, ``kernel_ms`` the CUDA kernel alone (the
    profiler), ``plain_ms`` and ``library_ms``."""
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")  # noqa: E731
    kern, (b_ms, b_by) = sp["kern"], sp["bound"]
    per = sp.get("per_call", 1)                # launches in one kern() call
    ms, call_ms = graph_ms(kern, 500) / per, cuda_ms(kern, 500) / per
    plain_ms = cuda_ms(sp["plain"], sp.get("plain_iters", 20))
    avgs, _ = profile(kern, 50)
    part_us = {sym: sum(device_us(e) for e in avgs
                        if is_cuda(e) and sym in e.key) / 50 / per
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
    rec = {
        "name": sp["name"], "route": "cuda", "source": sp["source"],
        "replaces": sp["replaces"], "launches": launches,
        "max_abs_err": sp["err"], "ms": ms, "plain_ms": plain_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
        "counter": sp["counter"], "call_ms": call_ms,
        "kernel_ms": k_us / 1e3 if k_us else None, **sp.get("extra", {})}
    log(f"phase 5: {sp['name']}: {ms:.6f} ms device (eager call {call_ms:.6f} ms, "
        f"kernel alone {k_us / 1e3:.6f} ms, plain {plain_ms:.6f} ms, library "
        f"{'none' if lib_ms is None else f'{lib_ms:.6f} ms'}, bound "
        f"{b_ms:.6f} ms by {b_by}) on {card}")
    if "earlier" in sp:
        fn, sym = sp["earlier"]
        e_avgs, _ = profile(fn, 50)
        e_ms = sum(device_us(e) for e in e_avgs if is_cuda(e) and sym in e.key) / 50e3
        rec.update(earlier_kernel_ms=e_ms, earlier_ms=graph_ms(fn, 500))
        log(f"phase 5: {sp['name']}: earlier design ({sym}) on the same inputs: "
            f"kernel alone {e_ms:.6f} ms, {rec['earlier_ms']:.6f} ms "
            f"device; now {k_us / 1e3 / e_ms:.4f} of it on {card}")
    return rec


def main() -> int:
    # phase 11a's bit-exact restart runs under deterministic algorithms,
    # which need cuBLAS's workspace fixed before CUDA initialises
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    if sys.argv[1:] == ["lfm2"]:
        phase14_lfm2(dev, card)
        return 0

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
        lm_launches, phase6_ref = phase_lm(lm, serve, mods, lm_params, lm_cfg,
                                           lm_tokens, dev)
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

    # -- phase 9: the explorer, serving GOP/s/W and board power --------------
    t0 = time.perf_counter()
    explore_launches = phase9(repro_torch, session, mods, qc, qm, ha, fxp,
                              lstm_ops, dev, card)
    log(f"phase 9: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{explore_launches}")

    # -- phase 10: the LM side's dense, MoE, RWKV-6, VLM and audio families --
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import moe as lm_moe
    from repro_torch.models import rwkv6 as lm_rwkv6
    layer_mods = (lm_layers, lm_moe, lm_rwkv6, lm_rglru)
    log(f"phase 10: {threading.active_count()} Python threads alive at its start: "
        f"{sorted(t.name for t in threading.enumerate())}")
    t0 = time.perf_counter()
    lm10_launches = {}
    with torch.inference_mode():
        for part in (
                lambda: phase10_qwen(lm, ARCH_CONFIGS, serve, mods, dev, card),
                lambda: phase10_k4(lm, ARCH_CONFIGS, QuantConfig, layer_mods, qm,
                                   mods, dev, card),
                lambda: phase10_families(lm, ARCH_CONFIGS, QuantConfig, mods, dev,
                                         card)):
            got = part()
            if isinstance(got, tuple):
                got, k4_rows = got
            for k, v in got.items():
                lm10_launches[k] = lm10_launches.get(k, 0) + v
            torch.cuda.empty_cache()
    log(f"phase 10: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{lm10_launches}")

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
                + explore_launches.get(k, 0) + lm10_launches.get(k, 0)
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
    kernels = [kernel_record(sp, launches[sp["counter"]], card) for sp in specs]
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")  # noqa: E731
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
    k4 = next(k for k in kernels if k["name"] == "quant_matmul_int32")
    k4.update({f"{name}_shape": row for name, row in k4_rows.items()})
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

    # One serving wave's datapath both ways: eager (the ids on the device)
    # and replayed from the CUDA graph the serving tier captures (x and the
    # ids as host arrays, staged by the engine); bit for bit.
    slot_fn = session.compiled_stateful_slots()
    xw = xs[:64, 0]
    routes = {"eager": (xw, table, g, s),
              "graph": (xw, table, g.cpu().numpy(), s.cpu().numpy())}
    y_eager, t_eager = slot_fn(*routes["eager"])
    for _ in range(2):                       # the capture, then a replay
        y_graph, t_graph = slot_fn(*routes["graph"])
        check(torch.equal(y_graph, y_eager.cpu()) and torch.equal(t_graph, t_eager),
              "the graph path differs from the eager one")
    for route, args in routes.items():
        avgs, wall_ms = profile(lambda args=args: slot_fn(*args)[0].cpu(), 20)
        busy_ms = sum(device_us(e) for e in avgs if is_cuda(e)) / 20 / 1e3
        log(f"phase 5: one serving wave's datapath, {route} (quantize, slot "
            f"kernel, dense head, copy back; batch 64): {wall_ms / 20:.6f} ms "
            f"wall, {busy_ms:.6f} ms device busy, idle share "
            f"{1 - busy_ms / (wall_ms / 20):.4f} on {card}")
        log(avgs.table(sort_by="cpu_time_total", row_limit=14))
    log(f"phase 5: the slot path's graphs {slot_fn.stats()}; graph and eager "
        f"equal bit for bit (y and table)")

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
    log(f"phase 5: StreamServer warm: {warm['waves']} waves, per-window latency "
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
            f"wall), per-window p50 {cw['latency_ms']['p50']:.6f} ms p99 "
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

    # -- phase 11: LM training, the training launcher, the wave batcher -------
    from repro_torch.launch import mesh as lm_mesh
    from repro_torch.launch import train as lm_train
    del lm_params, cache, k7_in, lm_tokens, logits, tok
    torch.cuda.empty_cache()
    # launch.train trains under the host mesh: its one-rank NCCL group is
    # opened here on card 0 and destroyed before the result lines
    torch.cuda.set_device(0)
    lm_mesh.ensure_process_group("cuda")
    try:
        kernels = phases_11_to_13(lm_mesh, lm_train, kernels, rg, mods, session,
                                  layer_mods, qm, phase6_ref, dev, card)
    finally:
        torch.distributed.destroy_process_group()

    torch.cuda.empty_cache()
    phase14_lfm2(dev, card)

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def phase14_lfm2(dev, card):
    """Phase 14 (the module docstring): LFM2-8B-A1B on the card."""
    from perfbench.reference import lfm2 as R
    from perfbench.systems import lfm2_sessions
    from repro_torch.launch import serve
    from repro_torch.models import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.serving import SessionServer
    t_phase = time.perf_counter()
    # the benchmark's configuration file (the published keys, which the
    # reference reads) and its weights, drawn as its cell draws them
    hf = json.loads((ROOT / "perfbench/configs/lfm2-8b-a1b.json").read_text())
    cfg = lfm2_sessions.model_config(hf)
    rel = lambda a, b: float((a.float() - b.float()).norm() / b.float().norm())
    # (a) grouped expert products against one product per expert
    gen = torch.Generator(device=dev).manual_seed(1)
    m = cfg.moe
    wg, wu = (torch.randn((m.num_experts, cfg.d_model, m.d_ff), generator=gen,
                          device=dev, dtype=torch.bfloat16) * cfg.d_model ** -0.5
              for _ in range(2))
    wd = torch.randn((m.num_experts, m.d_ff, cfg.d_model), generator=gen,
                     device=dev, dtype=torch.bfloat16) * m.d_ff ** -0.5
    counts = torch.bincount(torch.randint(0, m.num_experts, (4 * 4096,),
                                          generator=gen, device=dev),
                            minlength=m.num_experts)
    counts[3] = 0
    xs = torch.randn((int(counts.sum()), cfg.d_model), generator=gen,
                     device=dev, dtype=torch.bfloat16)
    act = torch.nn.functional.silu
    got = MOE.expert_products(xs, counts, wg, wu, wd, act)
    want = MOE.expert_products(xs.float(), counts, wg.float(), wu.float(),
                               wd.float(), act)
    log(f"phase 14: MoE products over {len(xs)} claims: grouped products' "
        f"relative gap to f32 per-expert products "
        f"{rel(got, want):.3e}; grouped {cuda_ms(lambda: MOE.expert_products(xs, counts, wg, wu, wd, act), 20):.4f} ms on {card}")
    check(rel(got, want) < 2e-2, "grouped expert products disagree")
    del wg, wu, wd, xs, got, want
    # (b)-(c) prefill, ragged extend chunks and decode against the reference
    R.exact()
    params = lfm2_sessions.make_weights(hf, 0, dev)["params"]
    rng = np.random.default_rng(14)
    seqs = [rng.integers(0, cfg.vocab_size, n) for n in (2048, 1300, 4051)]
    with torch.inference_mode():
        lp = T.forward_prefill(params, {"tokens": torch.as_tensor(
            seqs[0][None], device=dev)}, cfg)[0, 0]
        lr = R.forward(hf, params, seqs[0], [2047], dev)[0]
        e_pre = rel(lp, lr)
        table = T.init_cache(cfg, 3, 8192, device=dev)
        cut = [(1000, 300, 4000), (1048, 1000, 51)]
        at = [0, 0, 0]
        for chunk in cut:
            toks = np.concatenate([s[a:a + n] for s, a, n in zip(seqs, at, chunk)])
            logits = T.forward_extend(params, table, {
                "tokens": torch.as_tensor(toks, device=dev), "rows": [0, 1, 2],
                "starts": at, "lens": list(chunk)}, cfg)
            at = [a + n for a, n in zip(at, chunk)]
        e_ext = [rel(logits[r], R.forward(hf, params, s[:a], [a - 1], dev)[0])
                 for r, (s, a) in enumerate(zip(seqs, at))]
        check(at == [2048, 1300, 4051], f"extend chunks end at {at}")
        step = 4051
        for _ in range(4):
            nxt = rng.integers(0, cfg.vocab_size, 3)
            seqs = [np.r_[s[:step if r == 2 else len(s)], t]
                    for r, (s, t) in enumerate(zip(seqs, nxt))]
            # rows 0 and 1 stop at their extend lengths; decode runs at row
            # 2's position, so rows 0/1 are checked through extend above
            logits, table = T.forward_decode(params, table, {
                "tokens": torch.as_tensor(nxt[:, None], device=dev),
                "cache_pos": step}, cfg)
            step += 1
        e_dec = rel(logits[2, 0], R.forward(hf, params, seqs[2], [step - 1],
                                            dev)[0])
    log(f"phase 14: LFM2-8B-A1B bf16 against the f32 reference (extend's "
        f"packed flash route), relative L2 gap of the last logits: prefill T=2048 {e_pre:.4e}; extend chunks "
        f"{cut} {[f'{e:.4e}' for e in e_ext]}; after 4 decode steps at "
        f"4051.. {e_dec:.4e} on {card}")
    check(max(e_pre, e_dec, *e_ext) < 0.25, "LFM2 disagrees with its reference")
    del table, logits
    torch.cuda.empty_cache()
    # (d) waves of 32 turns through the session server
    srv = SessionServer(params, cfg, max_sessions=32, max_positions=8192,
                        batch=32, deadline_s=0.02, device=dev)
    hist = [rng.integers(0, cfg.vocab_size, int(n))
            for n in rng.integers(512, 4097, 32)]
    for s, h in enumerate(hist):
        srv.submit(s, h)
    srv.flush()
    srv.poll()
    srv.restart_numbering()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    waves = 8
    for _ in range(waves):
        for s in range(32):
            srv.submit(s, rng.integers(0, cfg.vocab_size, int(np.rint(
                np.exp(rng.uniform(np.log(32), np.log(512)))))))
        srv.flush()
    wall = time.perf_counter() - t0
    c = srv.counters()
    srv.close()
    log(f"phase 14: SessionServer, {waves} waves of 32 turns ({c['tokens']} "
        f"tokens, contexts from 512-4096): {1e3 * wall / waves:.2f} ms a wave "
        f"back to back, {c['tokens'] / wall:.0f} tokens/s, {32 * waves / wall:.1f} "
        f"turns/s; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB on {card}")
    del srv, params
    torch.cuda.empty_cache()
    # (e) decode through the cache, the serving launcher
    toks, tps, lines = run_serve(serve, ["--arch", "lfm2-8b-a1b", "--preset",
                                         "full", "--gen", "8"])
    log(f"phase 14: {lines[-2]} on {card}")
    check(np.isfinite(toks).all(), "serve --arch lfm2-8b-a1b")
    log(f"phase 14: done in {time.perf_counter() - t_phase:.1f} s")


def phases_11_to_13(lm_mesh, lm_train, kernels, rg, mods, session, layer_mods,
                    qm, ref6, dev, card):
    """Phases 11 to 13 in the host mesh's process group, with 13d's CPU
    processes running from phase 11's start; returns the kernel records
    with their launches counted."""
    procs = start_sweep()
    try:
        return phases_11_to_13_run(lm_mesh, lm_train, kernels, rg, mods, session,
                                   layer_mods, qm, ref6, procs, dev, card)
    finally:
        stop(procs)


def phases_11_to_13_run(lm_mesh, lm_train, kernels, rg, mods, session,
                        layer_mods, qm, ref6, procs, dev, card):
    t0 = time.perf_counter()
    lm11_launches = {}
    for name, part in (
            ("11a", lambda: phase11_qwen(lm_train, mods, dev, card)),
            ("11b", lambda: phase11_rgemma(rg, mods, dev, card)),
            ("11c", lambda: phase11_families(mods, dev, card)),
            ("11d", lambda: phase11_lstm(lm_train, mods, dev, card)),
            ("11e", lambda: phase11_batcher(session, layer_mods, mods, qm, dev,
                                            card))):
        t1 = time.perf_counter()
        got = part()
        if name == "11b":
            got, bwd_spec = got
        for k, v in (got or {}).items():
            lm11_launches[k] = lm11_launches.get(k, 0) + v
        torch.cuda.empty_cache()
        log(f"phase {name}: done in {time.perf_counter() - t1:.1f} s")
    log(f"phase 11: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{lm11_launches}")

    # -- phase 12: the sharded LM on the host mesh ----------------------------
    t0 = time.perf_counter()
    mesh = lm_mesh.make_host_mesh()
    check(tuple(mesh.mesh_dim_names) == ("data", "model")
          and tuple(mesh.shape) == (1, 1), f"the host mesh is {mesh}")
    lm12_launches = {}
    for name, part in (
            ("12a", lambda: phase12_qwen(lm_train, mesh, dev, card)),
            ("12b", lambda: phase12_rgemma(mesh, mods, dev, card)),
            ("12c", lambda: phase12_checkpoint(mesh, dev, card))):
        t1 = time.perf_counter()
        got = part()
        if name == "12b":
            lm12_launches = got
        torch.cuda.empty_cache()
        log(f"phase {name}: done in {time.perf_counter() - t1:.1f} s")
    log(f"phase 12: done in {time.perf_counter() - t0:.1f} s; launches "
        f"{lm12_launches}")

    # -- phase 13: prefill and decode on the mesh, the dry run, the examples --
    lm13_launches = phase13(mesh, mods, layer_mods, ref6, procs, dev, card)
    for k in kernels:
        k["launches"] += (lm11_launches.get(k["counter"], 0)
                          + lm12_launches.get(k["counter"], 0)
                          + lm13_launches.get(k["counter"], 0))
    kernels.append(kernel_record(bwd_spec, lm11_launches["rglru_seq_bwd"]
                                 + lm12_launches["rglru_seq_bwd"], card))
    return kernels


if __name__ == "__main__":
    sys.exit(main())
