#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/csrc`` and drives the
port's main path — ``build`` -> ``quantize`` -> ``infer(path="int")`` and
a stateful ``StreamServer`` — at the full width of the paper's model
(``QLSTMConfig()``: M=1, H=20, L=1, T=6, (4,8) codes), in phases:

  1. the card, torch/CUDA versions and the kernel build time;
  2. every kernel against its plain torch version on the card, bit for
     bit (tolerance 0), across (4,8)/(6,8)/(8,16)/(8,24), arithmetic/step,
     mxu/vpu, 1-3 layers, batches of 1, 37 and 256, weights in shared
     and in device memory, and slot permutations with ZERO/TRASH rows;
  3. ``infer`` on 256 windows through the fused kernel, equal to the
     ``ref`` engine, with the stack kernel's launch count read;
  4. a ``StreamServer`` (batch 64, device-resident state) serving 128
     streams x 6 windows, each stream equal to its stateful ``ref`` run
     and to one concatenated run, one slot-kernel launch per wave, no
     degradation, and no plain engine below the kernel on its ladder;
  5. CUDA-event timings of each kernel and its plain version at the
     shapes of phases 3 and 4, and the server's per-wave latency.

Any failure raises and exits non-zero.  The second-to-last line of
output is the ``{"kernels": [...]}`` record, the last one
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
rest of the repository beside it, the script exits non-zero and prints
no result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): device memory 3.35 TB/s; int8
# tensor-core rate 1,979 TOP/s, the card's peak for 8-bit integer codes.
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12


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


def phase2_kernels_vs_plain(qc, fxp, dev):
    """Each kernel against its plain version on the card; returns the
    largest absolute difference seen per kernel (must be 0)."""
    rng = np.random.default_rng(0)
    errs = {"multilayer": 0, "seq": 0, "slot": 0}
    n = 0
    for a, b in ((4, 8), (6, 8), (8, 16), (8, 24)):   # (8,24): int32 codes
        cfg = fxp.FixedPointConfig(a, b)
        for method in ("arithmetic", "step"):
            for unit in ("mxu", "vpu"):
                for L in (1, 2, 3):
                    for B in (1, 37, 256):
                        x, wxs, whs, bs, h0s, c0s = rand_stack(
                            rng, 6, B, 1, 20, L, cfg, dev)
                        kw = dict(cfg=cfg, hs_method=method, compute_unit=unit)
                        want, wstate = qc.qlstm_seq_multilayer_plain(
                            x, wxs, whs, bs, h0s, c0s, **kw)
                        got, state = qc.qlstm_seq_multilayer(
                            x, wxs, whs, bs, h0s, c0s, **kw)
                        torch.cuda.synchronize()
                        errs["multilayer"] = max(
                            errs["multilayer"], max_err(got, want),
                            *(max_err(p, q) for s1, s2 in zip(state, wstate)
                              for p, q in zip(s1, s2)))
                        g_out, g_h, g_c, args = qc._launch(
                            x, wxs, whs, bs, h0s=h0s, c0s=c0s, batch_block=None,
                            hs_slope_shift=3, hs_bound=3.0, ht_min=-1.0,
                            ht_max=1.0, weights_in_smem=False, cfg=cfg,
                            hs_method=method)
                        torch.cuda.synchronize()
                        check(args.w_smem == 0, "device-memory weights path not taken")
                        errs["multilayer"] = max(
                            errs["multilayer"], max_err(g_out, want),
                            *(max_err(g_h[li], wstate[li][0]) for li in range(L)),
                            *(max_err(g_c[li], wstate[li][1]) for li in range(L)))
                        if L == 1:
                            o1, (h1, c1) = qc.qlstm_seq(
                                x, wxs[0], whs[0], bs[0], h0=h0s[0], c0=c0s[0],
                                return_state=True, **kw)
                            p1, (ph, pc) = qc.qlstm_seq_plain(
                                x, wxs[0], whs[0], bs[0], h0=h0s[0], c0=c0s[0],
                                return_state=True, **kw)
                            torch.cuda.synchronize()
                            errs["seq"] = max(errs["seq"], max_err(o1, p1),
                                              max_err(h1, ph), max_err(c1, pc))
                        rows = 2 * B + 2
                        table = torch.as_tensor(
                            rng.integers(-90, 90, (rows, L, 2, 20)),
                            dtype=torch.int32, device=dev)
                        table[rows - 2] = 0
                        g = torch.as_tensor(rng.permutation(2 * B)[:B],
                                            dtype=torch.int32, device=dev)
                        s = torch.as_tensor(rng.permutation(2 * B)[:B],
                                            dtype=torch.int32, device=dev)
                        g[0], s[-1] = rows - 2, rows - 1      # ZERO gather, TRASH scatter
                        got, new_table = qc.qlstm_seq_slot(x, g, s, table, wxs,
                                                           whs, bs, **kw)
                        torch.cuda.synchronize()
                        want, want_table = qc.qlstm_seq_slot_plain(
                            x, g, s, table, wxs, whs, bs, **kw)
                        errs["slot"] = max(errs["slot"], max_err(got, want),
                                           max_err(new_table, want_table))
                        check(not new_table[rows - 2].any(), "ZERO row written")
                        check(torch.equal(new_table[rows - 1], table[rows - 1]),
                              "TRASH row written")
                        n += 1
    for name, e in errs.items():
        check(e == 0, f"kernel {name} differs from its plain version by {e}")
    return errs, n


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch
    from repro_torch.core import fixed_point as fxp
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.qlstm import QLSTMConfig, lstm_ops
    from repro_torch.kernels import _build
    from repro_torch.kernels import qlstm_cell as qc
    from repro_torch.serving import StreamServer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()

    # -- phase 1: card, versions, build ------------------------------------
    t0 = time.perf_counter()
    qc.load_library()
    build_s = time.perf_counter() - t0
    log(f"phase 1: card: {card} | torch {torch.__version__} CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} | "
        f"kernel build+load {build_s:.3f} s")
    ptxas = _build.library_path("qlstm_cell").with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())

    # -- phase 2: kernels vs plain versions --------------------------------
    t0 = time.perf_counter()
    errs, n_cases = phase2_kernels_vs_plain(qc, fxp, dev)
    log(f"phase 2: {n_cases} cases, max |kernel - plain| = {errs} "
        f"(tolerance 0) in {time.perf_counter() - t0:.1f} s")

    # -- phase 3: the session at full width --------------------------------
    model = QLSTMConfig()
    session = repro_torch.build(model, AcceleratorConfig(), seed=0).quantize()
    check(session.plan["backend"] == "pallas", f"plan {session.plan['backend']}")
    check(session.plan["state_residency"] == "device", "residency not device")
    rng = np.random.default_rng(1)
    x = (rng.normal(0.0, 1.0, (256, model.seq_len, model.input_size)) * 0.7
         ).astype(np.float32)
    for k in qc.LAUNCHES:
        qc.LAUNCHES[k] = 0
    y = session.infer(x, path="int")
    torch.cuda.synchronize()
    infer_launches = dict(qc.LAUNCHES)
    check(infer_launches == {"multilayer": 1, "seq": 0, "slot": 0},
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
    for k in qc.LAUNCHES:
        qc.LAUNCHES[k] = 0
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
    serve_launches = dict(qc.LAUNCHES)
    check(len(rows) == n_streams * n_windows, f"{len(rows)} results")
    check(all(r.ok and r.backend == "pallas" and not r.state_reset for r in rows),
          "a result failed, reset or ran off the fused engine")
    check(summary["faults"]["degradations"] == 0, "the server degraded")
    check(serve_launches["slot"] == summary["waves"] and
          serve_launches["multilayer"] == serve_launches["seq"] == 0,
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

    # -- phase 5: timings ----------------------------------------------------
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

    def bound(nbytes, ops):
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / INT8_OPS_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")

    state_bytes = lambda b: 2 * L * b * H * 4
    k1_bytes = x3.numel() + w_bytes + 2 * state_bytes(256) + T * 256 * H
    k3_bytes = (x4.numel() + w_bytes + 2 * 64 * 4 + 2 * table.numel() * 4
                + T * 64 * H)
    specs = [
        ("qlstm_seq_multilayer", "src/repro/kernels/qlstm_cell.py:348",
         "multilayer", infer_launches["multilayer"] + serve_launches["multilayer"],
         errs["multilayer"],
         lambda: qc.qlstm_seq_multilayer(x3, wxs, whs, bs, zeros, zeros, **kw),
         lambda: qc.qlstm_seq_multilayer_plain(x3, wxs, whs, bs, zeros, zeros, **kw),
         bound(k1_bytes, lstm_ops(model) * 256)),
        # K2 is K1's kernel at one layer behind the ``qlstm_seq`` entry;
        # infer and the server do not call that entry, so its main-path
        # count is 0 and phase 2 is its check.
        ("qlstm_seq", "src/repro/kernels/qlstm_cell.py:305",
         "seq", infer_launches["seq"] + serve_launches["seq"],
         errs["seq"],
         lambda: qc.qlstm_seq(x3, wxs[0], whs[0], bs[0], h0=zeros[0], c0=zeros[0],
                              return_state=True, **kw),
         lambda: qc.qlstm_seq_plain(x3, wxs[0], whs[0], bs[0], h0=zeros[0],
                                    c0=zeros[0], return_state=True, **kw),
         bound(k1_bytes, lstm_ops(model) * 256)),
        ("qlstm_seq_slot", "src/repro/kernels/qlstm_cell.py:401",
         "slot", infer_launches["slot"] + serve_launches["slot"], errs["slot"],
         lambda: qc.qlstm_seq_slot(x4, g, s, table, wxs, whs, bs, **kw),
         lambda: qc.qlstm_seq_slot_plain(x4, g, s, table, wxs, whs, bs, **kw),
         bound(k3_bytes, lstm_ops(model) * 64)),
    ]
    is_cuda = lambda e: str(e.device_type).endswith("CUDA")
    kernels = []
    for name, replaces, counter, launches, err, kern, plain, (b_ms, b_by) in specs:
        # ms: device time of the wrapper's work (graph replay); call_ms:
        # one eager call as Python issues it; kernel_ms: the CUDA kernel
        # alone, from the profiler.
        ms, call_ms = graph_ms(kern, 500), cuda_ms(kern, 500)
        plain_ms = cuda_ms(plain, 20)
        avgs, _ = profile(kern, 50)
        k_us = sum(device_us(e) for e in avgs
                   if is_cuda(e) and "qlstm_stack_kernel" in e.key) / 50
        kernels.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/qlstm_cell.cu",
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "counter": counter, "call_ms": call_ms,
            "kernel_ms": k_us / 1e3 if k_us else None})
        log(f"phase 5: {name}: {ms:.6f} ms device (eager call {call_ms:.6f} ms, "
            f"kernel alone {k_us / 1e3:.6f} ms, plain {plain_ms:.6f} ms, bound "
            f"{b_ms:.6f} ms by {b_by}) on {card}")

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

    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
