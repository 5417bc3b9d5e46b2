"""Real-time LSTM inference through the PyTorch port — the paper's
deployment scenario (§6: 32,873 samples/s on the XC7S15 at 204 MHz) — in
both serving forms, on the CUDA card unless ``--device cpu``.

Part 1 streams windows through ``Accelerator.serve`` (stateless
fixed-size waves) and reports samples/s with the energy model's GOP/s and
GOP/s/W.  Part 2 is the production form: named sensor streams
multiplexed through ``repro_torch.serving.StreamServer``, each stream's
LSTM (h, c) carried across its windows (the slot kernel, K3, on the
card), so a prediction sees the stream's whole history.

Run:  PYTHONPATH=src python examples/torch/serve_lstm_realtime.py [--device cpu]
"""
import argparse
import time

import numpy as np

import repro_torch
from repro_torch.core.accelerator import PAPER_DEFAULT, PAPER_NO_MXU
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.data.timeseries import pems_like_dataset
from repro_torch.serving import StreamServer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--waves", type=int, default=20)
    args = ap.parse_args(argv)

    cfg = QLSTMConfig()
    data = pems_like_dataset(seq_len=cfg.seq_len)
    x, y = data["test"]

    acc = repro_torch.build(cfg, PAPER_DEFAULT, seed=0, device=args.device)
    acc.train_qat(data, steps=args.steps, log_every=100).quantize()

    batch = 256
    # Whole waves only, within the test set: no final-wave padding in the clock.
    n = (min(batch * args.waves, len(x)) // batch) * batch
    next(acc.serve(iter(x[:batch]), batch=batch))       # warm-up wave

    t0 = time.perf_counter()
    preds = list(acc.serve(iter(x[:n]), batch=batch))
    dt = time.perf_counter() - t0
    sps = len(preds) / dt
    ops = acc.report()["ops_per_inference"]
    print(f"[serve] {len(preds)} samples in {dt:.2f}s = {sps:,.0f} samples/s "
          f"on {acc.device} (paper: 32,873 samples/s on FPGA)")
    print(f"[serve] equivalent GOP/s at this rate: {sps * ops / 1e9:.3f}")
    print(f"[serve] stream MSE vs targets: "
          f"{float(np.mean((np.stack(preds) - y[:n]) ** 2)):.5f}")

    for name, accel in [("mxu", PAPER_DEFAULT), ("vpu", PAPER_NO_MXU)]:
        # the energy model at the paper's rate (modelled, core/energy.py)
        rep = repro_torch.build(cfg, accel, device=args.device).report(
            latency_s=batch / 32873.0, batch=batch)["energy"]
        print(f"[energy/{name}] GOP/s/W={rep['gops_per_watt']:.2f} "
              f"total_W={rep['total_w']:.1f} (modelled; paper: 11.89 GOP/s/W)")

    # --- Part 2: multiplexed STATEFUL streams --------------------------------
    # 16 sensors, 8 windows each; every sensor's (h, c) carries across its
    # windows, so window k sees the sensor's whole history.
    n_streams, n_windows = 16, 8
    with StreamServer(acc, batch=n_streams, deadline_s=0.02,
                      max_streams=n_streams) as server:
        server.submit("warmup", x[0])          # first wave outside the clock
        server.drain()
        server.end_stream("warmup")
        server.reset_metrics()
        for w in range(n_windows):
            for s in range(n_streams):
                server.submit(f"sensor-{s}", x[(s * n_windows + w) % len(x)])
        server.drain()
        m = server.metrics_summary()
    print(f"[stream] {m['samples']} windows over {n_streams} stateful streams: "
          f"{m['samples_per_s']:,.0f} samples/s, "
          f"p50/p95/p99 = {m['latency_ms']['p50']:.1f}/"
          f"{m['latency_ms']['p95']:.1f}/{m['latency_ms']['p99']:.1f} ms")
    print(f"[stream] occupancy {m['mean_occupancy']:.1f}/{m['batch']}, "
          f"deadline flushes {m['deadline_flushes']}, "
          f"evictions {m['state']['evictions']}, "
          f"GOP/s/W at measured point {m['gops_per_watt']:.2e} (modelled)")
    return m


if __name__ == "__main__":
    main()
