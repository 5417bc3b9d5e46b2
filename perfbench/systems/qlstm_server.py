"""``qlstm_server``: the paper's quantised LSTM served by
``repro_torch.serving.StreamServer``; a configuration's file in, a warm
server out.

A configuration file that names this system (``"system":
"qlstm_server"``) gives the model (``QLSTMConfig``), the accelerator
(``AcceleratorConfig``), the plan it must resolve to (``expect_plan``)
and how the float master weights are drawn (``weights``).  The weights
are drawn from the seed on the run's device and handed both to the
program and to the reference.

A system module's interface is listed in ``perfbench/README.md``; this
one gives all of it: the requests (``payload``: the PeMS-like windows of
``perfbench/traffic.py``, and ``answer_width``), the server's lifetime
counters, the spans around its layers and the fault hook, and for the
readers of K3's roofline and the whole step's share of the peak
``dims``, ``fmt_bits`` and ``ops_per_window``.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from perfbench import counts
from perfbench.traffic import Windows

# The host spans ``instrument`` records, in the order an idle gap of the
# device is put down to them (first match wins); ``DATAPATH`` is the
# guarded datapath, which a whole trace sees once for each wave counted.
DATAPATH = "server.datapath"
SPANS = (DATAPATH, "server.execute", "server.assemble")
# The kernel every datapath call launches and waits for: K3, replayed
# from the wave's CUDA graph (a whole trace holds one a datapath span).
WAVE_KERNEL = "qlstm_rows_kernel"


def dims(cfg: Dict) -> Tuple[int, int, int, int, int]:
    """(M, H, L, T, P) of a configuration."""
    m = cfg["model"]
    return (m["input_size"], m["hidden_size"], m["num_layers"], m["seq_len"],
            m["out_features"])


def fmt_bits(cfg: Dict) -> Tuple[int, int]:
    """The configuration's fixed-point format ``(a, b)``."""
    a, b = cfg["accelerator"]["fxp"]
    return int(a), int(b)


def ops_per_window(cfg: Dict) -> int:
    """The paper's operations for one window (``counts.ops_per_window``)."""
    return counts.ops_per_window(*dims(cfg))


def payload(cfg: Dict, mix, seed: int) -> Windows:
    """The windows a run sends: window ``k`` of each of the mix's
    streams, (T, M) float32, drawn from the seed."""
    m, _, _, t, _ = dims(cfg)
    return Windows(seed, mix.streams, t, m)


def answer_width(cfg: Dict) -> int:
    """Floats in one answer: the dense head's P."""
    return dims(cfg)[4]


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Float32 master weights drawn in one call from a generator on
    ``device`` seeded with ``seed``: weights uniform in +-``scale``,
    biases uniform in +-``bias_scale`` with the forget gate's raised by
    ``forget_bias``."""
    m, h, layers, _, p = dims(cfg)
    if layers != 1:
        raise ValueError("the reference runs one LSTM layer")
    w = cfg["weights"]
    shapes = {"w_x": (m, 4 * h), "w_h": (h, 4 * h), "b": (4 * h,),
              "w_d": (h, p), "b_d": (p,)}
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.rand(sum(sizes), generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        scale = w["scale"] if name.startswith("w") else w["bias_scale"]
        out[name] = (u[at:at + size] * scale).reshape(shape).cpu().numpy()
        at += size
    out["b"][h:2 * h] += np.float32(w["forget_bias"])
    return out


def quantised_session(cfg: Dict, weights: Dict[str, np.ndarray], device):
    """The quantised session on ``device``; raises when its plan is not
    the one the configuration expects."""
    import repro_torch
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.core.qlstm import ActivationConfig, QLSTMConfig

    mc, ac = cfg["model"], cfg["accelerator"]
    acts = ActivationConfig(gate=mc["gate"], cell=mc["cell_act"],
                            hs_slope_shift=mc["hs_slope_shift"],
                            hs_bound=mc["hs_bound"])
    model = QLSTMConfig(input_size=mc["input_size"],
                        hidden_size=mc["hidden_size"],
                        num_layers=mc["num_layers"],
                        out_features=mc["out_features"],
                        seq_len=mc["seq_len"], acts=acts)
    a, b = fmt_bits(cfg)
    accel = AcceleratorConfig(
        compute_unit=ac["compute_unit"], weight_memory=ac["weight_memory"],
        hs_method=ac["hs_method"], ht_min=ac["ht_min"], ht_max=ac["ht_max"],
        alu_mode=ac["alu_mode"], fxp=FixedPointConfig(a, b),
        backend=ac["backend"])
    t = lambda k: torch.as_tensor(weights[k], device=device)
    params = {"layers": [{"w_x": t("w_x"), "w_h": t("w_h"), "b": t("b")}],
              "dense": {"w": t("w_d"), "b": t("b_d")}}
    session = repro_torch.build(model, accel, params=params,
                                device=device).quantize()
    for key, want in cfg["expect_plan"].items():
        if session.plan[key] != want:
            raise RuntimeError(f"plan[{key!r}] is {session.plan[key]!r}, "
                               f"the configuration expects {want!r}")
    return session


def build_server(cfg: Dict, weights: Dict[str, np.ndarray], mix, device):
    """The quantised session and its ``StreamServer`` (``max_streams`` =
    the mix's streams); raises when the plan or the carry's placement is
    not the one the configuration expects."""
    from repro_torch.serving import StreamServer

    session = quantised_session(cfg, weights, device)
    server = StreamServer(session, batch=mix.batch, deadline_s=mix.deadline_s,
                          max_streams=mix.streams)
    if server.state_residency != cfg["expect_plan"]["state_residency"]:
        server.close(abandon=True)
        raise RuntimeError(f"the server keeps carries on the "
                           f"{server.state_residency}, the configuration "
                           f"expects {cfg['expect_plan']['state_residency']}")
    return session, server


def warm(server, mix, cfg: Dict, device) -> None:
    """One full and one partial wave through the datapath, then every
    stream and counter reset: the window starts from zero carries on a
    warm server."""
    m, _, _, t, _ = dims(cfg)
    rows = min(mix.batch, mix.streams)
    x = np.full((t, m), 0.5, np.float32)
    for wave, n in enumerate((rows, max(1, rows // 2))):
        for i in range(n):
            server.submit(("warm", wave, i), x)
        server.drain(timeout=120)
    server.reset_streams()
    server.reset_metrics()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def counters(server) -> Dict:
    """The serving layer's lifetime counters (``MetricsSink.snapshot``):
    waves, windows, padded wave slots, deadline flushes and the waves'
    summed host time (s)."""
    snap = server.metrics.snapshot()
    return {"waves": snap["n_waves"], "samples": snap["n_samples"],
            "padded_slots": snap["n_padded_slots"],
            "deadline_flushes": snap["n_deadline_flushes"],
            "compute_s_total": snap["compute_s_total"]}


def instrument(spans, server) -> None:
    """Spans around the compute thread's wave (``server.execute``), the
    assembler's wave (``server.assemble``) and the guarded datapath
    within a wave (``DATAPATH``), by the server's own method names: a
    program that renames one fails the run at set-up."""
    spans.wrap(server._sched, "_execute", "server.execute")
    spans.wrap(server._sched, "_build_wave", "server.assemble")
    spans.wrap(server.guard, "run", DATAPATH)


def inject(server, fault) -> None:
    """Break the timed path underneath: every datapath callable of every
    session on the server's ladder is replaced by ``fault(fn)``."""
    server._fns = [[(n, fault(fn)) for n, fn in per] for per in server._fns]
