"""Run one cell of the benchmark once and print its result line.

``python3 perfbench/run.py --workload <name> --seed <n> --seconds <s>
--trace <0|1>``, from the root of a checkout.  Everything a cell needs
is found by name from ``BENCHMARK.json``: its configuration file, the
modules the configuration names (``"system"``: ``perfbench/systems/
<name>.py``, which builds the system under test and makes its requests;
``"reference"``: ``perfbench/reference/<name>.py``, the plain
reference), its traffic mix (``perfbench/traffic/<mix>.json``) and the
arrival process the mix names (``perfbench/arrivals/<name>.py``), and a
reader for each of its metrics (``perfbench/metrics/<metric>.py``, or
the file of the part of the name before its first dot).  A run:

1. builds the system from the configuration with weights drawn from the
   seed, starts its server and warms it, and draws the requests from the
   seed (set-up, timed as ``setup_s``);
2. drives the mix through ``submit``/``poll`` for ``--seconds``
   (the measured window), and with ``--trace 1`` for a further traced
   sub-window under the profiler (made again, up to ``TRACE_TRIES``
   times, while the trace is not whole);
3. stops sending, waits for every answer (up to a minute), reads the
   peak device memory and closes the server;
4. runs the plain reference over every request sent and compares each
   answer with it (``perfbench/compare.py``), and adds the numbers the
   system compares itself (its optional ``checks``);
5. prints the comparison's numbers beside their limits on standard
   error, and one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import re
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from perfbench import compare
from perfbench.client import OpenLoop
from perfbench.trace import Profiler, Spans, TraceResult
from perfbench.traffic import Mix

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRAIN_S = 60.0
TRACE_S = 1.0
TRACE_TRIES = 3
# A submit that takes longer than this was held back (backpressure).
SUBMIT_HELD_S = 0.005


class Spec:
    """``BENCHMARK.json`` and the files it names, under ``root``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def mix(self, name: str, system=None, **overrides) -> Mix:
        """The traffic mix ``name``, with any field replaced by
        ``overrides`` (the knee sweep's rates), checked against the
        parameters its arrival process reads and those the ``system``
        module's requests read (its ``PARAMS``, where it has them)."""
        path = self.root / "perfbench" / "traffic" / f"{name}.json"
        mix = Mix.from_dict(name, {**json.loads(path.read_text()),
                                   **overrides})
        arrivals = set(self.module("arrivals", mix.arrivals).PARAMS)
        requests = set(getattr(system, "PARAMS", ()))
        if set(mix.params) != arrivals | requests:
            raise ValueError(
                f"traffic {name}: arrivals {mix.arrivals!r} reads "
                f"{sorted(arrivals)} and the system's requests read "
                f"{sorted(requests)}, the mix gives {sorted(mix.params)}")
        return mix

    def module(self, kind: str, name: str):
        """``perfbench/<kind>/<name>.py``, loaded from this root (``kind``:
        ``systems``, ``reference``, ``arrivals`` or ``metrics``)."""
        if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name):
            raise ValueError(f"not a module name: {name!r}")
        path = self.root / "perfbench" / kind / f"{name}.py"
        if not path.is_file():
            raise KeyError(f"no {kind} module {name!r} ({path})")
        key = re.sub(r"\W", "_", f"perfbench_{kind}_{name}")
        spec = importlib.util.spec_from_file_location(key, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def metrics(self, workload: str, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        metrics (``trace`` true): those that list it, or list no cell."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The module that reads ``metric``: ``metrics/<name>.py``, else
        ``metrics/<name up to its first dot>.py``."""
        base = self.root / "perfbench" / "metrics"
        if not (base / f"{metric}.py").is_file():
            metric = metric.split(".")[0]
        return self.module("metrics", metric)


class Run:
    """What one run saw, for the metric readers.

    Window rows (one per window sent, in sending order): ``stream``,
    ``k``, ``due``, ``sub`` (``submit`` called), ``ret`` (it returned)
    and ``done`` (result polled; NaN if none), all on the host clock;
    ``ok``: answered without error.  The measured window is ``[t0,
    t1)``; ``counters`` are the server's lifetime counters (the system's
    ``counters``) read at ``t1``; ``trace`` the traced sub-window
    (``--trace 1``), with ``trace_counters`` read at its ends.
    ``dims``, ``bits`` and ``ops_per_window`` are the system's, or None
    where it does not give them; ``program_sink`` the program's stage
    record as the system's ``sink`` gives it, read once the server has
    closed (None: ``program_record.py``'s own pick)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def due_in_window(self) -> np.ndarray:
        return (self.due >= self.t0) & (self.due < self.t1)

    def done_between(self, a: float, b: float) -> int:
        return int(np.count_nonzero(self.ok & (self.done >= a)
                                    & (self.done < b)))


class GcPauses:
    """The interpreter's garbage collections, ``(generation, start,
    end)`` on the host clock, recorded while installed."""

    def __init__(self):
        self.events: List = []
        self._t = 0.0

    def _cb(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.events.append((info["generation"], self._t,
                                time.perf_counter()))

    def __enter__(self) -> "GcPauses":
        gc.callbacks.append(self._cb)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self._cb)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             *, device: str = "cuda", root: Path = ROOT,
             t_start: Optional[float] = None, fault=None,
             mix_overrides: Optional[Dict] = None):
    """One run of ``workload``: ``(result, run)``, the result dict (the
    comparison's ``checks`` last) and the :class:`Run` its metrics were
    read from.  ``fault``, for the harness's own tests, is handed to the
    system's ``inject`` to break the timed path underneath;
    ``mix_overrides`` replaces fields of the traffic mix (the knee sweep,
    and small runs in the tests)."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    spec = Spec(root)
    wl = spec.workload(workload)
    cfg = spec.config(wl["config"])
    system = spec.module("systems", cfg["system"])
    reference = spec.module("reference", cfg["reference"])
    mix = spec.mix(wl["traffic"], system, **(mix_overrides or {}))
    arrivals = spec.module("arrivals", mix.arrivals)
    metrics = spec.metrics(workload, trace)
    readers = {m["name"]: spec.reader(m["name"]) for m in metrics}
    given = lambda name: (getattr(system, name)(cfg)
                          if hasattr(system, name) else None)
    cuda = torch.device(device).type == "cuda"

    phases = [("imports", time.perf_counter())]
    weights = system.make_weights(cfg, seed, device)
    phases.append(("weights", time.perf_counter()))
    session, server = system.build_server(cfg, weights, mix, device)
    phases.append(("session and server", time.perf_counter()))
    if fault is not None:
        system.inject(server, fault)
    system.warm(server, mix, cfg, device)
    phases.append(("warm waves", time.perf_counter()))
    windows = system.payload(cfg, mix, seed)
    spans = Spans()
    prof = Profiler(spans, cuda=cuda,
                    datapath=getattr(system, "DATAPATH", None),
                    labels=getattr(system, "SPANS", ()),
                    kernel=getattr(system, "WAVE_KERNEL", None))
    if trace:
        if hasattr(system, "instrument"):
            system.instrument(spans, server)
        prof.warm()
    total_s = seconds + (TRACE_TRIES * TRACE_S + 0.5 if trace else 0.0)
    sched = arrivals.schedule(mix, seed, total_s)
    for kk in range(int(sched.k.max()) + 1 if len(sched.k) else 0):
        windows.round(kk)
    loop = OpenLoop(server, mix, windows, system.answer_width(cfg), sched,
                    spans)

    t0 = time.perf_counter()
    phases.append(("traffic", t0))
    setup_s = t0 - t_start
    loop.start(t0)
    t1 = t0 + seconds
    with GcPauses() as gc_pauses:
        loop.run_until(t1)
    counters = system.counters(server)
    result_trace: Optional[TraceResult] = None
    trace_counters, refused = None, []
    if trace:
        for _ in range(TRACE_TRIES):
            c_a, n_a = system.counters(server), loop.answered
            t_a = prof.start()
            loop.run_until(t_a + TRACE_S)
            result_trace = prof.stop()
            trace_counters = (c_a, system.counters(server))
            why = result_trace.fault(
                trace_counters[1]["waves"] - c_a["waves"]
                if prof.datapath else 0, loop.answered - n_a)
            if why is None:
                break
            refused.append(why)
        else:
            loop.drain(DRAIN_S)
            server.close(timeout=30.0)
            raise RuntimeError("no whole trace in "
                               f"{TRACE_TRIES} sub-windows: {refused}")
    loop.drain(DRAIN_S)
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    leaked = server.close(timeout=30.0)
    if leaked:
        raise RuntimeError(f"server threads left running: {leaked}")
    program_sink = system.sink(server) if hasattr(system, "sink") else None
    own_checks = system.checks(server) if hasattr(system, "checks") else {}
    del server, session
    if cuda:
        torch.cuda.empty_cache()

    stream, k, due, sub, ret, done, y, ok = loop.arrays()
    fmt = given("fmt_bits")
    run = Run(t0=t0, t1=t1, stream=stream, k=k, due=due, sub=sub, ret=ret,
              done=done, ok=ok, counters=counters, mix=mix, config=cfg,
              batch=mix.batch, dims=given("dims"),
              bits=fmt[1] if fmt else None, trace=result_trace,
              trace_counters=trace_counters, trace_refused=refused,
              setup_s=setup_s, gc_events=gc_pauses.events,
              ops_per_window=given("ops_per_window"),
              program_sink=program_sink)
    values = {}
    for mt in metrics:
        v = readers[mt["name"]].read(run)
        if v is not None:
            values[mt["name"]] = {"value": float(v), "unit": mt["unit"]}

    checks = compare.check(reference, cfg, weights, stream, k,
                           windows.take(stream, k), y, device=device)
    checks.update(own_checks)
    out = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
           "attempted": int(len(stream)),
           "failed": int(np.count_nonzero(~ok)),
           "metrics": values,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": (torch.cuda.get_device_name(0) if cuda
                               else "cpu"),
                      "count": 1, "memory_peak_bytes": int(memory_peak)}}
    if result_trace is not None:
        out["device"]["busy_s"] = result_trace.busy_s
        out["device"]["window_s"] = result_trace.window_s
        out["breakdown"] = {"device_ops": result_trace.device_ops(),
                            "idle_gaps": result_trace.idle_gaps()}
    out["checks"] = checks
    run.setup_phases = [(name, b - a) for (name, b), (_, a) in
                        zip(phases, [("start", t_start)] + phases[:-1])]
    return out, run


def wave_ms(c_a: Dict, c_b: Dict) -> Optional[float]:
    """Mean host time of a wave (ms) between two counter readings."""
    waves = c_b["waves"] - c_a["waves"]
    return (1e3 * (c_b["compute_s_total"] - c_a["compute_s_total"]) / waves
            if waves else None)


def report(run) -> None:
    """What a run saw beside its metrics, on standard error: set-up by
    phase, latency quantiles, the generator's lateness and held submits,
    collections, and for a traced run the wave's time with and without
    the profiler and the sub-windows refused."""
    say = lambda text: print(text, file=sys.stderr)
    say("set-up (s): " + ", ".join(f"{n} {s:.3f}"
                                   for n, s in run.setup_phases))
    sel = run.due_in_window()
    if sel.any():
        got = sel & run.ok
        q = np.percentile((run.done - run.due)[got], [50, 90, 95, 99, 99.9])
        say("latency (ms) from due to polled: " + ", ".join(
            f"p{p} {float(v) * 1e3!r}"
            for p, v in zip((50, 90, 95, 99, 99.9), q)))
        late = (run.sub - run.due)[sel]
        took = (run.ret - run.sub)[sel]
        say(f"generator: late p99 {float(np.percentile(late, 99)) * 1e3!r} "
            f"ms, max {float(late.max()) * 1e3!r} ms; submits held over "
            f"{SUBMIT_HELD_S * 1e3:g} ms {int((took > SUBMIT_HELD_S).sum())}"
            f" of {int(sel.sum())}, longest {float(took.max()) * 1e3!r} ms")
    full = [e - b for g, b, e in run.gc_events if g == 2]
    say(f"collections in the window: {len(run.gc_events)}, "
        f"{len(full)} of generation 2 taking {sum(full):.4f} s")
    if run.trace is not None:
        if "compute_s_total" in run.counters:
            w0 = wave_ms({"waves": 0, "compute_s_total": 0.0}, run.counters)
            say(f"wave (ms): measured window {w0!r}, traced sub-window "
                f"{wave_ms(*run.trace_counters)!r}")
        say(f"traced sub-windows refused {len(run.trace_refused)}: "
            f"{run.trace_refused}")


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is JAX's, its
    libraries' or the JAX package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def main(argv: List[str], t_start: Optional[float] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    spec = Spec(ROOT)
    chips = spec.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"perfbench: the cell needs {chips} CUDA card(s), this "
              f"machine has {have}; no result", file=sys.stderr)
        return 3
    out, run = run_cell(args.workload, args.seed, args.seconds,
                        bool(args.trace), t_start=t_start)
    report(run)
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: modules of JAX or the JAX package were loaded: "
              f"{bad}; no result", file=sys.stderr)
        return 4
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
