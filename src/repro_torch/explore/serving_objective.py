"""Serving-aware objectives: score a configuration point where it runs.

The offline sweep times a closed loop of the int path — the wrong
objective for a serving system, where the winning configuration depends
on the *operating point* (arrival rate, deadline, stream count), not peak
throughput.  A :class:`ServingScenario` pins that operating point and
scores a session by
standing up a short real ``StreamServer`` (or ``ClusterServer`` for
multi-replica points) run and deriving objectives from
``metrics_summary()``: achieved samples/s, p50/p95/p99 latency,
deadline-miss rate, GOP/s/W.

Constrained objectives — "max samples/s s.t. p99 <= 5 ms" — are SLO
strings parsed by :func:`parse_constraint`; the successive-halving sweep
(``repro_torch.explore.halving``) ranks candidates on the constrained
objective and ``autotune`` refuses to deploy an SLO-violating winner.

:func:`serving_plan` is the imperative feasibility gate (raises
:class:`~repro_torch.explore.constraints.InfeasiblePoint`); its
declarative twin is ``constraints.default_constraints()`` — the
prune/plan agreement test in ``tests/test_torch_explore.py`` holds them
together.  Counterpart of ``repro/explore/serving_objective.py`` on the
port's ``StreamServer`` and ``build_cluster``; a scenario's windows come
from ``np.random.default_rng(seed)``, as in the reference, so both
packages serve the same windows.
"""

from __future__ import annotations

import dataclasses
import math
import re
import time
from typing import Dict, Optional, Tuple, Union

import numpy as np

from repro_torch.explore.constraints import InfeasiblePoint

# The metrics a scenario run yields — the vocabulary serving-mode
# objectives and SLO constraints may reference.
SERVING_METRIC_KEYS = frozenset({
    "samples_per_s", "p50_ms", "p95_ms", "p99_ms", "mean_ms",
    "deadline_miss_rate", "gops_per_watt", "wall_s", "waves",
    "mean_occupancy", "deadline_flushes",
})

# Serving metrics whose "better" direction is "smaller".
SERVING_MINIMISE = ("p50_ms", "p95_ms", "p99_ms", "mean_ms",
                    "deadline_miss_rate", "wall_s", "deadline_flushes")

_SLO_RE = re.compile(
    r"^\s*([A-Za-z_][A-Za-z_0-9]*)\s*(<=|>=|<|>)\s*"
    r"([-+]?[0-9]*\.?[0-9]+(?:[eE][-+]?[0-9]+)?)\s*$")


@dataclasses.dataclass(frozen=True)
class SLO:
    """One service-level bound over a scenario metric, e.g. ``p99_ms <= 5``.

    ``ok(metrics)`` is the feasibility predicate; ``violation(metrics)``
    is the magnitude by which the bound is missed (0 when satisfied,
    ``inf`` for a missing/non-finite metric) — the tie-breaking measure
    successive halving ranks infeasible candidates by."""

    metric: str
    op: str
    bound: float

    @classmethod
    def parse(cls, text: str) -> "SLO":
        """Parse ``"<metric><op><bound>"`` (ops: ``<= >= < >``)."""
        m = _SLO_RE.match(text)
        if not m:
            raise ValueError(
                f"cannot parse SLO constraint {text!r}; expected "
                f"'<metric><op><bound>' like 'p99_ms<=5'")
        metric, op, bound = m.group(1), m.group(2), float(m.group(3))
        return cls(metric, op, bound)

    def ok(self, metrics) -> bool:
        """True iff ``metrics`` carries a finite value satisfying the
        bound."""
        v = metrics.get(self.metric)
        if v is None or not math.isfinite(float(v)):
            return False
        v = float(v)
        return {"<=": v <= self.bound, "<": v < self.bound,
                ">=": v >= self.bound, ">": v > self.bound}[self.op]

    def violation(self, metrics) -> float:
        """How far past the bound the point is (0 when feasible)."""
        v = metrics.get(self.metric)
        if v is None or not math.isfinite(float(v)):
            return float("inf")
        v = float(v)
        if self.op in ("<=", "<"):
            return max(0.0, v - self.bound)
        return max(0.0, self.bound - v)

    def describe(self) -> str:
        """The canonical string form, re-parseable by :meth:`parse`."""
        return f"{self.metric}{self.op}{self.bound:g}"


@dataclasses.dataclass(frozen=True)
class SLOSet:
    """A conjunction of :class:`SLO` terms (comma-separated in string
    form); feasible iff every term is, violation = sum of the terms'."""

    terms: Tuple[SLO, ...]

    def ok(self, metrics) -> bool:
        """All terms satisfied."""
        return all(t.ok(metrics) for t in self.terms)

    def violation(self, metrics) -> float:
        """Summed per-term violation magnitude."""
        return sum(t.violation(metrics) for t in self.terms)

    def describe(self) -> str:
        """Comma-joined canonical form."""
        return ",".join(t.describe() for t in self.terms)


def parse_constraint(spec: Union[str, SLO, SLOSet, None]
                     ) -> Optional[Union[SLO, SLOSet]]:
    """Normalise an SLO spec: ``None`` passes through, strings parse
    (``","`` separates conjunctive terms), SLO/SLOSet return as-is."""
    if spec is None or isinstance(spec, (SLO, SLOSet)):
        return spec
    terms = tuple(SLO.parse(t) for t in str(spec).split(",") if t.strip())
    if not terms:
        raise ValueError(f"empty SLO constraint {spec!r}")
    for t in terms:
        if t.metric not in SERVING_METRIC_KEYS:
            raise ValueError(
                f"unknown SLO metric {t.metric!r}; known: "
                f"{sorted(SERVING_METRIC_KEYS)}")
    return terms[0] if len(terms) == 1 else SLOSet(terms)


@dataclasses.dataclass(frozen=True)
class ServingScenario:
    """A serving operating point: who arrives, how fast, and the deadline.

    ``streams`` named clients each submit ``windows_per_stream`` windows of
    ``window_len`` steps (``None`` = the model's ``seq_len``); ``arrival_hz``
    paces the per-stream window arrival rate (``None`` = closed loop, as
    fast as the server absorbs them); ``deadline_ms`` is the wave-assembly
    deadline (``ServingConfig.deadline_s``).  ``run(session)`` measures a
    session at this operating point and returns the serving objectives."""

    streams: int = 8
    windows_per_stream: int = 4
    window_len: Optional[int] = None
    arrival_hz: Optional[float] = None
    deadline_ms: float = 10.0
    batch: Optional[int] = None
    seed: int = 0
    name: str = "scenario"

    def __post_init__(self):
        if self.streams < 1 or self.windows_per_stream < 1:
            raise ValueError("a scenario needs >= 1 stream and >= 1 window "
                             f"per stream, got streams={self.streams}, "
                             f"windows_per_stream={self.windows_per_stream}")

    def truncated(self, fraction: float) -> "ServingScenario":
        """A cheaper copy for an early halving rung: the window count is
        scaled by ``fraction`` (floored at one window per stream);
        ``fraction >= 1`` returns the scenario itself."""
        if fraction >= 1.0:
            return self
        wins = max(1, int(math.ceil(self.windows_per_stream * fraction)))
        return dataclasses.replace(
            self, windows_per_stream=wins,
            name=f"{self.name}@{fraction:g}")

    @property
    def label(self) -> str:
        """Stable id, e.g. ``scenario_s8w4_d10``."""
        return (f"{self.name}_s{self.streams}w{self.windows_per_stream}"
                f"_d{self.deadline_ms:g}")

    def asdict(self) -> dict:
        """JSON form for the BENCH_pareto payload."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "ServingScenario":
        """Rebuild from :meth:`asdict` (a stored payload's ``scenario``)."""
        return cls(**{f.name: d[f.name] for f in dataclasses.fields(cls)
                      if f.name in d})

    def run(self, session, *, batch: Optional[int] = None,
            replicas: int = 1, state_residency: str = "auto",
            devices=None) -> Dict[str, float]:
        """Measure ``session`` at this operating point.

        Stands up a real ``StreamServer`` (``replicas == 1``) or
        ``ClusterServer`` (via ``repro_torch.api.build_cluster``), on the
        session's device, warms the
        datapath, takes the short-run reset (``reset_streams()`` +
        ``reset_metrics()``), drives the load, and returns the
        ``SERVING_METRIC_KEYS`` objectives derived from
        ``metrics_summary()``."""
        from repro_torch.serving.server import ServingConfig, StreamServer

        b = batch if batch is not None else (
            self.batch if self.batch is not None else self.streams)
        t = self.window_len or session.model.seq_len
        rng = np.random.default_rng(self.seed)
        xs = (rng.standard_normal(
            (self.streams, self.windows_per_stream, t,
             session.model.input_size)) * 0.5).astype(np.float32)
        kw = dict(batch=b, deadline_s=self.deadline_ms / 1e3,
                  state_residency=state_residency,
                  max_streams=max(16, 2 * self.streams))
        if replicas > 1:
            from repro_torch.api import build_cluster
            server = build_cluster(session, replicas, devices=devices, **kw)
        else:
            server = StreamServer(session, ServingConfig(**kw))
        try:
            warm = np.zeros((t, session.model.input_size), np.float32)
            if replicas > 1:
                server.warmup(warm)
            else:
                server.submit("__scenario_warmup__", warm)
                server.drain()
            server.reset_streams()
            server.reset_metrics()
            t0 = time.perf_counter()
            for w in range(self.windows_per_stream):
                if self.arrival_hz:
                    target = t0 + w / self.arrival_hz
                    delay = target - time.perf_counter()
                    if delay > 0:
                        time.sleep(delay)
                for s in range(self.streams):
                    server.submit(f"s{s:04d}", xs[s, w])
            server.drain()
            summary = server.metrics_summary()
        finally:
            server.close()
        return scenario_metrics(summary)


def scenario_metrics(summary: Dict) -> Dict[str, float]:
    """Flatten a ``metrics_summary()`` dict into the scenario-objective
    vocabulary (:data:`SERVING_METRIC_KEYS`)."""
    lat = summary.get("latency_ms") or {}
    faults = summary.get("faults") or {}
    nan = float("nan")
    return {
        "samples_per_s": float(summary.get("samples_per_s", 0.0)),
        "p50_ms": float(lat.get("p50", nan)),
        "p95_ms": float(lat.get("p95", nan)),
        "p99_ms": float(lat.get("p99", nan)),
        "mean_ms": float(lat.get("mean", nan)),
        "deadline_miss_rate": float(faults.get("deadline_miss_rate", 0.0)),
        "gops_per_watt": float(summary.get("gops_per_watt", nan)),
        "wall_s": float(summary.get("wall_s", nan)),
        "waves": float(summary.get("waves", 0)),
        "mean_occupancy": float(summary.get("mean_occupancy", nan)),
        "deadline_flushes": float(summary.get("deadline_flushes", 0)),
    }


def serving_plan(point, base_model=None, base_accel=None,
                 kind: Optional[str] = None) -> Dict:
    """Resolve how a point would actually serve — or raise
    :class:`InfeasiblePoint` when it cannot.

    The checks are the imperative form of
    ``constraints.default_constraints()``: the (possibly explicit) backend
    must carry state for the configuration, pinned device residency needs
    the fused stateful plan, and ``replicas`` distinct devices of type
    ``kind`` must exist (production posture of
    ``launch.mesh.serving_devices``)."""
    from repro_torch import backends
    from repro_torch.core.accelerator import plan as _plan
    model_cfg, accel_cfg = point.configs(base_model, base_accel)
    try:
        engine = backends.select_stateful(model_cfg, accel_cfg)
    except backends.BackendUnsupported as e:
        raise InfeasiblePoint(f"backend: {e}") from e
    pl = _plan(model_cfg, accel_cfg)
    if point.state_residency == "device" \
            and pl["state_residency"] != "device":
        raise InfeasiblePoint(
            f"state_residency: device-resident carry needs the fused "
            f"stateful plan; cell={point.cell!r} on "
            f"backend={point.backend!r} resolves to "
            f"stateful_backend={pl['stateful_backend']!r}")
    if point.replicas > 1:
        from repro_torch.launch.mesh import serving_devices
        try:
            serving_devices(point.replicas, oversubscribe=False, kind=kind)
        except (RuntimeError, ValueError) as e:
            raise InfeasiblePoint(f"replicas: {e}") from e
    residency = (point.state_residency if point.state_residency != "auto"
                 else pl["state_residency"])
    return {
        "backend": engine.name,
        "stateful_backend": pl["stateful_backend"],
        "state_residency": residency,
        "replicas": point.replicas,
    }


def evaluate_serving_point(point, scenario: ServingScenario,
                           base_model=None, base_accel=None, *,
                           seed: int = 0, session=None,
                           device=None) -> Dict:
    """Build (or reuse) the point's session and measure it under
    ``scenario`` — the serving-mode analogue of
    ``measure.evaluate_point``.  Raises :class:`InfeasiblePoint` for
    points :func:`serving_plan` rejects.  A new session is built on
    ``device`` (``build``'s default: the card, raising without one).
    Returns the sweep-row dict."""
    from repro_torch.api import build, resolve_device
    dev = session.device if session is not None else resolve_device(device)
    pl = serving_plan(point, base_model, base_accel, kind=dev.type)
    if session is None:
        session = build(*point.configs(base_model, base_accel), seed=seed,
                        device=dev).quantize()
    metrics = scenario.run(session, batch=point.batch,
                           replicas=point.replicas,
                           state_residency=point.state_residency)
    return {
        "label": point.label,
        "config": point.asdict(),
        "status": "ok",
        "plan": pl,
        "metrics": metrics,
    }
