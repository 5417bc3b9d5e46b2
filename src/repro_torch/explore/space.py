"""Declarative search space over the paper's Table-2 meta-parameters.

A :class:`SearchSpace` is a finite set of choices per axis; every axis is a
tuple of candidate values and a configuration *point* is one value per axis.
The axes are exactly the knobs the paper sweeps by rebuilding the bitstream
(fixed-point format, HardSigmoid* method, ALU resource type, ALU pipelining)
plus the deployment-side parameters (layer width/depth, serve batch size,
execution backend) and the recurrent cell itself (``repro_torch.cells``:
lstm | gru | rglru — the scenario-diversity axis).

``Point.configs()`` turns a point into the ``(QLSTMConfig,
AcceleratorConfig)`` pair that ``repro_torch.build`` compiles — the search
space never bypasses the session API, so anything it scores is exactly
what a user would deploy.  Counterpart of ``repro/explore/space.py`` on
the port's configs; labels, axes and record forms are the reference's, so
a sweep record of either package rebuilds in the other.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.accelerator import (ALU_MODES, BACKENDS, HS_METHODS,
                                          AcceleratorConfig)
from repro_torch.core.fixed_point import FXP_4_8, FXP_8_16, FixedPointConfig
from repro_torch.core.qlstm import QLSTMConfig

# Axis order is the canonical iteration order of ``grid()`` — stable across
# runs so sweep artifacts diff cleanly.
AXES = ("fxp", "hs_method", "compute_unit", "alu_mode",
        "hidden_size", "num_layers", "batch", "backend", "cell",
        "replicas", "state_residency")

STATE_RESIDENCIES = ("auto", "host", "device")


@dataclasses.dataclass(frozen=True)
class Point:
    """One configuration point: a value per axis of the search space."""

    fxp: FixedPointConfig
    hs_method: str
    compute_unit: str
    alu_mode: str
    hidden_size: int
    num_layers: int
    batch: int
    backend: str
    # The recurrent cell id (default keeps pre-cell-axis records and
    # Point(...) call sites valid).
    cell: str = "lstm"
    # Serving-side deployment axes (defaults keep pre-serving-axis records
    # and positional Point(...) call sites valid): how many cluster
    # replicas the point deploys as, and where the per-stream carry lives
    # (auto | host | device — the ServingConfig knob).
    replicas: int = 1
    state_residency: str = "auto"

    def configs(self, base_model: Optional[QLSTMConfig] = None,
                base_accel: Optional[AcceleratorConfig] = None,
                ) -> Tuple[QLSTMConfig, AcceleratorConfig]:
        """The ``(model, accelerator)`` pair this point deploys as.

        ``base_model`` carries the non-swept functional parameters
        (input_size, out_features, seq_len, activation family);
        ``base_accel`` the non-swept implementation ones (weight_memory,
        vmem_budget, ht thresholds)."""
        model = dataclasses.replace(base_model or QLSTMConfig(),
                                    hidden_size=self.hidden_size,
                                    num_layers=self.num_layers,
                                    cell=self.cell)
        accel = dataclasses.replace(base_accel or AcceleratorConfig(),
                                    fxp=self.fxp, hs_method=self.hs_method,
                                    compute_unit=self.compute_unit,
                                    alu_mode=self.alu_mode,
                                    backend=self.backend)
        return model, accel

    @property
    def label(self) -> str:
        """Stable human/machine-readable id, e.g.
        ``a4b8_step_mxu_pipelined_h20x1_b256_auto`` (non-LSTM cells get
        a ``_gru``/``_rglru`` suffix; non-default serving axes append
        ``_rN`` / ``_host``/``_device``.  Default-axis labels are
        unchanged from earlier eras so existing sweep artifacts still
        diff cleanly)."""
        base = (f"a{self.fxp.frac_bits}b{self.fxp.total_bits}_"
                f"{self.hs_method}_{self.compute_unit}_{self.alu_mode}_"
                f"h{self.hidden_size}x{self.num_layers}_b{self.batch}_"
                f"{self.backend}")
        if self.cell != "lstm":
            base += f"_{self.cell}"
        if self.replicas != 1:
            base += f"_r{self.replicas}"
        if self.state_residency != "auto":
            base += f"_{self.state_residency}"
        return base

    def asdict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fxp"] = {"frac_bits": self.fxp.frac_bits,
                    "total_bits": self.fxp.total_bits}
        return d


def _as_tuple(v) -> tuple:
    if isinstance(v, (list, tuple)):
        return tuple(v)
    return (v,)


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """Finite choices per Table-2 axis.  Each field accepts a single value
    or a sequence; singletons pin the axis.

    ``constraints`` is the space's declarative validity tree (a
    ``repro_torch.explore.constraints.ConstraintNode``; ``None`` = the
    package default) — infeasible points are pruned before measurement,
    see :meth:`feasible`."""

    fxp: Sequence[FixedPointConfig] = (FXP_4_8,)
    hs_method: Sequence[str] = ("step",)
    compute_unit: Sequence[str] = ("mxu",)
    alu_mode: Sequence[str] = ("pipelined",)
    hidden_size: Sequence[int] = (20,)
    num_layers: Sequence[int] = (1,)
    batch: Sequence[int] = (256,)
    backend: Sequence[str] = ("auto",)
    cell: Sequence[str] = ("lstm",)
    replicas: Sequence[int] = (1,)
    state_residency: Sequence[str] = ("auto",)
    constraints: Optional[object] = None

    def __post_init__(self):
        for axis in AXES:
            object.__setattr__(self, axis, _as_tuple(getattr(self, axis)))
            if not getattr(self, axis):
                raise ValueError(f"search axis {axis!r} has no choices")
        for v in self.fxp:
            if not isinstance(v, FixedPointConfig):
                raise ValueError(f"fxp choices must be FixedPointConfig, "
                                 f"got {v!r}")
        _check("hs_method", self.hs_method, HS_METHODS)
        _check("compute_unit", self.compute_unit, ("mxu", "vpu"))
        _check("alu_mode", self.alu_mode, ALU_MODES)
        _check("backend", self.backend, BACKENDS)
        _check("state_residency", self.state_residency, STATE_RESIDENCIES)
        from repro_torch import cells as _cells
        _check("cell", self.cell, _cells.available())
        for axis in ("hidden_size", "num_layers", "batch", "replicas"):
            for v in getattr(self, axis):
                if not isinstance(v, int) or v < 1:
                    raise ValueError(f"{axis} choices must be positive ints, "
                                     f"got {v!r}")

    def feasible(self, point: Point, base_model=None, base_accel=None,
                 kind: Optional[str] = None) -> Optional[str]:
        """``None`` when ``point`` passes the space's constraint tree,
        else the violated rule's reason (prefixed with its name).  The
        sweep prunes non-``None`` points before measurement and records
        them with the reason.  ``kind`` is the type of device the sweep
        deploys on (the default tree's replica rule counts those; ``None``
        means the cards)."""
        node = self.constraints
        if node is None:
            from repro_torch.explore.constraints import default_constraints
            node = default_constraints(kind)
        return node.check(point, base_model, base_accel)

    @property
    def size(self) -> int:
        n = 1
        for axis in AXES:
            n *= len(getattr(self, axis))
        return n

    def grid(self) -> Iterator[Point]:
        """Every point, in canonical (AXES-major) order."""
        for combo in itertools.product(*(getattr(self, a) for a in AXES)):
            yield Point(*combo)

    def sample(self, n: int, seed: int = 0) -> Tuple[Point, ...]:
        """``n`` distinct points drawn uniformly without replacement (the
        whole grid, in sampled order, if ``n >= size``)."""
        rng = np.random.default_rng(seed)
        if n >= self.size:
            pts = list(self.grid())
            rng.shuffle(pts)
            return tuple(pts)
        picked = rng.choice(self.size, size=n, replace=False)
        sizes = [len(getattr(self, a)) for a in AXES]
        out = []
        for flat in sorted(int(i) for i in picked):
            idx, combo = flat, []
            for a, k in zip(reversed(AXES), reversed(sizes)):
                idx, r = divmod(idx, k)
                combo.append(getattr(self, a)[r])
            out.append(Point(*reversed(combo)))
        return tuple(out)

    def asdict(self) -> dict:
        d = {a: list(getattr(self, a)) for a in AXES}
        d["fxp"] = [{"frac_bits": f.frac_bits, "total_bits": f.total_bits}
                    for f in self.fxp]
        return d


def point_from_config(config: dict) -> Point:
    """Rebuild a :class:`Point` from its ``asdict()`` form (the ``config``
    record of a sweep row) — lets ``autotune`` redeploy a point from a saved
    ``BENCH_pareto.json`` without re-running the sweep."""
    kw = dict(config)
    kw["fxp"] = FixedPointConfig(kw["fxp"]["frac_bits"],
                                 kw["fxp"]["total_bits"])
    # Records written before the cell / serving axes existed have no keys
    # for them — they were single-replica LSTM points with auto residency.
    kw.setdefault("cell", "lstm")
    kw.setdefault("replicas", 1)
    kw.setdefault("state_residency", "auto")
    return Point(**{a: kw[a] for a in AXES})


def _check(axis: str, choices: tuple, allowed: tuple) -> None:
    for v in choices:
        if v not in allowed:
            raise ValueError(f"{axis} choice {v!r} not in {allowed}")


def paper_space(batch: int = 256) -> SearchSpace:
    """The Table-4 comparison as a search space: both compute units, both
    ALU modes, every HardSigmoid* method, this work's (4,8) format vs the
    baseline's (8,16)."""
    return SearchSpace(fxp=(FXP_4_8, FXP_8_16),
                       hs_method=HS_METHODS,
                       compute_unit=("mxu", "vpu"),
                       alu_mode=ALU_MODES,
                       batch=(batch,))


def smoke_space(batch: int = 32, cell: Sequence[str] = ("lstm",),
                replicas: Sequence[int] = (1,),
                state_residency: Sequence[str] = ("auto",)) -> SearchSpace:
    """Four cheap CPU-safe points per cell (fixed-point format x ALU
    mode) — the deterministic sweep CI runs and tests assert on.  ``cell``
    widens the sweep across the registered cell zoo (``bench_pareto``
    passes all three); ``replicas``/``state_residency`` open the serving
    deployment axes for scenario sweeps."""
    return SearchSpace(fxp=(FXP_4_8, FXP_8_16), alu_mode=ALU_MODES,
                       batch=(batch,), cell=cell, replicas=replicas,
                       state_residency=state_residency)
