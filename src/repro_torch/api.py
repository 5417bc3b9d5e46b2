"""The accelerator session API — ``repro_torch.build``.

Counterpart of ``repro/api.py`` for training, integer inference and
serving::

    import repro_torch
    from repro_torch.core.qlstm import QLSTMConfig
    from repro_torch.core.accelerator import AcceleratorConfig

    acc = repro_torch.build(QLSTMConfig(), AcceleratorConfig())  # on CUDA
    acc.train_qat(data, steps=200)           # QAT (§6.1) on the same device
    acc.quantize()                           # float master -> integer codes
    y = acc.infer(x, path="int")             # fused CUDA kernels

The session owns the float master params, the quantised params, the
resolved ``plan()`` and the ``device`` everything runs on.  Sessions run
on the CUDA card unless the caller asks for another device
(``build(..., device="cpu")``, as the tests do); with no card and no
device given, ``build`` raises.  ``infer``/``serve`` dispatch through the
backend registry (``ref`` | ``pallas`` | ``xla``); torch runs eagerly, so
the callables returned by ``compiled*`` are plain closures cached per
engine.

``replicate`` pins copies of a quantised session to devices, and
``build_cluster`` puts them behind a ``serving.ClusterServer``.
``report`` gives the resolved plan with the Table-4 energy block of
``core/energy.py`` (the H100's constants), and ``measure_scenario``
scores the session under a ``repro_torch.explore.ServingScenario``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import backends, cells
from repro_torch.backends.slot_graph import SlotGraphs
from repro_torch.core import fixed_point as fxp
from repro_torch.core.accelerator import (AcceleratorConfig, plan as resolve_plan,
                                          resolve_model, sync_accelerator)
from repro_torch.core.energy import power_report
from repro_torch.core.qlstm import QLSTMConfig, tree_to

Tensor = torch.Tensor
Params = Dict[str, Any]

PATHS = ("float", "qat", "int")

# The paper's measured operating point: 28.07 us an inference on its FPGA
# (the XC7S15, §6) — the default latency anchor of report(), not a
# measurement of this card.
PAPER_LATENCY_S = 28.07e-6


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card, and
    raises when there is none (nothing falls back to the CPU)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch sessions run on a CUDA card and none is available; "
            "pass device='cpu' to run the plain torch versions on the CPU")
    return torch.device("cuda")


def build(model: Optional[QLSTMConfig] = None,
          accel: Optional[AcceleratorConfig] = None, *,
          params: Optional[Params] = None, seed: int = 0,
          device: Union[str, torch.device, None] = None) -> "Accelerator":
    """Compile a (model, accelerator) configuration into a session.

    ``params`` seeds the session with float master weights (a params dict
    of tensors, e.g. from ``repro_torch.convert.params_from_reference``);
    otherwise they are drawn from a ``torch.Generator`` seeded with
    ``seed``.  ``device`` defaults to CUDA."""
    return Accelerator(model or QLSTMConfig(), accel or AcceleratorConfig(),
                       params=params, seed=seed, device=device)


def build_cluster(session, n: int, *, devices=None, names=None, config=None,
                  **overrides):
    """A ready multi-replica serving cluster from one quantised session:
    ``session.replicate(n)`` (per-device pinned copies) behind a
    ``repro_torch.serving.ClusterServer`` consistent-hash front door.

    ``devices`` pins explicit placement (``launch.mesh.serving_devices``
    semantics); ``names`` labels the replicas on the ring; ``config`` /
    keyword overrides set ``ClusterConfig`` and fall through to the
    per-replica ``ServingConfig`` (``batch=``, ``deadline_s=``, ...)."""
    from repro_torch.serving.cluster import ClusterServer

    replicas = session.replicate(n, devices=devices)
    return ClusterServer(replicas, config=config, names=names, **overrides)


class Accelerator:
    """A built accelerator: params + resolved plan + dispatchable
    datapaths on one device.  Lifecycle: ``build`` -> ``train_qat`` ->
    ``quantize`` -> ``infer`` / ``serve`` / ``report``; stage methods
    return ``self``."""

    def __init__(self, model: QLSTMConfig, accel: AcceleratorConfig, *,
                 params: Optional[Params] = None, seed: int = 0,
                 device: Union[str, torch.device, None] = None):
        self.device = resolve_device(device)
        self.model = resolve_model(model, accel)
        self.accel = sync_accelerator(self.model, accel)
        self.cell = cells.get(self.model.cell)
        self.plan = resolve_plan(self.model, self.accel)
        # Fail at build, not first infer: an explicit engine that cannot
        # run this configuration, or a kernel that cannot be built.
        if self.accel.backend != "auto":
            backends.select(self.model, self.accel)
        self._prepare(backends.get(self.plan["backend"]))
        if params is not None:
            self.params: Params = tree_to(params, self.device)
        else:
            gen = torch.Generator().manual_seed(seed)
            self.params = self.cell.init_params(self.model, gen,
                                                device=self.device)
        self.qparams: Optional[Params] = None
        self.train_summary: Optional[Dict[str, Any]] = None
        self._fns: Dict[Tuple[str, str], Any] = {}

    def _prepare(self, bk: backends.Backend) -> backends.Backend:
        if bk.prepare is not None:
            bk.prepare(self.device)
        return bk

    def _select(self, backend: Optional[str]) -> backends.Backend:
        return self._prepare(backends.select(self.model, self.accel,
                                             override=backend))

    def _select_stateful(self, backend: Optional[str]) -> backends.Backend:
        return self._prepare(backends.select_stateful(
            self.model, self.accel, override=backend))

    # -- training -----------------------------------------------------------

    def train_qat(self, data, steps: int = 200, *, batch: int = 64,
                  lr: float = 3e-3, seed: int = 0,
                  ckpt_dir: Optional[str] = None, log_every: int = 50,
                  log=print) -> "Accelerator":
        """Quantisation-aware training (§6.1) on the session's device: MSE
        regression through ``forward_qat`` (STE fake-quant at every
        hardware rounding point), gradients from ``torch.autograd``, AdamW.

        ``data``: the dict of ``data.timeseries.pems_like_dataset`` (its
        ``"train"`` split) or an ``(x, y)`` tuple, x (N, T, M) and y (N,
        P) float.  Batch ``step`` is drawn by
        ``np.random.default_rng((seed, step))``, as in the reference, so a
        run resumed from ``ckpt_dir`` replays the same batches (the
        shared ``Trainer``: checkpoint/resume, SIGTERM/SIGINT
        checkpoint-and-exit)."""
        from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                                    init_opt_state)
        from repro_torch.training.train_loop import LoopConfig, Trainer
        from repro_torch.training.tree import tree_leaves, tree_map

        xtr, ytr = data["train"] if isinstance(data, dict) else data
        cfg = self.model
        opt_cfg = OptConfig(name="adamw", lr=lr, weight_decay=0.0,
                            warmup_steps=min(20, max(1, steps // 10)),
                            total_steps=steps)
        state = {"params": self.params,
                 "opt": init_opt_state(self.params, opt_cfg),
                 "step": torch.zeros((), dtype=torch.int32, device=self.device)}
        forward_qat = self.cell.forward_qat

        def step_fn(state, batch_d):
            params = tree_map(lambda p: p.detach().requires_grad_(True),
                              state["params"])
            y = forward_qat(params, batch_d["x"], cfg)
            mse = torch.mean(torch.square(y - batch_d["y"]))
            grads = iter(torch.autograd.grad(mse, tree_leaves(params)))
            # tree_leaves' order is tree_map's over these dicts and lists
            grads = tree_map(lambda _: next(grads), params)
            p, o, om = apply_updates(state["params"], grads, state["opt"],
                                     opt_cfg)
            mse = mse.detach()
            return ({"params": p, "opt": o, "step": state["step"] + 1},
                    {"loss": mse, "mse": mse, **om})

        def batch_fn(step):
            rng = np.random.default_rng((seed, step))
            idx = rng.integers(0, len(xtr), batch)
            return {"x": torch.as_tensor(xtr[idx], device=self.device),
                    "y": torch.as_tensor(ytr[idx], device=self.device)}

        trainer = Trainer(step_fn, state, batch_fn,
                          LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                     ckpt_every=100, log_every=log_every),
                          log=log)
        trainer.maybe_resume()
        self.train_summary = trainer.run()
        self.params = trainer.state["params"]
        # Params changed: stale codes and cached entry points must go.
        self.qparams = None
        self._fns.clear()
        return self

    # -- quantisation -------------------------------------------------------

    def quantize(self) -> "Accelerator":
        """Float master weights -> integer codes (weights in (a,b); biases
        at the wide accumulator precision)."""
        self.qparams = self.cell.quantize_params(self.params, self.model)
        self._fns = {k: fn for k, fn in self._fns.items()
                     if not k[0].startswith("int")}
        return self

    # -- inference ----------------------------------------------------------

    def _input(self, x) -> Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def infer(self, x, path: str = "float",
              backend: Optional[str] = None) -> Tensor:
        """x: (B, T, M) float -> (B, P) float on the session's device.
        ``path``: ``float`` (training semantics), ``qat`` (fake-quant
        graph) or ``int`` (bit-exact integer datapath, dequantised at the
        boundary); ``backend`` overrides the plan's engine for the int
        path."""
        return self._fn(path, backend)(x)

    def infer_int(self, x_int, backend: Optional[str] = None) -> Tensor:
        """Integer codes in, integer codes out — the raw accelerator
        boundary."""
        self._require_quantized()
        bk = self._select(backend)
        return bk.run(self.qparams, torch.as_tensor(x_int, device=self.device),
                      self.model, self.accel)

    def compiled(self, path: str = "int", backend: Optional[str] = None):
        """The cached entry point for (path, backend): a callable
        ``(B, T, M) float -> (B, P) float``."""
        return self._fn(path, backend)

    def init_state(self, batch: int):
        """The reset cross-window carry for ``compiled_stateful``: per
        layer, the cell's zero int32 (batch, hidden) tensors."""
        return cells.init_state(self.model, batch, device=self.device)

    def compiled_stateful(self, backend: Optional[str] = None):
        """The cached STATEFUL int-path entry point: ``((B, T, M) float,
        state) -> ((B, P) float, new_state)``.  Feeding a stream window by
        window with the carried state is bit-identical to one call on the
        concatenated sequence."""
        self._require_quantized()
        bk = self._select_stateful(backend)
        key = ("int_stateful", bk.name)
        if key not in self._fns:
            qparams, model, accel = self.qparams, self.model, self.accel

            def stateful_path(x, state):
                x_int = fxp.quantize(self._input(x), model.fxp)
                y_int, new_state = bk.run_stateful(qparams, x_int, model,
                                                   accel, state)
                return fxp.dequantize(y_int, model.fxp), new_state

            self._fns[key] = stateful_path
        return self._fns[key]

    def init_state_table(self, max_slots: int) -> Tensor:
        """The reset device-resident state table for
        ``compiled_stateful_slots``: zero ``(max_slots + 2, L, S, H)``
        int32 on the session's device.  Rows ``max_slots`` (ZERO) and
        ``max_slots + 1`` (TRASH) follow the slot kernel's conventions."""
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        return torch.zeros((max_slots + 2, *self.plan["state_shape"]),
                           dtype=torch.int32, device=self.device)

    def compiled_stateful_slots(self, backend: Optional[str] = None):
        """The cached device-resident-state entry point: ``((B, T, M)
        float, table, gather_slots, scatter_slots) -> ((B, P) float,
        new_table)``; x and the (B,) slot ids may be host arrays or
        tensors.  The fused engine gathers and scatters inside its
        kernel; ``ref``/``xla`` use the generic adapter.  Bit-identical to
        ``compiled_stateful`` fed the host-gathered carries.  The table
        handed in is only read.

        On a CUDA session the fused engine's entry is a
        ``backends.slot_graph.SlotGraphs``: a wave given as host arrays
        replays a CUDA graph (y then comes back on the host, and
        ``new_table`` is the graph's own output table, overwritten by its
        next replay); device tensors take the eager path."""
        self._require_quantized()
        bk = self._select_stateful(backend)
        key = ("int_stateful_slots", bk.name)
        if key not in self._fns:
            impl = bk.run_stateful_slots
            if impl is None:
                from repro_torch.backends.common import run_slots_via_state
                impl = lambda *a: run_slots_via_state(bk.run_stateful, *a)
            qparams, model, accel = self.qparams, self.model, self.accel

            def slot_path(x, table, gather_slots, scatter_slots):
                x_int = fxp.quantize(self._input(x), model.fxp)
                y_int, new_table = impl(
                    qparams, x_int, model, accel, table,
                    torch.as_tensor(gather_slots, device=table.device),
                    torch.as_tensor(scatter_slots, device=table.device))
                return fxp.dequantize(y_int, model.fxp), new_table

            if bk.name == "pallas" and self.device.type == "cuda":
                slot_path = SlotGraphs(slot_path, qparams, model, accel)
            self._fns[key] = slot_path
        return self._fns[key]

    def degradation_ladder(self, backend: Optional[str] = None,
                           stateful: bool = True) -> Tuple[str, ...]:
        """Ordered engine names the serving tier falls back through on
        repeated backend failure (fastest first, all bit-identical).  On a
        CUDA session it ends at the fused kernels' engine, so a kernel
        failure is never served by a plain engine."""
        return backends.degradation_ladder(self.model, self.accel,
                                           override=backend,
                                           stateful=stateful,
                                           device=self.device)

    def replicate(self, n: int, devices=None) -> "list[Accelerator]":
        """``n`` device-pinned replica sessions of this (quantised)
        accelerator — the per-replica substrate of the serving cluster.

        Each replica shares this session's configuration and weights, with
        its params AND integer codes moved to its own device
        (``sharding.partition.pin_to_device``), so each replica's datapath
        runs there and a stream's carry stays replica-local under
        ``ClusterServer`` routing.  Devices come from
        ``launch.mesh.serving_devices``: round-robin over the visible
        devices of this session's type by default (one card's replicas
        share it, as the CPU tests' share the CPU), or an explicit
        ``devices`` list.  The codes are pinned, NOT re-quantised, so every
        replica is bit-identical to this session."""
        from repro_torch.launch.mesh import serving_devices
        from repro_torch.sharding.partition import pin_to_device

        self._require_quantized()
        out = []
        for d in serving_devices(n, devices, kind=self.device.type):
            rep = Accelerator(self.model, self.accel,
                              params=pin_to_device(self.params, d), device=d)
            rep.qparams = pin_to_device(self.qparams, d)
            rep.device = d
            out.append(rep)
        return out

    def _require_quantized(self):
        if self.qparams is None:
            raise RuntimeError(
                "the session is not quantised: call .quantize() before the "
                "int path (build -> quantize -> infer/serve)")

    def _fn(self, path: str, backend: Optional[str]):
        """Cached entry point for (path, backend)."""
        if path not in PATHS:
            raise ValueError(f"path must be one of {PATHS}, got {path!r}")
        if backend is not None and path != "int":
            raise ValueError(
                f"backend={backend!r} only applies to path='int'; the "
                f"{path!r} path runs the float graph")
        model = self.model
        if path == "int":
            self._require_quantized()
            bk = self._select(backend)
            key = (path, bk.name)
        else:
            key = (path, "plan")
        if key in self._fns:
            return self._fns[key]
        if path in ("float", "qat"):
            params = self.params
            fwd = (self.cell.forward_float if path == "float"
                   else self.cell.forward_qat)
            fn = lambda x: fwd(params, self._input(x), model)
        else:
            qparams, accel = self.qparams, self.accel

            def fn(x):
                x_int = fxp.quantize(self._input(x), model.fxp)
                return fxp.dequantize(bk.run(qparams, x_int, model, accel),
                                      model.fxp)

        self._fns[key] = fn
        return fn

    # -- serving ------------------------------------------------------------

    def serve(self, stream: Iterable[Union[Tensor, np.ndarray]],
              batch: int = 256, path: str = "int",
              backend: Optional[str] = None) -> Iterator[np.ndarray]:
        """Batched streaming inference: windows of shape (T, M) in,
        predictions of shape (P,) out, in submission order — a thin
        wrapper over ``repro_torch.serving.serve_windows`` (the final
        partial wave is padded and the padding's outputs dropped)."""
        from repro_torch.serving import serve_windows
        return serve_windows(self, stream, batch=batch, path=path,
                             backend=backend)

    def measure_scenario(self, scenario, *, batch: Optional[int] = None,
                         replicas: int = 1,
                         state_residency: str = "auto") -> Dict[str, Any]:
        """Measure THIS session at a serving operating point: ``scenario``
        (a ``repro_torch.explore.ServingScenario``) stands up a short real
        ``StreamServer`` (or ``ClusterServer`` when ``replicas > 1``) run
        and returns the ``metrics_summary()``-derived objectives
        (samples/s, p50/p95/p99 ms, deadline-miss rate, GOP/s/W) — the
        check that an autotuned session still meets its SLO."""
        return scenario.run(self, batch=batch, replicas=replicas,
                            state_residency=state_residency)

    # -- reporting ----------------------------------------------------------

    def report(self, latency_s: float = PAPER_LATENCY_S,
               batch: int = 1) -> Dict[str, Any]:
        """Resolved plan + op/footprint accounting + the Table-4-style
        energy report at the given operating point (``latency_s`` for a
        wave of ``batch`` inferences).

        The energy block scores the CUDA-core int32 terms for both
        ``compute_unit`` values: ``mxu`` and ``vpu`` run the same CUDA-core
        kernel on this card (``core/accelerator.py``), so tensor-core
        energy would score a unit the datapath never used."""
        ops = self.cell.ops_per_inference(self.model)
        energy = power_report(
            flops=ops * batch, hbm_bytes=self.plan["weight_bytes"],
            ici_bytes=0, latency_s=latency_s, unit="vpu",
            dtype="int8" if self.accel.fxp.total_bits <= 8 else "bf16")
        return {
            "model": dataclasses.asdict(self.model),
            "plan": {**self.plan,
                     "fxp": dataclasses.asdict(self.plan["fxp"])},
            "backend": self.plan["backend"],
            "backends_supported": backends.supported_backends(self.model,
                                                              self.accel),
            "stateful_backends": backends.stateful_backends(self.model,
                                                            self.accel),
            "ops_per_inference": ops,
            "weight_bytes": self.plan["weight_bytes"],
            "quantized": self.qparams is not None,
            "energy": energy,
        }

    def __repr__(self) -> str:
        return (f"Accelerator(fxp={self.model.fxp}, "
                f"unit={self.plan['compute_unit']}, "
                f"wmem={self.plan['weight_memory']}, "
                f"alu={self.plan['alu_mode']}, "
                f"hs={self.plan['hs_method']}, "
                f"backend={self.plan['backend']}, device={self.device}, "
                f"quantized={self.qparams is not None})")
