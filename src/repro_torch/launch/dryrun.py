"""Multi-pod dry run — counterpart of ``repro/launch/dryrun.py``: every
(architecture x input shape x mesh) cell's step traced once on the
production meshes, with its FLOPs, per-device memory, per-device
collective bytes and the roofline terms they give, appended to a JSON
results file.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma2-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--both-meshes] [--out results.json]

Nothing is allocated and no card is used.  The world is a ``fake``
process group of 512 ranks in this process (rank 0), over which
``launch.mesh.make_production_mesh`` builds the (16, 16) or (2, 16, 16)
mesh on device type ``cpu``; params, optimizer state, cache and batch are
``DTensor``s of fake tensors (``FakeTensorMode``) laid out by the
config's rules, and the step runs once on them, as the reference lowers
and compiles it once.  The fake tensors lie on the CPU, so the two kernels
the LM path reaches (K4 in the w8a8 ``linear``, K7 in RecurrentGemma's
prefill) take their plain torch versions there, which is the port's rule
for CPU tensors; shapes, not values, are what the trace reads.  Decode
runs at ``cache_pos = seq_len - 1``, a full cache (a fake tensor has no
value to read, so the position is a Python int).

What a record holds, and how each number is made:
  * ``flops_global``: ``torch.utils.flop_counter.FlopCounterMode`` over the
    same step on the same shapes without the mesh — the global program, as
    the reference counts its unpartitioned HLO; ``flops_per_device`` =
    ``flops_global / chips``, the reference's meaning.  (Under ``DTensor``
    — torch 2.13, ``tests/test_torch_dryrun.py`` — the mode counts an op on
    ``DTensor``s at its global shapes but the body of a ``local_map`` at
    its local shapes, so a count under the mesh is neither the global nor
    the per-device program.)  Python loops run unrolled, so the
    reference's ``unroll_mode`` cost pass has no counterpart, and its
    ``flops_per_device_scanned_hlo``, ``cost_lower_s``,
    ``bytes_unfused_global`` and ``transcendentals`` are not recorded.
    ``flops_local`` is what rank 0's local ops count on the mesh
    (replicated work included), from the same formulas.
  * ``memory``: a dispatch mode under the ``DTensor`` layer follows the
    local shards' storages: ``argument_gb`` (params, state, cache and
    batch as placed), ``output_gb`` (the step's new storages alive at its
    end), ``temp_gb`` (the most new storage alive at once, less the
    outputs), ``alias_gb`` (what the step donates in the reference:
    training its state, decode its cache) and ``peak_gb = argument +
    output + temp - alias``, the reference's formula.  The port's eager
    steps never reuse a donated buffer, so ``peak_undonated_gb`` =
    ``argument + output + temp`` is what one rank's card holds.
  * ``collectives``: ``analysis.hlo.CollectiveCounter`` over the mesh run,
    per device.  On device type ``cpu`` ``DTensor`` runs a shard-to-shard
    all-to-all as an all-gather and a local slice, so such a reshard is
    counted as an all-gather of the whole dim.
  * ``hbm_bytes_per_device_est``, ``roofline`` (``core/energy.py``'s
    ``roofline_terms`` with its H100 SXM data-sheet constants),
    ``model_flops_total``, ``useful_flops_ratio``, ``params`` and
    ``active_params``: the reference's formulas.
  * ``trace_s`` (the reference's ``compile_s``): the mesh run's wall time.
Every record says ``"modelled": true``: it models the reference's meshes
with the data sheet's rates, it measures nothing on a card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._sharding_prop import ShardingPropagator
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.analysis.hlo import CollectiveCounter
from repro_torch.configs import ARCH_CONFIGS, ASSIGNED_ARCHS, SHAPES
from repro_torch.configs.base import (ModelConfig, ShapeSpec, input_specs,
                                      shape_applicable)
from repro_torch.core import energy
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.serve import cache_shardings
from repro_torch.models import transformer as T
from repro_torch.sharding.partition import (distribute, param_shardings,
                                            rules_context)
from repro_torch.training.step import (TrainPlan, init_train_state,
                                       make_decode_step, make_prefill_step,
                                       make_train_step)
from repro_torch.training.tree import tree_leaves, tree_map

WORLD = 512                    # ranks of the fake world: both meshes fit
DEVICE_MODEL = "H100 SXM data sheet (core/energy.py)"
GB = 2 ** 30


def _fake_world(n: int = WORLD):
    """A ``fake`` process group of ``n`` ranks (this process is rank 0),
    unless a group exists already."""
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)


def _mesh_shape(mesh):
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _abstract_model(cfg: ModelConfig, mesh, dtype=None, quantize=False):
    """(params, axes, shardings) under the active ``FakeTensorMode``:
    fake tensors of the model's shapes (nothing allocated), floating
    leaves cast to ``dtype``; ``quantize=True`` builds the W8 serve tree
    ({"q": int8, "s": scale} leaves).  With a mesh the params are
    ``DTensor``s laid out by the config's rules; ``mesh=None`` leaves them
    whole (shardings None)."""
    meta, axes = T.init_model(cfg, None)
    params = tree_map(lambda m: torch.empty(m.shape, dtype=m.dtype), meta)
    if quantize:
        params, axes = T.quantize_model_params(params, axes, cfg)
    if dtype is not None:
        params = tree_map(lambda t: t.to(dtype) if t.is_floating_point()
                          else t, params)
    if mesh is None:
        return params, axes, None
    shardings = param_shardings(axes, mesh, cfg.sharding_overrides, params)
    return distribute(params, shardings), axes, shardings


def _batch_structs(cfg: ModelConfig, shape: ShapeSpec, mesh, overrides=None):
    """The cell's inputs (``input_specs``) as fake tensors, laid out on
    ``mesh`` by the rules; ``cache_pos`` is the Python int ``seq_len - 1``."""
    specs = {k: v for k, v in input_specs(cfg, shape).items()
             if k != "cache_pos"}
    out = {k: torch.empty(shp, dtype=dt) for k, (shp, dt, _) in specs.items()}
    if mesh is not None:
        out = distribute(out, param_shardings(
            {k: ax for k, (_, _, ax) in specs.items()}, mesh,
            cfg.sharding_overrides if overrides is None else overrides, out))
    if shape.kind == "decode":
        out["cache_pos"] = shape.seq_len - 1
    return out


def _microbatches_for(cfg: ModelConfig, shape: ShapeSpec, mesh) -> int:
    """Grad-accum count: keep per-device per-microbatch tokens bounded so
    activations (even with full remat the residual-stream checkpoints scale
    with d_model * layers) fit HBM — larger models get more microbatches."""
    dims = _mesh_shape(mesh)
    dp = 1
    for ax in ("pod", "data"):
        dp *= dims.get(ax, 1)
    per_dev_batch = max(1, shape.global_batch // dp)
    target_tokens = 16384 if cfg.d_model < 4096 else 8192
    nm = max(shape.microbatches,
             (per_dev_batch * shape.seq_len + target_tokens - 1) // target_tokens)
    nm = min(nm, per_dev_batch)
    while per_dev_batch % nm and nm > 1:
        nm -= 1
    return nm


def serve_overrides(cfg):
    """TP-only serve weights: the reference's refuted variant, kept for its
    record and tests — replicating the FSDP ('embed' -> data) dim.  Serving
    keeps the training sharding."""
    return tuple(cfg.sharding_overrides) + (("embed", None),)


def _lower_step(cfg, shape, mesh, quant_serve, place=True):
    """(step, args, donated, extra) of the cell under the active
    ``FakeTensorMode``: ``step(*args)`` runs it once; ``donated`` is the
    argument tree the reference donates (train: the state, decode: the
    cache).  ``place=False`` leaves every argument whole: the global
    program on the same shapes; for training, one microbatch of it."""
    extra = {}
    on = mesh if place else None
    if shape.kind == "train":
        nm = _microbatches_for(cfg, shape, mesh)
        extra["microbatches"] = nm
        if not place:
            # every microbatch is the same program: one of them, counted
            # nm times (extra["flop_scale"]), gives the step's products
            extra["flop_scale"] = nm
            shape = dataclasses.replace(shape,
                                        global_batch=shape.global_batch // nm)
            nm = 1
        plan = TrainPlan(microbatches=nm)
        params, _, _ = _abstract_model(cfg, on)
        state = init_train_state(params, plan)
        batch = _batch_structs(cfg, shape, on)
        return make_train_step(cfg, plan), (state, batch), state, extra
    if shape.kind == "prefill":
        params, _, _ = _abstract_model(cfg, on, torch.bfloat16)
        batch = _batch_structs(cfg, shape, on)
        return make_prefill_step(cfg), (params, batch), None, extra
    # decode keeps the training sharding (the reference's measured choice)
    ov = tuple(cfg.sharding_overrides)
    scfg = (cfg.replace(quant=QuantConfig("w8", quantize_kv=True))
            if quant_serve else cfg)        # C1 at LM scale: int8 W + KV
    params, _, _ = _abstract_model(scfg, on, torch.bfloat16,
                                   quantize=scfg.quant.enabled)
    b, s = shape.global_batch, shape.seq_len
    cache = {k: torch.empty(shp, dtype=dt)
             for k, (shp, dt, _) in T.cache_spec(scfg, b, s).items()}
    if on is not None:
        cache = distribute(cache, cache_shardings(scfg, b, s, on, ov))
    batch = _batch_structs(scfg, shape, on, ov)
    return make_decode_step(scfg), (params, cache, batch), cache, extra


def _local(t):
    return t.to_local() if isinstance(t, DTensor) else t


def _storages(tree):
    """{storage: bytes} of the local tensors of a tree's leaves (tuples,
    dicts and lists of tensors and ``DTensor``s)."""
    out = WeakIdKeyDictionary()
    for x in _leaves(tree):
        st = _local(x).untyped_storage()
        out[st] = st.nbytes()
    return out


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for v in tree for x in _leaves(v)]
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


class _LocalTracker(TorchDispatchMode):
    """Follows the storages the local ops make while active (an op on
    ``DTensor``s goes to ``DTensor`` first, so this sees one rank's shards):
    live and peak bytes of new storages, freed when their last tensor
    goes, and the FLOPs of the local ops by ``FlopCounterMode``'s
    formulas.  ``DTensor`` infers an op's output shape by running it on
    fake tensors of the global shapes (in the active fake mode, the run's
    own); while active, the tracker wraps that inference and leaves its
    ops out."""

    def __init__(self, args):
        super().__init__()
        self.inferring = 0
        self.seen = _storages(args)
        self.arg_bytes = sum(self.seen.values())
        self.live = self.peak = 0
        self.flops = 0
        self._refs = {}

    def _free(self, key, nbytes):
        self.live -= nbytes
        self._refs.pop(key, None)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.inferring:
            return out                 # DTensor's shape inference
        count = flop_registry.get(func._overloadpacket)
        if count is not None:
            self.flops += count(*args, **kwargs, out_val=out)
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self.seen:
                continue
            n = st.nbytes()
            self.seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            key = id(st)
            self._refs[key] = weakref.ref(
                st, lambda _, key=key, n=n: self._free(key, n))
        return out

    def __enter__(self):
        cls = ShardingPropagator
        self._name = next(n for n in ("_propagate_tensor_meta_non_cached",
                                      "_propagate_tensor_meta")
                          if hasattr(cls, n))
        real = self._real = getattr(cls, self._name)

        def inferring(prop, *args, **kwargs):
            self.inferring += 1
            try:
                return real(prop, *args, **kwargs)
            finally:
                self.inferring -= 1
        setattr(cls, self._name, inferring)
        return super().__enter__()

    def __exit__(self, *exc):
        setattr(ShardingPropagator, self._name, self._real)
        return super().__exit__(*exc)

    def memory(self, out, donated) -> dict:
        args = self.arg_bytes
        outs = _storages(out)
        out_b = sum(n for st, n in outs.items() if id(st) in self._refs)
        temp = max(self.peak - out_b, 0)
        alias = min(sum(_storages(donated).values()), out_b) if donated else 0
        return {"argument_gb": args / GB, "output_gb": out_b / GB,
                "temp_gb": temp / GB, "alias_gb": alias / GB,
                "peak_gb": (args + out_b + temp - alias) / GB,
                "peak_undonated_gb": (args + out_b + temp) / GB}


def run_cell(arch: str, shape_name, multi_pod: bool,
             quant_serve: bool = False, skip_cost_pass: bool = False) -> dict:
    """One cell's record.  ``shape_name`` names a cell of ``SHAPES`` or is
    a ``ShapeSpec``; ``skip_cost_pass`` skips the global FLOP pass, and
    ``flops_per_device`` is then rank 0's local count."""
    cfg: ModelConfig = ARCH_CONFIGS[arch]
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    _fake_world()
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape.name,
           "mesh": "x".join(str(s) for s in mesh.shape),
           "chips": chips, "kind": shape.kind, "modelled": True,
           "device_model": DEVICE_MODEL}
    ok, why = shape_applicable(cfg, shape)
    if ok and cfg.moe is not None and cfg.moe.router == "sigmoid":
        ok, why = False, ("skip: LFM2's dropless MoE sizes each expert's "
                          "product from the routing, which fake tensors "
                          "have no values for")
    if not ok:
        rec["status"] = "skipped"
        rec["reason"] = why
        return rec

    t0 = time.time()
    with FakeTensorMode(allow_non_fake_inputs=True), \
            rules_context(mesh, cfg.sharding_overrides):
        step, args, donated, extra = _lower_step(cfg, shape, mesh, quant_serve)
        rec.update(extra)
        tracker, comms = _LocalTracker(args), CollectiveCounter()
        with tracker, comms:
            out = step(*args)
        rec["memory"] = tracker.memory(out, donated)
        del out, args, donated
    rec["trace_s"] = round(time.time() - t0, 1)
    rec["flops_local"] = float(tracker.flops)
    colls = comms.summary()
    rec["collectives"] = colls

    if skip_cost_pass:
        rec["flops_per_device"] = rec["flops_local"]
    else:
        with FakeTensorMode(allow_non_fake_inputs=True):
            step, args, _, glob = _lower_step(cfg, shape, mesh, quant_serve,
                                              place=False)
            with FlopCounterMode(display=False) as fc:
                step(*args)
            del args
        rec["flops_global"] = float(fc.get_total_flops()
                                    * glob.get("flop_scale", 1))
        rec["flops_per_device"] = rec["flops_global"] / chips

    # HBM-traffic estimator (per device), the reference's:
    #   train:   read+write the state once, re-read bf16 weights fwd+bwd per
    #            microbatch, stream activations (~temp) twice per microbatch;
    #   prefill: read args once + 2x transient activations;
    #   decode:  read weights + KV cache once + 2x transients.
    arg_b = rec["memory"]["argument_gb"] * GB
    tmp_b = rec["memory"]["temp_gb"] * GB
    n_params = T.num_params(cfg)
    if shape.kind == "train":
        nm = rec.get("microbatches", 1)
        wb = 2 * n_params / chips          # bf16 weight copy per device
        hbm = 2 * arg_b + nm * 2 * wb + nm * 2 * tmp_b
    else:
        hbm = arg_b + 2 * tmp_b
    rec["hbm_bytes_per_device_est"] = hbm
    terms = energy.roofline_terms(rec["flops_per_device"], hbm,
                                  colls.get("total", 0.0))
    rec["roofline"] = terms.asdict()

    n_act = T.num_active_params(cfg)
    if shape.kind == "train":
        mf = energy.model_flops_train(n_params, shape.global_batch * shape.seq_len,
                                      n_act)
    elif shape.kind == "prefill":
        mf = energy.model_flops_decode(n_params, shape.global_batch * shape.seq_len,
                                       n_act)
    else:
        mf = energy.model_flops_decode(n_params, shape.global_batch, n_act)
    rec["model_flops_total"] = mf
    total = rec["flops_per_device"] * chips
    rec["useful_flops_ratio"] = (mf / total) if total else None
    rec["params"] = n_params
    rec["active_params"] = n_act
    rec["status"] = "ok"
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--quant-serve", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.json")
    args = ap.parse_args()

    archs = ASSIGNED_ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"], r.get("quant", False))
            for r in results}

    for a, s, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        key = (a, s, mesh_name, args.quant_serve)
        if key in done:
            print(f"[skip-cached] {key}", flush=True)
            continue
        print(f"[run] {a} x {s} x {mesh_name}", flush=True)
        try:
            rec = run_cell(a, s, mp, args.quant_serve)
        except Exception as e:
            rec = {"arch": a, "shape": s, "mesh": mesh_name,
                   "status": "error", "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:]}
        rec["quant"] = args.quant_serve
        results.append(rec)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"  -> {rec.get('status')} "
              f"trace={rec.get('trace_s', '-')}s "
              f"flops/dev={rec.get('flops_per_device', 0):.3g} "
              f"bound={rec.get('roofline', {}).get('bound', '-')}", flush=True)

    bad = [r for r in results if r.get("status") == "error"]
    print(f"\n{len(results)} cells recorded, {len(bad)} errors")
    if dist.is_initialized():
        dist.destroy_process_group()
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
