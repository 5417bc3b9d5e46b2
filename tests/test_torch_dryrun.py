"""The LM dry run's pieces against the reference, and the dry run itself
on small fake worlds.

* ``configs.shape_applicable`` and ``configs.input_specs`` equal the
  reference's for every arch and shape (shapes, dtypes mapped, logical
  axes); ``analysis.hlo.collective_bytes`` equals the reference's parser
  on ``tests/test_data_analysis.py``'s module and three more;
  ``core.accelerator.lstm_weight_bytes`` equals the reference's.
* ``launch.dryrun.run_cell`` on a fake 8-rank (2 data x 4 model) world at
  reduced configs, a small ``ShapeSpec`` per kind, the production mesh
  swapped for the small one as the reference's
  ``test_dryrun_single_cell_small_mesh`` swaps it: the cell is "ok" with
  FLOPs and collective bytes above 0; ``flops_global`` equals
  ``FlopCounterMode`` over the same step on real CPU tensors; the
  collective bytes equal ``CollectiveCounter``'s reading of the same
  step on 8 real gloo ranks; the per-device argument bytes are each
  leaf's shard (numel x itemsize over the shards of its own spec); a
  1 x 1 world moves nothing; ``analysis.report`` renders the records.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from gloo_ranks import run_ranks
from repro_torch.analysis import hlo as thlo
from repro_torch.analysis import report as treport
from repro_torch.configs import (ARCH_CONFIGS, REFERENCE_LM_ARCHS, SHAPES,
                                 input_specs, reduce_config, shape_applicable)
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D

try:  # the JAX reference; the card's machine has none
    import jax.numpy as jnp
    from repro.analysis import hlo as jhlo
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import input_specs as j_input_specs
    from repro.configs import shape_applicable as j_shape_applicable
    from repro.core import accelerator as jacc
except ImportError:
    jnp = None

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module")
def ref():
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


# ---------------------------------------------------------------------------
# configs, the HLO parser, the weight-bytes alias
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_shape_applicable_and_input_specs_match_reference(arch):
    dtypes = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16}
    assert list(SHAPES) == list(J_SHAPES)
    for name in SHAPES:
        t_cfg, j_cfg = ARCH_CONFIGS[arch], J_ARCHS[arch]
        assert shape_applicable(t_cfg, SHAPES[name]) == \
            j_shape_applicable(j_cfg, J_SHAPES[name])
        got, want = input_specs(t_cfg, SHAPES[name]), \
            j_input_specs(j_cfg, J_SHAPES[name])
        assert list(got) == list(want), (arch, name)
        for k, (shp, dt, axes) in want.items():
            assert got[k] == (shp, dtypes[dt], axes), (arch, name, k)


MORE_HLO = (
    # tuple results of a plain (synchronous) all-to-all and all-gather
    """
  %a2a = (bf16[4,64]{1,0}, bf16[4,64]{1,0}) all-to-all(bf16[4,64]{1,0} %a, bf16[4,64]{1,0} %b)
  %agt = (f32[16]{0}, s32[8]{0}) all-gather(f32[2]{0} %c, s32[1]{0} %d)
""",
    # async -start / -done pairs of every kind, -done echoes excluded
    """
  %ags = (bf16[2,8]{1,0}, bf16[16,8]{1,0}) all-gather-start(bf16[2,8]{1,0} %p)
  %agd = bf16[16,8]{1,0} all-gather-done(%ags)
  %cps = (f32[32]{0}, f32[32]{0}, u32[], u32[]) collective-permute-start(f32[32]{0} %q)
  %cpd = f32[32]{0} collective-permute-done(%cps)
  %rss = ((s8[64]{0}), s8[8]{0}) reduce-scatter-start(s8[64]{0} %r)
""",
    # an unknown dtype contributes nothing but the op still counts
    """
  %odd = f8e4m3b11fnuz[128]{0} all-reduce(f8e4m3b11fnuz[128]{0} %x), to_apply=%add
  %ok = pred[7]{0} all-reduce(pred[7]{0} %y), to_apply=%or
""",
)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("case", range(1 + len(MORE_HLO)))
def test_collective_bytes_matches_reference(case):
    if case == 0:
        from test_data_analysis import HLO as text
    else:
        text = MORE_HLO[case - 1]
    got, want = thlo.collective_bytes(text), jhlo.collective_bytes(text)
    assert got == want
    assert got["count"] > 0


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("hidden,layers", [(20, 1), (64, 2)])
def test_lstm_weight_bytes_alias_matches_reference(hidden, layers):
    from repro.core.qlstm import QLSTMConfig as JQ
    from repro_torch.core import accelerator as tacc
    from repro_torch.core.qlstm import QLSTMConfig as TQ
    t_cfg, j_cfg = TQ(hidden_size=hidden, num_layers=layers), \
        JQ(hidden_size=hidden, num_layers=layers)
    got = tacc.lstm_weight_bytes(t_cfg, tacc.PAPER_DEFAULT)
    assert got == jacc.lstm_weight_bytes(j_cfg, jacc.PAPER_DEFAULT)
    assert got == tacc.weight_bytes(t_cfg, tacc.PAPER_DEFAULT)
    if (hidden, layers) == (20, 1):   # tests/test_qlstm.py's accounting
        assert got == (21 * 80) + 4 * 20 * 2 + 20 * 1 + 1 * 2


# ---------------------------------------------------------------------------
# the dry run on fake worlds
# ---------------------------------------------------------------------------

ARCH = "qwen1.5-0.5b-tiny"
CELLS = {"train": ShapeSpec("train_s", "train", 32, 8, microbatches=2),
         "prefill": ShapeSpec("prefill_s", "prefill", 32, 4),
         "decode": ShapeSpec("decode_s", "decode", 32, 8)}


def _small_mesh(shape):
    def make(*, multi_pod=False, device_type="cpu"):
        return DeviceMesh(device_type, torch.arange(int(np.prod(shape)))
                          .reshape(shape), mesh_dim_names=("data", "model"))
    return make


@pytest.fixture
def fake_world(monkeypatch):
    """A fake process group of ``world`` ranks and the reduced arch
    registered under :data:`ARCH`; the production mesh swapped for a
    (data, model) mesh of ``shape``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    monkeypatch.setitem(D.ARCH_CONFIGS, ARCH,
                        reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]))

    def open_(shape):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=int(np.prod(shape)))
        monkeypatch.setattr(D, "make_production_mesh", _small_mesh(shape))
    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def records():
    """Each kind's record on the fake (2, 4) world, in a child process (a
    fake world and a gloo group cannot share this one)."""
    code = f"""
import json, torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
D.ARCH_CONFIGS[{ARCH!r}] = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
D.make_production_mesh = lambda *, multi_pod=False, device_type="cpu": DeviceMesh(
    device_type, torch.arange(8).reshape(2, 4), mesh_dim_names=("data", "model"))
cells = {json.dumps({k: list(v.__dict__.values()) for k, v in CELLS.items()})}
print(json.dumps({{k: D.run_cell({ARCH!r}, ShapeSpec(*v), False)
                  for k, v in cells.items()}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_dryrun_single_cell_small_mesh(records):
    """The port's counterpart of the reference's small-mesh dry run: each
    kind's cell is "ok", modelled, with FLOPs, collective bytes and every
    record key the reports read."""
    for kind, rec in records.items():
        assert rec["status"] == "ok", rec
        assert rec["modelled"] is True and rec["mesh"] == "2x4"
        assert rec["chips"] == 8 and rec["kind"] == kind
        assert rec["flops_per_device"] > 0 and rec["flops_global"] > 0
        assert rec["collectives"]["total"] > 0 and rec["collectives"]["count"] > 0
        assert rec["flops_per_device"] == rec["flops_global"] / 8
        mem = rec["memory"]
        assert mem["peak_gb"] == pytest.approx(
            mem["argument_gb"] + mem["output_gb"] + mem["temp_gb"]
            - mem["alias_gb"])
        assert mem["peak_undonated_gb"] >= mem["peak_gb"] > mem["argument_gb"]
        assert rec["roofline"]["bound"] in ("compute", "memory", "collective")
        assert rec["useful_flops_ratio"] > 0 and "trace_s" in rec
    assert records["train"]["microbatches"] == 2
    assert records["prefill"]["memory"]["alias_gb"] == 0
    # decode donates its cache, training its state
    for kind in ("train", "decode"):
        assert 0 < records[kind]["memory"]["alias_gb"] <= \
            records[kind]["memory"]["output_gb"]


def _real_args(kind):
    """The cell's global step and its arguments as real CPU tensors of
    zeros, whole, as the dry run's FLOP pass builds them."""
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
    step, args, _, _ = D._lower_step(cfg, CELLS[kind], D.make_production_mesh(),
                                     False, place=False)
    for t in D._leaves(args):
        t.zero_()
    return step, args


@pytest.mark.parametrize("kind", list(CELLS))
def test_flops_global_equals_flop_counter_on_real_tensors(records, fake_world,
                                                          kind):
    """The record's global FLOPs against ``FlopCounterMode`` over the same
    step on real (zero) CPU tensors without the mesh, every microbatch
    run."""
    from torch.utils.flop_counter import FlopCounterMode
    fake_world((2, 4))
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
    if kind == "train":
        from repro_torch.training.step import (TrainPlan, init_train_state,
                                               make_train_step)
        from repro_torch.models import transformer as T
        plan = TrainPlan(microbatches=records[kind]["microbatches"])
        params, _ = T.init_model(cfg, torch.Generator().manual_seed(0))
        b, s = CELLS[kind].global_batch, CELLS[kind].seq_len
        batch = {"tokens": torch.zeros((b, s), dtype=torch.int32),
                 "labels": torch.zeros((b, s), dtype=torch.int32)}
        step, args = make_train_step(cfg, plan), (init_train_state(params, plan),
                                                  batch)
    else:
        step, args = _real_args(kind)
    with FlopCounterMode(display=False) as fc:
        step(*args)
    assert records[kind]["flops_global"] == fc.get_total_flops() > 0


def test_flop_counter_under_dtensor_mixes_global_and_local_shapes(fake_world):
    """What ``FlopCounterMode`` sees under ``DTensor`` (torch 2.13), the
    reason the dry run counts the global program without the mesh: an op
    on ``DTensor``s at its global shapes, a ``local_map`` body at its local
    shapes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import local_map
    from torch.utils.flop_counter import FlopCounterMode
    fake_world((2, 4))
    mesh = D.make_production_mesh()
    m, k, n = 64, 32, 16
    rows, whole = (Shard(0), Replicate()), (Replicate(), Replicate())

    def counted(fn):
        with FakeTensorMode():
            x = distribute_tensor(torch.empty(m, k), mesh, rows, src_data_rank=None)
            w = distribute_tensor(torch.empty(k, n), mesh, whole,
                                  src_data_rank=None)
            with FlopCounterMode(display=False) as fc:
                fn(x, w)
        return fc.get_total_flops()

    glob, loc = 2 * m * k * n, 2 * (m // 2) * k * n
    assert counted(lambda x, w: x @ w) == glob
    assert counted(lambda x, w: local_map(
        torch.matmul, out_placements=(rows,), in_placements=(rows, whole),
        device_mesh=mesh)(x, w)) == loc


RANK_RUN = """
from repro_torch.analysis.hlo import CollectiveCounter
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding.partition import rules_context
cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
mesh = make_host_mesh(model_parallel=4, device_type="cpu")
out = {}
for kind, spec in %(cells)s.items():
    with rules_context(mesh, cfg.sharding_overrides):
        step, args, _, _ = D._lower_step(cfg, ShapeSpec(*spec), mesh, False)
        for t in D._leaves(args):
            D._local(t).zero_()
        with CollectiveCounter() as cc:
            step(*args)
    out[kind] = cc.summary()
print(json.dumps(out))
"""


def test_collective_bytes_equal_the_counter_on_gloo_ranks(records, tmp_path):
    """The same cells on 8 real gloo ranks (zero tensors), each rank's
    ``CollectiveCounter`` reading against the fake world's record."""
    cells = {k: list(v.__dict__.values()) for k, v in CELLS.items()}
    ranks = run_ranks(RANK_RUN % {"cells": cells}, 8, str(tmp_path / "store"))
    for kind, rec in records.items():
        for r in ranks:
            assert r[kind] == rec["collectives"], kind


def test_argument_bytes_are_each_leafs_shard(records, fake_world):
    """Per-device argument bytes of the prefill cell: every param leaf's
    numel x itemsize over the shards of its own spec (bf16 serve cast),
    plus the token ids' shard."""
    from repro_torch.models import transformer as T
    from repro_torch.sharding.partition import param_shardings
    fake_world((2, 4))
    mesh = D.make_production_mesh()
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
    meta, axes = T.init_model(cfg, None)
    sh = param_shardings(axes, mesh, cfg.sharding_overrides, meta)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0
    for leaf, s in zip(_sharding_leaves(meta), _sharding_leaves(sh)):
        shards = 1
        for entry in s.spec:
            for ax in ((entry,) if isinstance(entry, str) else entry or ()):
                shards *= sizes[ax]
        total += leaf.numel() * 2 // shards          # bf16
    b, s_len = CELLS["prefill"].global_batch, CELLS["prefill"].seq_len
    total += b * s_len * 4 // sizes["data"]          # int32 tokens over "data"
    assert records["prefill"]["memory"]["argument_gb"] * 2 ** 30 == total


def _sharding_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _sharding_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in _sharding_leaves(v)]
    return [tree]


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_one_rank_world_moves_nothing(fake_world, kind):
    fake_world((1, 1))
    rec = D.run_cell(ARCH, CELLS[kind], False)
    assert rec["status"] == "ok" and rec["mesh"] == "1x1"
    assert rec["collectives"] == {"total": 0, "count": 0}
    assert rec["flops_per_device"] == rec["flops_global"]


def test_lfm2_shapes_and_dry_run_cells(fake_world):
    """The port's own LFM2-8B-A1B (no JAX counterpart): its inputs per
    cell, the 500k-token decode skipped as for any full-attention arch,
    and the other cells recorded as skipped by the dry run, whose fake
    tensors cannot size the dropless MoE's products."""
    cfg = ARCH_CONFIGS["lfm2-8b-a1b"]
    fake_world((2, 4))
    for name, shape in SHAPES.items():
        specs = input_specs(cfg, shape)
        b = shape.global_batch
        s = 1 if shape.kind == "decode" else shape.seq_len
        assert specs["tokens"] == ((b, s), torch.int32, ("batch", None))
        assert ("cache_pos" in specs) == (shape.kind == "decode")
        rec = D.run_cell("lfm2-8b-a1b", name, False)
        assert rec["status"] == "skipped", name
        why = "quadratic" if name == "long_500k" else "dropless"
        assert shape_applicable(cfg, shape)[0] == (name != "long_500k")
        assert why in rec["reason"], name


def test_skipped_cell_and_reports_render(records, fake_world):
    """``long_500k`` of a full-attention arch is skipped by the reference's
    rule; ``analysis.report`` renders ok and skipped records alike."""
    fake_world((2, 4))
    skipped = D.run_cell("qwen1.5-0.5b", "long_500k", False)
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
    # under the production mesh's name, which the tables select
    recs = [dict(r, mesh="16x16") for r in list(records.values()) + [skipped]]
    table = treport.dryrun_table(recs, "16x16")
    lines = table.splitlines()
    assert len(lines) == 2 + len(recs)
    assert any("| ok |" in ln and "train_s" in ln for ln in lines)
    assert any("skipped" in ln and "long_500k" in ln for ln in lines)
    trace = {r["shape"]: r["trace_s"] for r in records.values()}
    assert all(f"| {trace[r['shape']]} |" in table for r in records.values())
    roof = treport.roofline_table(recs).splitlines()
    assert len(roof) == 2 + len(records)
    assert all(f"**{r['roofline']['bound']}**" in "\n".join(roof)
               for r in records.values())
