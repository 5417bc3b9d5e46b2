"""The port's logical-axis sharding rules (``sharding.partition``), meshes
(``launch.mesh``) and the decode cache's axes, against the JAX package.

The reference's ``resolve_rules`` and ``logical_to_spec`` read only a
mesh's axis names and sizes, so both packages run on the same stub mesh
(no devices).  Specs compare as tuples: a ``PartitionSpec``'s entries
against the port's spec tuple.  The production meshes are built over a
fake process group of 256 and 512 ranks; ``constrain`` and the
``DTensor`` placements run on a one-rank gloo group opened and closed
by their test.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs import ARCH_CONFIGS, REFERENCE_LM_ARCHS, reduce_config
from repro_torch.configs.base import batch_axes
from repro_torch.launch import mesh as M
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P

try:  # the JAX reference; the card's machine has none
    import jax
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.configs.base import batch_axes as j_batch_axes
    from repro.models import transformer as JT
    from repro.sharding import partition as JP
except ImportError:
    jax = None

PRODUCTION = {"single_pod": {"data": 16, "model": 16},
              "multi_pod": {"pod": 2, "data": 16, "model": 16}}


class StubMesh:
    """Axis names and sizes, as both packages' rule functions read them."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = self.mesh_dim_names = tuple(shape)

    def size(self, dim=None):
        return self.shape[self.mesh_dim_names[dim]]


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


@pytest.fixture
def gloo():
    """A one-rank gloo group for the test, destroyed after it."""
    assert not dist.is_initialized()
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    yield
    dist.destroy_process_group()


def _flat(tree, leaf, prefix=()):
    """{path: leaf(x)} over dicts and lists (tuples are leaves)."""
    if isinstance(tree, dict):
        return {k: v for key in tree
                for k, v in _flat(tree[key], leaf, prefix + (str(key),)).items()}
    if isinstance(tree, list):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, leaf, prefix + (str(i),)).items()}
    return {"/".join(prefix): leaf(tree)}


def _ref_specs(cfg, mesh):
    """The reference's param_shardings, spec by spec, on a stub mesh."""
    box = {}

    def init():
        params, box["axes"] = JT.init_model(cfg, jax.random.key(0))
        return params
    shapes = jax.eval_shape(init)
    rules = JP.resolve_rules(mesh, cfg.sharding_overrides)
    axes = _flat(box["axes"], lambda a: a)
    return {k: tuple(JP.logical_to_spec(axes[k], rules, tuple(s.shape), mesh))
            for k, s in _flat(shapes, lambda s: s).items()}


def _port_specs(cfg, mesh):
    params, axes = T.init_model(cfg, None)          # shapes only, on meta
    sh = P.param_shardings(axes, mesh, cfg.sharding_overrides, params)
    return _flat(sh, lambda s: s.spec)


@pytest.mark.usefixtures("ref")
def test_default_rules_and_production_tp_are_the_references():
    assert P.DEFAULT_RULES == JP.DEFAULT_RULES
    assert P.PRODUCTION_TP == JP.PRODUCTION_TP
    assert batch_axes() == j_batch_axes()


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("shape", [{"data": 2, "model": 4},
                                   {"pod": 2, "data": 16, "model": 16},
                                   {"replica": 4}], ids=["dm", "pdm", "replica"])
@pytest.mark.parametrize("overrides", [(), (("experts", "model"),
                                            ("expert_mlp", None)),
                                       (("batch", "data"),)],
                         ids=["default", "ep", "batch-data"])
def test_resolve_rules_matches_reference(shape, overrides):
    mesh = StubMesh(shape)
    assert P.resolve_rules(mesh, overrides) == JP.resolve_rules(mesh, overrides)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
@pytest.mark.parametrize("axes,shape", [
    (("batch", None, "kv_heads", None), (256, 4096, 8, 128)),    # 8 KV heads / 16
    (("batch", None, "kv_heads", None), (1, 4096, 16, 128)),     # batch 1
    (("batch", None), (16, 4096)),                               # 16 over pod x data
    (("batch", None), (512, 4096)),
    (("embed", "heads", "head_dim"), (2048, 12, 128)),           # 12 heads / 16
    (("embed", "mlp"), (4096, 14336)),
    (("experts", "embed", "expert_mlp"), (8, 4096, 14336)),
    (("layers", "batch", "kv_seq", "kv_heads", None), (24, 128, 32768, 2, 64)),
    (("vocab", "embed"), (151936, 1024)),
    (("heads", "heads"), (32, 32)),                              # an axis once
], ids=lambda v: "x".join(map(str, v)) if isinstance(v[0], int) else None)
def test_logical_to_spec_matches_reference(mesh_name, axes, shape):
    mesh = StubMesh(PRODUCTION[mesh_name])
    rules = P.resolve_rules(mesh)
    want = JP.logical_to_spec(axes, JP.resolve_rules(mesh), shape, mesh)
    assert P.logical_to_spec(axes, rules, shape, mesh) == tuple(want)
    # without a shape no divisibility guard applies
    assert P.logical_to_spec(axes, rules) == tuple(
        JP.logical_to_spec(axes, JP.resolve_rules(mesh)))


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_param_shardings_match_reference_for_every_arch(arch, mesh_name):
    """Every leaf's spec at the published widths and at ``reduce_config``'s,
    on (16, 16) and (2, 16, 16): phi3.5-moe's expert-parallel override
    included."""
    mesh = StubMesh(PRODUCTION[mesh_name])
    for j_cfg, cfg in ((J_ARCHS[arch], ARCH_CONFIGS[arch]),
                       (j_reduce(J_ARCHS[arch]), reduce_config(ARCH_CONFIGS[arch]))):
        assert cfg.sharding_overrides == j_cfg.sharding_overrides
        assert _port_specs(cfg, mesh) == _ref_specs(j_cfg, mesh)
    if arch == "phi3.5-moe":
        specs = _port_specs(ARCH_CONFIGS[arch], mesh)
        assert specs["blocks/mlp/w_up"] == (None, "model", "data", None)


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("mesh_name", sorted(PRODUCTION))
def test_lfm2_param_and_cache_shardings(mesh_name, reduced):
    """The port's own LFM2-8B-A1B (no JAX counterpart) on the production
    meshes: every leaf of its per-layer tree gets a spec from the rules,
    each split dim divides, the experts' width splits over ``model``
    where it divides, and the session table's KV and conv state split
    their batch."""
    from repro_torch.launch.serve import cache_shardings
    cfg = ARCH_CONFIGS["lfm2-8b-a1b"]
    cfg = reduce_config(cfg) if reduced else cfg
    mesh = StubMesh(PRODUCTION[mesh_name])
    params, _ = T.init_model(cfg, None)
    specs = _port_specs(cfg, mesh)
    shapes = _flat(params, lambda t: tuple(t.shape))
    assert set(specs) == set(shapes) and len(specs) > 10 * cfg.n_layers
    for path, spec in specs.items():
        for dim, ax in zip(shapes[path], spec):
            names = (ax,) if isinstance(ax, str) else tuple(ax or ())
            assert dim % int(np.prod([mesh.shape[n] for n in names])) == 0, \
                (path, spec)
    moe = next(i for i in range(cfg.n_layers) if cfg.moe_layer(i))
    f = cfg.moe.d_ff
    assert specs[f"layers/{moe}/mlp/w_up"][-1] == \
        ("model" if f % mesh.shape["model"] == 0 else None)
    cache = {k: v.spec for k, v in
             cache_shardings(cfg, 256, 8192, mesh).items()}
    assert set(cache) == {"k", "v", "conv"}
    assert cache["conv"][1] is not None and cache["k"][1] is not None


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("quantize_kv", [False, True], ids=["bf16-kv", "int8-kv"])
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_cache_spec_matches_reference(arch, quantize_kv):
    """Names, shapes, dtypes and logical axes of the decode cache, the
    PRODUCTION_TP choice between ``kv_heads`` and ``kv_seq`` included."""
    from repro.core.quant import QuantConfig as JQuant
    from repro_torch.core.quant import QuantConfig
    mode = "w8a8" if quantize_kv else "none"
    j_cfg = J_ARCHS[arch].replace(quant=JQuant(mode, quantize_kv=quantize_kv))
    cfg = ARCH_CONFIGS[arch].replace(quant=QuantConfig(mode, quantize_kv=quantize_kv))
    got = T.cache_spec(cfg, 4, 4096)
    want = JT.cache_spec(j_cfg, 4, 4096)
    assert list(got) == list(want)
    for k, (shape, dtype, axes) in got.items():
        w_shape, w_dtype, w_axes = want[k]
        assert (shape, axes) == (tuple(w_shape), w_axes), k
        assert str(dtype).replace("torch.", "") == np.dtype(w_dtype).name, k
    cache = T.init_cache(cfg, 1, 64)
    assert {k: (tuple(v.shape), v.dtype) for k, v in cache.items()} == {
        k: (sh, dt) for k, (sh, dt, _) in T.cache_spec(cfg, 1, 64).items()}


def test_spec_to_placements():
    mesh = StubMesh({"pod": 2, "data": 4, "model": 8})
    assert P.spec_to_placements((("pod", "data"), None, "model"), mesh) == (
        Shard(0), Shard(0), Shard(2))
    assert P.spec_to_placements((None, "data"), mesh) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        P.spec_to_placements((("data", "pod"),), mesh)
    # an axis of size 1 replicates
    one = StubMesh({"data": 1, "model": 1})
    assert P.spec_to_placements(("data", "model"), one) == (Replicate(),) * 2


def test_param_shardings_records_mesh_spec_and_placements():
    mesh = StubMesh({"data": 2, "model": 4})
    params, axes = T.init_model(reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]), None)
    sh = P.param_shardings(axes, mesh, (), params)
    wq = sh["blocks"]["mixer"]["wq"]          # (layers, embed, heads, head_dim)
    assert wq.mesh is mesh and wq.spec == (None, "data", "model", None)
    assert wq.placements == (Shard(1), Shard(2))
    # 2 KV heads do not divide 4-way TP: replicated, the embed dim still split
    assert sh["blocks"]["mixer"]["wk"].spec == (None, "data", None, None)
    # without shapes the rule's axes stand
    assert P.param_shardings(axes, mesh)["blocks"]["mixer"]["wk"].spec == (
        None, "data", "model", None)


def test_constrain_is_a_no_op_outside_a_context_and_raises_on_a_plain_tensor():
    x = torch.ones(4, 8)
    assert P.constrain(x, "batch", None) is x
    mesh = StubMesh({"data": 2, "model": 2})
    with P.rules_context(mesh):
        with pytest.raises(TypeError, match="plain Tensor inside a rules"):
            P.constrain(x, "batch", None)
    assert P.constrain(x, "batch", None) is x


def test_constrain_redistributes_a_dtensor_on_a_one_rank_mesh(gloo):
    mesh = M.make_host_mesh(device_type="cpu")
    assert tuple(mesh.mesh_dim_names) == ("data", "model")
    assert tuple(mesh.shape) == (1, 1)
    x = distribute_tensor(torch.arange(24.0).reshape(4, 6), mesh,
                          (Replicate(), Replicate()))
    with P.rules_context(mesh):
        y = P.constrain(x, "batch", "mlp")
        assert isinstance(y, DTensor)
        assert tuple(y.placements) == (Replicate(), Replicate())
        # plain constants meet DTensors as replicated inside the context
        z = y * torch.full((4, 6), 2.0)
        assert torch.equal(z.full_tensor(), torch.arange(24.0).reshape(4, 6) * 2)
    tree = {"w": [torch.ones(2, 3)], "b": torch.zeros(3)}
    sh = P.param_shardings({"w": [("embed", "mlp")], "b": ("mlp",)}, mesh)
    out = P.distribute(tree, sh)
    assert isinstance(out["w"][0], DTensor)
    assert torch.equal(out["w"][0].full_tensor(), tree["w"][0])


def test_make_host_mesh_checks_its_arguments(gloo):
    with pytest.raises(ValueError, match="does not divide"):
        M.make_host_mesh(model_parallel=2, device_type="cpu")
    with pytest.raises(ValueError, match="unknown device type"):
        M.make_host_mesh(device_type="tpu")


def test_make_host_mesh_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_host_mesh()
    assert not dist.is_initialized()


@pytest.fixture
def fake_world():
    """A fake process group of ``world`` ranks (this process is rank 0)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def open_(world):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world)
    yield open_
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("world,multi_pod", [(256, False), (512, False),
                                             (512, True)])
def test_make_production_mesh_over_a_fake_world(fake_world, world, multi_pod):
    fake_world(world)
    mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    want = ({"pod": 2, "data": 16, "model": 16} if multi_pod
            else {"data": 16, "model": 16})
    assert tuple(mesh.mesh_dim_names) == tuple(want)
    assert tuple(mesh.shape) == tuple(want.values())
    assert mesh.size() == 2 ** (8 + multi_pod)
    rules = P.resolve_rules(mesh)
    assert P.logical_to_spec(("batch", None), rules, (512, 8), mesh) == (
        (("pod", "data") if multi_pod else "data"), None)


@pytest.mark.parametrize("world", [None, 255])
def test_make_production_mesh_raises_when_the_world_is_short(fake_world, world):
    if world:
        fake_world(world)
    with pytest.raises(RuntimeError, match="need 256 ranks"):
        M.make_production_mesh(device_type="cpu")
    if world:
        with pytest.raises(RuntimeError, match="need 512 ranks"):
            M.make_production_mesh(multi_pod=True, device_type="cpu")


def test_make_serving_mesh_and_replica_shardings():
    cpu = torch.device("cpu")
    mesh = M.make_serving_mesh(1, kind="cpu")
    assert mesh.axis_names == ("replica",) and mesh.devices == (cpu,)
    assert P.replica_shardings(mesh) == [cpu]
    pinned = P.pin_to_device({"w": [torch.ones(2)], "s": torch.zeros(1)},
                             P.replica_shardings(mesh)[0])
    assert pinned["w"][0].device == cpu and pinned["s"].device == cpu
    with pytest.raises(RuntimeError, match="distinct devices"):
        M.make_serving_mesh(2, kind="cpu")            # oversubscribed
    with pytest.raises(RuntimeError, match="distinct devices"):
        M.make_serving_mesh(2, devices=["cpu", "cpu"])
    with pytest.raises(RuntimeError, match="need 2 devices"):
        M.make_serving_mesh(2, oversubscribe=False, kind="cpu")
    with pytest.raises(ValueError, match="replica"):
        P.replica_shardings(StubMesh({"data": 2}))


def test_serving_devices_takes_the_card_by_default():
    """``kind=None`` means the CUDA cards: where there is none it raises
    rather than fall back to the CPU."""
    if torch.cuda.is_available():
        assert M.serving_devices(1)[0].type == "cuda"
        return
    with pytest.raises(RuntimeError, match="no cuda device"):
        M.serving_devices(1)
    with pytest.raises(RuntimeError, match="no cuda device"):
        M.make_serving_mesh(1)
    assert M.serving_devices(2, kind="cpu") == [torch.device("cpu")] * 2


def test_pipeline_lays_batches_out_by_key(gloo):
    """``Pipeline(shardings=)``: the keys it names leave as DTensors in
    their placements, the others as plain tensors, values unchanged."""
    from repro_torch.data.pipeline import Pipeline
    from repro_torch.launch.train import batch_shardings
    mesh = M.make_host_mesh(device_type="cpu")
    src = lambda step: {"tokens": np.full((4, 8), step, np.int32),  # noqa: E731
                        "labels": np.arange(32, dtype=np.int32).reshape(4, 8)}
    like = {k: torch.as_tensor(v) for k, v in src(0).items()}
    sh = batch_shardings({"tokens": like["tokens"]}, mesh)
    assert sh["tokens"].spec == ("data", None)
    pipe = Pipeline(src, device="cpu", start_step=3, shardings=sh)
    try:
        batch = next(pipe)
    finally:
        pipe.close()
    assert isinstance(batch["tokens"], DTensor)
    assert tuple(batch["tokens"].placements) == sh["tokens"].placements
    assert torch.equal(batch["tokens"].full_tensor(), torch.full((4, 8), 3,
                                                                 dtype=torch.int32))
    assert not isinstance(batch["labels"], DTensor)
    with pytest.raises(ValueError, match="cannot take a batch"):
        Pipeline(src, device="meta", shardings=sh)


TRAIN_ARGV = ["--arch", "qwen1.5-0.5b", "--preset", "tiny", "--batch", "4",
              "--seq", "8", "--lr", "1e-3", "--device", "cpu", "--log-every", "1"]


def _plain_steps(steps):
    """``launch.train``'s params, plan and batches with no mesh."""
    from repro_torch.data.lm_data import SyntheticLM
    from repro_torch.training import step as TS
    from repro_torch.training.optimizer import OptConfig
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0))
    plan = TS.TrainPlan(opt=OptConfig(lr=1e-3, warmup_steps=10,
                                      total_steps=steps))
    state, step_fn = TS.init_train_state(params, plan), TS.make_train_step(cfg, plan)
    src, losses = SyntheticLM(cfg.vocab_size, seed=0), []
    for i in range(steps):
        state, m = step_fn(state, {k: torch.as_tensor(v)
                                   for k, v in src.batch(i, 4, 8).items()})
        losses.append(float(m["loss"]))
    return state, losses


def _same_state(mesh_state, plain_state):
    from repro_torch.training.tree import tree_leaves_with_path
    a, b = tree_leaves_with_path(mesh_state), tree_leaves_with_path(plain_state)
    assert [p for p, _ in a] == [p for p, _ in b]
    for (p, x), (_, y) in zip(a, b):
        x = x.to_local() if isinstance(x, DTensor) else x
        assert torch.equal(x, y), p


def test_launch_train_on_the_one_rank_mesh_equals_the_plain_step():
    """``launch.train`` trains under the host mesh (a one-rank gloo group
    it opens and closes): DTensor params and moments, and the same
    losses and state as the plain step, bit for bit."""
    from repro_torch.launch import train as TL
    out = TL.main(TRAIN_ARGV + ["--steps", "3"], log=lambda *_: None)
    assert not dist.is_initialized()
    state = out["state"]
    assert isinstance(state["params"]["embed"], DTensor)
    assert isinstance(state["opt"]["mu"]["blocks"]["mlp"]["w_up"], DTensor)
    plain, losses = _plain_steps(3)
    assert [h["loss"] for h in out["history"]] == losses
    _same_state(state, plain)


def test_launch_train_resumes_on_the_mesh_bit_for_bit(tmp_path):
    """4 straight steps == 2 steps ended by SIGTERM (a DTensor checkpoint)
    + ``launch.train`` rerun, resuming through ``maybe_resume(shardings=)``."""
    import os
    import signal
    from repro_torch.launch import train as TL
    from repro_torch.training import checkpoint as tck

    def preempt_at_2(msg):
        if msg.startswith("[step 2]"):
            os.kill(os.getpid(), signal.SIGTERM)

    argv = TRAIN_ARGV + ["--steps", "4", "--ckpt-dir", str(tmp_path / "ck")]
    cut = TL.main(argv, log=preempt_at_2)
    assert cut["preempted"] and cut["step"] == 2
    assert tck.latest_step(str(tmp_path / "ck")) == 2
    resumed = TL.main(argv, log=lambda *_: None)
    assert resumed["step"] == 4 and not resumed["preempted"]
    assert isinstance(resumed["state"]["opt"]["nu"]["embed"], DTensor)
    plain, _ = _plain_steps(4)
    _same_state(resumed["state"], plain)
