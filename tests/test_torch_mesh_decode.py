"""Prefill and decode of the sharded LM on real multi-rank meshes: gloo
ranks on the CPU, one subprocess each (``tests/gloo_ranks.py``), on a
(2 data x 4 model) and a (2 x 2) mesh.

Reduced qwen1.5-0.5B (its 2 KV heads cannot split over 4-way TP, so its
cache splits its sequence: ``kv_seq``), reduced gemma2-2b (the same, with
local/global windows and softcaps) and reduced RecurrentGemma (1 KV head,
a ring cache of its window, and the hybrid's recurrent states) run in f32
on the reference's params (carried across with
``convert.lm_params_from_reference``): the last-token prefill logits and
the logits of every one of 10 decode steps (through RecurrentGemma's
ring of 8 slots) against the reference's one-device
``forward_prefill``/``forward_decode`` on the same numpy inputs, within
the tolerances ``tests/test_torch_lm_families.py`` holds the one-device
port to (2e-4 abs/rel on prefill logits; 1e-3 on decode logits, where
the bf16 KV cache may round a value on a bf16 boundary the other way).
The new cache keeps the placements the cache came in.

A w8a8 decode with the int8 KV cache on the mesh runs each quantised
``linear``'s int8 product on the local shards through ``local_map``; its
int32 accumulators equal the unsharded port's bit for bit.
"""

import pickle

import numpy as np
import pytest
import torch

from gloo_ranks import run_ranks

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.models import transformer as JT
except ImportError:
    jax = None

ARCHS = ("qwen1.5-0.5b", "gemma2-2b", "recurrentgemma-2b")
B, PREFILL_T, DECODE_STEPS, MAX_SEQ = 4, 12, 10, 16
PREFILL_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=1e-3, atol=1e-3)

RANK_RUN = """
import pickle
from torch.distributed.tensor import DTensor
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.serve import cache_shardings
from repro_torch.launch.train import batch_shardings
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.sharding import partition as P

d, mp = sys.argv[1], int(sys.argv[2])
with open(os.path.join(d, "inputs.pkl"), "rb") as f:
    inputs = pickle.load(f)
mesh = make_host_mesh(model_parallel=mp, device_type="cpu")
full = lambda t: t.full_tensor() if isinstance(t, DTensor) else t

def run(arch, cfg, params, axes, steps):
    tok = torch.as_tensor(inputs["prefill"])
    with torch.no_grad(), P.rules_context(mesh, cfg.sharding_overrides):
        sp = P.distribute(params, P.param_shardings(axes, mesh,
                                                    cfg.sharding_overrides, params))
        b = {"tokens": tok}
        pre = full(T.forward_prefill(sp, P.distribute(b, batch_shardings(b, mesh)),
                                     cfg))
        held = cache_shardings(cfg, %(b)d, %(s)d, mesh)
        cache = P.distribute(T.init_cache(cfg, %(b)d, %(s)d), held)
        logits = []
        for t in range(steps):
            b = {"tokens": torch.as_tensor(inputs["decode"][:, t:t + 1])}
            b = P.distribute(b, batch_shardings(b, mesh))
            b["cache_pos"] = t
            lg, cache = T.forward_decode(sp, cache, b, cfg)
            logits.append(full(lg)[:, 0].tolist())
        placed = all(tuple(cache[k].placements) == tuple(h.placements)
                     for k, h in held.items())
    return pre[:, 0].tolist(), logits, placed, sorted(
        {k: str(h.placements) for k, h in held.items()}.items())

out = {"mesh": list(mesh.shape)}
for arch in %(archs)r:
    cfg = reduce_config(ARCH_CONFIGS[arch]).replace(dtype="float32")
    with open(os.path.join(d, arch + ".pkl"), "rb") as f:
        params = lm_params_from_reference(pickle.load(f))
    _, axes = T.init_model(cfg, None)
    pre, logits, placed, layout = run(arch, cfg, params, axes, %(steps)d)
    out[arch] = {"prefill": pre, "decode": logits, "placed": placed,
                 "layout": layout}

# w8a8 + int8 KV on qwen: the int8 products' accumulators on the mesh
cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(
    dtype="float32", quant=QuantConfig("w8a8", quantize_kv=True))
with open(os.path.join(d, "qwen1.5-0.5b.pkl"), "rb") as f:
    params = lm_params_from_reference(pickle.load(f))
_, axes = T.init_model(cfg, None)
params, axes = T.quantize_model_params(params, axes, cfg)
accs, real = [], L._local_int8_matmul
def recording(xq, w2):
    acc = real(xq, w2)
    accs.append(acc.full_tensor())
    return acc
L._local_int8_matmul = recording
_, logits, placed, layout = run("w8a8", cfg, params, axes, 3)
L._local_int8_matmul = real
torch.save(accs, os.path.join(d, f"accs_{mp}_{RANK}.pt"))
out["w8a8"] = {"decode": logits, "placed": placed, "layout": layout,
               "n_accs": len(accs)}
print(json.dumps(out))
"""


def _ref_run(arch, inputs):
    """The reference's one-device f32 prefill logits and decode logits."""
    jcfg = j_reduce(J_ARCHS[arch]).replace(remat="none", dtype="float32")
    jp, _ = JT.init_model(jcfg, jax.random.key(0))
    pre = JT.forward_prefill(jp, {"tokens": jnp.asarray(inputs["prefill"])},
                             jcfg)
    step = jax.jit(lambda p, c, b: JT.forward_decode(p, c, b, jcfg))
    cache = JT.init_cache(jcfg, B, MAX_SEQ)
    logits = []
    for t in range(DECODE_STEPS):
        lg, cache = step(jp, cache, {
            "tokens": jnp.asarray(inputs["decode"][:, t:t + 1]),
            "cache_pos": jnp.asarray(t, jnp.int32)})
        logits.append(np.asarray(lg)[:, 0])
    return np.asarray(pre)[:, 0], np.stack(logits), jax.tree.map(np.asarray, jp)


def _unsharded_w8a8(params_np, inputs):
    """The port's unsharded w8a8 prefill and int8-KV decode, as the ranks
    run them: the decode logits and the int32 accumulators of every int8
    product, in call order."""
    from repro_torch.configs import ARCH_CONFIGS, reduce_config
    from repro_torch.convert import lm_params_from_reference
    from repro_torch.core.quant import QuantConfig
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(
        dtype="float32", quant=QuantConfig("w8a8", quantize_kv=True))
    _, axes = T.init_model(cfg, None)
    params, _ = T.quantize_model_params(lm_params_from_reference(params_np),
                                        axes, cfg)
    accs, real = [], L.int8_matmul
    L.int8_matmul = lambda xq, w2: accs.append(real(xq, w2)) or accs[-1]
    try:
        cache = T.init_cache(cfg, B, MAX_SEQ)
        logits = []
        with torch.no_grad():
            T.forward_prefill(params, {"tokens": torch.as_tensor(
                inputs["prefill"])}, cfg)
            for t in range(3):
                lg, cache = T.forward_decode(params, cache, {
                    "tokens": torch.as_tensor(inputs["decode"][:, t:t + 1]),
                    "cache_pos": t}, cfg)
                logits.append(lg[:, 0].numpy())
    finally:
        L.int8_matmul = real
    return np.stack(logits), accs


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """The reference's one-device runs, the port's unsharded w8a8 decode,
    and the mesh runs on 8 ranks (2 x 4) and 4 ranks (2 x 2)."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    d = tmp_path_factory.mktemp("mesh_decode")
    rng = np.random.default_rng(22)
    inputs = {"prefill": rng.integers(0, 128, (B, PREFILL_T)).astype(np.int32),
              "decode": rng.integers(0, 128, (B, DECODE_STEPS)).astype(np.int32)}
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    ref = {}
    for arch in ARCHS:
        pre, dec, params_np = _ref_run(arch, inputs)
        ref[arch] = (pre, dec)
        with open(d / f"{arch}.pkl", "wb") as f:
            pickle.dump(params_np, f)
    with open(d / "qwen1.5-0.5b.pkl", "rb") as f:
        w8a8 = _unsharded_w8a8(pickle.load(f), inputs)
    script = RANK_RUN % {"archs": ARCHS, "b": B, "s": MAX_SEQ,
                         "steps": DECODE_STEPS}
    ranks = {}
    for world, mp in ((8, 4), (4, 2)):
        ranks[mp] = run_ranks(f"sys.argv = ['', {str(d)!r}, '{mp}']\n" + script,
                              world, str(d / f"store{world}"))
    return {"ref": ref, "ranks": ranks, "w8a8": w8a8, "dir": d}


@pytest.mark.parametrize("mp", [4, 2], ids=["2x4", "2x2"])
@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_prefill_and_decode_match_the_reference(mesh_runs, arch, mp):
    """Every rank's prefill and decode logits against the reference's
    one-device step; the new cache keeps its placements."""
    pre, dec = mesh_runs["ref"][arch]
    for r in mesh_runs["ranks"][mp]:
        assert r["mesh"] == [2, mp]
        got = r[arch]
        np.testing.assert_allclose(np.asarray(got["prefill"]), pre, **PREFILL_TOL)
        np.testing.assert_allclose(np.asarray(got["decode"]), dec, **DECODE_TOL)
        assert got["placed"]


@pytest.mark.parametrize("mp", [4, 2], ids=["2x4", "2x2"])
def test_kv_cache_splits_its_sequence_where_heads_cannot(mesh_runs, mp):
    """2 KV heads (qwen, gemma2) and 1 (RecurrentGemma) cannot split over
    the production TP width, so each cache splits its sequence over
    "model" (``kv_seq``) and its batch over "data"."""
    for arch in ARCHS:
        layout = dict(mesh_runs["ranks"][mp][0][arch]["layout"])
        assert layout["k"] == "(Shard(dim=1), Shard(dim=2))", (arch, layout)
    rg = dict(mesh_runs["ranks"][mp][0]["recurrentgemma-2b"]["layout"])
    assert rg["rec_h"] == "(Shard(dim=1), Shard(dim=2))"


@pytest.mark.parametrize("mp", [4, 2], ids=["2x4", "2x2"])
def test_w8a8_decode_accumulators_equal_the_unsharded_port(mesh_runs, mp):
    """The int8 products on the local shards, row-parallel partial sums
    all-reduced: every int32 accumulator equals the unsharded one bit for
    bit, and the logits agree."""
    logits, accs = mesh_runs["w8a8"]
    for rank, r in enumerate(mesh_runs["ranks"][mp]):
        got = torch.load(mesh_runs["dir"] / f"accs_{mp}_{rank}.pt")
        assert r["w8a8"]["n_accs"] == len(accs) == len(got) > 0
        for a, b in zip(got, accs):
            assert a.dtype == torch.int32 and torch.equal(a, b)
        np.testing.assert_allclose(np.asarray(r["w8a8"]["decode"]), logits,
                                   **DECODE_TOL)
        assert r["w8a8"]["placed"]
