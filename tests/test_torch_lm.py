"""The port's hybrid LM (``repro_torch.models``: RecurrentGemma at the
reduced config) against the JAX package's ``repro.models``, on the same
weights: the reference's init carried across leaf for leaf with
``convert.lm_params_from_reference``, the same numpy tokens.

Tolerances: 2e-4 abs/rel in f32 (the RG-LRU runs as a sequential
recurrence here and as an associative scan there, and fp32 sums are
taken in other orders); in bf16, 0.25 absolute on the logits, two bf16
ulps at the final softcap's scale of 30 (the two frameworks round bf16
at different places: inside the activations, the matmul accumulators).
The decode runs 14 steps through a ring of 8 slots (window 8)."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_CONFIGS, SHAPES, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.launch import serve
from repro_torch.models import layers as TL
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.modules import param, tree_index

try:  # the JAX reference
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import reduce_config as j_reduce
    from repro.models import layers as JL
    from repro.models import transformer as JT
except ImportError:
    jax = None

ARCH = "recurrentgemma-2b"
BF16_ATOL = 0.25
DECODE_STEPS, MAX_SEQ = 14, 32


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _cfgs(dtype="float32", hard=False):
    kw = dict(remat="none", dtype=dtype, hard_acts=hard)
    return (j_reduce(J_ARCHS[ARCH]).replace(**kw),
            reduce_config(ARCH_CONFIGS[ARCH]).replace(**kw))


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", hard=False):
    """(jcfg, tcfg, jax params, torch params) from the reference's init."""
    jcfg, tcfg = _cfgs(dtype, hard)
    jp, _ = JT.init_model(jcfg, jax.random.key(0))
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp))


def _tokens(b, t, seed=1):
    return np.random.default_rng(seed).integers(0, 128, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# configs, registry, init
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_config_matches_reference(reduced):
    j, t = J_ARCHS[ARCH], ARCH_CONFIGS[ARCH]
    if reduced:
        j, t = j_reduce(j), reduce_config(t)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.layer_kinds() == j.layer_kinds()
    for seq in (8, 2048, 4096):
        assert t.layer_windows(seq) == j.layer_windows(seq)
    assert (t.subquadratic(), t.q_dim, t.kv_dim, t.uniform_window) == \
        (j.subquadratic(), j.q_dim, j.kv_dim, j.uniform_window)
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in J_SHAPES.items()}


@pytest.mark.usefixtures("ref")
def test_registry_resolves_every_arch():
    """All eleven of the reference's archs resolve, in its order, and
    every LM arch's published and reduced configs equal the reference's."""
    from repro.configs import ASSIGNED_ARCHS as J_ASSIGNED
    from repro_torch.configs import ASSIGNED_ARCHS
    assert list(ARCH_CONFIGS) == list(J_ARCHS) and len(ARCH_CONFIGS) == 11
    assert ASSIGNED_ARCHS == J_ASSIGNED
    assert registry.list_archs() == sorted(J_ARCHS)
    for name in J_ARCHS:
        assert registry.get_config(name) is ARCH_CONFIGS[name]
    for name in ASSIGNED_ARCHS:
        j, t = J_ARCHS[name], ARCH_CONFIGS[name]
        assert dataclasses.asdict(t) == dataclasses.asdict(j), name
        assert dataclasses.asdict(reduce_config(t)) == \
            dataclasses.asdict(j_reduce(j)), name
    with pytest.raises(KeyError, match="unknown arch"):
        registry.get_config("no-such-arch")


@pytest.mark.usefixtures("ref")
def test_init_model_tree_matches_reference():
    """Same keys, shapes, list lengths and logical axes; norms at zero
    (gemma's (1 + w)), Lambda at one, fan-in scaled normals."""
    jcfg, tcfg = _cfgs()
    jp, jaxes = JT.init_model(jcfg, jax.random.key(0))
    tp, taxes = T.init_model(tcfg, torch.Generator().manual_seed(0))

    def walk(j, t, ja, ta, path):
        assert type(j) is type(t) or isinstance(t, torch.Tensor), path
        if isinstance(j, dict):
            assert set(j) == set(t) == set(ja) == set(ta), path
            for k in j:
                walk(j[k], t[k], ja[k], ta[k], f"{path}/{k}")
        elif isinstance(j, list):
            assert len(j) == len(t) == len(ja) == len(ta), path
            for i, (a, b, c, d) in enumerate(zip(j, t, ja, ta)):
                walk(a, b, c, d, f"{path}/{i}")
        else:
            assert tuple(t.shape) == tuple(j.shape), path
            assert t.dtype == torch.float32 and tuple(ta) == tuple(ja), path

    walk(jp, tp, jaxes, taxes, "")
    assert not tp["final_norm"].any()
    assert bool((tp["groups"][0]["mixer"]["lam"] == 1).all())
    w_a = tp["groups"][0]["mixer"]["w_a"]
    assert abs(float(w_a.std()) * w_a.shape[-2] ** 0.5 - 1.0) < 0.1


def test_param_rules():
    g = torch.Generator().manual_seed(0)
    assert not param(g, (3, 4), (None, None), init="zeros").value.any()
    assert bool((param(g, (3,), (None,), init="ones").value == 1).all())
    v = param(g, (2, 400, 300), ("layers", None, None)).value
    assert abs(float(v.std()) * 400 ** 0.5 - 1.0) < 0.02      # fan-in shape[-2]
    v = param(g, (5000,), (None,), scale=3.0).value
    assert abs(float(v.std()) - 3.0) < 0.15
    with pytest.raises(ValueError, match="rank"):
        param(g, (3, 4), (None,))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("norm", ["rmsnorm", "gemma_rmsnorm", "layernorm"])
def test_norm_apply_matches_reference(norm):
    jcfg, tcfg = (c.replace(norm=norm) for c in _cfgs())
    rng = np.random.default_rng(5)
    x = rng.normal(0, 2, (2, 7, 64)).astype(np.float32)
    w = rng.normal(0, 0.5, (64,)).astype(np.float32)
    got = TL.norm_apply(torch.as_tensor(w), torch.as_tensor(x), tcfg)
    want = JL.norm_apply(jnp.asarray(w), jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.usefixtures("ref")
def test_apply_rope_matches_reference():
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 9, 3, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(9) + 5, (2, 9)).copy()
    got = TL.apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


FLASH_CASES = {
    # name: (T, S, causal, window, softcap, q_offset, kv_valid, q_chunk, kv_chunk)
    "triangle": (24, 24, True, None, None, 0, None, 8, 8),
    "triangle-window": (40, 40, True, 12, None, 0, None, 8, 16),
    "padded-softcap": (13, 21, False, None, 20.0, 0, None, 8, 8),
    "decode-ring": (1, 16, False, None, None, 23, 16, 1, 16),
    "decode-window": (1, 32, False, 8, None, 9, 10, 1, 32),
}


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_reference(case):
    t, s, causal, window, cap, off, valid, qc, kc = FLASH_CASES[case]
    rng = np.random.default_rng(7)
    q = rng.normal(0, 1, (2, t, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, s, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=causal, window=window, softcap=cap, scale=0.25,
              q_offset=off, kv_valid_len=valid, q_chunk=qc, kv_chunk=kc)
    got = TL.flash_attention(*map(torch.as_tensor, (q, k, v)), **kw)
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
def test_attn_and_mlp_match_reference(hard):
    jcfg, tcfg, jp, tp = _model(hard=hard)
    attn_j = jax.tree.map(lambda a: a[0], jp["groups"][2])
    attn_t = tree_index(tp["groups"][2], 0)
    x = np.random.default_rng(8).normal(0, 1, (2, 20, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(20), (2, 20)).copy()
    got = TL.attn_apply(attn_t["mixer"], torch.as_tensor(x), torch.as_tensor(pos),
                        cfg=tcfg, window=8)
    want = JL.attn_apply(attn_j["mixer"], jnp.asarray(x), jnp.asarray(pos),
                         cfg=jcfg, window=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)
    got = TL.mlp_apply(attn_t["mlp"], torch.as_tensor(x), tcfg)
    want = JL.mlp_apply(attn_j["mlp"], jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


# ---------------------------------------------------------------------------
# the whole model
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_prefill_matches_reference(dtype, hard):
    """20 tokens: over two windows of 8, through 3 rec layers and 1 attn."""
    jcfg, tcfg, jp, tp = _model(dtype, hard)
    tok = _tokens(2, 20)
    got = T.forward_prefill(tp, {"tokens": torch.as_tensor(tok)}, tcfg)
    want = np.asarray(JT.forward_prefill(jp, {"tokens": jnp.asarray(tok)}, jcfg))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 1, 128)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=BF16_ATOL)


@pytest.fixture(scope="module")
def decode_runs(ref):
    """14 decode steps of both packages, f32 and bf16: per step the logits
    and the new cache, as numpy."""
    out = {}
    tok = _tokens(2, DECODE_STEPS, seed=2)
    for dtype in ("float32", "bfloat16"):
        jcfg, tcfg, jp, tp = _model(dtype)
        jstep = jax.jit(functools.partial(JT.forward_decode, cfg=jcfg))
        jc = JT.init_cache(jcfg, 2, MAX_SEQ)
        tc = T.init_cache(tcfg, 2, MAX_SEQ)
        runs = []
        for t in range(DECODE_STEPS):
            jl, jc = jstep(jp, jc, {"tokens": jnp.asarray(tok[:, t:t + 1]),
                                    "cache_pos": jnp.asarray(t, jnp.int32)})
            tl, tc = T.forward_decode(tp, tc, {"tokens": torch.as_tensor(
                tok[:, t:t + 1]), "cache_pos": t}, tcfg)
            runs.append((np.asarray(jl), {k: np.asarray(v.astype(jnp.float32))
                                          for k, v in jc.items()},
                         tl.numpy(), {k: v.float().numpy() for k, v in tc.items()},
                         {k: str(v.dtype) for k, v in tc.items()}))
        pre = T.forward_prefill(tp, {"tokens": torch.as_tensor(tok)}, tcfg)
        out[dtype] = runs, pre.numpy()
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_decode_matches_reference_through_ring_wrap(decode_runs, dtype):
    """Every step's logits and every cache entry (KV ring of 8 slots,
    rec h and conv state) equal the reference's; the cache keeps the
    reference's dtypes (KV and conv bf16, h f32)."""
    if dtype == "float32":
        # f32 logits and h; KV and conv are stored in bf16: one bf16 ulp.
        tol = dict(rtol=2e-4, atol=2e-4)
        cache_tol = dict(k=dict(rtol=2 ** -7, atol=2e-4), rec_h=tol)
        cache_tol.update(v=cache_tol["k"], rec_conv=cache_tol["k"])
    else:
        # bf16 activations: the logits within BF16_ATOL, the states within
        # two bf16 ulps + 0.02.
        tol = dict(rtol=0, atol=BF16_ATOL)
        cache_tol = dict.fromkeys(("k", "v", "rec_h", "rec_conv"),
                                  dict(rtol=2 ** -6, atol=2e-2))
    runs, _ = decode_runs[dtype]
    for jl, jc, tl, tc, tdt in runs:
        np.testing.assert_allclose(tl, jl, **tol)
        assert set(tc) == set(jc) == set(cache_tol)
        assert tdt == {"k": "torch.bfloat16", "v": "torch.bfloat16",
                       "rec_h": "torch.float32", "rec_conv": "torch.bfloat16"}
        for k in jc:
            assert tc[k].shape == jc[k].shape, k
            np.testing.assert_allclose(tc[k], jc[k], err_msg=k, **cache_tol[k])
    assert DECODE_STEPS > runs[0][1]["k"].shape[2]          # the ring wrapped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_equals_sequential_decode(decode_runs, dtype):
    """Decoding the prompt step by step reproduces the prefill's last
    logits within the reference's own bound (``test_models.py``: 0.3)."""
    runs, pre = decode_runs[dtype]
    assert float(np.abs(pre[:, -1] - runs[-1][2][:, 0]).max()) < 0.3


def test_forward_decode_leaves_its_cache_unchanged():
    tcfg = reduce_config(ARCH_CONFIGS[ARCH])
    tp, _ = T.init_model(tcfg, torch.Generator().manual_seed(1))
    cache = T.init_cache(tcfg, 2, 16)
    before = {k: v.clone() for k, v in cache.items()}
    _, new = T.forward_decode(tp, cache, {"tokens": torch.ones(2, 1, dtype=torch.long),
                                          "cache_pos": torch.tensor(0)}, tcfg)
    assert all(torch.equal(cache[k], before[k]) for k in cache)
    assert any(not torch.equal(new[k], before[k]) for k in cache)


# ---------------------------------------------------------------------------
# the serving entry
# ---------------------------------------------------------------------------

def test_serve_main_on_cpu_returns_the_generated_tokens(capsys):
    gen = serve.main(["--arch", ARCH, "--batch", "3", "--prompt-len", "5",
                      "--gen", "7", "--max-seq", "16", "--device", "cpu"])
    assert gen.shape == (3, 7)
    assert ((0 <= gen) & (gen < 128)).all()
    out = capsys.readouterr().out
    assert "tok/s" in out and "CPU host" in out
    again = serve.main(["--arch", ARCH, "--batch", "3", "--prompt-len", "5",
                        "--gen", "7", "--max-seq", "16", "--device", "cpu"])
    np.testing.assert_array_equal(gen, again)          # seeded


def test_serve_main_defaults_to_the_card(monkeypatch):
    """Without --device it serves on CUDA; with no card it raises instead
    of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--gen", "1"])


@pytest.mark.parametrize("flag", [["--quant", "w8"], ["--kv-int8"]])
def test_serve_quant_flags_run(flag, capsys):
    """``--quant w8`` serves int8 weights, ``--kv-int8`` alone (weights
    w8, as in the reference) an int8 KV cache too."""
    gen = serve.main(["--arch", ARCH, "--device", "cpu", "--gen", "3", *flag])
    assert gen.shape == (4, 3)
    out = capsys.readouterr().out
    kv = flag == ["--kv-int8"]
    assert f"[serve] weights quantised: mode=w8 int8-KV={kv}" in out
    assert f"quant=w8, int8-KV={kv}" in out
