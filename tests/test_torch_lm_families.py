"""The port's LM serving path for every architecture the reference serves
(``repro_torch.models``: dense, MoE, VLM, audio, SSM and hybrid families
at ``reduce_config``) against the JAX package's ``repro.models``, on the
same weights: the reference's init carried across leaf for leaf with
``convert.lm_params_from_reference``, the same numpy tokens (or frame
embeddings, for musicgen) and, for qwen2-vl's M-RoPE, three distinct
position streams.

Tolerances:
  * f32: 2e-4 abs/rel on prefill logits and on states (fp32 sums in
    other orders).  KV is stored in bf16 in both packages, so one bf16
    ulp on it; and since an f32 k or v that sits on a bf16 rounding
    boundary can round the other way in the other framework, decode
    logits are held to ``F32_DECODE_TOL`` = 1e-3 abs/rel.
  * bf16: the two frameworks round bf16 at different places (inside the
    activations, the matmul accumulators), so logits are held to
    ``BF16_ATOL`` = 0.25 plus 2% of their magnitude, and the states to
    two bf16 ulps + 0.05.
  * MoE routing is compared exactly (expert ids and capacity slots) where
    the router's k-th and (k+1)-th probabilities differ by more than
    ``TIE_MARGIN``; tokens below it are counted and reported, never
    chosen away by the seed.
  * prefill against step-by-step decode: the reference's own bound, 0.3
    (``tests/test_models.py``).
The decode runs ``DECODE_STEPS`` = 12 steps, through a ring of 8 slots
for mixtral's window of 8."""

import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import (ARCH_CONFIGS, ASSIGNED_ARCHS,
                                 REFERENCE_LM_ARCHS, SHAPES,
                                 reduce_config)
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.quant import QuantConfig
from repro_torch.launch import serve
from repro_torch.models import moe as TMOE
from repro_torch.models import rwkv6 as TRW
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_index

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import SHAPES as J_SHAPES
    from repro.configs import reduce_config as j_reduce
    from repro.models import moe as JMOE
    from repro.models import rwkv6 as JRW
    from repro.models import transformer as JT
except ImportError:
    jax = None

BF16_ATOL, BF16_RTOL = 0.25, 0.02
F32_TOL = dict(rtol=2e-4, atol=2e-4)
F32_DECODE_TOL = dict(rtol=1e-3, atol=1e-3)
TIE_MARGIN = 1e-5
B, PREFILL_T, DECODE_STEPS, MAX_SEQ = 2, 12, 12, 16
KEY_SEED = 0


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _cfgs(arch, dtype="float32", hard=False, quant=None):
    kw = dict(remat="none", dtype=dtype, hard_acts=hard)
    if quant is not None:
        kw["quant"] = quant
    return (j_reduce(J_ARCHS[arch]).replace(**kw),
            reduce_config(ARCH_CONFIGS[arch]).replace(**kw))


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    jcfg, _ = _cfgs(arch)
    jp, jaxes = JT.init_model(jcfg, jax.random.key(KEY_SEED))
    return jp, jaxes


def _model(arch, dtype="float32", hard=False, quant=None):
    """(jcfg, tcfg, jax params, torch params) from the reference's init;
    quantised by the reference when ``quant`` is given."""
    jcfg, tcfg = _cfgs(arch, dtype, hard, quant)
    jp, jaxes = _ref_params(arch)
    if quant is not None:
        jp, _ = JT.quantize_model_params(jp, jaxes, jcfg)
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp))


def _inputs(cfg, t, seed=1):
    """numpy model inputs of ``t`` steps for ``cfg``: tokens or frame
    embeddings, plus M-RoPE position streams where the arch has them."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, t)).astype(np.int32)
    else:
        out["inputs_embeds"] = rng.normal(0, 1, (B, t, cfg.d_model)).astype(np.float32)
    if cfg.attn and cfg.attn.mrope_sections:
        pos = np.arange(t)
        out["position_ids"] = np.broadcast_to(
            np.stack([pos, pos // 2, pos % 3])[:, None], (3, B, t)).astype(np.int32)
    return out


def _step(inputs, t):
    """Decode step t's slice of ``_inputs``."""
    out = {}
    for k, v in inputs.items():
        out[k] = v[:, :, t:t + 1] if k == "position_ids" else v[:, t:t + 1]
    return out


def _jbatch(np_batch, jcfg):
    out = {k: jnp.asarray(v) for k, v in np_batch.items()}
    if "inputs_embeds" in out:
        out["inputs_embeds"] = out["inputs_embeds"].astype(jcfg.dtype)
    return out


def _tbatch(np_batch):
    return {k: torch.as_tensor(v) for k, v in np_batch.items()}


def _close_logits(got, want, dtype, what="", f32_tol=F32_TOL):
    if dtype == "float32":
        np.testing.assert_allclose(got, want, err_msg=what, **f32_tol)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# configs, init, counts
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_init_tree_shapes_axes_and_counts_match_reference(arch):
    """Same keys, list lengths, shapes and logical axes; num_params and
    num_active_params equal the reference's at the reduced and the
    published config (the latter without allocating anything)."""
    jcfg, tcfg = _cfgs(arch)
    jp, jaxes = _ref_params(arch)
    tp, taxes = T.init_model(tcfg, torch.Generator().manual_seed(0))

    def walk(j, t, ja, ta, path):
        if isinstance(j, dict):
            assert set(j) == set(t) == set(ja) == set(ta), path
            for k in j:
                walk(j[k], t[k], ja[k], ta[k], f"{path}/{k}")
        elif isinstance(j, list):
            assert len(j) == len(t) == len(ja) == len(ta), path
            for i, parts in enumerate(zip(j, t, ja, ta)):
                walk(*parts, f"{path}/{i}")
        else:
            assert tuple(t.shape) == tuple(j.shape), path
            assert t.dtype == torch.float32 and tuple(ta) == tuple(ja), path

    walk(jp, tp, jaxes, taxes, "")
    for j, t in ((jcfg, tcfg), (J_ARCHS[arch], ARCH_CONFIGS[arch])):
        assert T.num_params(t) == JT.num_params(j)
        assert T.num_active_params(t) == JT.num_active_params(j)
    assert {k: v for k, v in SHAPES.items()}.keys() == J_SHAPES.keys()


# ---------------------------------------------------------------------------
# the whole model: prefill, decode through a ring wrap, prefill vs decode
# ---------------------------------------------------------------------------

CASES = [(a, d, h) for a in REFERENCE_LM_ARCHS for d in ("float32", "bfloat16")
         for h in (False, True)]
CASE_IDS = [f"{a}-{d}-{'hard' if h else 'soft'}" for a, d, h in CASES]


@functools.lru_cache(maxsize=None)
def _runs(arch, dtype, hard):
    """Both packages' prefill of PREFILL_T steps and DECODE_STEPS decode
    steps (per step: logits and cache as numpy), and the port's prefill
    over the decoded steps."""
    jcfg, tcfg, jp, tp = _model(arch, dtype, hard)
    pre_in = _inputs(tcfg, PREFILL_T)
    j_pre = np.asarray(JT.forward_prefill(jp, _jbatch(pre_in, jcfg), jcfg))
    t_pre = T.forward_prefill(tp, _tbatch(pre_in), tcfg)
    dec_in = _inputs(tcfg, DECODE_STEPS, seed=2)
    jstep = jax.jit(functools.partial(JT.forward_decode, cfg=jcfg))
    jc = JT.init_cache(jcfg, B, MAX_SEQ)
    tc = T.init_cache(tcfg, B, MAX_SEQ)
    steps = []
    for t in range(DECODE_STEPS):
        sb = _step(dec_in, t)
        jl, jc = jstep(jp, jc, {**_jbatch(sb, jcfg),
                                "cache_pos": jnp.asarray(t, jnp.int32)})
        tl, tc = T.forward_decode(tp, tc, {**_tbatch(sb), "cache_pos": t}, tcfg)
        steps.append((np.asarray(jl), {k: np.asarray(v.astype(jnp.float32))
                                       for k, v in jc.items()},
                      tl.numpy(), {k: v.float().numpy() for k, v in tc.items()},
                      {k: (str(v.dtype), str(jc[k].dtype)) for k, v in tc.items()}))
    dec_pre = T.forward_prefill(tp, _tbatch(dec_in), tcfg).numpy()
    return j_pre, t_pre, steps, dec_pre


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch,dtype,hard", CASES, ids=CASE_IDS)
def test_forward_prefill_matches_reference(arch, dtype, hard):
    j_pre, t_pre, _, _ = _runs(arch, dtype, hard)
    assert t_pre.dtype == torch.float32
    assert tuple(t_pre.shape) == (B, 1, reduce_config(ARCH_CONFIGS[arch]).vocab_size)
    _close_logits(t_pre.numpy(), j_pre, dtype)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch,dtype,hard", CASES, ids=CASE_IDS)
def test_forward_decode_matches_reference_through_ring_wrap(arch, dtype, hard):
    """Every step's logits and every cache entry (KV, rec and rwkv state)
    equal the reference's, in the reference's dtypes."""
    _, _, steps, _ = _runs(arch, dtype, hard)
    if dtype == "float32":
        state_tol = dict(F32_TOL)
        kv_tol = dict(rtol=2 ** -7, atol=2e-4)          # KV stored in bf16
    else:
        state_tol = kv_tol = dict(rtol=2 ** -6, atol=5e-2)
    for i, (jl, jc, tl, tc, dts) in enumerate(steps):
        _close_logits(tl, jl, dtype, f"step {i}", F32_DECODE_TOL)
        assert set(tc) == set(jc)
        for k in jc:
            t_dt, j_dt = dts[k]
            assert t_dt.split(".")[-1] == j_dt, (k, t_dt, j_dt)
            assert tc[k].shape == jc[k].shape, k
            tol = kv_tol if k in ("k", "v", "rec_conv", "tm_shift", "cm_shift") \
                else state_tol
            np.testing.assert_allclose(tc[k], jc[k], err_msg=f"{k} step {i}", **tol)
    if arch == "mixtral-8x7b":
        assert DECODE_STEPS > steps[0][1]["k"].shape[2]    # the ring wrapped


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch,dtype,hard", CASES, ids=CASE_IDS)
def test_prefill_equals_sequential_decode(arch, dtype, hard):
    """Decoding the steps one by one reproduces the prefill's last logits
    within the reference's bound (0.3)."""
    _, _, steps, dec_pre = _runs(arch, dtype, hard)
    err = float(np.abs(dec_pre[:, -1] - steps[-1][2][:, 0]).max())
    assert err < 0.3, err


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_w8a8_int8_kv_decode_matches_reference(arch):
    """Quantised serve weights (the reference's codes carried across) and
    an int8 KV cache: every step's logits within F32_DECODE_TOL of the
    reference's in f32, the int8 KV codes equal except where a value lands
    within float rounding of a code boundary (then one code), their scales
    within 2e-4, and the other states as in the f32 decode test."""
    quant = QuantConfig("w8a8", quantize_kv=True)
    jcfg, tcfg, jp, tp = _model(arch, "float32", quant=quant)
    dec_in = _inputs(tcfg, DECODE_STEPS, seed=3)
    jstep = jax.jit(functools.partial(JT.forward_decode, cfg=jcfg))
    jc = JT.init_cache(jcfg, B, MAX_SEQ)
    tc = T.init_cache(tcfg, B, MAX_SEQ)
    for t in range(DECODE_STEPS):
        sb = _step(dec_in, t)
        jl, jc = jstep(jp, jc, {**_jbatch(sb, jcfg),
                                "cache_pos": jnp.asarray(t, jnp.int32)})
        tl, tc = T.forward_decode(tp, tc, {**_tbatch(sb), "cache_pos": t}, tcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   err_msg=f"step {t}", **F32_DECODE_TOL)
    assert set(tc) == set(jc)
    for k in jc:
        assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
        if tc[k].dtype == torch.int8:
            got, want = tc[k].numpy().astype(int), np.asarray(jc[k]).astype(int)
            assert np.abs(got - want).max() <= 1, k
            assert (got == want).mean() > 0.99, k
        else:
            tol = dict(rtol=2 ** -7, atol=2e-4) if k == "rec_conv" else F32_TOL
            np.testing.assert_allclose(tc[k].float().numpy(),
                                       np.asarray(jc[k].astype(jnp.float32)),
                                       err_msg=k, **tol)


# ---------------------------------------------------------------------------
# MoE routing and RWKV-6's wkv
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "phi3.5-moe"])
@pytest.mark.parametrize("t", [16, 40], ids=["dropless", "capacity"])
def test_moe_routing_ids_slots_and_aux_match_reference(arch, t):
    """Expert ids, capacity slots (the cumsum over the flattened (token, k)
    order, drops included) and the kept/dropped split equal the
    reference's on every token whose top-k margin exceeds TIE_MARGIN; the
    output within 2e-4 and the aux loss within 1e-6.  At t=40 capacity
    (25) is below some experts' load, so claims are dropped."""
    jcfg, tcfg, jp, tp = _model(arch)
    pj = jax.tree.map(lambda a: a[0], jp["blocks"]["mlp"])
    pt = tree_index(tp["blocks"]["mlp"], 0)
    x = np.random.default_rng(7).normal(0, 1, (B, t, 64)).astype(np.float32)
    probs, gates, ids, slots, dest = TMOE.route(pt, torch.as_tensor(x), tcfg)
    y, aux = TMOE.moe_apply(pt, torch.as_tensor(x), tcfg, "prefill")
    jy, jaux = JMOE.moe_apply(pj, jnp.asarray(x), jcfg, "prefill")

    # the reference's routing, step by step as in moe_apply
    k, e = jcfg.moe.top_k, jcfg.moe.num_experts
    jlogits = (jnp.asarray(x) @ pj["router"]).astype(jnp.float32)
    jprobs = jax.nn.softmax(jlogits, -1)
    jg, jids = jax.lax.top_k(jprobs, k)
    jg = jg / jnp.maximum(jg.sum(-1, keepdims=True), 1e-9)
    flat = jids.reshape(B, t * k)
    eo = jax.nn.one_hot(flat, e, dtype=jnp.int32)
    jslot = jnp.take_along_axis((jnp.cumsum(eo, 1) - 1) * eo, flat[..., None], 2)[..., 0]
    cap = TMOE.capacity(tcfg, t)

    srt = np.sort(np.asarray(jprobs), -1)[..., ::-1]
    margin = srt[..., k - 1] - srt[..., k]                 # (B, t)
    near = margin < TIE_MARGIN
    if near.any():
        print(f"{arch} t={t}: {int(near.sum())} token(s) with a top-{k} "
              f"margin below {TIE_MARGIN}; their routing is not compared")
    clear = ~near
    np.testing.assert_array_equal(ids.numpy()[clear], np.asarray(jids)[clear])
    if not near.any():
        np.testing.assert_array_equal(slots.numpy(), np.asarray(jslot))
        np.testing.assert_array_equal((slots < cap).numpy(), np.asarray(jslot) < cap)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), **F32_TOL)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(gates.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6
    if t == 40:
        assert bool((slots >= cap).any())                   # claims were dropped
        assert bool((dest == e * cap).any())


def test_moe_topk_ties_keep_the_lower_expert_first():
    """Equal router probabilities: the lower expert id comes first, as
    ``jax.lax.top_k`` orders them."""
    cfg = reduce_config(ARCH_CONFIGS["mixtral-8x7b"]).replace(dtype="float32")
    p = {"router": torch.zeros(64, 4)}          # every expert equally likely
    _, gates, ids, slots, _ = TMOE.route(p, torch.ones(1, 3, 64), cfg)
    assert ids.tolist() == [[[0, 1]] * 3]
    assert slots.tolist() == [[0, 0, 1, 1, 2, 2]]
    assert torch.allclose(gates, torch.full_like(gates, 0.5))


@pytest.mark.parametrize("t,chunk", [(37, 8), (16, 16), (5, 128)])
def test_wkv_chunked_equals_sequential(t, chunk):
    """The block-parallel form against the literal recurrence (the
    reference's ``test_models.py`` case and two more): outputs and final
    state within 2e-4 in f32 (the chunked form exponentiates cumulative
    log-decays within a chunk; exp(L_{t-1} - L_s) <= 1 keeps it stable)."""
    rng = np.random.default_rng(0)
    b, h, n = 2, 3, 8
    r, k, v = (torch.as_tensor(rng.normal(0, 1, (b, t, h, n)).astype(np.float32))
               for _ in range(3))
    w = torch.as_tensor(rng.normal(-1, 1, (b, t, h, n)).astype(np.float32))
    u = torch.as_tensor(rng.normal(0, 1, (h, n)).astype(np.float32))
    s0 = torch.as_tensor(rng.normal(0, 1, (b, h, n, n)).astype(np.float32))
    for state in (None, s0):
        y_seq, s_seq = TRW.wkv_sequential(r, k, v, w, u, state)
        y_chk, s_chk = TRW.wkv_chunked(r, k, v, w, u, state, chunk=chunk)
        np.testing.assert_allclose(y_chk.numpy(), y_seq.numpy(), **F32_TOL)
        np.testing.assert_allclose(s_chk.numpy(), s_seq.numpy(), **F32_TOL)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("form", ["sequential", "chunked"])
def test_wkv_matches_reference(form):
    """Both forms against the reference's, 2e-5 in f32."""
    rng = np.random.default_rng(4)
    b, t, h, n = 2, 21, 3, 8
    r, k, v = (rng.normal(0, 1, (b, t, h, n)).astype(np.float32) for _ in range(3))
    w = rng.normal(-1, 1, (b, t, h, n)).astype(np.float32)
    u = rng.normal(0, 1, (h, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, n, n)).astype(np.float32)
    kw = {"chunk": 8} if form == "chunked" else {}
    fn_t = getattr(TRW, f"wkv_{form}")
    fn_j = getattr(JRW, f"wkv_{form}")
    yt, st = fn_t(*map(torch.as_tensor, (r, k, v, w, u, s0)), **kw)
    yj, sj = fn_j(*map(jnp.asarray, (r, k, v, w, u, s0)), **kw)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# ports of tests/test_models.py's substrate checks
# ---------------------------------------------------------------------------

def _port_params(arch, seed=0, **kw):
    cfg = reduce_config(ARCH_CONFIGS[arch]).replace(**kw)
    return cfg, T.init_model(cfg, torch.Generator().manual_seed(seed))


def test_moe_conservation_and_aux():
    cfg, (params, _) = _port_params("mixtral-8x7b")
    p = tree_index(params["blocks"]["mlp"], 0)
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator().manual_seed(2))
    y, aux = TMOE.moe_apply(p, x, cfg)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())
    assert 0.5 < float(aux) < 4.0


def test_quantized_serve_params_close():
    cfg, (params, axes) = _port_params("qwen1.5-0.5b", quant=QuantConfig("w8"))
    qp, _ = T.quantize_model_params(params, axes, cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 8),
                         generator=torch.Generator().manual_seed(3))
    lf = T.forward_prefill(params, {"tokens": toks}, cfg.replace(quant=QuantConfig("none")))
    lq = T.forward_prefill(qp, {"tokens": toks}, cfg)
    assert float((lq - lf).abs().max()) / (float(lf.std()) + 1e-9) < 0.35


def test_int8_kv_cache_decode_close_to_bf16():
    cfg, (params, _) = _port_params("qwen1.5-0.5b")
    cfg_q = cfg.replace(quant=QuantConfig("none", quantize_kv=True))
    toks = torch.randint(0, cfg.vocab_size, (2, 6),
                         generator=torch.Generator().manual_seed(4))
    outs = {}
    for name, c in (("bf16", cfg), ("int8kv", cfg_q)):
        cache = T.init_cache(c, 2, 16)
        for t in range(6):
            logits, cache = T.forward_decode(
                params, cache, {"tokens": toks[:, t:t + 1], "cache_pos": t}, c)
        outs[name] = logits
    assert float((outs["bf16"] - outs["int8kv"]).abs().max()) < 0.5
    assert cache["k"].dtype == torch.int8 and cache["k_scale"].dtype == torch.float32


def test_swa_ring_buffer_wrap_matches_full_cache():
    """Uniform-SWA decode with a ring cache (size = window) matches decoding
    with a full-length cache once positions exceed the window."""
    import dataclasses
    cfg, (params, _) = _port_params("mixtral-8x7b")
    assert cfg.uniform_window == 8
    toks = torch.randint(0, cfg.vocab_size, (1, 14),
                         generator=torch.Generator().manual_seed(5))
    ring = T.init_cache(cfg, 1, 14)
    assert ring["k"].shape[2] == 8
    full = T.init_cache(cfg.replace(attn=dataclasses.replace(cfg.attn, window=None)),
                        1, 14)
    for t in range(14):
        b = {"tokens": toks[:, t:t + 1], "cache_pos": t}
        lr, ring = T.forward_decode(params, ring, b, cfg)
        lf, full = T.forward_decode(params, full, b, cfg)
    assert float((lr - lf).abs().max()) < 1e-3


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_decode_step_shapes_finite_and_leaves_its_cache(arch):
    """The port's own init: one decode step is finite, keeps the cache's
    keys and leaves the cache it was given unchanged."""
    cfg, (params, _) = _port_params(arch, quant=QuantConfig("none", quantize_kv=True))
    cache = T.init_cache(cfg, 2, 32)
    before = {k: v.clone() for k, v in cache.items()}
    batch = _tbatch(_step(_inputs(cfg, 1), 0))
    logits, new = T.forward_decode(params, cache, {**batch, "cache_pos": 0}, cfg)
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all())
    assert set(new) == set(cache)
    assert all(torch.equal(cache[k], before[k]) for k in cache)


# ---------------------------------------------------------------------------
# the serving entry
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("quant", [[], ["--quant", "w8a8", "--kv-int8"]],
                         ids=["float", "w8a8-kv8"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_serve_main_on_cpu_for_every_arch(arch, quant, capsys):
    gen = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "3",
                      "--gen", "4", "--max-seq", "16", "--device", "cpu", *quant])
    assert gen.shape == (2, 4)
    assert ((0 <= gen) & (gen < reduce_config(ARCH_CONFIGS[arch]).vocab_size)).all()
    out = capsys.readouterr().out
    assert "tok/s" in out and "CPU host" in out
    mode = "w8a8" if quant else "none"
    assert f"quant={mode}" in out and f"int8-KV={bool(quant)}" in out
    if quant:
        assert "[serve] weights quantised: mode=w8a8 int8-KV=True" in out
