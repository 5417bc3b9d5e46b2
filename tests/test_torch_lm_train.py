"""The port's LM training forward (``transformer.forward_train``), its
fake-quant straight-through gradient (``core.quant``), the RG-LRU scan's
gradient (``kernels.rglru_scan.RglruSeq``: K7 forward and backward on the
card, the plain version on the CPU), activation checkpointing
(``cfg.remat``) and the paper's model behind the LM interface
(``models.lstm_model``), against the JAX package on the same weights (the
reference's init carried across with ``convert.lm_params_from_reference``)
and the same numpy inputs.

Tolerances:
  * f32 ``forward_train``: the loss to 1e-5 relative; each gradient leaf
    to 1e-4 of that leaf's largest reference gradient (the backward sums
    run in another order in the two frameworks; a per-element relative
    bound has no meaning where terms cancel to near zero).  The w8a8
    fake-quant, hard-activation and bf16 cases are in
    ``tests/test_torch_lm_train_variants.py``.
  * ``fake_quant_tensor`` / ``fq_matmul`` gradients: 1e-6 relative to
    each gradient's largest value, and the straight-through gradient
    exactly 1 inside the clip range, 0 outside it and 1/2 on a bound, as
    ``jnp.clip`` gives.
  * the K7 Function against the plain recurrence's autograd: 1e-6
    relative to each gradient's largest value (the same recurrence in
    another order); the rec block's parameter gradients against
    ``jax.grad`` of the reference's associative scan: 1e-4 of each
    leaf's largest value.
  * ``remat`` "full" against "none": bit for bit.
"""

import functools
import warnings

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_CONFIGS, REFERENCE_LM_ARCHS, reduce_config
from repro_torch.convert import lm_params_from_reference, params_from_reference
from repro_torch.core import quant as TQ
from repro_torch.core.qlstm import QLSTMConfig
from repro_torch.kernels import ref as tref
from repro_torch.kernels import rglru_scan as K
from repro_torch.models import lstm_model as TLM
from repro_torch.models import rglru as TRG
from repro_torch.models import transformer as T
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path, tree_map

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.core import quant as JQ
    from repro.core import qlstm as jq
    from repro.models import lstm_model as JLM
    from repro.models import rglru as JRG
    from repro.models import transformer as JT
    from repro.models.modules import unbox
except ImportError:
    jax = None

B, S = 2, 8
F32_LOSS_RTOL, F32_GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def cfgs(arch, **kw):
    kw = dict(dict(remat="none", dtype="float32"), **kw)
    jkw = dict(kw)
    if "quant" in kw:
        jkw["quant"] = JQ.QuantConfig(kw["quant"])
        kw["quant"] = TQ.QuantConfig(kw["quant"])
    return (j_reduce(J_ARCHS[arch]).replace(**jkw),
            reduce_config(ARCH_CONFIGS[arch]).replace(**kw))


@functools.lru_cache(maxsize=None)
def ref_params(arch):
    jcfg, _ = cfgs(arch)
    jp, _ = JT.init_model(jcfg, jax.random.key(0))
    return jp


def inputs(cfg, seed=1):
    """numpy batch for ``forward_train``: tokens (or frame embeddings),
    labels with two -1 paddings, M-RoPE position streams."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.embed_inputs:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    else:
        out["inputs_embeds"] = rng.normal(0, 1, (B, S, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, -2:] = -1
    out["labels"] = labels
    if cfg.attn and cfg.attn.mrope_sections:
        pos = np.arange(S)
        out["position_ids"] = np.broadcast_to(
            np.stack([pos, pos // 2, pos % 3])[:, None], (3, B, S)).astype(np.int32)
    return out


def jax_loss_and_grads(jp, batch, jcfg):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if "inputs_embeds" in jb:
        jb["inputs_embeds"] = jb["inputs_embeds"].astype(jcfg.dtype)
    (loss, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: JT.forward_train(p, jb, jcfg), has_aux=True))(jp)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(tree_leaves_with_path(jax.tree.map(
                lambda g: np.asarray(g.astype(jnp.float32)), grads))))


def torch_loss_and_grads(tp, batch, tcfg):
    leaves = [p.requires_grad_(True) for p in tree_leaves(tp)]
    loss, metrics = T.forward_train(tp, {k: torch.as_tensor(v)
                                         for k, v in batch.items()}, tcfg)
    gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    paths = [p for p, _ in tree_leaves_with_path(tp)]
    grads = {p: (np.zeros(x.shape, np.float32) if g is None else g.float().numpy())
             for p, x, g in zip(paths, leaves, gs)}
    return (float(loss.detach()), {k: float(v.detach()) for k, v in metrics.items()},
            grads)


def assert_grads_close(got, want, tol, what):
    assert got.keys() == want.keys()
    for path, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(got[path] - w).max())
        assert err <= tol * scale + 1e-30, \
            f"{what} {'/'.join(path)}: |err| {err} > {tol} x {scale}"


def check_train_parity(arch, loss_rtol, grad_tol, **kw):
    jcfg, tcfg = cfgs(arch, **kw)
    jp = ref_params(arch)
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp))
    batch = inputs(tcfg)
    jl, jm, jg = jax_loss_and_grads(jp, batch, jcfg)
    tl, tm, tg = torch_loss_and_grads(tp, batch, tcfg)
    assert np.isfinite(tl)
    np.testing.assert_allclose(tl, jl, rtol=loss_rtol)
    for k in ("ce", "aux"):
        np.testing.assert_allclose(tm[k], jm[k], rtol=loss_rtol, atol=1e-6)
    assert_grads_close(tg, jg, grad_tol, arch)
    return tg


# ---------------------------------------------------------------------------
# forward_train and its gradients, every LM arch
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch", REFERENCE_LM_ARCHS)
def test_forward_train_loss_and_gradients_match_jax_f32(arch):
    tg = check_train_parity(arch, F32_LOSS_RTOL, F32_GRAD_TOL)
    assert any(np.abs(g).max() > 0 for g in tg.values())


def test_forward_train_ignores_padding_labels():
    """Labels of -1 drop out of the mean: all-padding gives ce 0, and a
    padded position's logits get no gradient."""
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(dtype="float32",
                                                              remat="none")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0))
    batch = {k: torch.as_tensor(v) for k, v in inputs(cfg).items()}
    loss, m = T.forward_train(params, dict(batch, labels=torch.full((B, S), -1)), cfg)
    assert float(m["ce"]) == 0.0 and float(loss) == 0.0
    loss, m = T.forward_train(params, batch, cfg)
    assert float(loss) > 0 and float(m["aux"]) == 0.0


# ---------------------------------------------------------------------------
# fake quantisation's straight-through gradient
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("axis", [None, (0,)], ids=["tensor", "channel"])
def test_fake_quant_ste_gradient_matches_jax_including_a_bound(axis):
    """Values inside the clip range and exactly on its bound 127 s (a
    largest value of 127 x 2^-5 makes the power-of-two scale s = 2^-5
    exactly, so that value sits on the bound): the gradient of
    sum(w * fq(x)) is w inside and w / 2 on the bound, in both packages
    (``jnp.clip`` is a ``minimum`` of a ``maximum``, each splitting a tie;
    ``torch.clamp`` would give w); the forward agrees bit for bit."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (16, 8)).astype(np.float32)
    x[3, :] = 127.0 * 2.0 ** -5   # each column's largest value
    w = rng.normal(0, 1, x.shape).astype(np.float32)
    jf = lambda v: jnp.sum(jnp.asarray(w) * JQ.fake_quant_tensor(v, axis=axis))  # noqa: E731
    jg = np.asarray(jax.grad(jf)(jnp.asarray(x)))
    xt = torch.as_tensor(x).requires_grad_(True)
    fq = TQ.fake_quant_tensor(xt, axis=axis)
    (tg,) = torch.autograd.grad(torch.sum(torch.as_tensor(w) * fq), xt)
    np.testing.assert_array_equal(fq.detach().numpy(),
                                  np.asarray(JQ.fake_quant_tensor(jnp.asarray(x), axis=axis)))
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-6, atol=1e-6)
    scale = TQ.compute_scale(torch.as_tensor(x), axis=axis)
    assert float(scale.max()) == 2.0 ** -5
    on_bound = torch.as_tensor(x) == 127.0 * scale
    assert bool(on_bound.any())
    ratio = tg / torch.as_tensor(w)
    assert torch.equal(ratio[on_bound], torch.full_like(ratio[on_bound], 0.5))
    assert torch.equal(ratio[~on_bound], torch.ones_like(ratio[~on_bound]))


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("mode", ["w8", "w8a8", "none"])
def test_fq_matmul_value_and_gradients_match_jax(mode):
    """The counterpart of ``tests/test_quant.py``'s fq_matmul test, against
    ``jax.grad`` in both operands; the forward stays close to float."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (8, 16)).astype(np.float32)
    w = rng.normal(0, 0.1, (16, 4)).astype(np.float32)
    jcfg, tcfg = JQ.QuantConfig(mode), TQ.QuantConfig(mode)
    jgx, jgw = jax.grad(lambda a, b: jnp.sum(JQ.fq_matmul(a, b, jcfg) ** 2),
                        argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt, wt = (torch.as_tensor(a).requires_grad_(True) for a in (x, w))
    y = TQ.fq_matmul(xt, wt, tcfg)
    gx, gw = torch.autograd.grad(torch.sum(y ** 2), (xt, wt))
    np.testing.assert_allclose(y.detach().numpy(),
                               np.asarray(JQ.fq_matmul(jnp.asarray(x), jnp.asarray(w), jcfg)),
                               rtol=1e-6, atol=1e-6)
    for got, want in ((gx, jgx), (gw, jgw)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    assert float(gw.abs().sum()) > 0
    assert float((y.detach() - torch.as_tensor(x @ w)).abs().max()) < 0.2


def test_quantised_linear_trains_through_fq_matmul():
    """A float weight in "train" mode with quantisation on takes the
    fake-quant product (no longer an error); serve mode stays the float
    product."""
    from repro_torch.models.layers import linear
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.normal(0, 1, (2, 5, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(0, 0.2, (16, 2, 4)).astype(np.float32))
    q = TQ.QuantConfig("w8a8")
    y = linear(x, w, q, "train")
    want = TQ.fq_matmul(x, w.reshape(16, 8), q).reshape(2, 5, 2, 4)
    assert torch.equal(y, want)
    assert not torch.equal(y, linear(x, w, q, "prefill"))


# ---------------------------------------------------------------------------
# the RG-LRU scan's gradient (K7 Function)
# ---------------------------------------------------------------------------

def scan_inputs(t, bsz, w, seed=7):
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.normal(0, 0.5, (t, bsz, w))).astype(np.float32)
    b = rng.normal(0, 1, (t, bsz, w)).astype(np.float32)
    dh = rng.normal(0, 1, (t, bsz, w)).astype(np.float32)
    return log_a, b, dh


def plain_grads(log_a, b, dh):
    la, bb = (torch.as_tensor(a).requires_grad_(True) for a in (log_a, b))
    h = tref.rglru_seq_ref(la, bb)
    return torch.autograd.grad(h, (la, bb), torch.as_tensor(dh))


@pytest.mark.parametrize("t,bsz,w", [(1, 2, 4), (5, 3, 8), (33, 2, 70)])
def test_rglru_function_gradient_matches_plain_autograd(t, bsz, w):
    """dlog_a and db of the Function (its backward: the reverse recurrence
    on the flipped, shifted operands) equal the plain recurrence's
    autograd; the forward equals the plain version bit for bit; on the
    CPU no launch is counted."""
    log_a, b, dh = scan_inputs(t, bsz, w)
    before = dict(K.LAUNCHES)
    la, bb = (torch.as_tensor(a).requires_grad_(True) for a in (log_a, b))
    h = K.rglru_seq_grad(la, bb)
    assert torch.equal(h.detach(), tref.rglru_seq_ref(la.detach(), bb.detach()))
    got = torch.autograd.grad(h, (la, bb), torch.as_tensor(dh))
    for g, want in zip(got, plain_grads(log_a, b, dh)):
        assert g.dtype == torch.float32
        torch.testing.assert_close(g, want, rtol=0,
                                   atol=1e-6 * float(want.abs().max()))
    assert K.LAUNCHES == before


def test_rglru_function_takes_views_and_bf16_b():
    """(T, B, W) views of (B, T, W) tensors, as the model passes them, and
    a bf16 b: the gradients come back in each operand's dtype and shape."""
    log_a, b, dh = scan_inputs(6, 2, 16, seed=8)
    la = torch.as_tensor(log_a).transpose(0, 1).contiguous().transpose(0, 1)
    la.requires_grad_(True)
    bb = torch.as_tensor(b).to(torch.bfloat16).requires_grad_(True)
    h = K.rglru_seq_grad(la, bb)
    assert h.dtype == torch.bfloat16
    dla, db = torch.autograd.grad(h, (la, bb), torch.as_tensor(dh).to(torch.bfloat16))
    assert dla.dtype == torch.float32 and db.dtype == torch.bfloat16
    assert dla.shape == la.shape and db.shape == bb.shape
    want = plain_grads(log_a, bb.detach().float().numpy(),
                       torch.as_tensor(dh).to(torch.bfloat16).float().numpy())
    # h is saved in b's dtype (bf16): dlog_a's h_{t-1} factor is rounded
    torch.testing.assert_close(dla, want[0], rtol=2 ** -7, atol=1e-5)
    torch.testing.assert_close(db.float(), want[1], rtol=2 ** -7, atol=1e-5)


@pytest.fixture(scope="module")
def rec_block():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    cfg = j_reduce(J_ARCHS["recurrentgemma-2b"])
    jp, _ = unbox(JRG.init_rglru_block(jax.random.key(3), cfg))
    rng = np.random.default_rng(4)
    jp = dict(jp, b_a=jnp.asarray(rng.normal(0, 0.5, jp["b_a"].shape), jnp.float32),
              b_i=jnp.asarray(rng.normal(0, 0.5, jp["b_i"].shape), jnp.float32))
    return cfg, jp


@pytest.mark.parametrize("hard", [False, True], ids=["sigmoid", "hard"])
def test_rec_block_gradients_match_jax_grad(rec_block, hard):
    """Every parameter of a rec block (w_x, w_gate, w_out, conv, w_a, w_i,
    b_a, b_i, lam) and its input, through the K7 Function, against
    ``jax.grad`` of the reference's block (its associative scan)."""
    cfg, jp = rec_block
    jcfg = cfg.replace(hard_acts=hard)
    tcfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"]).replace(hard_acts=hard)
    rng = np.random.default_rng(45)
    x = rng.normal(0, 1, (2, 11, cfg.d_model)).astype(np.float32)
    w = rng.normal(0, 1, (2, 11, cfg.d_model)).astype(np.float32)
    jgp, jgx = jax.grad(lambda p, a: jnp.sum(JRG.rec_block_apply(p, a, jcfg) * w),
                        argnums=(0, 1))(jp, jnp.asarray(x))
    tp = {k: v.requires_grad_(True) for k, v in
          lm_params_from_reference(jax.tree.map(np.asarray, jp)).items()}
    xt = torch.as_tensor(x).requires_grad_(True)
    y = TRG.rec_block_apply(tp, xt, tcfg, "train")
    keys = sorted(tp)
    gs = torch.autograd.grad(torch.sum(y * torch.as_tensor(w)),
                             [tp[k] for k in keys] + [xt])
    want = {(k,): np.asarray(jgp[k]) for k in keys}
    want[("x",)] = np.asarray(jgx)
    got = {(k,): g.numpy() for k, g in zip(keys + ["x"], gs)}
    assert_grads_close(got, want, F32_GRAD_TOL, "rec block")


# ---------------------------------------------------------------------------
# RWKV-6's chunked wkv over a full training chunk
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("chunk", [128, 16])
def test_wkv_chunked_is_finite_where_decays_overflow_the_reference(chunk):
    """A channel decaying by exp(-4.5) a step sums past exp's f32 range
    within a 128-token chunk: the reference's chunked form (exp(-L_s),
    whose clamp never acts) gives NaN there, the port's pairwise factors
    stay finite and equal the reference's sequential recurrence (2e-4
    relative to the largest output, fp32 sums over a chunk in another
    order), output and final state, with gradients through both."""
    from repro.models import rwkv6 as JRW
    from repro_torch.models import rwkv6 as TRW
    rng = np.random.default_rng(9)
    r, k, v, w = (rng.normal(0, 1, (1, 128, 2, 8)).astype(np.float32) for _ in range(4))
    w[..., 0] = 1.5
    u = rng.normal(0, 1, (2, 8)).astype(np.float32)
    jy, js = JRW.wkv_sequential(*map(jnp.asarray, (r, k, v, w, u)))
    if chunk == 128:
        jyc, _ = JRW.wkv_chunked(*map(jnp.asarray, (r, k, v, w, u)), chunk=chunk)
        assert not np.isfinite(np.asarray(jyc)).all()
    tr = [torch.as_tensor(a).requires_grad_(True) for a in (r, k, v, w, u)]
    ty, ts = TRW.wkv_chunked(*tr, chunk=chunk)
    for got, want in ((ty, jy), (ts, js)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                                   atol=2e-4 * np.abs(want).max())
    gs = torch.autograd.grad(ty.square().sum() + ts.sum(), tr)
    assert all(bool(torch.isfinite(g).all()) for g in gs)


@pytest.mark.parametrize("t,chunk", [(300, 128), (40, 16), (21, 128)])
def test_wkv_chunked_stays_finite_where_one_sub_chunk_overflows(t, chunk):
    """Decays of exp(-e^4) ~ exp(-54.6) a step sum past exp's f32 range
    within two tokens, so a factor rebased on a sub-chunk's start would
    overflow: the chunked form (several chunks, a state carried in) and
    its gradients equal the sequential recurrence's, in f32 to 2e-4 of
    the largest value (sums over a chunk in another order)."""
    from repro_torch.models import rwkv6 as TRW
    rng = np.random.default_rng(11)
    r, k, v = (rng.normal(0, 1, (2, t, 2, 8)).astype(np.float32) for _ in range(3))
    w = rng.normal(-1, 1, (2, t, 2, 8)).astype(np.float32)
    w[..., :3] = 4.0
    w[:, ::7, :, 5] = 4.0
    u = rng.normal(0, 1, (2, 8)).astype(np.float32)
    s0 = rng.normal(0, 1, (2, 2, 8, 8)).astype(np.float32)
    runs = []
    for fn in (lambda *a: TRW.wkv_chunked(*a, chunk=chunk), TRW.wkv_sequential):
        tr = [torch.as_tensor(a).requires_grad_(True) for a in (r, k, v, w, u, s0)]
        y, s = fn(*tr)
        gs = torch.autograd.grad(y.square().sum() + s.sum(), tr)
        runs.append([y, s, *gs])
    for got, want in zip(*runs):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=0,
                                   atol=2e-4 * float(want.detach().abs().max()))


# ---------------------------------------------------------------------------
# activation checkpointing
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b",
                                  "mixtral-8x7b", "rwkv6-7b"])
def test_remat_full_equals_none_bit_for_bit(arch):
    """``remat="full"`` recomputes each layer (each period of the hybrid,
    and the tail's layers) in the backward pass: the loss and every
    gradient equal ``"none"``'s bit for bit."""
    base = reduce_config(ARCH_CONFIGS[arch]).replace(dtype="float32")
    params, _ = T.init_model(base, torch.Generator().manual_seed(2))
    batch = {k: torch.as_tensor(v) for k, v in inputs(base, seed=3).items()}
    out = {}
    for remat in ("none", "full"):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, _ = T.forward_train(live, batch, base.replace(remat=remat))
        out[remat] = (loss.detach(), torch.autograd.grad(loss, leaves,
                                                         allow_unused=True))
    assert torch.equal(out["none"][0], out["full"][0])
    for a, b in zip(out["none"][1], out["full"][1]):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_recomputes_through_the_scan_function():
    """Under ``remat="full"`` the hybrid's periods are recomputed in the
    backward pass, so the scan's forward runs twice per rec block; with
    ``"none"`` once.  Counted on the CPU by wrapping the Function."""
    cfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"]).replace(dtype="float32")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(2))
    batch = {k: torch.as_tensor(v) for k, v in inputs(cfg, seed=3).items()}
    n_rec = sum(k == "rec" for k in cfg.layer_kinds())
    real, calls = K.rglru_seq, []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    K.rglru_seq = counting
    try:
        for remat, want in (("none", n_rec), ("full", 2 * n_rec)):
            calls.clear()
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            it = iter(leaves)
            live = tree_map(lambda _: next(it), params)
            loss, _ = T.forward_train(live, batch, cfg.replace(remat=remat))
            torch.autograd.grad(loss, leaves, allow_unused=True)
            assert len(calls) == want, remat
    finally:
        K.rglru_seq = real


# ---------------------------------------------------------------------------
# the paper's model behind the LM interface
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("mode", ["float", "qat"])
def test_lstm_model_forward_and_loss_match_reference(mode):
    """``forward``/``loss_fn`` on the reference's init (1e-6 absolute, the
    float paths' last bit; the QAT grid's rounding agrees at this seed,
    see ``tests/test_torch_training.py`` for the flip accounting)."""
    cfg = QLSTMConfig()
    jp, jaxes = JLM.init_lstm_model(jq.QLSTMConfig(), jax.random.key(0))
    tp = params_from_reference(jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(0)
    x = rng.normal(0, 0.7, (16, cfg.seq_len, cfg.input_size)).astype(np.float32)
    y = rng.normal(0, 0.5, (16, cfg.out_features)).astype(np.float32)
    got = TLM.forward(tp, torch.as_tensor(x), cfg, mode)
    want = JLM.forward(jp, jnp.asarray(x), jq.QLSTMConfig(), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    tl, tm = TLM.loss_fn(tp, {"x": torch.as_tensor(x), "y": torch.as_tensor(y)},
                         cfg, mode)
    jl, jm = JLM.loss_fn(jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                         jq.QLSTMConfig(), mode)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    assert float(tm["mse"]) == float(tl)
    _, taxes = TLM.init_lstm_model(cfg, torch.Generator().manual_seed(0))
    assert jax.tree.map(tuple, jaxes, is_leaf=lambda a: isinstance(a, tuple)) == taxes


def test_lstm_model_serve_int_warns_and_equals_the_session():
    cfg = QLSTMConfig()
    params, _ = TLM.init_lstm_model(cfg, torch.Generator().manual_seed(1))
    x = np.random.default_rng(2).normal(0, 0.7, (8, cfg.seq_len, 1)).astype(np.float32)
    with pytest.warns(DeprecationWarning, match="serve_int is deprecated"):
        y = TLM.serve_int(params, x, cfg)
    import repro_torch
    want = repro_torch.build(cfg, params=params, device="cpu").quantize().infer(
        x, path="int")
    assert torch.equal(y, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert torch.equal(TLM.serve_int(params, x, cfg, use_kernel=False), want)
