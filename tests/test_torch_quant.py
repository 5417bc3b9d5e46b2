"""The port's tensor-level int8 quantisation (``repro_torch.core.quant``),
the w8/w8a8 ``linear`` and ``quantize_model_params`` against the JAX
package's, on the same numpy inputs.

Integer results are held bit for bit (tolerance 0): codes, scales, the
w8a8 int32 accumulator and every arch's quantised serve weights.  Float
results built from them are held within the tolerance each test states.
The properties of ``tests/test_quant.py`` (all but the ``fq_matmul``
gradient, which belongs to LM training) run here on the port."""

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

from repro_torch.configs import ARCH_CONFIGS, ASSIGNED_ARCHS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.core.quant import (W8, W8A8, QuantConfig, compute_scale,
                                    fake_quant_tensor, qmatmul, quantize_kv,
                                    quantize_tensor, quantize_weight)
from repro_torch.kernels import quant_matmul as qm
from repro_torch.models import layers as TL
from repro_torch.models import transformer as T

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.core import quant as JQ
    from repro.models import layers as JL
    from repro.models import transformer as JT
except ImportError:
    jax = None


@pytest.fixture
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _eq(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# the properties of tests/test_quant.py, on the port
# ---------------------------------------------------------------------------

@given(st.integers(0, 1000), st.floats(0.01, 1000.0))
@settings(max_examples=100, deadline=None)
def test_quantize_error_bound(seed, scale_mag):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, scale_mag, (32,)).astype(np.float32)
    qt = quantize_tensor(torch.as_tensor(x))
    err = np.abs(qt.dequantize().numpy() - x)
    assert err.max() <= float(qt.scale) / 2 + 1e-6


@given(st.integers(0, 200))
@settings(max_examples=50, deadline=None)
def test_p2_scales_are_powers_of_two(seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, rng.uniform(0.01, 100), (16, 8)).astype(np.float32)
    s = float(compute_scale(torch.as_tensor(x), p2=True))
    assert s > 0 and abs(np.log2(s) - round(np.log2(s))) < 1e-6
    qt = quantize_tensor(torch.as_tensor(x), p2=True)
    assert qt.values.abs().max() <= 127


def test_per_channel_weight_quant():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1, (64, 32)).astype(np.float32)
    w[:, 5] *= 100  # one hot channel shouldn't wreck the others
    qt = quantize_weight(torch.as_tensor(w), W8A8, out_axis=-1)
    assert tuple(qt.scale.shape) == (1, 32)
    err = np.abs(qt.dequantize().numpy() - w)
    assert err[:, 0].max() < 0.02


def test_qmatmul_close_to_float():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 1, (16, 64)).astype(np.float32)
    w = rng.normal(0, 0.1, (64, 32)).astype(np.float32)
    wq = quantize_weight(torch.as_tensor(w), W8A8)
    y8 = qmatmul(torch.as_tensor(x), wq, W8A8).numpy()
    yf = x @ w
    assert np.abs(y8 - yf).max() / (np.abs(yf).max() + 1e-9) < 0.05


def test_kv_quantisation_roundtrip():
    rng = np.random.default_rng(3)
    kv = rng.normal(0, 1, (2, 10, 4, 16)).astype(np.float32)  # B,S,KV,hd
    qt = quantize_kv(torch.as_tensor(kv))
    assert qt.values.dtype == torch.int8
    assert np.abs(qt.dequantize().numpy() - kv).max() < 0.05


# ---------------------------------------------------------------------------
# bit for bit against the reference
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("p2", [True, False], ids=["p2", "free"])
@pytest.mark.parametrize("axis", [None, (0,), (1, 2), (0, 2)])
def test_quantize_tensor_codes_and_scales_equal_reference(axis, p2):
    """Round half up, saturation and the scale (power-of-two rounding up
    through log2/ceil/exp2) give the reference's codes and scales, on
    values that land on .5 after scaling too."""
    rng = np.random.default_rng(11)
    x = rng.normal(0, 3, (6, 5, 7)).astype(np.float32)
    x[0, 0, :3] = [2.5, -2.5, 0.5]                      # half-way cases
    got = quantize_tensor(torch.as_tensor(x), axis=axis, p2=p2)
    want = JQ.quantize_tensor(jnp.asarray(x), axis=axis, p2=p2)
    _eq(got.values, want.values)
    _eq(got.scale, want.scale)
    _eq(fake_quant_tensor(torch.as_tensor(x), axis=axis, p2=p2),
        JQ.fake_quant_tensor(jnp.asarray(x), axis=axis, p2=p2))


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("cfg", [W8, W8A8, QuantConfig("w8", per_channel=False)],
                         ids=["w8", "w8a8", "per-tensor"])
def test_quantize_weight_qmatmul_and_kv_equal_reference(cfg):
    rng = np.random.default_rng(12)
    x = rng.normal(0, 1, (5, 3, 48)).astype(np.float32)
    w = rng.normal(0, 0.1, (48, 24)).astype(np.float32)
    got = quantize_weight(torch.as_tensor(w), cfg)
    want = JQ.quantize_weight(jnp.asarray(w), cfg)
    _eq(got.values, want.values)
    _eq(got.scale, want.scale)
    # qmatmul: the exact int32 product (w8a8), the same float epilogue
    y = qmatmul(torch.as_tensor(x), got, cfg).numpy()
    y_ref = np.asarray(JQ.qmatmul(jnp.asarray(x), want, cfg))
    np.testing.assert_allclose(y, y_ref, rtol=1e-6, atol=1e-6)
    kv = rng.normal(0, 1, (2, 9, 3, 8)).astype(np.float32)
    got_kv, want_kv = quantize_kv(torch.as_tensor(kv)), JQ.quantize_kv(jnp.asarray(kv))
    _eq(got_kv.values, want_kv.values)
    _eq(got_kv.scale, want_kv.scale)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p2", [True, False], ids=["p2", "free"])
def test_w8a8_linear_int32_accumulator_equals_reference(dtype, p2, monkeypatch):
    """The w8a8 ``linear`` on a (d, H, hd) weight: the activation's codes
    and the int32 accumulator equal the reference's ``dot_general`` bit
    for bit; the output, scaled in f32 and cast to x's dtype, equals the
    reference's within 1e-6 (f32) or one bf16 ulp (bf16)."""
    rng = np.random.default_rng(13)
    x = rng.normal(0, 2, (3, 5, 64)).astype(np.float32)
    w = rng.normal(0, 0.2, (64, 4, 16)).astype(np.float32)
    quant = QuantConfig("w8a8", p2_scale=p2)
    wq_t = quantize_tensor(torch.as_tensor(w), axis=(0,), p2=p2)
    wq_j = JQ.quantize_tensor(jnp.asarray(w), axis=(0,), p2=p2)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    xj, xt = jnp.asarray(x).astype(jdt), torch.as_tensor(x).to(tdt)

    seen = []
    real = TL.int8_matmul

    def spy(a, b):
        out = real(a, b)
        seen.append((a, out))
        return out

    monkeypatch.setattr(TL, "int8_matmul", spy)
    got = TL.linear(xt, {"q": wq_t.values, "s": wq_t.scale}, quant, "decode")
    want = JL.linear(xj, {"q": wq_j.values, "s": wq_j.scale}, quant, "decode")
    (xq_t, acc_t), = seen
    s_x = jnp.maximum(jnp.max(jnp.abs(xj)), 1e-12) / 127.0
    s_x = jnp.exp2(jnp.ceil(jnp.log2(s_x))) if p2 else s_x
    xq_j = jnp.clip(jnp.floor(xj / s_x + 0.5), -128, 127).astype(jnp.int8)
    acc_j = jax.lax.dot_general(xq_j, wq_j.values.reshape(64, -1),
                                (((2,), (0,)), ((), ())),
                                preferred_element_type=jnp.int32)
    _eq(xq_t, xq_j)
    _eq(acc_t, acc_j)
    assert got.dtype == tdt and tuple(got.shape) == (3, 5, 4, 16)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8, atol=0)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8_linear_matches_reference(dtype):
    rng = np.random.default_rng(14)
    x = rng.normal(0, 1, (2, 3, 32)).astype(np.float32)
    w = rng.normal(0, 0.2, (32, 40)).astype(np.float32)
    wq = JQ.quantize_tensor(jnp.asarray(w), axis=(0,))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got = TL.linear(torch.as_tensor(x).to(tdt),
                    {"q": torch.as_tensor(np.asarray(wq.values)),
                     "s": torch.as_tensor(np.asarray(wq.scale))}, W8, "decode")
    want = JL.linear(jnp.asarray(x).astype(jdt),
                     {"q": wq.values, "s": wq.scale}, W8, "decode")
    tol = 2e-6 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=tol, atol=tol)


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("p2", [True, False], ids=["p2", "free"])
@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_quantize_model_params_equal_reference(arch, p2):
    """Every arch's serve weights: the same leaves quantised (the
    reference's exclusion lists), int8 codes and f32 scales bit for bit,
    scales reduced over the contraction dim after any layers/experts dims,
    and the same axes trees."""
    quant = QuantConfig("w8a8", p2_scale=p2)
    jcfg = j_reduce(J_ARCHS[arch]).replace(quant=quant, remat="none")
    tcfg = reduce_config(ARCH_CONFIGS[arch]).replace(quant=quant)
    jp, jaxes = JT.init_model(jcfg, jax.random.key(0))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp))
    _, taxes = T.init_model(tcfg, torch.Generator().manual_seed(0))
    jq, jqa = JT.quantize_model_params(jp, jaxes, jcfg)
    tq, tqa = T.quantize_model_params(tp, taxes, tcfg)
    n_q = 0

    def walk(j, t, ja, ta, path):
        nonlocal n_q
        if isinstance(j, dict):
            assert set(j) == set(t), path
            if set(j) == {"q", "s"}:
                n_q += 1
            for k in j:
                walk(j[k], t[k], ja[k], ta[k], f"{path}/{k}")
        elif isinstance(j, list):
            assert len(j) == len(t), path
            for i, parts in enumerate(zip(j, t, ja, ta)):
                walk(*parts, f"{path}/{i}")
        else:
            assert tuple(ta) == tuple(ja), path
            _eq(t, j)

    walk(jq, tq, jqa, tqa, "")
    assert n_q >= 4
    # the converted quantised tree keeps int8 codes as they are
    tq2 = lm_params_from_reference(jax.tree.map(np.asarray, jq))
    walk(jq, tq2, jqa, tqa, "")


# ---------------------------------------------------------------------------
# on the card: the w8a8 product through K4
# ---------------------------------------------------------------------------

@pytest.mark.gpu
def test_w8a8_decode_step_kernel_equals_plain_product_on_card(monkeypatch):
    """A w8a8 decode step of qwen1.5-0.5B (reduced) on the card runs one
    K4 launch per quantised ``linear``; the same step with K4's plain
    version gives the same int32 accumulators and the same logits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(
        dtype="float32", quant=QuantConfig("w8a8", quantize_kv=True))
    params, axes = T.init_model(cfg, torch.Generator(device=dev).manual_seed(0))
    params, _ = T.quantize_model_params(params, axes, cfg)
    cache = T.init_cache(cfg, 4, 16, device=dev)
    batch = {"tokens": torch.arange(4, device=dev)[:, None], "cache_pos": 0}
    accs = {"kernel": [], "plain": []}

    def run(route):
        def mm(x, w, out_mode="int32", **kw):
            fn = qm._launch if route == "kernel" else qm.quant_matmul_plain
            out = fn(x, w, out_mode, None) if route == "kernel" else fn(x, w)
            accs[route].append(out)
            return out
        monkeypatch.setattr(qm, "quant_matmul", mm)
        return T.forward_decode(params, cache, batch, cfg)[0]

    before = qm.LAUNCHES["int32"]
    got = run("kernel")
    torch.cuda.synchronize()
    n_linear = 7 * cfg.n_layers          # q, k, v, o, gate, up, down
    assert qm.LAUNCHES["int32"] - before == n_linear == len(accs["kernel"])
    want = run("plain")
    assert len(accs["plain"]) == n_linear
    for a, b in zip(accs["kernel"], accs["plain"]):
        assert torch.equal(a, b)
    assert torch.equal(got, want)
