"""The port's ``kernels.ops`` entry point against the JAX package's
``repro.kernels.ops`` on the same numpy inputs: ``qlstm_seq`` through the
engines' ``layer`` entries (and ``BackendUnsupported`` off the fused
datapath), the integer chain ``quant_matmul_requant -> hard_sigmoid_star_int
-> hard_tanh_int`` and ``mha_flash`` at small widths, with the kernel and
the oracle routes.  Integer paths match bit for bit, attention within
2e-5.  Off the CPU every wrapper launches its kernel or raises."""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import backends as tbackends
from repro_torch.core import fixed_point as tfxp
from repro_torch.core.accelerator import AcceleratorConfig as TAcc
from repro_torch.core.qlstm import QLSTMConfig as TModel
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import hard_act as tha
from repro_torch.kernels import ops as tops
from repro_torch.kernels import qlstm_cell as tqc
from repro_torch.kernels import quant_matmul as tqm

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax.numpy as jnp
    from repro.core import fixed_point as jfxp
    from repro.core.accelerator import AcceleratorConfig as JAcc
    from repro.core.qlstm import QLSTMConfig as JModel
    from repro.kernels import ops as jops
except ImportError:
    jnp = None


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _rand_lstm(rng, T, B, M, H, b=8):
    lo, hi = -(1 << (b - 1)), 1 << (b - 1)
    dt = np.int8 if b <= 8 else np.int16
    x = rng.integers(lo, hi, (T, B, M)).astype(dt)
    wx = rng.integers(lo // 4, hi // 4, (M, 4 * H)).astype(dt)
    wh = rng.integers(lo // 8, hi // 8, (H, 4 * H)).astype(dt)
    bb = rng.integers(-200, 200, (4 * H,)).astype(np.int32)
    return x, wx, wh, bb


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("T,B,M,H", [(3, 2, 1, 4), (7, 13, 3, 20),
                                     (6, 128, 1, 20), (2, 5, 10, 60),
                                     (12, 1, 2, 8)])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.usefixtures("reference")
def test_ops_qlstm_seq_shapes(T, B, M, H, use_kernel):
    arrays = _rand_lstm(np.random.default_rng(T * B + H), T, B, M, H)
    got = tops.qlstm_seq(*map(torch.as_tensor, arrays),
                         TModel(input_size=M, hidden_size=H, seq_len=T),
                         use_kernel=use_kernel)
    assert tuple(got.shape) == (T, B, H) and got.dtype == torch.int32
    _eq(got, jops.qlstm_seq(*map(jnp.asarray, arrays),
                            JModel(input_size=M, hidden_size=H, seq_len=T),
                            use_kernel=use_kernel))


@pytest.mark.parametrize("hs_method", ["arithmetic", "step", "1to1"])
@pytest.mark.usefixtures("reference")
def test_ops_qlstm_seq_int16_datapath(hs_method):
    """(8,16) — the baseline [15] width — through the same kernel, under
    each HardSigmoid* method of the accelerator."""
    arrays = _rand_lstm(np.random.default_rng(16), 4, 3, 1, 8, b=16)
    got = tops.qlstm_seq(*map(torch.as_tensor, arrays),
                         TModel(input_size=1, hidden_size=8, seq_len=4),
                         TAcc(fxp=tfxp.FXP_8_16, hs_method=hs_method))
    _eq(got, jops.qlstm_seq(*map(jnp.asarray, arrays),
                            JModel(input_size=1, hidden_size=8, seq_len=4),
                            JAcc(fxp=jfxp.FXP_8_16, hs_method=hs_method)))


@pytest.mark.parametrize("case", ["per_step_alu", "lut_gate"])
def test_ops_qlstm_seq_rejects_non_fused_datapaths(case):
    model = TModel(input_size=1, hidden_size=4, seq_len=3)
    accel = TAcc(alu_mode="per_step") if case == "per_step_alu" else TAcc()
    if case == "lut_gate":
        model = dataclasses.replace(
            model, acts=dataclasses.replace(model.acts, gate="lut_sigmoid"))
    x, wx, wh, bb = map(torch.as_tensor,
                        _rand_lstm(np.random.default_rng(0), 3, 2, 1, 4))
    for use_kernel in (True, False):
        with pytest.raises(tbackends.BackendUnsupported, match="fused"):
            tops.qlstm_seq(x, wx, wh, bb, model, accel, use_kernel=use_kernel)


@pytest.mark.parametrize("a,b", [(4, 8), (8, 16)])
@pytest.mark.parametrize("method", ["arithmetic", "1to1", "step"])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.usefixtures("reference")
def test_slice_integer_chain_matches_reference(a, b, method, use_kernel):
    """quant_matmul_requant -> hard_sigmoid_star_int -> hard_tanh_int, the
    integer chain of a gated layer at small widths, equal to the
    reference step by step."""
    rng = np.random.default_rng(a * b)
    dt = np.int8 if b <= 8 else np.int16
    lo, hi = -(1 << (b - 1)), 1 << (b - 1)
    x = rng.integers(lo, hi, (24, 40)).astype(dt)
    w = rng.integers(lo // 4, hi // 4, (40, 36)).astype(dt)
    jc, tc = jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)
    kw = dict(use_kernel=use_kernel)
    t_pre = tops.quant_matmul_requant(torch.as_tensor(x), torch.as_tensor(w),
                                      tc, **kw)
    j_pre = jops.quant_matmul_requant(jnp.asarray(x), jnp.asarray(w), jc,
                                      block=(16, 16, 16), **kw)
    _eq(t_pre, j_pre)
    t_g = tops.hard_sigmoid_star_int(t_pre, tc, method=method, **kw)
    j_g = jops.hard_sigmoid_star_int(j_pre, jc, method=method, **kw)
    _eq(t_g, j_g)
    _eq(tops.hard_tanh_int(t_g, tc, **kw), jops.hard_tanh_int(j_g, jc, **kw))
    _eq(tops.quant_matmul(torch.as_tensor(x), torch.as_tensor(w), **kw),
        jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), **kw))


@pytest.mark.parametrize("h,kv,window", [(4, 4, None), (4, 1, None),
                                         (6, 2, 12)])
@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.usefixtures("reference")
def test_slice_mha_flash_matches_reference(h, kv, window, use_kernel):
    rng = np.random.default_rng(h * 10 + kv)
    b, t, hd = 2, 40, 32
    q = rng.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    got = tops.mha_flash(*map(torch.as_tensor, (q, k, v)), window=window,
                         use_kernel=use_kernel)
    want = jops.mha_flash(*map(jnp.asarray, (q, k, v)), window=window,
                          block_q=16, block_k=16, use_kernel=use_kernel)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU a wrapper launches its kernel or raises: tensors on a
    device that is neither the CPU nor CUDA are refused, not computed, by
    every kernel entry and every ``ops`` wrapper that reaches one."""
    meta = lambda *shape, dt=torch.int8: torch.zeros(*shape, dtype=dt,
                                                     device="meta")
    cfg = tfxp.FXP_4_8
    calls = [
        lambda: tqm.quant_matmul(meta(4, 5), meta(5, 3)),
        lambda: tops.quant_matmul(meta(4, 5), meta(5, 3)),
        lambda: tops.quant_matmul_requant(meta(4, 5), meta(5, 3), cfg),
        lambda: tha.hard_sigmoid_star(meta(4, 4), cfg=cfg, method="step"),
        lambda: tops.hard_sigmoid_star_int(meta(4, 4), cfg, method="1to1"),
        lambda: tops.hard_tanh_int(meta(4, 4), cfg),
        lambda: tfa.flash_attention(*(meta(2, 8, 16, dt=torch.float32),) * 3),
        lambda: tops.mha_flash(*(meta(1, 8, 2, 16, dt=torch.float32),) * 3),
        lambda: tops.qlstm_seq(meta(3, 2, 1), meta(1, 16), meta(4, 16),
                               meta(16, dt=torch.int32),
                               TModel(input_size=1, hidden_size=4, seq_len=3)),
    ]
    before = [dict(m.LAUNCHES) for m in (tqm, tha, tfa, tqc)]
    for call in calls:
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert [dict(m.LAUNCHES) for m in (tqm, tha, tfa, tqc)] == before


@pytest.mark.gpu
def test_cuda_ops_launch_their_kernels():
    """On the card each ``ops`` wrapper launches its kernel exactly once
    per call and equals its oracle route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.integers(-128, 128, (100, 96)), dtype=torch.int8,
                        device=dev)
    w = torch.as_tensor(rng.integers(-128, 128, (96, 130)), dtype=torch.int8,
                        device=dev)
    cfg = tfxp.FXP_4_8
    counters = (tqm.LAUNCHES, tha.LAUNCHES, tfa.LAUNCHES, tqc.LAUNCHES)
    for c in counters:
        for key in c:
            c[key] = 0
    pre = tops.quant_matmul_requant(x, w, cfg)
    assert torch.equal(pre, tops.quant_matmul_requant(
        x, w, cfg, use_kernel=False).to(torch.int8))
    assert torch.equal(tops.quant_matmul(x, w),
                       tops.quant_matmul(x, w, use_kernel=False))
    for method in ("arithmetic", "step", "1to1"):
        assert torch.equal(
            tops.hard_sigmoid_star_int(pre, cfg, method=method),
            tops.hard_sigmoid_star_int(pre, cfg, method=method,
                                       use_kernel=False).to(torch.int8))
    assert torch.equal(tops.hard_tanh_int(pre, cfg),
                       tops.hard_tanh_int(pre, cfg, use_kernel=False)
                       .to(torch.int8))
    q = torch.as_tensor(rng.normal(0, 1, (1, 96, 4, 64)), dtype=torch.float32,
                        device=dev)
    torch.testing.assert_close(tops.mha_flash(q, q, q),
                               tops.mha_flash(q, q, q, use_kernel=False),
                               rtol=2e-5, atol=2e-5)
    lstm = [torch.as_tensor(a, device=dev)
            for a in _rand_lstm(rng, 6, 37, 1, 20)]
    model = TModel()
    assert torch.equal(tops.qlstm_seq(*lstm, model),
                       tops.qlstm_seq(*lstm, model, use_kernel=False))
    assert (tqm.LAUNCHES, tha.LAUNCHES, tfa.LAUNCHES) == (
        {"int32": 1, "requant": 1},
        {"hard_sigmoid_star": 3, "hard_tanh": 1}, {"flash_attention": 1})
    assert tqc.LAUNCHES == {"multilayer": 0, "seq": 1, "slot": 0}
