"""The port's fixed-point core and hard activations against the JAX
reference: exhaustive over every code of (4,8), (6,8), (8,10) and (8,16);
integer results must match bit for bit, float activations to float32
rounding (1e-6)."""

import pytest

pytest.importorskip("jax")  # the reference package

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import hard_act as jact  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import hard_act as tact  # noqa: E402

WIDTHS = [(4, 8), (6, 8), (8, 10), (8, 16)]


def _cfgs(a, b):
    return jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)


def _codes(cfg):
    return np.arange(cfg.int_min, cfg.int_max + 1, dtype=np.int32)


def _same(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


@pytest.mark.parametrize("a,b", WIDTHS)
def test_saturate_and_requantize_exhaustive(a, b):
    jc, tc = _cfgs(a, b)
    jp, tp = jfxp.product_config(jc, jc), tfxp.product_config(tc, tc)
    rng = np.random.default_rng(a * 100 + b)
    # every code, wide accumulator values, and the int32 edges (wraparound)
    v = np.concatenate([_codes(tc) * (1 << a), _codes(tc),
                        rng.integers(-2**31, 2**31 - 1, 4096, dtype=np.int64),
                        [2**31 - 1, 2**31 - 2, -2**31]]).astype(np.int32)
    _same(tfxp.saturate(torch.as_tensor(v), tc), jfxp.saturate(jnp.asarray(v), jc))
    for rounding in ("half_up", "trunc"):
        _same(tfxp.requantize(torch.as_tensor(v), tp, tc, rounding),
              jfxp.requantize(jnp.asarray(v), jp, jc, rounding))
    codes = _codes(tc)          # shift < 0: widen back to the product format
    _same(tfxp.requantize(torch.as_tensor(codes), tc, tp),
          jfxp.requantize(jnp.asarray(codes), jc, jp))


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.parametrize("rounding", ["half_up", "nearest_even", "trunc"])
def test_quantize_dequantize_exhaustive(a, b, rounding):
    jc, tc = _cfgs(a, b)
    codes = _codes(tc).astype(np.float32)
    x = np.concatenate([codes * tc.scale + off * tc.scale
                        for off in (0.0, 0.25, 0.5, -0.5, 0.75)]
                       + [np.asarray([1e9, -1e9, np.inf, -np.inf, np.nan])])
    x = x.astype(np.float32)
    q = tfxp.quantize(torch.as_tensor(x), tc, rounding)
    _same(q, jfxp.quantize(jnp.asarray(x), jc, rounding))
    assert q.dtype == torch.int32
    _same(tfxp.dequantize(q, tc), jfxp.dequantize(jnp.asarray(q.numpy()), jc))
    _same(tfxp.quantize_to_storage(torch.as_tensor(x), tc),
          jfxp.quantize_to_storage(jnp.asarray(x), jc))
    _same(tfxp.fake_quant(torch.as_tensor(x[:-3]), tc),
          jfxp.fake_quant(jnp.asarray(x[:-3]), jc))


@pytest.mark.parametrize("a,b", WIDTHS)
def test_mac_datapaths(a, b):
    jc, tc = _cfgs(a, b)
    rng = np.random.default_rng(7 + a + b)
    x = rng.integers(tc.int_min, tc.int_max + 1, (5, 3, 21)).astype(np.int32)
    w = rng.integers(tc.int_min, tc.int_max + 1, (21, 80)).astype(np.int32)
    bias = rng.integers(-2000, 2000, (80,)).astype(np.int32)
    wv = w[:, 0]
    _same(tfxp.fxp_matvec_late_rounding(torch.as_tensor(x), torch.as_tensor(w),
                                        torch.as_tensor(bias), tc),
          jfxp.fxp_matvec_late_rounding(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(bias), jc))
    for acc_bits in (32, 20):
        _same(tfxp.fxp_mac_late_rounding(torch.as_tensor(x), torch.as_tensor(wv),
                                         tc, acc_bits),
              jfxp.fxp_mac_late_rounding(jnp.asarray(x), jnp.asarray(wv), jc,
                                         acc_bits))
    _same(tfxp.fxp_mac_per_step_rounding(torch.as_tensor(x), torch.as_tensor(wv), tc),
          jfxp.fxp_mac_per_step_rounding(jnp.asarray(x), jnp.asarray(wv), jc))


def test_int_matmul_wraps_like_int32():
    """Sums past 2**31 wrap exactly as XLA's int32 accumulator does."""
    x = np.full((2, 4), 2**15 - 1, np.int32)
    w = np.full((4, 3), 2**15 - 1, np.int32)
    got = tfxp.int_matmul(torch.as_tensor(x), torch.as_tensor(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jnp.asarray(x) @ jnp.asarray(w)))


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.parametrize("slope_shift,bound", [(3, 3.0), (2, 2.5)])
def test_hard_sigmoid_star_forms_exhaustive(a, b, slope_shift, bound):
    jc, tc = _cfgs(a, b)
    js = jact.HardSigmoidStarSpec(jc, slope_shift, bound)
    ts = tact.HardSigmoidStarSpec(tc, slope_shift, bound)
    assert ts.bound_int == js.bound_int
    codes = _codes(tc)
    xt, xj = torch.as_tensor(codes), jnp.asarray(codes)
    for method in ("arithmetic", "1to1", "step"):
        _same(tact.hs_star_int(xt, ts, method), jact.hs_star_int(xj, js, method))
    _same(tact.hs_star_int_step_unrolled(xt, ts),
          jact.hs_star_int_step_unrolled(xj, js))
    thr_t, out_t = tact.step_table(ts)
    thr_j, out_j = jact.step_table(js)
    np.testing.assert_array_equal(thr_t, thr_j)
    np.testing.assert_array_equal(out_t, out_j)
    np.testing.assert_array_equal(tact.one_to_one_table(ts),
                                  jact.one_to_one_table(js))
    assert tact.num_step_entries(ts) == jact.num_step_entries(js)
    assert tact.num_1to1_entries(ts) == jact.num_1to1_entries(js)


def test_paper_table_entry_counts():
    """The paper's 96 one-to-one and 14 step entries for (4,8)."""
    spec = tact.HardSigmoidStarSpec(tfxp.FXP_4_8)
    assert tact.num_1to1_entries(spec) == 96
    assert tact.num_step_entries(spec) == 14


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.parametrize("lo,hi", [(-1.0, 1.0), (-0.53, 2.0)])
def test_hard_tanh_and_lut_exhaustive(a, b, lo, hi):
    jc, tc = _cfgs(a, b)
    codes = _codes(tc)
    xt, xj = torch.as_tensor(codes), jnp.asarray(codes)
    _same(tact.hard_tanh_int(xt, tc, lo, hi), jact.hard_tanh_int(xj, jc, lo, hi))
    _same(tact.lut_sigmoid_int(xt, tc), jact.lut_sigmoid_int(xj, jc))
    _same(tact.lut_tanh_int(xt, tc), jact.lut_tanh_int(xj, jc))


@pytest.mark.parametrize("name", ["sigmoid", "tanh", "silu", "gelu",
                                  "gelu_tanh", "relu", "relu2", "hard_tanh",
                                  "hard_sigmoid", "hard_sigmoid_star",
                                  "hard_silu", "hard_gelu"])
def test_float_activations(name):
    x = np.random.default_rng(3).normal(0, 3, 4096).astype(np.float32)
    np.testing.assert_allclose(
        tact.get_float_act(name)(torch.as_tensor(x)).numpy(),
        np.asarray(jact.get_float_act(name)(jnp.asarray(x))),
        rtol=1e-6, atol=1e-6)
