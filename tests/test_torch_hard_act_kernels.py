"""The port's elementwise hard activations (``kernels/hard_act.py``)
against the JAX package's ``hard_sigmoid_star_pallas`` /
``hard_tanh_pallas`` (interpret mode on the CPU, as the reference's own
tests run them).  On the CPU each entry runs its plain torch version;
every result must match bit for bit.  Mirrors ``tests/test_kernels.py``:
every code of (4,8), (6,8), (8,10) and (8,16) under every method, plus a
3-D input that pins the reshape and codes outside the table.
``test_cuda_kernels_match_plain`` holds the CUDA kernel against its plain
versions on the card."""

import numpy as np
import pytest
import torch

from repro_torch.core import fixed_point as tfxp
from repro_torch.core import hard_act as thact
from repro_torch.kernels import hard_act as tk
from repro_torch.kernels import ops as tops

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax.numpy as jnp
    from repro.core import fixed_point as jfxp
    from repro.kernels import ops as jops
    from repro.kernels.hard_act import hard_sigmoid_star_pallas
except ImportError:
    jnp = None

WIDTHS = [(4, 8), (6, 8), (8, 10), (8, 16)]
METHODS = ["arithmetic", "1to1", "step"]


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _all_codes(a, b):
    cfg = tfxp.FixedPointConfig(a, b)
    dt = np.int8 if b <= 8 else np.int16
    return np.arange(cfg.int_min, cfg.int_max + 1).reshape(-1, 16).astype(dt)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.usefixtures("reference")
def test_hard_act_kernel_all_configs(a, b, method):
    xs = _all_codes(a, b)
    jc, tc = jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)
    got = tops.hard_sigmoid_star_int(torch.as_tensor(xs), tc, method=method)
    _eq(got, jops.hard_sigmoid_star_int(jnp.asarray(xs), jc, method=method))
    _eq(tops.hard_sigmoid_star_int(torch.as_tensor(xs), tc, method=method,
                                   use_kernel=False),
        jops.hard_sigmoid_star_int(jnp.asarray(xs), jc, method=method,
                                   use_kernel=False))


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.usefixtures("reference")
def test_hard_tanh_kernel(a, b):
    xs = _all_codes(a, b)
    jc, tc = jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)
    _eq(tops.hard_tanh_int(torch.as_tensor(xs), tc),
        jops.hard_tanh_int(jnp.asarray(xs), jc))
    _eq(tops.hard_tanh_int(torch.as_tensor(xs), tc, -0.5, 0.75),
        jops.hard_tanh_int(jnp.asarray(xs), jc, -0.5, 0.75))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.usefixtures("reference")
def test_hard_act_3d_input_keeps_its_shape(method):
    rng = np.random.default_rng(3)
    xs = rng.integers(-128, 128, (3, 5, 7)).astype(np.int8)
    got = tops.hard_sigmoid_star_int(torch.as_tensor(xs), tfxp.FXP_4_8,
                                     method=method)
    assert tuple(got.shape) == (3, 5, 7)
    _eq(got, jops.hard_sigmoid_star_int(jnp.asarray(xs), jfxp.FXP_4_8,
                                        method=method))
    ht = tops.hard_tanh_int(torch.as_tensor(xs), tfxp.FXP_4_8)
    assert tuple(ht.shape) == (3, 5, 7)
    _eq(ht, jops.hard_tanh_int(jnp.asarray(xs), jfxp.FXP_4_8))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.usefixtures("reference")
def test_codes_outside_the_range_follow_the_kernel(method):
    """int16 codes beyond (4,8)'s range: each method gives what the TPU
    kernel gives (1to1's one-hot finds no entry and yields 0)."""
    xs = np.arange(-400, 400, dtype=np.int16).reshape(-1, 16)
    got = tk.hard_sigmoid_star(torch.as_tensor(xs), cfg=tfxp.FXP_4_8,
                               method=method)
    _eq(got, hard_sigmoid_star_pallas(jnp.asarray(xs), cfg=jfxp.FXP_4_8,
                                      method=method))


def test_device_tables_are_built_once():
    """The 1to1 and step tables are copied to a device once per spec and
    are what the plain lookups index."""
    spec = thact.HardSigmoidStarSpec(tfxp.FXP_8_16)
    cpu = torch.device("cpu")
    table = thact.one_to_one_table_tensor(spec, cpu)
    assert table is thact.one_to_one_table_tensor(spec, cpu)
    assert table.numel() == 1 << 16
    assert thact.step_table_tensors(spec, cpu) is thact.step_table_tensors(spec, cpu)
    xs = torch.arange(-32768, 32768, dtype=torch.int32)
    assert torch.equal(thact.hs_star_int_1to1(xs, spec), table)
    assert torch.equal(thact.hs_star_int_step(xs, spec), table)


def test_hard_act_validates_inputs():
    x = torch.zeros(4, 4, dtype=torch.int8)
    for fn in (tk.hard_sigmoid_star, tk.hard_sigmoid_star_plain):
        with pytest.raises(ValueError, match="method"):
            fn(x, cfg=tfxp.FXP_4_8, method="lut")
        with pytest.raises(ValueError, match="int8/int16/int32"):
            fn(x.float(), cfg=tfxp.FXP_4_8)
    for fn in (tk.hard_tanh, tk.hard_tanh_plain):
        with pytest.raises(ValueError, match="int8/int16/int32"):
            fn(x.float(), cfg=tfxp.FXP_4_8)


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """HardSigmoid* (every method) and HardTanh on the card equal their
    plain versions bit for bit over every code of each width, on aligned
    and unaligned views, and keep the dtype and shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for a, b in WIDTHS + [(8, 24)]:
        cfg = tfxp.FixedPointConfig(a, b)
        lo, hi = (cfg.int_min, cfg.int_max) if b <= 16 else (-5000, 5000)
        xs = torch.arange(lo, hi + 1, device=dev).to(cfg.storage_dtype)
        for view in (xs, xs[3:], xs[: (xs.numel() // 16) * 16].reshape(-1, 16)):
            for method in METHODS:
                got = tk.hard_sigmoid_star(view, cfg=cfg, method=method)
                torch.cuda.synchronize()
                want = tk.hard_sigmoid_star_plain(view, cfg=cfg, method=method)
                assert got.dtype == view.dtype and got.shape == view.shape
                assert torch.equal(got, want), (a, b, method)
            got = tk.hard_tanh(view, cfg=cfg)
            torch.cuda.synchronize()
            assert torch.equal(got, tk.hard_tanh_plain(view, cfg=cfg))
