"""The port's elementwise hard activations (``kernels/hard_act.py``)
against the JAX package's ``hard_sigmoid_star_pallas`` /
``hard_tanh_pallas`` (interpret mode on the CPU, as the reference's own
tests run them).  On the CPU each entry runs its plain torch version;
every result must match bit for bit.  Mirrors ``tests/test_kernels.py``:
every code of (4,8), (6,8), (8,10) and (8,16) under every method, plus a
3-D input that pins the reshape and codes outside the table.
``test_cuda_kernels_match_plain`` holds the CUDA kernel against its plain
versions on the card.

``step``'s kernel runs one of three routes per (table, code dtype)
(``kernels/hard_act.py::step_route``); :func:`_step_like_the_kernel`
repeats each route's arithmetic in torch on the table the kernel is
given, slot by slot in the kernel's order — the bytes route's words of
four codes with the same subtract, majority and high-word multiply-add,
the words route's int32 cascade, the bisect route's loop — and
``test_step_routes_follow_the_reference`` holds it against the TPU
kernel in interpret mode over every code of each width in each storage
dtype, at tolerance 0."""

import itertools

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


M32 = 0xFFFFFFFF


def _step_like_the_kernel(x, spec):
    """``step`` on CPU codes ``x`` through the route the CUDA kernel takes,
    operation for operation (uint32 words held in int64)."""
    route = tk.step_route(spec, x.dtype)
    x32 = x.to(torch.int32).reshape(-1)
    if route.name == "bisect":
        thr, outs = (torch.as_tensor(t) for t in thact.step_table(spec))
        lo = torch.zeros_like(x32, dtype=torch.int64)
        hi = torch.full_like(lo, thr.numel())
        while bool((lo < hi).any()):
            live = lo < hi
            mid = (lo + hi) >> 1
            up = thr[mid.clamp(max=thr.numel() - 1)] <= x32
            lo = torch.where(live & up, mid + 1, lo)
            hi = torch.where(live & ~up, mid, hi)
        return outs[lo].to(x.dtype).reshape(x.shape)
    c = tk._cascade(route)                  # the kernel's parameter
    slots = tk.cascade_slots(route)
    if route.name == "words":
        y = torch.full_like(x32, route.start)
        for k in slots:
            t = int(np.uint32(c.thr[k]).view(np.int32))
            y = y + torch.where(x32 >= t, int(c.delta[k]), 0).to(torch.int32)
    else:
        assert max(c.delta, default=0) <= 0xFE000000   # products stay in int64
        pad = (-x32.numel()) % 4
        b = torch.cat([x.reshape(-1).view(torch.uint8).to(torch.int64),
                       torch.zeros(pad, dtype=torch.int64)]).reshape(-1, 4)
        w = b[:, 0] | b[:, 1] << 8 | b[:, 2] << 16 | b[:, 3] << 24
        hi, top = w | tk._H, (w ^ M32) & tk._H
        acc = torch.full_like(w, c.start)
        for k in slots:
            t7, sign, d25 = c.thr[k], c.sign[k], c.delta[k]
            low = (hi - t7) & M32
            ge = (top & sign) | (top & low) | (sign & low)
            acc = (acc + ((ge * d25) >> 32)) & M32
        w = acc ^ tk._H
        b = torch.stack([(w >> s) & 0xFF for s in (0, 8, 16, 24)], dim=1)
        y = b.reshape(-1)[:x32.numel()].to(torch.uint8).view(torch.int8)
    return y.to(x.dtype).reshape(x.shape)


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


STORAGE = [torch.int8, torch.int16, torch.int32]


@pytest.mark.parametrize("a,b", WIDTHS + [(6, 16)])
@pytest.mark.parametrize("dtype", STORAGE, ids=str)
@pytest.mark.usefixtures("reference")
def test_step_routes_follow_the_reference(a, b, dtype):
    """Every code of the width that the storage dtype holds, through the
    kernel's route in torch, equals ``hard_sigmoid_star_pallas(step)``
    bit for bit.  (6,16) in int8 has thresholds below -128 and above 127,
    folded into the start and dropped."""
    cfg = tfxp.FixedPointConfig(a, b)
    info = torch.iinfo(dtype)
    lo, hi = max(cfg.int_min, info.min), min(cfg.int_max, info.max)
    xs = torch.arange(lo, hi + 1).to(dtype).reshape(-1, 16)
    got = _step_like_the_kernel(xs, thact.HardSigmoidStarSpec(cfg))
    _eq(got, hard_sigmoid_star_pallas(jnp.asarray(xs.numpy()),
                                      cfg=jfxp.FixedPointConfig(a, b),
                                      method="step"))


def test_step_route_choice():
    """The route by table and dtype: bytes for int8 codes whose cascade
    stays inside a byte, bisect past the cap, words otherwise; and every
    partial sum of a bytes route lies in [start, end] inside int8."""
    want = {((4, 8), torch.int8): "bytes", ((6, 8), torch.int8): "bytes",
            ((6, 16), torch.int8): "bytes", ((8, 16), torch.int8): "words",
            ((4, 8), torch.int16): "words", ((4, 8), torch.int32): "words",
            ((6, 8), torch.int16): "words", ((8, 10), torch.int16): "bisect",
            ((8, 16), torch.int16): "bisect", ((8, 24), torch.int32): "bisect"}
    for ((a, b), dtype), name in want.items():
        spec = thact.HardSigmoidStarSpec(tfxp.FixedPointConfig(a, b))
        route = tk.step_route(spec, dtype)
        assert route.name == name, ((a, b), dtype, route.name)
        thr, outs = thact.step_table(spec)
        assert len(route.thresholds) == len(route.deltas) <= (
            tk.CASCADE_CAP if name != "bisect" else len(thr))
        if name != "bisect":
            slots = tk.cascade_slots(route)
            assert len(set(slots)) == len(route.thresholds)
            assert all(0 <= k < tk.CASCADE_CAP for k in slots)
            if name == "bytes" and len(slots) <= tk.EXACT_CAP:
                assert slots == tuple(range(len(slots)))
        if name == "bytes":
            sums = route.start + np.cumsum((0,) + route.deltas)
            assert -128 <= sums.min() and sums.max() <= 127
    spec = thact.HardSigmoidStarSpec(tfxp.FixedPointConfig(6, 16))
    folded = tk.step_route(spec, torch.int8)
    thr, outs = thact.step_table(spec)
    assert thr.min() < -128 and thr.max() > 127
    assert len(folded.thresholds) == int(((thr > -128) & (thr <= 127)).sum())
    assert folded.start == int(outs[int((thr <= -128).sum())])


@pytest.mark.usefixtures("reference")
def test_step_out_of_range_int16_codes_follow_the_reference():
    """int16 codes beyond (4,8)'s range take the words route and give
    what the TPU kernel gives."""
    xs = torch.arange(-400, 400, dtype=torch.int16).reshape(-1, 16)
    spec = thact.HardSigmoidStarSpec(tfxp.FXP_4_8)
    assert tk.step_route(spec, torch.int16).name == "words"
    _eq(_step_like_the_kernel(xs, spec),
        hard_sigmoid_star_pallas(jnp.asarray(xs.numpy()), cfg=jfxp.FXP_4_8,
                                 method="step"))


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


@pytest.mark.gpu
def test_cuda_step_routes_match_plain():
    """``step`` on the card equals its plain version bit for bit on every
    route: every code of each width in each storage dtype, on a view whose
    base is off 16-byte alignment and on sizes that leave a tail."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    seen = set()
    for (a, b), dtype in itertools.product(WIDTHS + [(6, 16), (8, 24)], STORAGE):
        cfg = tfxp.FixedPointConfig(a, b)
        info = torch.iinfo(dtype)
        lo, hi = max(cfg.int_min, info.min, -5000), min(cfg.int_max, info.max, 5000)
        xs = torch.arange(lo, hi + 1, device=dev).to(dtype).repeat(3)
        seen.add(tk.step_route(thact.HardSigmoidStarSpec(cfg), dtype).name)
        for view in (xs, xs[3:], xs[: xs.numel() - 5]):
            got = tk.hard_sigmoid_star(view, cfg=cfg, method="step")
            torch.cuda.synchronize()
            want = tk.hard_sigmoid_star_plain(view, cfg=cfg, method="step")
            assert got.dtype == view.dtype and got.shape == view.shape
            assert torch.equal(got, want), (a, b, dtype)
    assert seen == {"bytes", "words", "bisect"}
