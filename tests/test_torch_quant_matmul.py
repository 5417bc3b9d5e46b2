"""The port's integer GEMM (``kernels/quant_matmul.py``) against the JAX
package's ``quant_matmul_pallas`` (interpret mode on the CPU, as the
reference's own tests run it).  On the CPU the entry runs its plain torch
version; every result must match bit for bit.  Mirrors
``tests/test_kernels.py``: a property over shapes and the three blocks,
the fused requantisation and its dtype, plus (8,16) int16 and (8,24)
int32 codes whose sums wrap int32.  ``test_cuda_kernel_matches_plain``
holds the CUDA kernel against its plain version on the card."""

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro_torch.core import fixed_point as tfxp
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.kernels import ref as tref

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax.numpy as jnp
    from repro.core import fixed_point as jfxp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.quant_matmul import quant_matmul_pallas
except ImportError:
    jnp = None

BLOCKS = [(16, 16, 16), (32, 16, 8), (128, 128, 128)]


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _codes(rng, shape, bits):
    dt = np.int8 if bits <= 8 else np.int16 if bits <= 16 else np.int32
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), shape).astype(dt)


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert t.numpy().dtype == np.asarray(j).dtype


@given(st.integers(1, 5), st.integers(1, 5), st.integers(1, 5),
       st.integers(0, 2))
@settings(max_examples=12, deadline=None)
def test_quant_matmul_property(mi, ki, ni, blocki):
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")
    m, k, n = mi * 13, ki * 17, ni * 11
    block = BLOCKS[blocki]
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    x, w = _codes(rng, (m, k), 8), _codes(rng, (k, n), 8)
    got = tops.quant_matmul(torch.as_tensor(x), torch.as_tensor(w), block=block)
    _eq(got, jops.quant_matmul(jnp.asarray(x), jnp.asarray(w), block=block))
    np.testing.assert_array_equal(got.numpy(),
                                  x.astype(np.int32) @ w.astype(np.int32))


@pytest.mark.parametrize("block", BLOCKS)
@pytest.mark.usefixtures("reference")
def test_quant_matmul_requant_fused(block):
    rng = np.random.default_rng(1)
    x, w = _codes(rng, (50, 70), 8), _codes(rng, (70, 90), 8)
    got = tops.quant_matmul_requant(torch.as_tensor(x), torch.as_tensor(w),
                                    tfxp.FXP_4_8, block=block)
    want = jops.quant_matmul_requant(jnp.asarray(x), jnp.asarray(w),
                                     jfxp.FXP_4_8, block=block)
    _eq(got, want)
    assert got.dtype == torch.int8


@pytest.mark.parametrize("a,b", [(8, 16), (8, 24)])
@pytest.mark.parametrize("out_mode", ["int32", "requant"])
@pytest.mark.usefixtures("reference")
def test_quant_matmul_wide_codes_wrap_int32(a, b, out_mode):
    """int16 and int32 codes at a K whose exact sums leave int32: the
    port wraps exactly as XLA's int32 accumulator does."""
    rng = np.random.default_rng(a + b)
    x, w = _codes(rng, (19, 301), b), _codes(rng, (301, 23), b)
    exact = x.astype(object) @ w.astype(object)
    assert np.abs(exact).max() > 2 ** 31          # the sums do wrap
    jc, tc = jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)
    got = tqm.quant_matmul(torch.as_tensor(x), torch.as_tensor(w),
                           out_mode=out_mode, cfg=tc, block=(32, 32, 32))
    want = quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w),
                               out_mode=out_mode, cfg=jc, block=(32, 32, 32))
    _eq(got, want)


@pytest.mark.usefixtures("reference")
def test_quant_matmul_int16_extremes():
    """Every product at its largest (2**30): five of them wrap."""
    x = np.full((3, 5), -32768, np.int16)
    w = np.full((5, 4), -32768, np.int16)
    got = tops.quant_matmul(torch.as_tensor(x), torch.as_tensor(w))
    _eq(got, quant_matmul_pallas(jnp.asarray(x), jnp.asarray(w)))
    assert int(got[0, 0]) == (5 << 30) - (1 << 32)


@pytest.mark.parametrize("b", [8, 16, 24])
@pytest.mark.usefixtures("reference")
def test_oracles_match_reference(b):
    rng = np.random.default_rng(b)
    x, w = _codes(rng, (9, 40), b), _codes(rng, (40, 6), b)
    tx, tw, jx, jw = (torch.as_tensor(x), torch.as_tensor(w),
                      jnp.asarray(x), jnp.asarray(w))
    _eq(tref.quant_matmul_ref(tx, tw), jref.quant_matmul_ref(jx, jw))
    _eq(tref.quant_matmul_requant_ref(tx, tw, tfxp.FixedPointConfig(4, b)),
        jref.quant_matmul_requant_ref(jx, jw, jfxp.FixedPointConfig(4, b)))
    _eq(tops.quant_matmul_requant(tx, tw, tfxp.FixedPointConfig(4, b),
                                  use_kernel=False),
        jops.quant_matmul_requant(jx, jw, jfxp.FixedPointConfig(4, b),
                                  use_kernel=False))


@pytest.mark.parametrize("out_mode", ["int32", "requant"])
@pytest.mark.usefixtures("reference")
def test_quant_matmul_int8_wrap_int32(out_mode):
    """Every int8 code -128 at K = 135,168: each exact sum, 2,214,592,512,
    leaves int32 and wraps to -2,080,374,784.  The plain version and the
    ``ops`` entry equal the reference's oracles bit for bit."""
    k = 135168
    x = np.full((3, k), -128, np.int8)
    w = np.full((k, 5), -128, np.int8)
    assert 128 * 128 * k > 2 ** 31 - 1
    tx, tw, jx, jw = (torch.as_tensor(x), torch.as_tensor(w),
                      jnp.asarray(x), jnp.asarray(w))
    if out_mode == "int32":
        want = jref.quant_matmul_ref(jx, jw)
        assert (np.asarray(want) == -2080374784).all()
        _eq(tqm.quant_matmul_plain(tx, tw), want)
        _eq(tops.quant_matmul(tx, tw), want)
    else:   # the oracle returns the codes in int32, the entries in int8
        tc, jc = tfxp.FixedPointConfig(4, 8), jfxp.FixedPointConfig(4, 8)
        want = jref.quant_matmul_requant_ref(jx, jw, jc)
        _eq(tref.quant_matmul_requant_ref(tx, tw, tc), want)
        for got in (tqm.quant_matmul_plain(tx, tw, out_mode="requant", cfg=tc),
                    tops.quant_matmul_requant(tx, tw, tc)):
            assert got.dtype == torch.int8
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_matmul_validates_inputs():
    x = torch.zeros(3, 4, dtype=torch.int8)
    for fn in (tqm.quant_matmul, tqm.quant_matmul_plain):
        with pytest.raises(ValueError, match="expected x"):
            fn(x, torch.zeros(5, 2, dtype=torch.int8))
        with pytest.raises(ValueError, match="out_mode"):
            fn(x, torch.zeros(4, 2, dtype=torch.int8), out_mode="int8")
        with pytest.raises(ValueError, match="FixedPointConfig"):
            fn(x, torch.zeros(4, 2, dtype=torch.int8), out_mode="requant")
        with pytest.raises(ValueError, match="codes"):
            fn(x.float(), torch.zeros(4, 2))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel equals its plain version on the card, bit for bit,
    in both modes, at shapes that are no multiple of a tile, for int8,
    int16 and int32 codes (int16/int32 with sums that wrap int32); for
    int8 also at the edges of its 128 x 128 x 64 tiles, with x rows off
    16-byte alignment (a column slice and an offset base pointer), and in
    the wrap case of ``test_quant_matmul_int8_wrap_int32``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for b, shapes in ((8, [(1, 1, 1), (67, 129, 45), (130, 64, 257)]),
                      (16, [(33, 1000, 17), (64, 64, 64)]),
                      (24, [(7, 300, 70)])):
        for m, k, n in shapes:
            x = torch.as_tensor(_codes(rng, (m, k), b), device=dev)
            w = torch.as_tensor(_codes(rng, (k, n), b), device=dev)
            for out_mode, cfg in (("int32", None),
                                  ("requant", tfxp.FixedPointConfig(4, b))):
                got = tqm.quant_matmul(x, w, out_mode=out_mode, cfg=cfg)
                torch.cuda.synchronize()
                want = tqm.quant_matmul_plain(x, w, out_mode=out_mode, cfg=cfg)
                assert got.dtype == want.dtype
                assert torch.equal(got, want), (b, m, k, n, out_mode)
    flat = torch.as_tensor(_codes(rng, (5 + 37 * 1000,), 8), device=dev)
    xs = [torch.as_tensor(_codes(rng, (m, k), 8), device=dev)
          for m, k in ((127, 16), (129, 48), (257, 1040))]
    xs += [torch.as_tensor(_codes(rng, (129, 1100), 8), device=dev)[:, 3:1000],
           flat[5:].view(37, 1000)]
    pairs = [(x, torch.as_tensor(_codes(rng, (x.shape[1], 129), 8), device=dev))
             for x in xs]
    wrap = (torch.full((16, 135168), -128, dtype=torch.int8, device=dev),
            torch.full((135168, 8), -128, dtype=torch.int8, device=dev))
    for x, w in pairs + [wrap]:
        for out_mode, cfg in (("int32", None),
                              ("requant", tfxp.FixedPointConfig(4, 8))):
            got = tqm.quant_matmul(x, w, out_mode=out_mode, cfg=cfg)
            torch.cuda.synchronize()
            want = tqm.quant_matmul_plain(x, w, out_mode=out_mode, cfg=cfg)
            assert torch.equal(got, want), (tuple(x.shape), out_mode)
    assert bool((tqm.quant_matmul(*wrap) == -2080374784).all())
