"""The port's flash attention (``kernels/flash_attention.py``) against the
JAX package's ``flash_attention_pallas`` (interpret mode on the CPU, as
the reference's own tests run it).  On the CPU the entry runs its plain
torch version, the masked fp32 softmax.  Mirrors
``tests/test_kernels.py``: the five shape cases at 2e-5 (fp32 sums in
another order than the reference's online softmax) and the GQA
``mha_flash`` case at 2e-4, as the reference holds its own kernel.
``test_cuda_kernel_matches_plain`` holds the CUDA kernel against its
plain version on the card."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels import ref as jref
    from repro.kernels.flash_attention import flash_attention_pallas
except ImportError:
    jnp = None

CASES = [
    (64, 64, 32, True, None),
    (64, 64, 32, False, None),
    (96, 96, 16, True, 24),       # sliding window
    (40, 72, 32, False, None),    # padded kv, cross-attention shapes
    (128, 128, 64, True, None),
]


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _qkv(rng, bh, t, s, hd, dtype=np.float32):
    return tuple(rng.normal(0, 1, (bh, n, hd)).astype(dtype)
                 for n in (t, s, s))


@pytest.mark.parametrize("t,s,hd,causal,window", CASES)
@pytest.mark.usefixtures("reference")
def test_flash_attention_vs_reference(t, s, hd, causal, window):
    q, k, v = _qkv(np.random.default_rng(7), 3, t, s, hd)
    got = tfa.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=causal,
                              window=window, block_q=32, block_k=32)
    want = flash_attention_pallas(*map(jnp.asarray, (q, k, v)), causal=causal,
                                  window=window, block_q=32, block_k=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(
        tref.attention_ref(*map(torch.as_tensor, (q, k, v)), causal=causal,
                           window=window).numpy(),
        np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                      causal=causal, window=window)),
        rtol=2e-5, atol=2e-5)


@pytest.mark.usefixtures("reference")
def test_mha_flash_gqa_matches_reference():
    """GQA (4 query heads on 2 kv heads) through ``ops.mha_flash``: equal
    to the reference's wrapper and to its model attention
    (``layers.flash_attention``) within 2e-4."""
    from repro.models.layers import flash_attention as jnp_attn
    rng = np.random.default_rng(8)
    b, t, h, kv, hd = 2, 64, 4, 2, 16
    q = rng.normal(0, 1, (b, t, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (b, t, kv, hd)).astype(np.float32)
    got = tops.mha_flash(*map(torch.as_tensor, (q, k, v)), causal=True,
                         scale=hd ** -0.5, block_q=16, block_k=16)
    assert tuple(got.shape) == (b, t, h, hd)
    for want in (jops.mha_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                                scale=hd ** -0.5, block_q=16, block_k=16),
                 jnp_attn(*map(jnp.asarray, (q, k, v)), causal=True,
                          scale=hd ** -0.5, q_chunk=16, kv_chunk=16)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.usefixtures("reference")
def test_flash_attention_bf16_inputs():
    """bf16 q/k/v give bf16 out, within bf16's rounding of the reference."""
    q, k, v = _qkv(np.random.default_rng(9), 2, 48, 48, 32)
    tq, tk_, tv = (torch.as_tensor(a).to(torch.bfloat16) for a in (q, k, v))
    got = tfa.flash_attention(tq, tk_, tv, causal=True, window=16)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
                  for a in (tq, tk_, tv))
    want = flash_attention_pallas(jq, jk, jv, causal=True, window=16,
                                  block_q=16, block_k=16)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=1e-2)


def _tf32_split(x):
    """The kernel's 3xTF32 split of an f32 tensor: hi is x rounded to tf32
    (10 mantissa bits) to nearest, ties away from zero, by bit masking
    (``cvt.rna``'s rounding, which the kernel does in integer operations);
    lo = x - hi, truncated to tf32 as the tensor cores read it."""
    bits = x.contiguous().view(torch.int32)
    hi = ((bits + 0x1000) & -0x2000).view(torch.float32)
    lo = ((x - hi).view(torch.int32) & -0x2000).view(torch.float32)
    return hi, lo


def _mm_tf32(a, b, terms):
    """a @ b as the kernel's MMAs form it: ``terms=3`` is 3xTF32
    (lo.hi + hi.lo + hi.hi), ``terms=1`` a single TF32 product.  Every
    product of two tf32 values is exact in f32; the sums are in f32."""
    ah, al = _tf32_split(a)
    bh, bl = _tf32_split(b)
    if terms == 1:
        return ah @ bh
    return al @ bh + ah @ bl + ah @ bh


def _attention_tf32(q, k, v, causal, window, terms):
    """``ref.attention_ref`` with both products in TF32 form."""
    t, s = q.shape[1], k.shape[1]
    sc = _mm_tf32(q, k.transpose(1, 2), terms) * q.shape[2] ** -0.5
    qpos, kpos = torch.arange(t)[:, None], torch.arange(s)[None, :]
    keep = torch.ones(t, s, dtype=torch.bool)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= (qpos - kpos) < window
    p = torch.softmax(sc.masked_fill(~keep, tref.NEG_INF), dim=-1)
    return _mm_tf32(p, v, terms)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 48),
                                           (False, 48)])
@pytest.mark.usefixtures("reference")
def test_3xtf32_products_hold_the_reference_tolerance(causal, window):
    """Why the CUDA kernel may run on the TF32 tensor cores: with both
    products in 3xTF32 form, attention at (3, 256, 64) stays within the
    reference's 2e-5 of ``repro.kernels.ref.attention_ref``; with a single
    TF32 product it does not."""
    q, k, v = _qkv(np.random.default_rng(10), 3, 256, 256, 64)
    want = np.asarray(jref.attention_ref(*map(jnp.asarray, (q, k, v)),
                                         causal=causal, window=window))
    tq, tk_, tv = map(torch.as_tensor, (q, k, v))
    three = _attention_tf32(tq, tk_, tv, causal, window, terms=3)
    np.testing.assert_allclose(three.numpy(), want, rtol=2e-5, atol=2e-5)
    one = _attention_tf32(tq, tk_, tv, causal, window, terms=1)
    assert not np.allclose(one.numpy(), want, rtol=2e-5, atol=2e-5)


def test_flash_attention_validates_inputs():
    q = torch.zeros(2, 8, 16)
    for fn in (tfa.flash_attention, tfa.flash_attention_plain):
        with pytest.raises(ValueError, match="expected q"):
            fn(q, torch.zeros(2, 8, 8), torch.zeros(2, 8, 8))
        with pytest.raises(ValueError, match="expected q"):
            fn(q, torch.zeros(3, 8, 16), torch.zeros(3, 8, 16))


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel equals its plain version on the card: the five
    reference cases, hd 128 and 256, windows with T != S (one leaving rows
    no key), T no multiple of the kernel's 64-row q tile, hd 4 and 12
    (padded to 8 and 16 in the kernel), the full (16, 2048, 64) causal
    prefill, views off the kernel's 16-byte alignment, GQA through
    ``mha_flash`` (2e-5 in f32) and bf16 inputs (1e-2)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    cases = CASES + [(70, 70, 128, True, None), (33, 65, 256, False, 9),
                     (100, 40, 32, False, 10),   # rows 49.. keep no key
                     (200, 200, 64, True, None), (130, 130, 4, True, None),
                     (100, 90, 12, False, 30), (2048, 2048, 64, True, None)]
    for t, s, hd, causal, window in cases:
        q, k, v = (torch.as_tensor(a, device=dev)
                   for a in _qkv(rng, 16 if t == 2048 else 3, t, s, hd))
        got = tfa.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        want = tfa.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
        got = tfa.flash_attention(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                  causal=causal, window=window)
        want = tfa.flash_attention_plain(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), causal=causal,
                                         window=window)
        torch.testing.assert_close(got.float(), want.float(),
                                   rtol=1e-2, atol=1e-2)
    # q, k, v as views one element past an aligned base (copied once)
    flat = torch.as_tensor(rng.normal(0, 1, 3 * 3 * 50 * 32 + 1),
                           dtype=torch.float32, device=dev)
    q, k, v = flat[1:].view(3, 3, 50, 32).unbind(0)
    torch.testing.assert_close(
        tfa.flash_attention(q, k, v, causal=True),
        tfa.flash_attention_plain(q, k, v, causal=True), rtol=2e-5, atol=2e-5)
    q = torch.as_tensor(rng.normal(0, 1, (2, 64, 8, 64)), dtype=torch.float32,
                        device=dev)
    kv = torch.as_tensor(rng.normal(0, 1, (2, 2, 64, 2, 64)),
                         dtype=torch.float32, device=dev)
    got = tops.mha_flash(q, kv[0], kv[1], causal=True)
    want = tops.mha_flash(q, kv[0], kv[1], causal=True, use_kernel=False)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)
