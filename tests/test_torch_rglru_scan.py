"""The port's RG-LRU recurrence (``kernels/rglru_scan.py``, K7) and the
recurrent block around it (``models/rglru.py``) against the JAX package.

On the CPU the kernel entry runs its plain torch version, the sequential
fp32 recurrence: held to 1e-6 against the reference's oracle
``rglru_seq_ref`` and its Pallas kernel in interpret mode, on the
reference's shapes (``tests/test_kernels.py``) plus a zero-decay anchor
(a running sum).  The model's ``rglru_scan`` and ``rec_block_apply``
(train and decode) run on weights carried across from the reference's
init and are held to 2e-4 in f32, the reference's own tolerance for its
associative scan against the sequential recurrence.
``test_cuda_kernel_matches_plain`` holds the CUDA kernel against its plain
version on the card."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference
from repro_torch.kernels import rglru_scan as K
from repro_torch.kernels import ref as tref
from repro_torch.models import rglru as TRG

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.kernels import ref as jref
    from repro.kernels.rglru_scan import rglru_seq_pallas
    from repro.models import rglru as JRG
    from repro.models.modules import unbox
except ImportError:
    jax = None

SHAPES = [(5, 3, 8), (16, 7, 32), (9, 128, 16)]   # test_kernels.py's


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _inputs(t, bsz, w, seed=11, zero_decay=False, decay_scale=1.0):
    rng = np.random.default_rng(seed)
    log_a = -np.abs(rng.normal(0, decay_scale, (t, bsz, w))).astype(np.float32)
    if zero_decay:
        log_a[:] = 0.0
    b = rng.normal(0, 1, (t, bsz, w)).astype(np.float32)
    return log_a, b


@pytest.mark.parametrize("zero_decay", [False, True], ids=["decay", "cumsum"])
@pytest.mark.parametrize("t,bsz,w", SHAPES)
@pytest.mark.usefixtures("reference")
def test_plain_matches_reference_oracle_and_kernel(t, bsz, w, zero_decay):
    log_a, b = _inputs(t, bsz, w, zero_decay=zero_decay)
    got = K.rglru_seq_plain(torch.as_tensor(log_a), torch.as_tensor(b)).numpy()
    for want in (jref.rglru_seq_ref(jnp.asarray(log_a), jnp.asarray(b)),
                 rglru_seq_pallas(jnp.asarray(log_a), jnp.asarray(b),
                                  batch_block=4)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-6, atol=1e-6)
    if zero_decay:   # exp(0) = 1: the recurrence is a running sum
        np.testing.assert_allclose(got, np.cumsum(b, 0), rtol=1e-5, atol=1e-5)


@pytest.mark.usefixtures("reference")
def test_plain_bf16_matches_reference_oracle():
    """bf16 inputs give bf16 out, carried in fp32: the two agree but for
    the last rounding (one bf16 ulp, 2**-7 relative at most)."""
    log_a, b = _inputs(12, 5, 24, seed=3)
    la16, b16 = (torch.as_tensor(a).to(torch.bfloat16) for a in (log_a, b))
    got = K.rglru_seq(la16, b16)
    assert got.dtype == torch.bfloat16
    want = jref.rglru_seq_ref(jnp.asarray(la16.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(b16.float().numpy()).astype(jnp.bfloat16))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=2 ** -7, atol=1e-6)


def test_entry_on_cpu_is_the_plain_version_and_takes_views():
    """The entry equals the oracle on CPU tensors, also on transposed
    (B, T, W) views, and keeps b's memory layout."""
    log_a, b = _inputs(7, 3, 16, seed=5)
    la_btw = torch.as_tensor(log_a).transpose(0, 1).contiguous()
    b_btw = torch.as_tensor(b).transpose(0, 1).contiguous()
    want = tref.rglru_seq_ref(torch.as_tensor(log_a), torch.as_tensor(b))
    got = K.rglru_seq(la_btw.transpose(0, 1), b_btw.transpose(0, 1))
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tuple(got.shape) == (7, 3, 16)
    empty = K.rglru_seq(torch.zeros(0, 2, 4), torch.zeros(0, 2, 4))
    assert tuple(empty.shape) == (0, 2, 4)


def test_entry_validates_shapes():
    for fn in (K.rglru_seq, K.rglru_seq_plain):
        with pytest.raises(ValueError, match="expected log_a and b"):
            fn(torch.zeros(3, 2, 4), torch.zeros(3, 2, 5))
        with pytest.raises(ValueError, match="expected log_a and b"):
            fn(torch.zeros(3, 4), torch.zeros(3, 4))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU the entry launches its kernel or raises: tensors on a
    device that is neither the CPU nor CUDA are refused, not computed,
    also when they come through the model's ``rglru_scan``; a CPU/device
    mix is refused too."""
    meta = torch.zeros(4, 2, 8, device="meta")
    cfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"])
    w = cfg.recurrent.lru_width
    p = {"w_a": torch.zeros(w, w, device="meta"),
         "w_i": torch.zeros(w, w, device="meta"),
         "b_a": torch.zeros(w, device="meta"), "b_i": torch.zeros(w, device="meta"),
         "lam": torch.ones(w, device="meta")}
    before = dict(K.LAUNCHES)
    for call in (lambda: K.rglru_seq(meta, meta),
                 lambda: K.rglru_seq(torch.zeros(4, 2, 8), meta),
                 lambda: TRG.rglru_scan(p, torch.zeros(2, 4, w, device="meta"),
                                        cfg)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert K.LAUNCHES == before


# ---------------------------------------------------------------------------
# The model's recurrence and block against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block():
    """A reduced rec block's params from the reference's init, as JAX and
    as torch trees."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")
    cfg = j_reduce(J_ARCHS["recurrentgemma-2b"])
    jp, _ = unbox(JRG.init_rglru_block(jax.random.key(3), cfg))
    # Non-zero biases, so the gates see them.
    rng = np.random.default_rng(4)
    jp = dict(jp, b_a=jnp.asarray(rng.normal(0, 0.5, jp["b_a"].shape), jnp.float32),
              b_i=jnp.asarray(rng.normal(0, 0.5, jp["b_i"].shape), jnp.float32))
    tp = lm_params_from_reference(jax.tree.map(np.asarray, jp))
    return cfg, jp, tp


def _cfgs(cfg, hard):
    tcfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"])
    return cfg.replace(hard_acts=hard), tcfg.replace(hard_acts=hard)


@pytest.mark.parametrize("hard", [False, True], ids=["sigmoid", "hard"])
def test_rglru_scan_matches_reference(block, hard):
    cfg, jp, tp = block
    jcfg, tcfg = _cfgs(cfg, hard)
    x = np.random.default_rng(42).normal(0, 1, (2, 13, cfg.recurrent.lru_width)
                                         ).astype(np.float32)
    got = TRG.rglru_scan(tp, torch.as_tensor(x), tcfg)
    want = JRG.rglru_scan(jp, jnp.asarray(x), jcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hard", [False, True], ids=["sigmoid", "hard"])
def test_rec_block_train_matches_reference(block, hard):
    cfg, jp, tp = block
    jcfg, tcfg = _cfgs(cfg, hard)
    x = np.random.default_rng(43).normal(0, 1, (2, 11, cfg.d_model)).astype(np.float32)
    got = TRG.rec_block_apply(tp, torch.as_tensor(x), tcfg)
    want = JRG.rec_block_apply(jp, jnp.asarray(x), jcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("hard", [False, True], ids=["sigmoid", "hard"])
def test_rec_block_decode_matches_reference_and_train(block, hard):
    """Step-by-step decode equals the reference's decode (every output and
    both states) and the port's own full-sequence block."""
    cfg, jp, tp = block
    jcfg, tcfg = _cfgs(cfg, hard)
    w, cw = cfg.recurrent.lru_width, cfg.recurrent.conv_width
    x = np.random.default_rng(44).normal(0, 1, (2, 9, cfg.d_model)).astype(np.float32)
    jst = {"h": jnp.zeros((2, w), jnp.float32),
           "conv": jnp.zeros((2, cw - 1, w), jnp.float32)}
    tst = {"h": torch.zeros(2, w), "conv": torch.zeros(2, cw - 1, w)}
    ys = []
    for t in range(x.shape[1]):
        ty, tst = TRG.rec_block_apply(tp, torch.as_tensor(x[:, t:t + 1]), tcfg,
                                      "decode", tst)
        jy, jst = JRG.rec_block_apply(jp, jnp.asarray(x[:, t:t + 1]), jcfg,
                                      "decode", jst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=2e-4, atol=2e-4)
        for k in ("h", "conv"):
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]),
                                       rtol=2e-4, atol=2e-4)
        ys.append(ty)
    full = TRG.rec_block_apply(tp, torch.as_tensor(x), tcfg)
    torch.testing.assert_close(torch.cat(ys, 1), full, rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_cuda_kernel_matches_plain():
    """The CUDA kernel equals its plain version on the card (1e-5 relative
    + 1e-6 absolute in f32, one bf16 ulp in bf16: the kernel rounds the
    multiply and the add one at a time, as torch does; the margin is for
    exp's last bit), on the reference's shapes, the zero-decay anchor, a
    4096-step long-memory chain, strided (B, T, W) views and bf16, and
    launches once per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [_inputs(*s) for s in SHAPES] + [
        _inputs(33, 3, 70, zero_decay=True), _inputs(1000, 2, 96, seed=2),
        _inputs(4096, 2, 64, seed=4, decay_scale=0.01)]     # long memory
    for log_a, b in cases:
        la, bb = (torch.as_tensor(a, device=dev) for a in (log_a, b))
        n = K.LAUNCHES["rglru_seq"]
        got = K.rglru_seq(la, bb)
        torch.cuda.synchronize()
        assert K.LAUNCHES["rglru_seq"] == n + 1
        torch.testing.assert_close(got, K.rglru_seq_plain(la, bb),
                                   rtol=1e-5, atol=1e-6)
        la_v = la.transpose(0, 1).contiguous().transpose(0, 1)
        b_v = bb.transpose(0, 1).contiguous().transpose(0, 1)
        got_v = K.rglru_seq(la_v, b_v)
        assert got_v.transpose(0, 1).is_contiguous()
        torch.testing.assert_close(got_v, got, rtol=0, atol=0)
        got16 = K.rglru_seq(la.bfloat16(), bb.bfloat16())
        want16 = K.rglru_seq_plain(la.bfloat16(), bb.bfloat16())
        torch.testing.assert_close(got16.float(), want16.float(),
                                   rtol=2 ** -7, atol=1e-6)
