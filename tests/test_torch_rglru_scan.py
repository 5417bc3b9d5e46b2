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
version on the card; ``test_cuda_backward_matches_plain_autograd`` and
``test_cuda_rec_block_gradients_match_the_cpu`` hold the scan's gradient
(the ``RglruSeq`` Function, whose backward is one more K7 launch) against
the plain recurrence's autograd there.  The Function's CPU path is tested
in ``tests/test_torch_lm_train.py``."""

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


@pytest.mark.parametrize("shape,dtypes,offset,fits", [
    ((5, 3, 8), (torch.float32, torch.float32), 0, True),       # 32-byte rows
    ((33, 3, 70), (torch.float32, torch.float32), 0, False),    # 280 bytes
    ((9, 2, 72), (torch.float32, torch.float32), 0, True),
    ((9, 2, 72), (torch.bfloat16, torch.bfloat16), 0, True),    # 144 bytes
    ((9, 2, 12), (torch.bfloat16, torch.float32), 0, False),    # 24-byte log_a rows
    ((9, 2, 12), (torch.float32, torch.bfloat16), 0, False),
    ((9, 2, 40), (torch.bfloat16, torch.float32), 0, True),
    ((9, 2, 64), (torch.float32, torch.float32), 1, False),     # base off by 4 bytes
    ((9, 2, 64), (torch.float32, torch.float32), 4, True),      # base off by 16 bytes
], ids=["w8", "w70", "w72", "w72-bf16", "w12-bf16a", "w12-bf16b", "w40-bf16a",
        "offset4B", "offset16B"])
def test_tile_route_fits_takes_aligned_rows_only(shape, dtypes, offset, fits):
    """The tile route's predicate: 16-byte aligned bases, t and b strides
    and rows of W elements, for each operand; (T, B, W) views of (B, T, W)
    tensors at the model's widths fit."""
    t, bsz, w = shape
    ops = []
    for dt in dtypes:
        base = torch.zeros(t, bsz, w + offset, dtype=dt)
        ops.append(base[:, :, offset:])
    if offset == 0:
        assert ops[0].data_ptr() % 16 == 0
    assert K.tile_route_fits(*ops) is fits
    # the model's operands: (T, B, W) views of (B, T, W) tensors
    views = [torch.zeros(2, 64, 2560).transpose(0, 1) for _ in range(2)]
    assert K.tile_route_fits(*views)
    odd = [torch.zeros(2, 64, 70).transpose(0, 1) for _ in range(2)]
    assert not K.tile_route_fits(*odd)


def test_tile_route_fits_checks_the_output_too():
    """The output takes b's strides when b is dense and is contiguous
    otherwise, so a sliced b whose own strides fit can still leave the
    output's rows off 16 bytes: the route is chosen on all three."""
    la, b = (torch.zeros(9, 2, 40)[:, :, :34] for _ in range(2))
    out = torch.empty_like(b)
    assert out.is_contiguous() and out.stride(1) * 4 % 16
    assert K.tile_route_fits(la, b)
    assert not K.tile_route_fits(la, b, out)


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
    launches once per call, on the route its shape selects."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    cases = [_inputs(*s) for s in SHAPES] + [
        _inputs(33, 3, 70, zero_decay=True), _inputs(1000, 2, 96, seed=2),
        _inputs(4096, 2, 64, seed=4, decay_scale=0.01)]     # long memory
    for log_a, b in cases:
        la, bb = (torch.as_tensor(a, device=dev) for a in (log_a, b))
        key = "rglru_seq" if K.tile_route_fits(la, bb) else "rglru_seq_lane"
        n, total = K.LAUNCHES[key], sum(K.LAUNCHES.values())
        got = K.rglru_seq(la, bb)
        torch.cuda.synchronize()
        assert K.LAUNCHES[key] == n + 1
        assert sum(K.LAUNCHES.values()) == total + 1
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


@pytest.mark.gpu
def test_cuda_routes_by_shape_and_agree_bit_for_bit():
    """Each shape takes the route ``tile_route_fits`` names, counted under
    that route's key: T not a multiple of the 64-step chunk and T below it,
    B*W not a multiple of the 32-channel tile with W unaligned (70, lane)
    and aligned (2560, 2568: a ragged last tile), bf16 log_a and/or b,
    (B, T, W) views, a base off 16-byte alignment and a sliced b whose
    output rows are not 16-byte multiples.  Every result is
    within the plain version's tolerance (1e-5 relative + 1e-6 in f32, one
    bf16 ulp in bf16), and wherever the tile route runs, the lane route
    gives the same bits on the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    f32, b16 = torch.float32, torch.bfloat16
    cases = [((100, 3, 64), f32, f32, "tile"), ((5, 2, 64), f32, f32, "tile"),
             ((70, 2, 2568), f32, f32, "tile"), ((130, 2, 2560), f32, f32, "tile"),
             ((33, 3, 70), f32, f32, "lane"), ((64, 2, 70), b16, b16, "lane"),
             ((65, 2, 2560), b16, b16, "tile"), ((65, 2, 40), b16, f32, "tile"),
             ((65, 2, 36), f32, b16, "lane"), ((200, 1, 4096), f32, b16, "tile")]
    for seed, ((t, bsz, w), da, db, route) in enumerate(cases):
        log_a, b = _inputs(t, bsz, w, seed=seed)
        la, bb = (torch.as_tensor(a, device=dev) for a in (log_a, b))
        la, bb = la.to(da), bb.to(db)
        views = [(la, bb), tuple(x.transpose(0, 1).contiguous().transpose(0, 1)
                                 for x in (la, bb))]
        padded = torch.zeros(t, bsz, w + 1, dtype=da, device=dev)
        padded[:, :, 1:] = la
        views.append((padded[:, :, 1:], bb))            # base off by 2 or 4 bytes
        for i, (x, y) in enumerate(views):
            want_route = route if i < 2 else "lane"
            assert K.tile_route_fits(x, y) is (want_route == "tile")
            key = "rglru_seq" if want_route == "tile" else "rglru_seq_lane"
            before = dict(K.LAUNCHES)
            got = K.rglru_seq(x, y)
            torch.cuda.synchronize()
            assert K.LAUNCHES[key] == before[key] + 1
            assert sum(K.LAUNCHES.values()) == sum(before.values()) + 1
            assert got.dtype == db and got.shape == (t, bsz, w)
            want = K.rglru_seq_plain(x, y)
            torch.testing.assert_close(got.float(), want.float(), atol=1e-6,
                                       rtol=1e-5 if db == f32 else 2 ** -7)
            if want_route == "tile":
                lane = K._launch(x, y, route="lane")
                torch.cuda.synchronize()
                assert torch.equal(got, lane)
    big = torch.as_tensor(_inputs(9, 2, 40, seed=9)[1], device=dev)
    la, bb = (-big.abs())[:, :, :34], big[:, :, :34]   # output rows of 136 bytes
    assert K.tile_route_fits(la, bb)
    before = dict(K.LAUNCHES)
    got = K.rglru_seq(la, bb)
    torch.cuda.synchronize()
    assert K.LAUNCHES["rglru_seq_lane"] == before["rglru_seq_lane"] + 1
    torch.testing.assert_close(got, K.rglru_seq_plain(la, bb), rtol=1e-5, atol=1e-6)
    misaligned = torch.zeros(9, 2, 71, device=dev)[:, :, 1:]
    with pytest.raises(RuntimeError, match="tile route"):
        K._launch(misaligned, misaligned, route="tile")


def _plain_grads(log_a, b, dh):
    la, bb = (x.detach().clone().requires_grad_(True) for x in (log_a, b))
    h = K.rglru_seq_plain(la, bb)
    return torch.autograd.grad(h, (la, bb), dh)


@pytest.mark.gpu
@pytest.mark.parametrize("b_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_cuda_backward_matches_plain_autograd(b_dtype):
    """The K7 Function's backward on the card (one launch on the flipped,
    shifted operands, counted as ``rglru_seq_bwd``) against autograd
    through the plain recurrence on the same card, on the tile route (W =
    64, 2560) and the lane route (W = 70), on contiguous operands and on
    the model's (T, B, W) views.  dlog_a and db to 1e-5 of each one's
    largest value in f32 (the same recurrence, exp's last bit aside); with
    a bf16 b, h is saved in bf16, so dlog_a's h_{t-1} factor and db carry
    one bf16 rounding: 2^-7 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    for seed, (t, bsz, w, route) in enumerate([(100, 3, 64, "tile"),
                                              (4096, 2, 2560, "tile"),
                                              (33, 3, 70, "lane")]):
        log_a, b = _inputs(t, bsz, w, seed=seed, decay_scale=0.1)
        dh = np.random.default_rng(seed + 50).normal(0, 1, b.shape).astype(np.float32)
        la = torch.as_tensor(log_a, device=dev)
        bb = torch.as_tensor(b, device=dev).to(b_dtype)
        g = torch.as_tensor(dh, device=dev).to(b_dtype)
        shifted = torch.cat([torch.zeros_like(la[:1]), la.flip(0)[:-1]])
        assert K.tile_route_fits(shifted, g.float().flip(0)) is (route == "tile")
        views = [(la, bb), tuple(x.transpose(0, 1).contiguous().transpose(0, 1)
                                 for x in (la, bb))]
        for x, y in views:
            x, y = x.clone().requires_grad_(True), y.clone().requires_grad_(True)
            before = dict(K.LAUNCHES)
            h = K.rglru_seq_grad(x, y)
            dla, db = torch.autograd.grad(h, (x, y), g)
            torch.cuda.synchronize()
            assert K.LAUNCHES["rglru_seq_bwd"] == before["rglru_seq_bwd"] + 1
            assert sum(K.LAUNCHES.values()) == sum(before.values()) + 2
            assert dla.dtype == torch.float32 and db.dtype == b_dtype
            want_la, want_b = _plain_grads(x, y, g)
            tol = 1e-5 if b_dtype == torch.float32 else 2 ** -7
            for got, want in ((dla, want_la), (db.float(), want_b.float())):
                assert bool(torch.isfinite(got).all())
                torch.testing.assert_close(got, want, rtol=tol,
                                           atol=tol * float(want.abs().max()))


@pytest.mark.gpu
def test_cuda_rec_block_gradients_match_the_cpu(monkeypatch):
    """A reduced rec block trained on the card: ``loss.backward()`` through
    the K7 Function (one forward and one backward launch) gives every
    parameter's gradient (w_x, w_gate, w_out, conv, w_a, w_i, b_a, b_i,
    lam) equal to the CPU's plain-version run within 1e-4 of each leaf's
    largest value (f32 products on the card; TF32 is off)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = reduce_config(ARCH_CONFIGS["recurrentgemma-2b"])
    from repro_torch.models.modules import unbox
    p_cpu = unbox(TRG.init_rglru_block(torch.Generator().manual_seed(1), cfg))[0]
    x = np.random.default_rng(46).normal(0, 1, (2, 40, cfg.d_model)).astype(np.float32)
    grads = {}
    for dev in ("cpu", "cuda"):
        p = {k: v.detach().to(dev).requires_grad_(True) for k, v in p_cpu.items()}
        before = dict(K.LAUNCHES)
        y = TRG.rec_block_apply(p, torch.as_tensor(x, device=dev), cfg, "train")
        y.square().sum().backward()
        grads[dev] = {k: v.grad.cpu() for k, v in p.items()}
        launched = {k: K.LAUNCHES[k] - before[k] for k in before}
        if dev == "cuda":
            torch.cuda.synchronize()
            assert launched["rglru_seq_bwd"] == 1
            assert launched["rglru_seq"] + launched["rglru_seq_lane"] == 1
        else:
            assert not any(launched.values())
    for k, want in grads["cpu"].items():
        torch.testing.assert_close(grads["cuda"][k], want, rtol=0,
                                   atol=1e-4 * float(want.abs().max()), msg=k)
