"""The port's fused-LSTM kernel entries against the JAX package's Pallas
kernels (interpret mode on the CPU, as the reference's own tests run
them).  On the CPU each entry runs its plain torch version; every result
must match bit for bit.  Mirrors ``tests/test_kernels.py``: shapes,
mxu/vpu, arithmetic/step, (4,8)/(6,8)/(8,16), 1-3 layers, a batch that is
not a multiple of the block, slot permutations with ZERO/TRASH rows, and
validation errors.  ``test_cuda_kernels_match_plain_versions`` holds each
CUDA kernel against its plain version on the card."""

import numpy as np
import pytest
import torch

from repro_torch.core import fixed_point as tfxp
from repro_torch.kernels import qlstm_cell as tk
from repro_torch.kernels import ref as tref

try:  # the JAX reference; the card's machine runs only the gpu test
    import jax.numpy as jnp
    from repro.core import fixed_point as jfxp
    from repro.kernels import qlstm_cell as jk
    from repro.kernels import ref as jref
except ImportError:
    jnp = None

WIDTHS = [(4, 8), (6, 8), (8, 16)]
INT32_CODES = (8, 24)      # stored in int32: the kernel's third code type


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jnp is None:
        pytest.skip("the JAX reference package is not installed")


def _rand_lstm(rng, T, B, M, H, a=4, b=8, layers=1):
    """Random codes in the (a, b) range as numpy: x, per-layer w_x, w_h, b."""
    lo, hi = -(1 << (b - 1)), 1 << (b - 1)
    dt = np.int8 if b <= 8 else np.int16 if b <= 16 else np.int32
    x = rng.integers(lo, hi, (T, B, M)).astype(dt)
    wxs, whs, bs = [], [], []
    for li in range(layers):
        k = M if li == 0 else H
        wxs.append(rng.integers(lo // 4, hi // 4, (k, 4 * H)).astype(dt))
        whs.append(rng.integers(lo // 8, hi // 8, (H, 4 * H)).astype(dt))
        bs.append(rng.integers(-200, 200, (4 * H,)).astype(np.int32))
    return x, wxs, whs, bs


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _cfgs(a, b):
    return jfxp.FixedPointConfig(a, b), tfxp.FixedPointConfig(a, b)


@pytest.mark.parametrize("a,b", WIDTHS + [INT32_CODES])
@pytest.mark.usefixtures("reference")
def test_ref_oracle_matches_reference(a, b):
    jc, tc = _cfgs(a, b)
    rng = np.random.default_rng(a + b)
    x, (wx,), (wh,), (bb,) = _rand_lstm(rng, 7, 5, 3, 12, a, b)
    h0 = rng.integers(-100, 100, (5, 12)).astype(np.int32)
    c0 = rng.integers(-100, 100, (5, 12)).astype(np.int32)
    got, (h, c) = tref.qlstm_seq_ref(*_t(x, wx, wh, bb), tc, h0=torch.as_tensor(h0),
                                     c0=torch.as_tensor(c0), return_state=True)
    want, (hw, cw) = jref.qlstm_seq_ref(*_j(x, wx, wh, bb), jc, h0=jnp.asarray(h0),
                                        c0=jnp.asarray(c0), return_state=True)
    _eq(got, want)
    _eq(h, hw)
    _eq(c, cw)
    _eq(tref.qlstm_seq_ref(*_t(x, wx, wh, bb), tc),
        jref.qlstm_seq_ref(*_j(x, wx, wh, bb), jc))


@pytest.mark.parametrize("T,B,M,H", [(3, 2, 1, 4), (7, 13, 3, 20),
                                     (6, 16, 1, 20), (9, 1, 2, 8)])
@pytest.mark.usefixtures("reference")
def test_qlstm_seq_shapes(T, B, M, H):
    jc, tc = _cfgs(4, 8)
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(T * B), T, B, M, H)
    got = tk.qlstm_seq(*_t(x, wx, wh, bb), cfg=tc)
    assert got.dtype == torch.int8 and tuple(got.shape) == (T, B, H)
    _eq(got, jk.qlstm_seq_pallas(*_j(x, wx, wh, bb), cfg=jc))


@pytest.mark.parametrize("unit", ["mxu", "vpu"])
@pytest.mark.parametrize("method", ["arithmetic", "step"])
@pytest.mark.usefixtures("reference")
def test_qlstm_seq_units_and_methods(unit, method):
    jc, tc = _cfgs(4, 8)
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(5), 6, 9, 2, 16)
    got = tk.qlstm_seq(*_t(x, wx, wh, bb), cfg=tc, hs_method=method,
                       compute_unit=unit)
    _eq(got, jk.qlstm_seq_pallas(*_j(x, wx, wh, bb), cfg=jc, hs_method=method,
                                 compute_unit=unit))


@pytest.mark.parametrize("a,b", WIDTHS)
@pytest.mark.parametrize("method", ["arithmetic", "step"])
@pytest.mark.usefixtures("reference")
def test_qlstm_seq_windowed_resume(a, b, method):
    """Three windows with the carry fed back equal the reference's
    one-shot run — outputs and final state."""
    jc, tc = _cfgs(a, b)
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(9), 9, 5, 2, 12, a, b)
    want, (h_w, c_w) = jk.qlstm_seq_pallas(*_j(x, wx, wh, bb), cfg=jc,
                                           hs_method=method, return_state=True)
    outs, state = [], (None, None)
    for w in range(3):
        o, state = tk.qlstm_seq(*_t(x[3 * w:3 * (w + 1)], wx, wh, bb), cfg=tc,
                                hs_method=method, h0=state[0], c0=state[1],
                                return_state=True)
        outs.append(o)
    _eq(torch.cat(outs), want)
    _eq(state[0], h_w)
    _eq(state[1], c_w)


@pytest.mark.parametrize("unit", ["mxu", "vpu"])
@pytest.mark.parametrize("num_layers", [1, 2, 3])
@pytest.mark.usefixtures("reference")
def test_qlstm_multilayer_matches_reference(num_layers, unit):
    """Fused stack, non-zero carry, batch 5 in blocks of 2."""
    jc, tc = _cfgs(4, 8)
    T, B, M, H = 5, 5, 2, 12
    rng = np.random.default_rng(num_layers)
    x, wxs, whs, bs = _rand_lstm(rng, T, B, M, H, layers=num_layers)
    h0s = [rng.integers(-100, 100, (B, H)).astype(np.int32)
           for _ in range(num_layers)]
    c0s = [rng.integers(-100, 100, (B, H)).astype(np.int32)
           for _ in range(num_layers)]
    got, state = tk.qlstm_seq_multilayer(
        torch.as_tensor(x), _t(*wxs), _t(*whs), _t(*bs), _t(*h0s), _t(*c0s),
        cfg=tc, compute_unit=unit, batch_block=2)
    want, wstate = jk.qlstm_seq_multilayer_pallas(
        jnp.asarray(x), tuple(_j(*wxs)), tuple(_j(*whs)), tuple(_j(*bs)),
        tuple(_j(*h0s)), tuple(_j(*c0s)), cfg=jc, compute_unit=unit,
        batch_block=2)
    _eq(got, want)
    for (h, c), (hw, cw) in zip(state, wstate):
        _eq(h, hw)
        _eq(c, cw)


def test_qlstm_multilayer_rejects_mismatched_tuples():
    tc = tfxp.FXP_4_8
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(0), 3, 2, 1, 4)
    z = torch.zeros(2, 4, dtype=torch.int32)
    x, wx, wh, bb = _t(x, wx, wh, bb)
    for fn in (tk.qlstm_seq_multilayer, tk.qlstm_seq_multilayer_plain):
        with pytest.raises(ValueError, match="layer count"):
            fn(x, (wx,), (wh, wh), (bb,), (z,), (z,), cfg=tc)


@pytest.mark.parametrize(
    "a,b,method,num_layers",
    [(a, b, m, 1) for a, b in WIDTHS for m in ("arithmetic", "step")]
    + [(4, 8, "step", 2), (4, 8, "arithmetic", 3), (6, 8, "step", 3),
       (*INT32_CODES, "arithmetic", 2)])
@pytest.mark.usefixtures("reference")
def test_qlstm_slot_matches_reference(a, b, method, num_layers):
    """Random slot permutations of a pre-filled table, with a ZERO gather
    and a TRASH scatter: outputs and every table row but TRASH (whose
    content is don't-care in the reference and left untouched here) match
    the reference bit for bit; rows no scatter targets are byte-identical
    to the input, and ZERO stays zero."""
    jc, tc = _cfgs(a, b)
    T, B, M, H, n_data = 4, 5, 2, 8, 6
    zero, trash = n_data, n_data + 1
    rng = np.random.default_rng(7 * num_layers + len(method) + a)
    x, wxs, whs, bs = _rand_lstm(rng, T, B, M, H, a, b, layers=num_layers)
    table = rng.integers(-100, 100, (n_data + 2, num_layers, 2, H)).astype(np.int32)
    table[zero] = 0
    gather = rng.permutation(n_data)[:B].astype(np.int32)
    scatter = rng.permutation(n_data)[:B].astype(np.int32)
    gather[0] = zero
    scatter[1] = trash
    got, new_table = tk.qlstm_seq_slot(
        *_t(x, gather, scatter, table), _t(*wxs), _t(*whs), _t(*bs),
        cfg=tc, hs_method=method)
    want, want_table = jk.qlstm_seq_slot_pallas(
        *_j(x, gather, scatter, table), tuple(_j(*wxs)), tuple(_j(*whs)),
        tuple(_j(*bs)), cfg=jc, hs_method=method)
    _eq(got, want)
    keep = np.arange(n_data + 2) != trash
    np.testing.assert_array_equal(new_table.numpy()[keep],
                                  np.asarray(want_table)[keep])
    untouched = [r for r in range(n_data + 2) if r not in set(scatter)]
    np.testing.assert_array_equal(new_table.numpy()[untouched], table[untouched])
    assert not new_table.numpy()[zero].any()


def test_qlstm_slot_validates_inputs():
    tc = tfxp.FXP_4_8
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(0), 3, 2, 1, 4)
    x, wx, wh, bb = _t(x, wx, wh, bb)
    slots = torch.zeros(2, dtype=torch.int32)
    table = torch.zeros(5, 1, 2, 4, dtype=torch.int32)
    for fn in (tk.qlstm_seq_slot, tk.qlstm_seq_slot_plain):
        with pytest.raises(ValueError, match="layer count"):
            fn(x, slots, slots, table, (wx, wx), (wh,), (bb,), cfg=tc)
        with pytest.raises(ValueError, match="table"):
            fn(x, slots, slots, torch.zeros(2, 1, 2, 4, dtype=torch.int32),
               (wx,), (wh,), (bb,), cfg=tc)


def test_non_cpu_tensors_never_take_the_plain_version():
    """Off the CPU a wrapper launches its kernel or raises: tensors on a
    device that is neither the CPU nor CUDA are refused, not computed."""
    tc = tfxp.FXP_4_8
    x, (wx,), (wh,), (bb,) = _rand_lstm(np.random.default_rng(0), 3, 2, 1, 4)
    meta = [t.to("meta") for t in _t(x, wx, wh, bb)]
    with pytest.raises(ValueError, match="CUDA"):
        tk.qlstm_seq(*meta, cfg=tc)


def test_slot_ids_outside_the_table_are_contained():
    """The plain slot version (the kernel's specification) reads ZERO for
    gather ids outside the live rows and ZERO, and drops scatters outside
    the live rows, so a bad id never addresses memory outside the table."""
    tc = tfxp.FXP_4_8
    rng = np.random.default_rng(4)
    x, (wx,), (wh,), (bb,) = _rand_lstm(rng, 3, 4, 1, 4)
    table = torch.as_tensor(rng.integers(-50, 50, (5, 1, 2, 4)).astype(np.int32))
    table[3] = 0
    gather = torch.tensor([-1, 4, 99, 3], dtype=torch.int32)
    scatter = torch.tensor([-1, 3, 4, 99], dtype=torch.int32)
    out, new_table = tk.qlstm_seq_slot(*_t(x), gather, scatter, table,
                                       _t(wx), _t(wh), _t(bb), cfg=tc)
    fresh = tk.qlstm_seq(*_t(x, wx, wh, bb), cfg=tc)
    torch.testing.assert_close(out, fresh, rtol=0, atol=0)
    torch.testing.assert_close(new_table, table, rtol=0, atol=0)


@pytest.mark.parametrize("hdim,rows", [(1, 32), (8, 32), (9, 15), (20, 10),
                                       (32, 8), (33, 6), (64, 4), (200, 4),
                                       (1024, 4)])
def test_max_rows_per_block_follows_the_group_size(hdim, rows):
    """A row is a group of whole warps, a quad of lanes per unit (at most
    256 lanes): up to H = 8 one warp, and a block holds 32 rows; beyond it
    at most 15 rows (named barriers 1..15) and 1,024 threads."""
    assert tk.max_rows_per_block(hdim) == rows
    assert tk._rows_per_block(500, 2, hdim, torch.device("cpu")) == rows
    assert tk._rows_per_block(1, 2, hdim, torch.device("cpu")) == 1
    with pytest.raises(ValueError, match="positive"):
        tk.max_rows_per_block(0)


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    """Each CUDA kernel equals its plain version on the card, bit for bit,
    across widths, methods, layer counts, ragged batches and slot
    permutations, with weights in shared memory and in device memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    for a, b in WIDTHS + [INT32_CODES]:
        tc = tfxp.FixedPointConfig(a, b)
        for method in ("arithmetic", "step"):
            for num_layers in (1, 2, 3):
                for B in (1, 37, 70):
                    x, wxs, whs, bs = _rand_lstm(rng, 6, B, 2, 20, a, b,
                                                 num_layers)
                    xt = torch.as_tensor(x, device=dev)
                    wx = [torch.as_tensor(w, device=dev) for w in wxs]
                    wh = [torch.as_tensor(w, device=dev) for w in whs]
                    bb = [torch.as_tensor(v, device=dev) for v in bs]
                    h0 = [torch.as_tensor(rng.integers(-90, 90, (B, 20)),
                                          dtype=torch.int32, device=dev)
                          for _ in range(num_layers)]
                    c0 = [torch.as_tensor(rng.integers(-90, 90, (B, 20)),
                                          dtype=torch.int32, device=dev)
                          for _ in range(num_layers)]
                    kw = dict(cfg=tc, hs_method=method)
                    want, wstate = tk.qlstm_seq_multilayer_plain(
                        xt, wx, wh, bb, h0, c0, **kw)
                    for smem in (True, False):
                        out, h_f, c_f, _ = tk._launch(
                            xt, wx, wh, bb, h0s=h0, c0s=c0, batch_block=None,
                            hs_slope_shift=3, hs_bound=3.0, ht_min=-1.0,
                            ht_max=1.0, weights_in_smem=smem, **kw)
                        torch.cuda.synchronize()
                        assert torch.equal(out, want)
                        for li, (h, c) in enumerate(wstate):
                            assert torch.equal(h_f[li], h)
                            assert torch.equal(c_f[li], c)
                    rows = 2 * B + 2
                    table = torch.as_tensor(
                        rng.integers(-90, 90, (rows, num_layers, 2, 20)),
                        dtype=torch.int32, device=dev)
                    table[rows - 2] = 0
                    g = torch.as_tensor(rng.permutation(2 * B)[:B],
                                        dtype=torch.int32, device=dev)
                    s = torch.as_tensor(rng.permutation(2 * B)[:B],
                                        dtype=torch.int32, device=dev)
                    g[0], s[-1] = rows - 2, rows - 1
                    got = tk.qlstm_seq_slot(xt, g, s, table, wx, wh, bb, **kw)
                    torch.cuda.synchronize()
                    want = tk.qlstm_seq_slot_plain(xt, g, s, table, wx, wh,
                                                   bb, **kw)
                    assert torch.equal(got[0], want[0])
                    assert torch.equal(got[1], want[1])


@pytest.mark.gpu
def test_cuda_kernels_match_plain_across_hidden_sizes_and_blocks():
    """Rows of one warp (H = 8: __syncwarp), of 3, 5 and 8 warps on named
    barriers (H = 20, the paper's, 40 and 64) and of two passes of 8 warps
    (H = 100), 1 and 3 layers, int8, int16 and int32 codes, batches of 1,
    37 and 256, explicit rows per block (1, 3, 8 and one past the cap) and
    weights in device memory: every output, final state and new table
    equals the plain version bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    blocks = ((None, True), (1, False), (3, True), (8, False), (64, True))
    for hdim in (8, 20, 40, 64, 100):
        for a, b in ((4, 8), (8, 16), INT32_CODES):
            tc = tfxp.FixedPointConfig(a, b)
            method = "step" if b == 8 else "arithmetic"
            for num_layers in (1, 3):
                for B in (1, 37, 256):
                    x, wxs, whs, bs = _rand_lstm(rng, 6, B, 3, hdim, a, b,
                                                 num_layers)
                    xt = torch.as_tensor(x, device=dev)
                    wx = [torch.as_tensor(w, device=dev) for w in wxs]
                    wh = [torch.as_tensor(w, device=dev) for w in whs]
                    bb = [torch.as_tensor(v, device=dev) for v in bs]
                    h0, c0 = ([torch.as_tensor(rng.integers(-90, 90, (B, hdim)),
                                               dtype=torch.int32, device=dev)
                               for _ in range(num_layers)] for _ in range(2))
                    kw = dict(cfg=tc, hs_method=method)
                    want, wstate = tk.qlstm_seq_multilayer_plain(
                        xt, wx, wh, bb, h0, c0, **kw)
                    for rows, smem in blocks:
                        out, h_f, c_f, args = tk._launch(
                            xt, wx, wh, bb, h0s=h0, c0s=c0, batch_block=rows,
                            hs_slope_shift=3, hs_bound=3.0, ht_min=-1.0,
                            ht_max=1.0, weights_in_smem=smem, **kw)
                        torch.cuda.synchronize()
                        assert args.rows_per_block == tk._rows_per_block(
                            rows, B, hdim, dev)
                        assert smem or args.w_smem == 0
                        assert torch.equal(out, want)
                        for li, (h, c) in enumerate(wstate):
                            assert torch.equal(h_f[li], h)
                            assert torch.equal(c_f[li], c)
                    n_rows = 2 * B + 2
                    table = torch.as_tensor(
                        rng.integers(-90, 90, (n_rows, num_layers, 2, hdim)),
                        dtype=torch.int32, device=dev)
                    table[n_rows - 2] = 0
                    g = torch.as_tensor(rng.permutation(2 * B)[:B],
                                        dtype=torch.int32, device=dev)
                    s = torch.as_tensor(rng.permutation(2 * B)[:B],
                                        dtype=torch.int32, device=dev)
                    g[0], s[-1] = n_rows - 2, n_rows - 1
                    got = tk.qlstm_seq_slot(xt, g, s, table, wx, wh, bb, **kw)
                    torch.cuda.synchronize()
                    want_slot = tk.qlstm_seq_slot_plain(xt, g, s, table, wx, wh,
                                                        bb, **kw)
                    assert torch.equal(got[0], want_slot[0])
                    assert torch.equal(got[1], want_slot[1])


@pytest.mark.gpu
def test_cuda_stream_server_fails_waves_when_the_kernel_fails(monkeypatch):
    """On the card a slot kernel that fails to launch fails its waves: the
    server's ladder ends at the fused engine, so no row is served by a
    plain torch engine, and the launch counter does not move."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import repro_torch
    from repro_torch.core.qlstm import QLSTMConfig
    from repro_torch.serving import ResiliencePolicy, StreamServer

    session = repro_torch.build(QLSTMConfig(hidden_size=8), seed=0).quantize()

    def launch_fails(*a, **k):
        raise RuntimeError("qlstm kernel launch failed: injected")

    monkeypatch.setattr(tk, "_launch", launch_fails)
    before = dict(tk.LAUNCHES)
    windows = np.random.default_rng(0).uniform(0, 1, (4, 6, 1)).astype(np.float32)
    with StreamServer(session, batch=4, deadline_s=0.005,
                      resilience=ResiliencePolicy(max_retries=0)) as srv:
        assert srv.health()["ladder"] == ["pallas"]
        for i, w in enumerate(windows):
            srv.submit(f"s{i}", w)
        rows = srv.drain(timeout=60)
        summary = srv.metrics_summary()
    assert len(rows) == 4
    assert all(not r.ok and r.backend is None for r in rows)
    assert summary["faults"]["degradations"] == 0
    assert tk.LAUNCHES == before
