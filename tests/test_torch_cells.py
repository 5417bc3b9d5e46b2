"""The port's cell registry (``repro_torch.cells``): lstm, gru and rglru
held against the reference's ``repro.cells``.

Every registered cell passes the battery of ``tests/test_cells.py`` on
the port, and each cell's integer path equals the reference's bit for
bit: the reference's seeded float params and its quantised codes are
carried across with ``repro_torch.convert``, inputs come from a numpy
seed.  Tolerances, each stated where it is checked:

  * integer paths (``ref`` and ``xla`` engines, stateful windows,
    ``StreamServer`` rows, ``quantize_params`` under the hard gate): bit
    for bit;
  * ``forward_float``: 1e-6 absolute;
  * ``forward_qat``: 1e-6 absolute, except where the two frameworks'
    float sums differ in the last bit across a fake-quant rounding
    boundary, which moves an output by one LSB of the (a,b) grid; such
    outputs are counted, at most ``MAX_FLIPS_PER_CASE`` a case;
  * ``rglru.quantize_params`` under the float ``sigmoid`` gate: the baked
    ``lam_q`` codes within one code, at most ``MAX_LAM_FLIPS`` of them
    moved (torch's and XLA's sigmoid may differ by an ulp).

``Accelerator.report`` and the explorer's cell axis are held here too
(``test_report_runs_per_cell``, ``test_explore_cell_axis``,
``test_point_from_config_defaults_old_records_to_lstm``,
``test_point_configs_set_model_cell``)."""

import dataclasses

import numpy as np
import pytest
import torch

from hypothesis_compat import given, settings, st

import repro_torch
from repro_torch import backends as tbackends
from repro_torch import explore
from repro_torch import cells as tcells
from repro_torch.backends import BackendUnsupported
from repro_torch.convert import params_from_reference, qparams_from_reference
from repro_torch.core import fixed_point as tfxp
from repro_torch.core import qlstm as tq
from repro_torch.core.accelerator import (AcceleratorConfig, HS_METHODS, plan,
                                          resolve_model)
from repro_torch.serving import StreamServer

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    import repro
    from repro import backends as jbackends
    from repro import cells as jcells
    from repro.core import accelerator as jacc
    from repro.core import fixed_point as jfxp
    from repro.core import qlstm as jq
except ImportError:
    jax = None

CELLS = ("lstm", "gru", "rglru")
NON_FUSED_CELLS = ("gru", "rglru")
FXPS = ((4, 8), (6, 10), (8, 16))
MAX_FLIPS_PER_CASE = 1
MAX_LAM_FLIPS = 1


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _fp(pair):
    return tfxp.FixedPointConfig(*pair)


def _model(cell, layers=2, hidden=8, **kw):
    return tq.QLSTMConfig(input_size=3, hidden_size=hidden, num_layers=layers,
                          seq_len=4, out_features=2, cell=cell, **kw)


def _jmodel(cell, layers=2, hidden=8, acts=None, **kw):
    if acts is not None:
        kw["acts"] = jq.ActivationConfig(**dataclasses.asdict(acts))
    if "fxp" in kw:
        kw["fxp"] = jfxp.FixedPointConfig(kw["fxp"].frac_bits,
                                          kw["fxp"].total_bits)
    return jq.QLSTMConfig(input_size=3, hidden_size=hidden, num_layers=layers,
                          seq_len=4, out_features=2, cell=cell, **kw)


def _jaccel(**kw):
    if "fxp" in kw:
        kw["fxp"] = jfxp.FixedPointConfig(kw["fxp"].frac_bits,
                                          kw["fxp"].total_bits)
    return jacc.AcceleratorConfig(**kw)


def _x(batch=2, t=4, m=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1.0, 1.0, (batch, t, m)).astype(np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _ref_params(cell, seed, **model_kw):
    """The reference's seeded float params as numpy (and the port's copy)."""
    jm = _jmodel(cell, **model_kw)
    tree = _np_tree(jcells.get(cell).init_params(jm, jax.random.key(seed)))
    return tree, params_from_reference(tree)


def _sessions(cell, seed, accel_kw=None, **model_kw):
    """A quantised reference session and the port's session on the CPU
    over the same float weights."""
    accel_kw = accel_kw or {}
    js = repro.build(_jmodel(cell, **model_kw), _jaccel(**accel_kw),
                     seed=seed).quantize()
    ts = repro_torch.build(_model(cell, **model_kw),
                           AcceleratorConfig(**accel_kw),
                           params=params_from_reference(_np_tree(js.params)),
                           device="cpu").quantize()
    return js, ts


def _assert_codes_equal(tqp, jqp):
    for a, b in zip(jax.tree_util.tree_leaves(_np_tree(jqp)),
                    jax.tree_util.tree_leaves(
                        jax.tree_util.tree_map(lambda t: t.numpy(), tqp))):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Registry surfaces
# ---------------------------------------------------------------------------

def test_registry_lists_the_zoo():
    assert tcells.available() == ("gru", "lstm", "rglru")
    for name in CELLS:
        spec = tcells.get(name)
        assert spec.name == name
        assert spec.state_arity == len(spec.state_names)
    assert [tcells.get(n).supports_fused is None for n in CELLS] == \
        [False, True, True]


def test_registry_unknown_cell_names_known_ones():
    with pytest.raises(KeyError, match="rglru"):
        tcells.get("rwkv6")


def test_state_shape_and_init_state_follow_the_spec():
    for name in CELLS:
        m = _model(name, layers=3, hidden=5)
        arity = tcells.get(name).state_arity
        assert tcells.state_shape(m) == (3, arity, 5)
        st_ = tcells.init_state(m, batch=4)
        assert len(st_) == 3
        for layer in st_:
            assert len(layer) == arity
            for a in layer:
                assert a.shape == (4, 5) and a.dtype == torch.int32
                assert not bool(a.any())


def test_lstm_init_state_matches_legacy_init_int_state():
    m = _model("lstm")
    legacy = tq.init_int_state(m, 2)
    generic = tcells.init_state(m, 2)
    assert len(legacy) == len(generic)
    for (lh, lc), (gh, gc) in zip(legacy, generic):
        assert torch.equal(lh, gh) and torch.equal(lc, gc)


def test_unknown_cell_fails_at_build():
    with pytest.raises(KeyError, match="registered"):
        repro_torch.build(tq.QLSTMConfig(cell="nope"), device="cpu")


# ---------------------------------------------------------------------------
# The parity battery: the reference's oracle == the port's ref and xla
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("fp", [(4, 8), (8, 16)], ids=["a4b8", "a8b16"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.usefixtures("reference")
def test_ref_xla_parity(cell, fp, layers):
    """For every HardSigmoid* method: the reference's codes, quantised
    from its seeded params, equal the port's ``quantize_params`` of the
    same floats, and the port's ``ref`` and ``xla`` engines both equal the
    reference's oracle bit for bit."""
    fp = _fp(fp)
    tree, tparams = _ref_params(cell, layers, layers=layers, fxp=fp)
    x = _x(seed=layers)
    for hs_method in HS_METHODS:
        taccel = AcceleratorConfig(fxp=fp, hs_method=hs_method)
        jaccel = _jaccel(fxp=fp, hs_method=hs_method)
        tm = resolve_model(_model(cell, layers=layers), taccel, warn=False)
        jm = jacc.resolve_model(_jmodel(cell, layers=layers), jaccel,
                                warn=False)
        jqp = jcells.get(cell).quantize_params(
            jax.tree_util.tree_map(jnp.asarray, tree), jm)
        _assert_codes_equal(tcells.get(cell).quantize_params(tparams, tm),
                            jqp)
        want = np.asarray(jbackends.get("ref").run(
            jqp, jfxp.quantize(jnp.asarray(x), jm.fxp), jm, jaccel))
        tqp = qparams_from_reference(_np_tree(jqp))
        x_int = tfxp.quantize(torch.as_tensor(x), fp)
        for engine in ("ref", "xla"):
            got = tbackends.get(engine).run(tqp, x_int, tm, taccel).numpy()
            np.testing.assert_array_equal(
                got, want, err_msg=f"{cell} {engine} at {fp} {hs_method} "
                f"L{layers}")


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.usefixtures("reference")
def test_stateful_windowed_equals_concatenated_backends(cell):
    """k windows through run_stateful == one run over the k*T sequence,
    bit-exact, on both int engines, and equal to the reference's run."""
    js, ts = _sessions(cell, 1)
    k, t = 3, ts.model.seq_len
    x = _x(t=k * t, seed=7)
    want = np.asarray(js.infer(jnp.asarray(x), path="int", backend="ref"))
    x_int = tfxp.quantize(torch.as_tensor(x), ts.model.fxp)
    for name in ("ref", "xla"):
        bk = tbackends.get(name)
        y_full = bk.run(ts.qparams, x_int, ts.model, ts.accel)
        state = tcells.init_state(ts.model, x_int.shape[0])
        for w in range(k):
            y, state = bk.run_stateful(ts.qparams, x_int[:, w * t:(w + 1) * t],
                                       ts.model, ts.accel, state)
        assert torch.equal(y, y_full), f"{cell}@{name}"
        np.testing.assert_array_equal(
            tfxp.dequantize(y, ts.model.fxp).numpy(), want)


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.usefixtures("reference")
def test_per_step_alu_runs_on_xla(cell):
    """The per-step (baseline [15]) ALU has no oracle, but the general
    datapath runs it for every cell, bit for bit as the reference's."""
    js, ts = _sessions(cell, 2, accel_kw=dict(alu_mode="per_step"))
    assert ts.plan["backend"] == js.plan["backend"] == "xla"
    x = _x(seed=3)
    y_per = ts.infer(x, path="int").numpy()
    assert np.all(np.isfinite(y_per)) and y_per.shape == (2, 2)
    np.testing.assert_array_equal(y_per,
                                  np.asarray(js.infer(jnp.asarray(x),
                                                      path="int")))


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.usefixtures("reference")
def test_float_and_qat_paths_run(cell):
    """The float forward within 1e-6 of the reference's; the QAT forward
    within 1e-6 except for counted one-LSB flips."""
    js, ts = _sessions(cell, 4)
    x = _x(batch=32, seed=4)
    for path in ("float", "qat"):
        y = ts.infer(x, path=path).numpy()
        assert y.shape == (32, 2) and np.all(np.isfinite(y))
        want = np.asarray(js.infer(jnp.asarray(x), path=path))
        diff = np.abs(y - want)
        if path == "float":
            assert float(diff.max()) <= 1e-6, diff.max()
        else:
            assert int((diff > 1e-6).sum()) <= MAX_FLIPS_PER_CASE, diff.max()
            assert float(diff.max()) <= ts.model.fxp.scale + 1e-6


# ---------------------------------------------------------------------------
# Plan / backend selection
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
def test_plan_carries_cell_and_state_shape():
    for cell in CELLS:
        m = _model(cell)
        p = plan(m, AcceleratorConfig())
        assert p["cell"] == cell
        assert p["state_shape"] == tcells.state_shape(m)
        jp = jacc.plan(_jmodel(cell), jacc.AcceleratorConfig())
        assert tuple(jp["state_shape"]) == tuple(p["state_shape"])


@pytest.mark.usefixtures("reference")
def test_auto_backend_per_cell():
    """LSTM keeps the fused kernel; cells without one resolve to xla (and
    therefore to host state residency) — the reference's answers."""
    p = plan(_model("lstm"), AcceleratorConfig())
    assert p["backend"] == "pallas" and p["state_residency"] == "device"
    for cell in NON_FUSED_CELLS:
        p = plan(_model(cell), AcceleratorConfig())
        jp = jacc.plan(_jmodel(cell), jacc.AcceleratorConfig())
        for key in ("backend", "stateful_backend", "state_residency"):
            assert p[key] == jp[key], key
        assert p["backend"] == "xla"
        assert p["stateful_backend"] == "xla"
        assert p["state_residency"] == "host"


def test_pallas_refuses_cells_without_fused_kernel():
    for cell in NON_FUSED_CELLS:
        with pytest.raises(BackendUnsupported, match="no fused kernel"):
            tbackends.select(_model(cell), AcceleratorConfig(),
                             override="pallas")
        with pytest.raises(BackendUnsupported, match="no fused kernel"):
            tbackends.select_stateful(_model(cell), AcceleratorConfig(),
                                      override="pallas")
        with pytest.raises(ValueError, match="no fused kernel"):
            repro_torch.build(_model(cell), AcceleratorConfig(backend="pallas"),
                              device="cpu")


def test_report_runs_per_cell():
    for cell in CELLS:
        r = repro_torch.build(_model(cell), seed=5, device="cpu") \
            .quantize().report()
        assert r["ops_per_inference"] > 0
        assert r["weight_bytes"] > 0
        assert r["plan"]["cell"] == cell
        if jax is not None:
            jr = repro.build(_jmodel(cell), seed=5).quantize().report()
            assert (r["ops_per_inference"], r["weight_bytes"]) == \
                (jr["ops_per_inference"], jr["weight_bytes"])


def test_explore_cell_axis():
    # cell sits between the Table-2 axes and the serving axes
    assert explore.AXES[-3:] == ("cell", "replicas", "state_residency")
    space = explore.SearchSpace(cell=("lstm", "gru"))
    assert space.size == 2
    labels = [p.label for p in space.grid()]
    assert labels[0].endswith("_auto")          # lstm label unchanged
    assert labels[1].endswith("_gru")
    with pytest.raises(ValueError, match="cell choice"):
        explore.SearchSpace(cell=("mamba",))


def test_point_from_config_defaults_old_records_to_lstm():
    from repro_torch.explore.space import point_from_config
    p = next(iter(explore.SearchSpace().grid()))
    d = p.asdict()
    del d["cell"]                               # a pre-cell-axis record
    assert point_from_config(d).cell == "lstm"
    assert point_from_config(p.asdict()) == p


def test_point_configs_set_model_cell():
    space = explore.SearchSpace(cell=("rglru",))
    model, accel = next(iter(space.grid())).configs()
    assert model.cell == "rglru"
    assert plan(model, accel)["backend"] == "xla"


def test_stateful_ladder_per_cell():
    """Non-fused cells degrade xla -> ref, on the CPU and on CUDA alike
    (no kernel is cut from their ladder: they have none); the fused LSTM
    keeps its three rungs on the CPU and ends at its kernel on CUDA."""
    build = lambda cell: repro_torch.build(_model(cell), device="cpu")
    assert build("lstm").degradation_ladder() == ("pallas", "xla", "ref")
    cuda = torch.device("cuda")
    lstm = _model("lstm")
    assert tbackends.degradation_ladder(lstm, AcceleratorConfig(),
                                        device=cuda) == ("pallas",)
    for cell in NON_FUSED_CELLS:
        assert build(cell).degradation_ladder() == ("xla", "ref")
        assert tbackends.degradation_ladder(
            _model(cell), AcceleratorConfig(), device=cuda) == ("xla", "ref")


# ---------------------------------------------------------------------------
# Serving: windowed-vs-concatenated through StreamServer, both residencies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("residency", ["host", "device"])
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.usefixtures("reference")
def test_stream_server_carry_equals_concatenated(cell, residency):
    """Feeding a stream window by window through the port's StreamServer
    is bit-identical to one shot over the concatenated sequence — on the
    host LRU store AND on the device-resident slot table (which GRU/rGLRU
    reach through ``backends.common.run_slots_via_state``) — and to the
    reference's one-shot run."""
    js, ts = _sessions(cell, 6)
    k, t = 3, ts.model.seq_len
    streams = {f"s{i}": _x(t=k * t, seed=20 + i)[0] for i in range(3)}
    with StreamServer(ts, batch=2, deadline_s=0.005, max_streams=8,
                      state_residency=residency) as srv:
        assert srv.state_residency == residency
        for w in range(k):
            for sid, xs in streams.items():
                srv.submit(sid, xs[w * t:(w + 1) * t])
        results = srv.drain(timeout=120)
    by = {}
    for r in results:
        assert r.error is None
        by.setdefault(r.stream_id, {})[r.seq] = r.y
    for sid, xs in streams.items():
        full = ts.infer(xs[None], path="int").numpy()
        np.testing.assert_array_equal(by[sid][k - 1], full[0],
                                      err_msg=f"{cell}@{residency}:{sid}")
        np.testing.assert_array_equal(
            full, np.asarray(js.infer(jnp.asarray(xs[None]), path="int")))


@pytest.mark.parametrize("cell", NON_FUSED_CELLS)
def test_stream_state_read_seed_roundtrip(cell):
    """Warm stream handoff (read_stream_state -> seed_stream_state) is
    carry-shape-agnostic: a moved stream continues bit-exactly."""
    m = _model(cell)
    sess = repro_torch.build(m, seed=8, device="cpu").quantize()
    t = m.seq_len
    xs = _x(t=2 * t, seed=31)[0]
    with StreamServer(sess, batch=1, deadline_s=0.005) as src:
        src.submit("mv", xs[:t])
        src.drain(timeout=60)
        st_ = src.read_stream_state("mv")
    assert st_ is not None
    assert len(st_) == m.num_layers
    assert all(len(layer) == tcells.get(cell).state_arity for layer in st_)
    with StreamServer(sess, batch=1, deadline_s=0.005) as dst:
        dst.seed_stream_state("mv", st_)
        dst.submit("mv", xs[t:])
        (r,) = dst.drain(timeout=60)
    full = sess.infer(xs[None], path="int").numpy()
    np.testing.assert_array_equal(r.y, full[0])


# ---------------------------------------------------------------------------
# rGLRU's baked decay under the float sigmoid gate
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.usefixtures("reference")
def test_rglru_quantize_params_sigmoid_gate_within_one_code(seed):
    """``lam_q = quantize(sigmoid(lam))``: torch's and XLA's sigmoid may
    differ by an ulp, which can move a code across a rounding boundary.
    Every other leaf is bit for bit; the ``lam_q`` codes are within one
    code, and at most ``MAX_LAM_FLIPS`` of the 2 x 256 differ."""
    kw = dict(layers=2, hidden=256, acts=tq.FLOAT_ACTS)
    jm = _jmodel("rglru", **kw)
    tm = _model("rglru", layers=2, hidden=256, acts=tq.FLOAT_ACTS)
    tree = _np_tree(jcells.get("rglru").init_params(jm, jax.random.key(seed)))
    jqp = jcells.get("rglru").quantize_params(
        jax.tree_util.tree_map(jnp.asarray, tree), jm)
    tqp = tcells.get("rglru").quantize_params(params_from_reference(tree), tm)
    flips = 0
    for tl, jl in zip(tqp["layers"], jqp["layers"]):
        for key, code in tl.items():
            want = np.asarray(jl[key])
            if key != "lam_q":
                np.testing.assert_array_equal(code.numpy(), want)
                continue
            diff = np.abs(code.numpy().astype(np.int64) - want)
            assert int(diff.max()) <= 1
            flips += int((diff > 0).sum())
    assert flips <= MAX_LAM_FLIPS, flips


# ---------------------------------------------------------------------------
# Properties (``tests/test_cells_property.py``'s four)
# ---------------------------------------------------------------------------

def _draw_case(cell, fp, hs_method, layers, hidden, seed, t=3):
    """One resolved (model, accel, spec, params, qparams, x_int) case, the
    params from the port's own seeded init."""
    base = tq.QLSTMConfig(input_size=2, hidden_size=hidden, num_layers=layers,
                          seq_len=t, out_features=2, cell=cell)
    accel = AcceleratorConfig(fxp=fp, hs_method=hs_method)
    m = resolve_model(base, accel, warn=False)
    spec = tcells.get(cell)
    params = spec.init_params(m, torch.Generator().manual_seed(seed))
    qp = spec.quantize_params(params, m)
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.0, 1.0, (2, t, 2)).astype(np.float32)
    return m, accel, spec, params, qp, tfxp.quantize(torch.as_tensor(x), fp)


def _check_registry_roundtrip(cell, fp, layers, hidden, seed):
    m, _, spec, params, qp, x_int = _draw_case(
        cell, fp, "arithmetic", layers, hidden, seed)
    assert tcells.state_shape(m) == (layers, spec.state_arity, hidden)
    state = tcells.init_state(m, batch=2)
    assert len(state) == layers
    assert all(len(layer) == spec.state_arity for layer in state)
    assert len(qp["layers"]) == len(params["layers"]) == layers
    for qlayer, flayer in zip(qp["layers"], params["layers"]):
        assert set(qlayer) >= set(flayer) - {"lam"}
        for v in qlayer.values():
            assert v.dtype == torch.int32
    y, out = spec.run_int_stateful(qp, x_int, m, state)
    assert y.shape == (2, m.out_features)
    assert len(out) == layers
    for layer in out:
        assert len(layer) == spec.state_arity
        for a in layer:
            assert a.shape == (2, hidden) and a.dtype == torch.int32


def _check_ref_xla_bit_exact(cell, fp, hs_method, layers, hidden, seed):
    m, accel, _, _, qp, x_int = _draw_case(
        cell, fp, hs_method, layers, hidden, seed)
    y_ref = tbackends.get("ref").run(qp, x_int, m, accel)
    y_xla = tbackends.get("xla").run(qp, x_int, m, accel)
    assert torch.equal(y_ref, y_xla), \
        f"{cell} {fp} {hs_method} L{layers} H{hidden} s{seed}"


@pytest.mark.property
@given(st.sampled_from(CELLS), st.sampled_from(FXPS),
       st.integers(1, 3), st.integers(2, 12), st.integers(0, 2 ** 16))
@settings(max_examples=25, deadline=None)
def test_registry_roundtrip_property(cell, fp, layers, hidden, seed):
    _check_registry_roundtrip(cell, _fp(fp), layers, hidden, seed)


@pytest.mark.property
@given(st.sampled_from(CELLS), st.sampled_from(FXPS),
       st.sampled_from(HS_METHODS), st.integers(1, 3), st.integers(2, 10),
       st.integers(0, 2 ** 16))
@settings(max_examples=25, deadline=None)
def test_ref_xla_bit_exact_property(cell, fp, hs_method, layers, hidden,
                                    seed):
    _check_ref_xla_bit_exact(cell, _fp(fp), hs_method, layers, hidden, seed)


@pytest.mark.parametrize("cell", CELLS)
def test_registry_roundtrip_sampled(cell):
    rng = np.random.default_rng(CELLS.index(cell))
    for _ in range(4):
        fp = _fp(FXPS[rng.integers(len(FXPS))])
        _check_registry_roundtrip(cell, fp, int(rng.integers(1, 4)),
                                  int(rng.integers(2, 13)),
                                  int(rng.integers(2 ** 16)))


@pytest.mark.parametrize("cell", CELLS)
def test_ref_xla_bit_exact_sampled(cell):
    rng = np.random.default_rng(CELLS.index(cell) + 10)
    for _ in range(4):
        fp = _fp(FXPS[rng.integers(len(FXPS))])
        hs = HS_METHODS[rng.integers(len(HS_METHODS))]
        _check_ref_xla_bit_exact(cell, fp, hs, int(rng.integers(1, 4)),
                                 int(rng.integers(2, 11)),
                                 int(rng.integers(2 ** 16)))
