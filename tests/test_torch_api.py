"""The port's session API against the JAX package's, given the same
params (carried across with ``repro_torch.convert``).  Every port engine
(``ref``, ``xla``, ``pallas``) must equal the reference's ``infer_int``
bit for bit; the float path agrees within ``atol=1e-5``, because float32
sums run in a different order in the two frameworks."""

import dataclasses
import warnings

import pytest

pytest.importorskip("jax")  # the reference package; absent on the card

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

import repro  # noqa: E402
import repro_torch  # noqa: E402
from repro import backends as jbackends  # noqa: E402
from repro.core import accelerator as jacc  # noqa: E402
from repro.core import fixed_point as jfxp  # noqa: E402
from repro.core import qlstm as jq  # noqa: E402
from repro_torch import backends as tbackends  # noqa: E402
from repro_torch.convert import params_from_reference, qparams_from_reference  # noqa: E402
from repro_torch.core import accelerator as tacc  # noqa: E402
from repro_torch.core import fixed_point as tfxp  # noqa: E402
from repro_torch.core import qlstm as tq  # noqa: E402


def _pair(seed=0, model_kw=None, **accel_kw):
    """A reference session and a port session (CPU) sharing its params."""
    js = repro.build(jq.QLSTMConfig(**(model_kw or {})),
                     jacc.AcceleratorConfig(**accel_kw), seed=seed)
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    ts = repro_torch.build(tq.QLSTMConfig(**(model_kw or {})),
                           tacc.AcceleratorConfig(**accel_kw),
                           params=params_from_reference(tree), device="cpu")
    return js.quantize(), ts.quantize()


def _x(b=8, t=6, m=1, seed=1):
    return (np.random.default_rng(seed).normal(0, 1, (b, t, m)) * 0.5
            ).astype(np.float32)


@pytest.mark.parametrize("hs_method", ["arithmetic", "1to1", "step"])
@pytest.mark.parametrize("alu_mode", ["pipelined", "per_step"])
def test_paths_and_backends_parity(hs_method, alu_mode):
    """Each port engine able to run the configuration equals the
    reference's ``infer_int`` bit for bit, and both packages agree on
    which engines those are."""
    js, ts = _pair(hs_method=hs_method, alu_mode=alu_mode)
    names = tbackends.supported_backends(ts.model, ts.accel)
    assert names == jbackends.supported_backends(js.model, js.accel)
    x_int = np.array(jfxp.quantize(jnp.asarray(_x()), js.model.fxp))
    want = np.asarray(js.infer_int(jnp.asarray(x_int)))
    for n in names:
        got = ts.infer_int(torch.as_tensor(x_int), backend=n)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"backend {n}")
        np.testing.assert_array_equal(
            ts.infer(_x(), path="int", backend=n).numpy(),
            np.asarray(js.infer(jnp.asarray(_x()), path="int")))


@pytest.mark.parametrize("fxp", [(4, 8), (8, 16)])
def test_baseline_lut_per_step_parity(fxp):
    """The baseline [15] point — 256-entry LUT activations, per-step ALU,
    1to1 HardSigmoid* — runs only on the general engine, bit-exact with
    the reference's."""
    jcfg = jq.QLSTMConfig(acts=jq.BASELINE_ACTS, num_layers=2, hidden_size=8)
    js = repro.build(jcfg, jacc.AcceleratorConfig(
        hs_method="1to1", alu_mode="per_step",
        fxp=jfxp.FixedPointConfig(*fxp)), seed=2).quantize()
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    ts = repro_torch.build(
        tq.QLSTMConfig(acts=tq.BASELINE_ACTS, num_layers=2, hidden_size=8),
        tacc.AcceleratorConfig(hs_method="1to1", alu_mode="per_step",
                               fxp=tfxp.FixedPointConfig(*fxp)),
        params=params_from_reference(tree), device="cpu").quantize()
    assert ts.plan["backend"] == "xla"
    assert tbackends.supported_backends(ts.model, ts.accel) == ("xla",)
    x = _x(b=6) * 4
    np.testing.assert_array_equal(
        ts.infer(x, path="int").numpy(),
        np.asarray(js.infer(jnp.asarray(x), path="int")))


def test_unbuildable_kernel_fails_at_build(monkeypatch):
    """A fused kernel that cannot be built raises when the session resolves
    the engine, before any serving guard could degrade past it."""
    from repro_torch.kernels import qlstm_cell

    def no_toolkit():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(qlstm_cell, "load_library", no_toolkit)
    with pytest.raises(RuntimeError, match="nvcc"):
        repro_torch.build(device="cuda")
    assert repro_torch.build(device="cpu").plan["backend"] == "pallas"


def test_quantized_params_match_reference():
    js, ts = _pair(seed=3, model_kw=dict(num_layers=2, hidden_size=8))
    want = jax.tree_util.tree_map(np.asarray, js.qparams)
    got = qparams_from_reference(want)
    for li in range(2):
        for k in ("w_x", "w_h", "b"):
            torch.testing.assert_close(ts.qparams["layers"][li][k],
                                       got["layers"][li][k], rtol=0, atol=0)
    for k in ("w", "b"):
        torch.testing.assert_close(ts.qparams["dense"][k], got["dense"][k],
                                   rtol=0, atol=0)


@pytest.mark.parametrize("unit", ["mxu", "vpu"])
def test_parity_multilayer_and_units(unit):
    model_kw = dict(input_size=2, hidden_size=8, num_layers=2, seq_len=4)
    js, ts = _pair(model_kw=model_kw, compute_unit=unit)
    x = _x(b=5, t=4, m=2)
    want = np.asarray(js.infer(jnp.asarray(x), path="int"))
    for n in ("ref", "pallas", "xla"):
        np.testing.assert_array_equal(
            ts.infer(x, path="int", backend=n).numpy(), want)


@pytest.mark.parametrize("backend", ["ref", "pallas"])
def test_layered_run_equals_whole_model(backend):
    """Stacking an engine's one-layer entry (for ``pallas`` the fused
    single-layer kernel) with ``run_layered`` equals the reference's
    whole-model ``infer_int``."""
    from repro_torch.backends.common import run_layered
    model_kw = dict(input_size=2, hidden_size=8, num_layers=3, seq_len=5)
    js, ts = _pair(seed=6, model_kw=model_kw)
    x_int = np.array(jfxp.quantize(jnp.asarray(_x(b=4, t=5, m=2)), js.model.fxp))
    got = run_layered(tbackends.get(backend).layer, ts.qparams,
                      torch.as_tensor(x_int), ts.model, ts.accel)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(js.infer_int(jnp.asarray(x_int))))


@pytest.mark.parametrize("acts", ["paper", "baseline", "float"])
@pytest.mark.parametrize("model_kw", [{}, dict(num_layers=3, hidden_size=12,
                                                input_size=2)])
def test_float_path_within_tolerance(model_kw, acts):
    js, _ = _pair(seed=5, model_kw=model_kw)
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    jacts = {"paper": jq.PAPER_ACTS, "baseline": jq.BASELINE_ACTS,
             "float": jq.FLOAT_ACTS}[acts]
    tacts = {"paper": tq.PAPER_ACTS, "baseline": tq.BASELINE_ACTS,
             "float": tq.FLOAT_ACTS}[acts]
    js = repro.build(jq.QLSTMConfig(acts=jacts, **model_kw), params=js.params)
    ts = repro_torch.build(tq.QLSTMConfig(acts=tacts, **model_kw),
                           params=params_from_reference(tree), device="cpu")
    x = _x(b=7, m=model_kw.get("input_size", 1))
    np.testing.assert_allclose(
        ts.infer(x, path="float").numpy(),
        np.asarray(js.infer(jnp.asarray(x), path="float")), rtol=0, atol=1e-5)


@pytest.mark.parametrize("backend", ["ref", "xla", "pallas"])
def test_windowed_stateful_equals_concatenated(backend):
    """Three windows through ``compiled_stateful`` with the carry fed back
    equal one run over the concatenated sequence, and the reference's
    windowed run."""
    model_kw = dict(hidden_size=8, num_layers=2, seq_len=4)
    js, ts = _pair(model_kw=model_kw)
    x = _x(b=3, t=12)
    fn, jfn = ts.compiled_stateful(backend), js.compiled_stateful(backend)
    state, jstate = ts.init_state(3), js.init_state(3)
    for w in range(3):
        xw = x[:, 4 * w:4 * (w + 1)]
        y, state = fn(xw, state)
        jy, jstate = jfn(jnp.asarray(xw), jstate)
    full = ts.infer(x, path="int", backend=backend)
    torch.testing.assert_close(y, full, rtol=0, atol=0)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    for (h, c), (jh, jc) in zip(state, jstate):
        np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


@pytest.mark.parametrize("backend", ["ref", "xla", "pallas"])
def test_stateful_slots_equals_host_gathered_carries(backend):
    model_kw = dict(hidden_size=8, num_layers=2, seq_len=4)
    _, ts = _pair(model_kw=model_kw)
    rng = np.random.default_rng(11)
    x = _x(b=4, t=4)
    table = ts.init_state_table(6)
    table[:6] = torch.as_tensor(rng.integers(-20, 20, (6, 2, 2, 8)),
                                dtype=torch.int32)
    gather = torch.tensor([2, 6, 0, 5], dtype=torch.int32)   # 6 = ZERO
    scatter = torch.tensor([1, 7, 3, 4], dtype=torch.int32)  # 7 = TRASH
    y, new_table = ts.compiled_stateful_slots(backend)(x, table, gather, scatter)
    carry = table[gather.long()]
    state = tuple((carry[:, li, 0], carry[:, li, 1]) for li in range(2))
    y_want, new_state = ts.compiled_stateful(backend)(x, state)
    torch.testing.assert_close(y, y_want, rtol=0, atol=0)
    for i, row in enumerate(scatter.tolist()):
        if row == 7:
            continue
        for li, (h, c) in enumerate(new_state):
            torch.testing.assert_close(new_table[row, li, 0], h[i], rtol=0, atol=0)
            torch.testing.assert_close(new_table[row, li, 1], c[i], rtol=0, atol=0)
    for row in (0, 2, 5, 6):      # rows no scatter targets are untouched
        torch.testing.assert_close(new_table[row], table[row], rtol=0, atol=0)


def test_plan_matches_reference_except_hopper_fields():
    """Same plan on the paper config, except the documented Hopper
    fields: ``mxu_fill_fraction`` is None until the MAC uses tensor
    cores, and the budget behind ``weight_memory`` is shared memory."""
    js, ts = _pair()
    jp, tp = dict(js.plan), dict(ts.plan)
    assert tp.pop("mxu_fill_fraction") is None
    jp.pop("mxu_fill_fraction")
    assert dataclasses.asdict(tp.pop("fxp")) == dataclasses.asdict(jp.pop("fxp"))
    assert tp == jp
    assert tp["backend"] == "pallas" and tp["state_residency"] == "device"
    assert tacc.VMEM_BUDGET_BYTES == 232_448
    spill = tacc.AcceleratorConfig(vmem_budget=100)
    assert tacc.plan(tq.QLSTMConfig(), spill)["weight_memory"] == "hbm"


@pytest.mark.parametrize("accel_kw,backend", [
    ({}, "pallas"), (dict(alu_mode="per_step"), "xla"),
    (dict(backend="ref"), "ref"),
    (dict(hs_method="1to1", alu_mode="per_step", compute_unit="mxu"), "xla")])
def test_auto_backend_follows_plan(accel_kw, backend):
    js, ts = _pair(**accel_kw)
    assert ts.plan["backend"] == js.plan["backend"] == backend
    assert ts.degradation_ladder() == js.degradation_ladder()


@pytest.mark.parametrize("override,want", [
    (None, ("pallas",)), ("xla", ("xla", "pallas")), ("ref", ("ref", "pallas"))])
def test_cuda_ladder_ends_at_the_fused_engine(override, want):
    """On a CUDA device no plain engine stands below the fused kernels'
    engine, so a failing kernel cannot be served by a plain one; on the
    CPU, where ``pallas`` runs the plain versions, the ladder is whole."""
    model, accel = tq.QLSTMConfig(), tacc.AcceleratorConfig()
    assert tbackends.degradation_ladder(model, accel, override=override,
                                        device=torch.device("cuda")) == want
    full = tbackends.degradation_ladder(model, accel, override=override,
                                        device="cpu")
    assert full[:len(want)] == want and sorted(full) == ["pallas", "ref", "xla"]
    per_step = tacc.AcceleratorConfig(alu_mode="per_step")
    assert tbackends.degradation_ladder(model, per_step, device="cuda") == ("xla",)


def test_explicit_unsupported_backend_raises():
    ts = repro_torch.build(tq.QLSTMConfig(),
                           tacc.AcceleratorConfig(alu_mode="per_step"),
                           device="cpu").quantize()
    for name in ("pallas", "ref"):
        with pytest.raises(tbackends.BackendUnsupported):
            ts.infer(_x(), path="int", backend=name)
    with pytest.raises(tbackends.BackendUnsupported):
        repro_torch.build(tq.QLSTMConfig(),
                          tacc.AcceleratorConfig(alu_mode="per_step",
                                                 backend="pallas"),
                          device="cpu")


def test_int_path_requires_quantize_and_known_path():
    ts = repro_torch.build(device="cpu")
    with pytest.raises(RuntimeError, match="quantize"):
        ts.infer(_x(), path="int")
    with pytest.raises(ValueError, match="path"):
        ts.infer(_x(), path="qat")


def test_build_runs_on_cuda_unless_asked(monkeypatch):
    """With no card and no device given, ``build`` raises instead of
    quietly running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.build()
    assert repro_torch.build(device="cpu").device.type == "cpu"


def test_seeded_init_is_deterministic_and_in_range():
    a = repro_torch.build(seed=4, device="cpu").params
    b = repro_torch.build(seed=4, device="cpu").params
    c = repro_torch.build(seed=5, device="cpu").params
    w = a["layers"][0]["w_h"]
    torch.testing.assert_close(w, b["layers"][0]["w_h"], rtol=0, atol=0)
    assert not torch.equal(w, c["layers"][0]["w_h"])
    assert float(w.abs().max()) <= 1 / np.sqrt(20)
    assert torch.equal(a["layers"][0]["b"][20:40], torch.ones(20))


def test_legacy_model_knobs_and_aliases_warn_like_reference():
    legacy = tq.QLSTMConfig(alu_mode="per_step",
                            acts=tq.ActivationConfig(hs_method="1to1"))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        m = tacc.resolve_model(legacy, tacc.AcceleratorConfig())
        acc = tacc.AcceleratorConfig(pipelined_alu=False)
    assert m.alu_mode == "per_step" and m.acts.hs_method == "1to1"
    assert acc.alu_mode == "per_step" and acc.pipelined_alu is False
    assert sum(issubclass(x.category, DeprecationWarning) for x in w) >= 3


def test_ops_and_weight_bytes_match_reference():
    for kw in ({}, dict(num_layers=3, hidden_size=12, input_size=2)):
        assert tq.ops_per_inference(tq.QLSTMConfig(**kw)) == \
            jq.ops_per_inference(jq.QLSTMConfig(**kw))
    assert tq.ops_per_inference(tq.QLSTMConfig()) == 22_001
    assert tacc.weight_bytes(tq.QLSTMConfig(), tacc.AcceleratorConfig()) == \
        jacc.weight_bytes(jq.QLSTMConfig(), jacc.AcceleratorConfig())


def test_serve_matches_batched_infer():
    _, ts = _pair(seed=2)
    windows = np.random.default_rng(0).uniform(0, 1, (11, 6, 1)).astype(np.float32)
    preds = list(ts.serve(iter(windows), batch=4))
    assert len(preds) == 11
    np.testing.assert_array_equal(np.stack(preds),
                                  ts.infer(windows, path="int").numpy())
