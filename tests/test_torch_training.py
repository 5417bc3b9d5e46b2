"""The port's quantisation-aware training against the JAX package's: the
fake-quant forward, its gradients, a 20-step ``train_qat`` loss curve, the
optimizer, checkpoints (in both directions between the packages), the
fault-tolerant ``Trainer`` and the session lifecycle.

Inputs come from a numpy seed; params are the reference's seeded init,
carried across with ``repro_torch.convert``.  Tolerances, each stated
where it is checked:

  * ``forward_qat``: 1e-6 absolute, except where the two frameworks'
    float sums or ``sigmoid``/``tanh`` differ in the last bit across a
    fake-quant rounding boundary, which moves that value by one LSB of
    the (a,b) grid; those outputs are counted, and at most
    ``MAX_FLIPS_PER_CASE`` per case may differ, by one LSB at most.
  * gradients: 1e-5 relative to the largest gradient of each leaf, on
    inputs whose forward agrees bit for bit (the backward sums run in
    another order in the two frameworks; a relative bound per element
    has no meaning where terms cancel to near zero).
  * the loss of each of 20 ``train_qat`` steps: 1e-4 relative.
  * integer results, checkpoints and the restart: bit for bit.
"""

import os
import signal

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.convert import params_from_reference, train_state_from_reference
from repro_torch.core import fixed_point as tfxp
from repro_torch.core import qlstm as tq
from repro_torch.data import pems_like_dataset as t_pems
from repro_torch.training import checkpoint as tck
from repro_torch.training.optimizer import (OptConfig, apply_updates,
                                            clip_by_global_norm,
                                            init_opt_state, schedule)
from repro_torch.training.train_loop import LoopConfig, StragglerWatchdog, Trainer
from repro_torch.training.tree import tree_leaves, tree_map

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    import repro
    from repro.core import qlstm as jq
    from repro.data.timeseries import pems_like_dataset as j_pems
    from repro.training import checkpoint as jck
    from repro.training.optimizer import OptConfig as JOptConfig
    from repro.training.optimizer import apply_updates as j_apply_updates
    from repro.training.optimizer import init_opt_state as j_init_opt_state
except ImportError:
    jax = None

GATES = ["hard_sigmoid_star", "lut_sigmoid", "sigmoid"]
CELLS = ["hard_tanh", "tanh"]
SHAPES = {"paper": {}, "L2H12": dict(num_layers=2, hidden_size=12, input_size=3)}
MAX_FLIPS_PER_CASE = 1


@pytest.fixture
def reference():
    """Skips a parity test where the JAX reference is not installed."""
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _models(gate="hard_sigmoid_star", cell="hard_tanh", **shape):
    acts = dict(gate=gate, cell=cell)
    return (jq.QLSTMConfig(acts=jq.ActivationConfig(**acts), **shape),
            tq.QLSTMConfig(acts=tq.ActivationConfig(**acts), **shape))


def _params(jm, seed=0):
    """The reference's seeded init as numpy, and the port's copy."""
    tree = jax.tree_util.tree_map(np.asarray, jq.init_params(jm, jax.random.key(seed)))
    return tree, params_from_reference(tree)


def _inputs(m, b=32, seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.normal(0, 1, (b, m.seq_len, m.input_size)) * 0.5).astype(np.float32)
    y = rng.uniform(0, 1, (b, m.out_features)).astype(np.float32)
    return x, y


def _assert_leaves_equal(a, b):
    la, lb = tree_leaves(a), jax.tree.leaves(b) if jax is not None else None
    assert len(la) == len(lb)
    for p, q in zip(la, lb):
        np.testing.assert_array_equal(p.cpu().numpy(), np.asarray(q))


# ---------------------------------------------------------------------------
# forward_qat and its gradients against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("gate", GATES)
@pytest.mark.usefixtures("reference")
def test_forward_qat_matches_reference(gate, cell, shape):
    jm, tm = _models(gate, cell, **SHAPES[shape])
    jp, tp = _params(jm)
    x, _ = _inputs(tm)
    want = np.asarray(jax.jit(jq.forward_qat, static_argnums=2)(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jm))
    got = tq.forward_qat(tp, torch.as_tensor(x), tm).numpy()
    diff = np.abs(got - want)
    flips = diff > 1e-6
    assert int(flips.sum()) <= MAX_FLIPS_PER_CASE, (int(flips.sum()), diff.max())
    assert float(diff.max()) <= tm.fxp.scale + 1e-6
    # forward_float is the same graph without fake-quant
    np.testing.assert_allclose(
        tq.forward_float(tp, torch.as_tensor(x), tm).numpy(),
        np.asarray(jax.jit(jq.forward_float, static_argnums=2)(
            jax.tree.map(jnp.asarray, jp), jnp.asarray(x), jm)),
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("gate,cell", [("hard_sigmoid_star", "hard_tanh"),
                                       ("sigmoid", "tanh")])
@pytest.mark.usefixtures("reference")
def test_qat_gradients_match_jax_grad(gate, cell, shape):
    """d MSE / d params through the STE graph, against ``jax.grad``."""
    jm, tm = _models(gate, cell, **SHAPES[shape])
    jp, tp = _params(jm)
    x, y = _inputs(tm)
    jparams = jax.tree.map(jnp.asarray, jp)
    np.testing.assert_array_equal(
        tq.forward_qat(tp, torch.as_tensor(x), tm).numpy(),
        np.asarray(jax.jit(jq.forward_qat, static_argnums=2)(jparams, jnp.asarray(x), jm)))
    jg = jax.jit(jax.grad(lambda p: jnp.mean(jnp.square(
        jq.forward_qat(p, jnp.asarray(x), jm) - jnp.asarray(y)))))(jparams)
    tp = tree_map(lambda p: p.requires_grad_(True), tp)
    loss = torch.mean(torch.square(tq.forward_qat(tp, torch.as_tensor(x), tm)
                                   - torch.as_tensor(y)))
    tg = torch.autograd.grad(loss, tree_leaves(tp))
    jleaves = jax.tree.leaves(jg)
    assert len(tg) == len(jleaves)
    for g, w in zip(tg, jleaves):
        w = np.asarray(w)
        # a leaf whose every gradient is 0 (h rounded to 0 feeds it) must
        # be 0 in the port too
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-5 * float(np.abs(w).max()))
    assert sum(float(g.abs().max()) > 0 for g in tg) >= len(tg) - 2


@pytest.mark.usefixtures("reference")
def test_train_qat_loss_curve_matches_reference():
    """20 steps from the same params on the same batches: each step's
    loss within 1e-4 relative of the reference's."""
    data = j_pems(seq_len=6, n_days=4)
    js = repro.build(seed=0)
    tree = jax.tree_util.tree_map(np.asarray, js.params)
    ts = repro_torch.build(params=params_from_reference(tree), device="cpu")
    for s in (js, ts):
        s.train_qat(data, steps=20, batch=32, log_every=1, log=lambda *_: None)
    jl = [h["loss"] for h in js.train_summary["history"]]
    tl = [h["loss"] for h in ts.train_summary["history"]]
    assert len(jl) == len(tl) == 20
    np.testing.assert_allclose(tl, jl, rtol=1e-4, atol=0)
    assert np.mean(tl[-5:]) < np.mean(tl[:5])


@pytest.mark.usefixtures("reference")
def test_data_is_the_references():
    want, got = j_pems(seq_len=6, n_days=4, seed=3), t_pems(seq_len=6, n_days=4, seed=3)
    for split in ("train", "test"):
        for a, b in zip(got[split], want[split]):
            np.testing.assert_array_equal(a, b)
    assert got["norm"] == want["norm"]


# ---------------------------------------------------------------------------
# optimizer (ports of tests/test_training.py)
# ---------------------------------------------------------------------------

def test_adamw_minimises_quadratic():
    cfg = OptConfig(lr=0.1, weight_decay=0.0, warmup_steps=0, total_steps=200)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = init_opt_state(params, cfg)
    for _ in range(150):
        g = {"w": 2 * params["w"]}                 # d sum(w^2) / dw
        params, state, _ = apply_updates(params, g, state, cfg)
    assert float(params["w"].abs().max()) < 0.1


def test_schedule_warmup_cosine():
    cfg = OptConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    assert float(schedule(cfg, torch.tensor(5))) == pytest.approx(0.5)
    assert float(schedule(cfg, torch.tensor(10))) == pytest.approx(1.0, abs=1e-3)
    assert float(schedule(cfg, torch.tensor(100))) == pytest.approx(0.1, abs=1e-3)


def test_grad_clip():
    g = {"a": torch.tensor([3.0, 4.0])}
    clipped, gn = clip_by_global_norm(g, 1.0)
    assert float(gn) == pytest.approx(5.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0)


@pytest.mark.parametrize("name", ["adamw", "sgd"])
@pytest.mark.usefixtures("reference")
def test_updates_match_reference(name):
    """Five updates of the same params by the same gradients (1e-6
    relative: ``pow``/``cos``/``sqrt`` may differ in their last bit)."""
    kw = dict(name=name, lr=1e-2, warmup_steps=2, total_steps=10)
    cfg, jcfg = OptConfig(**kw), JOptConfig(**kw)
    jp, tp = _params(_models()[0])
    jparams = jax.tree.map(jnp.asarray, jp)
    jstate, tstate = j_init_opt_state(jparams, jcfg), init_opt_state(tp, cfg)
    rng = np.random.default_rng(2)
    for _ in range(5):
        g = jax.tree.map(lambda p: rng.normal(0, 1, p.shape).astype(np.float32), jp)
        jparams, jstate, _ = jax.jit(j_apply_updates, static_argnums=3)(
            jparams, jax.tree.map(jnp.asarray, g), jstate, jcfg)
        tp, tstate, _ = apply_updates(tp, params_from_reference(g), tstate, cfg)
    for a, b in zip(tree_leaves(tp), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-7)
    assert int(tstate["count"]) == int(jstate["count"]) == 5


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _qat_state(seed=0, name="adamw"):
    s = repro_torch.build(seed=seed, device="cpu")
    return {"params": s.params, "opt": init_opt_state(s.params, OptConfig(name=name)),
            "step": torch.zeros((), dtype=torch.int32)}


def test_checkpoint_roundtrip_and_keep_k(tmp_path):
    state = _qat_state()
    d = str(tmp_path / "ck")
    for s in (1, 2, 3, 4):
        tck.save(d, state, s, keep=2)
    assert tck.latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_0000000003", "step_0000000004"]
    restored = tck.restore(d, state)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a, b)


def test_async_checkpointer(tmp_path):
    state = _qat_state()
    d = str(tmp_path / "ck")
    ac = tck.AsyncCheckpointer(d, keep=3)
    ac.save_async(state, 7)
    ac.wait()
    assert tck.latest_step(d) == 7


def test_checkpoint_atomicity_no_partial_dirs(tmp_path):
    d = str(tmp_path / "ck")
    tck.save(d, _qat_state(), 1)
    assert not any(p.startswith("tmp.") for p in os.listdir(d))


@pytest.mark.usefixtures("reference")
def test_checkpoints_cross_between_packages(tmp_path):
    """The reference's ``save`` restored by the port and the port's by the
    reference, leaf for leaf, names and dtypes included."""
    jparams = jq.init_params(_models()[0], jax.random.key(5))
    jstate = {"params": jparams,
              "opt": {"mu": jax.tree.map(lambda p: p * 0.5, jparams),
                      "nu": jax.tree.map(jnp.square, jparams),
                      "count": jnp.asarray(7, jnp.int32)},
              "step": jnp.asarray(42, jnp.int32)}
    jck.save(str(tmp_path / "ref"), jstate, 42)
    like = train_state_from_reference(jax.tree.map(np.zeros_like, jstate))
    got = tck.restore(str(tmp_path / "ref"), like)
    _assert_leaves_equal(got, jstate)
    assert got["step"].dtype == torch.int32 and got["opt"]["count"].dtype == torch.int32

    tstate = train_state_from_reference(jax.tree.map(np.asarray, jstate))
    tstate["opt"]["nu"] = tree_map(lambda p: p + 0.25, tstate["opt"]["nu"])
    tck.save(str(tmp_path / "port"), tstate, 43)
    back = jck.restore(str(tmp_path / "port"), jstate)
    _assert_leaves_equal(tstate, back)


# ---------------------------------------------------------------------------
# the loop
# ---------------------------------------------------------------------------

def test_straggler_watchdog():
    w = StragglerWatchdog(factor=2.0, alpha=0.5)
    for _ in range(5):
        w.observe(0, 0.1)
    assert not w.observe(6, 0.15)
    assert w.observe(7, 0.5)          # 5x EMA -> straggler
    assert len(w.events) == 1
    # straggler must not poison the EMA
    assert w.ema < 0.2


def _qat_step(model, cfg):
    """A train step as ``train_qat`` builds it, from the public pieces."""
    def step(state, batch):
        params = tree_map(lambda p: p.detach().requires_grad_(True), state["params"])
        loss = torch.mean(torch.square(tq.forward_qat(params, batch["x"], model)
                                       - batch["y"]))
        grads = iter(torch.autograd.grad(loss, tree_leaves(params)))
        grads = tree_map(lambda _: next(grads), params)
        p, o, m = apply_updates(state["params"], grads, state["opt"], cfg)
        return {"params": p, "opt": o, "step": state["step"] + 1}, {"loss": loss.detach(), **m}
    return step


def test_trainer_runs_and_checkpoints(tmp_path):
    state = _qat_state()
    model = tq.QLSTMConfig()
    step = _qat_step(model, OptConfig(lr=1e-3, warmup_steps=2, total_steps=20))
    x, y = _inputs(model, b=8)
    batch = lambda i: {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
    tr = Trainer(step, state, batch,
                 LoopConfig(total_steps=6, ckpt_dir=str(tmp_path / "ck"),
                            ckpt_every=3, log_every=100),
                 log=lambda s: None)
    out = tr.run()
    assert out["step"] == 6 and not out["preempted"]
    assert tck.latest_step(str(tmp_path / "ck")) == 6
    # resume path: a new trainer picks up from 6 and does nothing (total 6)
    tr2 = Trainer(step, state, batch,
                  LoopConfig(total_steps=6, ckpt_dir=str(tmp_path / "ck")),
                  log=lambda s: None)
    assert tr2.maybe_resume() == 6
    assert tr2.run()["step"] == 6


def test_restart_is_bit_exact(tmp_path):
    """10 straight ``train_qat`` steps == 5 steps ended by SIGTERM
    (checkpoint-and-exit) + a new session resumed from ``ckpt_dir`` for 5
    more, with the step-keyed batches replaying identically."""
    data = t_pems(seq_len=6, n_days=4)
    params0 = repro_torch.build(seed=3, device="cpu").params
    kw = dict(steps=10, batch=16, log_every=5)
    full = repro_torch.build(params=params0, device="cpu").train_qat(
        data, log=lambda *_: None, **kw)

    def preempt_at_5(msg):
        if msg.startswith("[step 5]"):
            os.kill(os.getpid(), signal.SIGTERM)

    d = str(tmp_path / "ck")
    first = repro_torch.build(params=params0, device="cpu").train_qat(
        data, ckpt_dir=d, log=preempt_at_5, **kw)
    assert first.train_summary["preempted"] and first.train_summary["step"] == 5
    assert tck.latest_step(d) == 5
    resumed = repro_torch.build(params=params0, device="cpu").train_qat(
        data, ckpt_dir=d, log=lambda *_: None, **kw)
    assert resumed.train_summary["step"] == 10
    for a, b in zip(tree_leaves(full.params), tree_leaves(resumed.params)):
        assert torch.equal(a, b)
    assert not any(torch.equal(a, b) for a, b in
                   zip(tree_leaves(first.params), tree_leaves(full.params)))


# ---------------------------------------------------------------------------
# the session (ports of tests/test_qlstm.py and tests/test_api.py)
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("reference")
def test_qat_matches_int_datapath():
    """forward_qat simulates the hardware: dequant(forward_int) must agree
    to within 1 LSB at the output (the reference's bound and inputs)."""
    jm, tm = _models()
    _, tp = _params(jm)
    x = np.array(jax.random.normal(jax.random.key(1), (16, tm.seq_len,
                                                         tm.input_size)) * 0.5)
    x = torch.as_tensor(x)
    yq = tq.forward_qat(tp, x, tm)
    yi = tfxp.dequantize(tq.forward_int(tq.quantize_params(tp, tm),
                                        tfxp.quantize(x, tm.fxp), tm), tm.fxp)
    assert float((yq - yi).abs().max()) <= tm.fxp.scale + 1e-7


def test_lifecycle_train_quantize_infer_serve():
    data = t_pems(seq_len=6, n_days=4)
    sess = repro_torch.build(seed=0, device="cpu")
    sess.train_qat(data, steps=5, batch=16, log=lambda *_: None).quantize()
    assert sess.train_summary["step"] == 5

    xte, _ = data["test"]
    y = sess.infer(xte[:32], path="int")
    assert tuple(y.shape) == (32, 1)

    # serve: wave-batched streaming matches batched infer, in order
    preds = list(sess.serve(iter(xte[:37]), batch=16))
    want = sess.infer(xte[:37], path="int").numpy()
    assert len(preds) == 37
    np.testing.assert_array_equal(np.stack(preds), want)
    assert tuple(sess.infer(xte[:4], path="qat").shape) == (4, 1)


def test_train_invalidates_quantization():
    data = t_pems(seq_len=6, n_days=4)
    sess = repro_torch.build(device="cpu").quantize()
    assert sess.qparams is not None
    fn = sess.compiled("float")
    sess.train_qat(data, steps=2, batch=8, log=lambda *_: None)
    assert sess.qparams is None  # stale codes dropped
    assert sess.compiled("float") is not fn
