"""The port's LM train step (``training.step``), gradient compression
(``training.compress``), the fault-tolerant ``Trainer`` on the LM state
and the training launcher (``launch.train``), against the JAX package.

Both packages start from one state: the reference's ``init_train_state``
carried across with ``convert.lm_train_state_from_reference``, and the
same ``SyntheticLM`` batches.  The step comparisons use AdamW's ``eps`` =
1e-3: with the default 1e-8, ``m / sqrt(v)`` turns a gradient that is
rounding noise (the key bias's is zero in exact arithmetic: softmax does
not see a constant added to every score of a query) into a full +-lr step
whose sign is the noise's, in either package.  Tolerances, after every
step:
  * loss, ce, grad_norm: 1e-5 relative.
  * params: 1e-5 absolute (a hundredth of one step at lr 1e-3).
  * AdamW moments: 1e-4 of each leaf's largest reference value (f32
    gradients summed in another order); under bf16 compression 2^-7 (a
    gradient that lands on a bf16 rounding boundary rounds the other way).
  * int8 compression's error state: 1e-4 of each leaf's largest
    gradient, taken as 64 s for its quantum s (the largest lies between
    63.5 s and 127 s; the residual is below s / 2, so s is twice the
    largest residual); an element whose code rounded the other way (its
    g / s within rounding noise of a half-integer) differs by s (found as
    a difference above s / 4), and such elements (at most 1% of a leaf,
    or one) and their moments and params are left out of the comparison
    from then on.
  * compression, restarts and checkpoints: as the reference's own tests,
    and bit for bit where the port is compared with itself.
"""

import os
import signal

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_train_state_from_reference
from repro_torch.data.lm_data import SyntheticLM
from repro_torch.launch import train as TL
from repro_torch.models import transformer as T
from repro_torch.training import checkpoint as tck
from repro_torch.training import compress as TC
from repro_torch.training import step as TS
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.train_loop import LoopConfig, Trainer
from repro_torch.training.tree import tree_leaves, tree_leaves_with_path

try:  # the JAX reference; the card's machine has none
    import jax
    import jax.numpy as jnp
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.models import transformer as JT
    from repro.training import compress as JC
    from repro.training import step as JS
    from repro.training.optimizer import OptConfig as JOptConfig
except ImportError:
    jax = None

LR, EPS = 1e-3, 1e-3


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _cfgs(arch):
    kw = dict(remat="none", dtype="float32")
    return (j_reduce(J_ARCHS[arch]).replace(**kw),
            reduce_config(ARCH_CONFIGS[arch]).replace(**kw))


def _batch(cfg, src, step, b=4, s=8):
    out = dict(src.batch(step, b, s))
    if cfg.attn and cfg.attn.mrope_sections:
        pos = np.arange(s)
        out["position_ids"] = np.broadcast_to(
            np.stack([pos, pos // 2, pos % 3])[:, None], (3, b, s)).astype(np.int32)
    return out


def _moment_tol(mode):
    return 2.0 ** -7 if mode == "bf16" else 1e-4


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch,mode", [("qwen1.5-0.5b", "none"),
                                       ("qwen1.5-0.5b", "bf16"),
                                       ("qwen1.5-0.5b", "int8"),
                                       ("qwen2-vl-2b", "none")])
def test_train_step_matches_reference_for_three_steps(arch, mode):
    """3 steps of ``make_train_step`` with 2 microbatches (qwen2-vl: the
    M-RoPE positions split on their axis 1): metrics, params, AdamW
    moments and the int8 error state against the reference's jitted step
    after every step."""
    jcfg, tcfg = _cfgs(arch)
    jp, _ = JT.init_model(jcfg, jax.random.key(0))
    sched = dict(lr=LR, eps=EPS, warmup_steps=1, total_steps=10)
    jplan = JS.TrainPlan(opt=JOptConfig(**sched), microbatches=2, grad_compress=mode)
    tplan = TS.TrainPlan(opt=OptConfig(**sched), microbatches=2, grad_compress=mode)
    js = JS.init_train_state(jp, jplan)
    ts = lm_train_state_from_reference(jax.tree.map(np.asarray, js))
    assert set(ts) == set(js) and ts["step"].dtype == torch.int32
    jstep = jax.jit(JS.make_train_step(jcfg, jplan))
    tstep = TS.make_train_step(tcfg, tplan)
    src = SyntheticLM(tcfg.vocab_size, seed=3)
    flipped = {}
    for i in range(3):
        b = _batch(tcfg, src, i)
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in b.items()})
        old = ts
        before = [x.clone() for x in tree_leaves(old)]
        ts, tm = tstep(old, {k: torch.as_tensor(v) for k, v in b.items()})
        assert all(torch.equal(a, x) for a, x in zip(before, tree_leaves(old)))
        assert set(tm) == set(jm)
        for k in ("loss", "ce", "grad_norm", "lr", "aux"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)
        want = dict(tree_leaves_with_path(jax.tree.map(np.asarray, js)))
        got = {p: x.numpy() for p, x in tree_leaves_with_path(ts)}
        assert got.keys() == want.keys()
        # each leaf of params, opt/mu, opt/nu and grad_err by its param path
        leaf = lambda p: p[2:] if p[:2] in (("opt", "mu"), ("opt", "nu")) else p[1:]  # noqa: E731
        if mode == "int8":   # codes that rounded the other way
            for p, w in want.items():
                if p[0] == "grad_err":
                    quantum = 2 * np.abs(w).max()   # the residual is below s / 2
                    new = np.abs(got[p] - w) > quantum / 4
                    assert new.sum() <= max(1, 0.01 * new.size), (p, int(new.sum()))
                    flipped[leaf(p)] = flipped.get(leaf(p), False) | new
        for p, w in want.items():
            if p in (("step",), ("opt", "count")):
                np.testing.assert_array_equal(got[p], w, err_msg=str(p))
                continue
            err = np.abs(got[p] - w)[~flipped.get(leaf(p), np.zeros(w.shape, bool))]
            tol = {"params": 1e-5, "opt": _moment_tol(mode) * np.abs(w).max(),
                   "grad_err": 1e-4 * 64 * 2 * np.abs(w).max()}[p[0]]
            assert err.size == 0 or err.max() <= tol, (i, p, err.max(), tol)
        assert int(ts["step"]) == i + 1


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("mode", ["bf16", "int8"])
def test_gradient_compression_matches_reference(mode):
    """The counterpart of ``tests/test_training.py``'s compression test:
    within 10% of a 1e-3 gradient scale, bf16 out for bf16; and the same
    values and error state as the reference's ``compress``, bit for bit
    (the int8 scale uses ``jnp``'s log2/exp2 formulas)."""
    g = np.random.default_rng(0).normal(0, 1e-3, (64,)).astype(np.float32)
    e0 = np.random.default_rng(1).normal(0, 1e-5, (64,)).astype(np.float32)
    out, err = TC.compress({"w": torch.as_tensor(g)}, mode,
                           {"w": torch.as_tensor(e0)})
    jout, jerr = JC.compress({"w": jnp.asarray(g)}, mode, {"w": jnp.asarray(e0)})
    if mode == "bf16":
        assert out["w"].dtype == torch.bfloat16
    rel = float((out["w"].float() - torch.as_tensor(g)).abs().max()) / 1e-3
    assert rel < 0.1
    np.testing.assert_array_equal(out["w"].float().numpy(),
                                  np.asarray(jout["w"].astype(jnp.float32)))
    np.testing.assert_array_equal(err["w"].numpy(), np.asarray(jerr["w"]))


def test_int8_error_feedback_converges():
    """Error feedback: the accumulated quantisation error stays bounded and
    the running sum of compressed grads tracks the true sum
    (``tests/test_training.py``'s bound)."""
    rng = np.random.default_rng(1)
    true_sum = np.zeros(16, np.float32)
    comp_sum = np.zeros(16, np.float32)
    err = TC.init_error_state({"w": torch.zeros(16)})
    for _ in range(50):
        g = rng.normal(0, 1e-2, 16).astype(np.float32)
        true_sum += g
        out, err = TC.compress({"w": torch.as_tensor(g)}, "int8", err)
        comp_sum += out["w"].numpy()
    resid = np.abs(err["w"].numpy())
    assert np.abs(comp_sum - true_sum).max() <= resid.max() + 1e-5
    g = {"w": torch.ones(3)}
    assert TC.compress(g, "none", None) == (g, None)
    with pytest.raises(ValueError, match="unknown compression"):
        TC.compress(g, "fp4")


def test_step_builders_for_prefill_and_decode():
    """``make_prefill_step`` is ``forward_prefill``; ``make_decode_step``
    returns the argmax token of ``forward_decode``'s last logits."""
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"])
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0))
    toks = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 6)))
    assert torch.equal(TS.make_prefill_step(cfg)(params, {"tokens": toks}),
                       T.forward_prefill(params, {"tokens": toks}, cfg))
    cache = T.init_cache(cfg, 2, 8)
    batch = {"tokens": toks[:, :1], "cache_pos": 0}
    tok, _ = TS.make_decode_step(cfg)(params, cache, batch)
    logits, _ = T.forward_decode(params, cache, batch, cfg)
    assert torch.equal(tok, logits[:, -1].argmax(-1))


def _lm_trainer(cfg, plan, params, steps, ckpt_dir=None, log=lambda *_: None):
    src = SyntheticLM(cfg.vocab_size, seed=4)
    batch_fn = lambda i: {k: torch.as_tensor(v) for k, v in src.batch(i, 4, 8).items()}  # noqa: E731
    return Trainer(TS.make_train_step(cfg, plan), TS.init_train_state(params, plan),
                   batch_fn, LoopConfig(total_steps=steps, ckpt_dir=ckpt_dir,
                                        ckpt_every=100, log_every=5), log=log)


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_lm_trainer_restart_is_bit_exact(tmp_path, mode):
    """10 straight LM steps == 5 steps ended by SIGTERM (checkpoint and
    exit, the int8 error state included) + a new trainer resumed from the
    checkpoint for 5 more, bit for bit."""
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(remat="full")
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(5))
    plan = TS.TrainPlan(opt=OptConfig(lr=1e-3, warmup_steps=2, total_steps=10),
                        microbatches=2, grad_compress=mode)
    full = _lm_trainer(cfg, plan, params, 10)
    assert full.run()["step"] == 10

    def preempt_at_5(msg):
        if msg.startswith("[step 5]"):
            os.kill(os.getpid(), signal.SIGTERM)

    d = str(tmp_path / "ck")
    cut = _lm_trainer(cfg, plan, params, 10, d, preempt_at_5)
    out = cut.run()
    assert out["preempted"] and out["step"] == 5 and tck.latest_step(d) == 5
    resumed = _lm_trainer(cfg, plan, params, 10, d)
    assert resumed.maybe_resume() == 5
    assert resumed.run()["step"] == 10
    for (p, a), (_, b) in zip(tree_leaves_with_path(full.state),
                              tree_leaves_with_path(resumed.state)):
        assert torch.equal(a, b), p
    assert ("grad_err" in full.state) == (mode == "int8")


def test_launch_train_lm_on_cpu_loss_falls(capsys):
    """``python -m repro_torch.launch.train --arch qwen1.5-0.5b --preset
    tiny --device cpu``: the loss falls over 30 steps."""
    out = TL.main(["--arch", "qwen1.5-0.5b", "--preset", "tiny", "--steps", "30",
                   "--batch", "8", "--seq", "32", "--lr", "3e-3", "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert out["step"] == 30 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]
    assert "[step 30]" in capsys.readouterr().out


@pytest.mark.parametrize("argv", [
    ["--arch", "qwen2-vl-2b", "--microbatches", "2", "--grad-compress", "int8"],
    ["--arch", "musicgen-medium", "--quant", "w8a8", "--hard-acts"],
    ["--arch", "recurrentgemma-2b", "--grad-compress", "bf16", "--remat", "none"]],
    ids=["mrope-int8", "frames-w8a8-hard", "hybrid-bf16"])
def test_launch_train_lm_flags_on_cpu(argv):
    out = TL.main(argv + ["--preset", "tiny", "--steps", "3", "--batch", "4",
                          "--seq", "8", "--device", "cpu"], log=lambda *_: None)
    assert out["step"] == 3 and all(np.isfinite(h["loss"]) for h in out["history"])
    assert all(x.device.type == "cpu" for x in tree_leaves(out["state"]))


def test_launch_train_lstm_on_cpu(capsys):
    """``--arch lstm-pems``: QAT on the PeMS-like series, then the float,
    QAT and integer paths' test MSE; the loss falls and the integer path
    stays within the reference's bound (``tests/test_system.py``: below
    twice the QAT MSE, or 0.05)."""
    out = TL.main(["--arch", "lstm-pems", "--steps", "200", "--batch", "64",
                   "--device", "cpu"])
    losses = [h["loss"] for h in out["history"]]
    assert np.mean(losses[-2:]) < losses[0]
    mse = out["test_mse"]
    assert mse["int8-kernel"] < max(2 * mse["qat"], 0.05)
    assert "test MSE [int8-kernel" in capsys.readouterr().out


def test_launch_train_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        TL.main(["--arch", "qwen1.5-0.5b", "--steps", "1"])
