"""The port's ``WaveBatcher`` (``launch/batcher.py``) against the JAX
package's: LM lockstep wave decoding over ``forward_decode`` (float and
w8a8 serve weights; the w8a8 ``linear``'s int8 product runs the integer
GEMM's plain version here, K4 on the card) and the LSTM-accelerator mode
over ``serve_windows``, plus the counterparts of ``tests/test_batcher.py``.

The port's batcher feeds each slot its own tokens as soon as its prompt
ends, so every slot equals its batch-of-one run; the reference's starts
every slot's output at the wave's longest prompt, so only those slots do
(``launch/batcher.py``'s docstring).  So the port's batched tokens are
held against the reference's batch-of-one runs for every request, and
against its batched run for the slots with their wave's longest prompt.

Cross-package token comparisons run the model in f32 on the reference's
weights carried across (``convert.lm_params_from_reference``): the two
frameworks' logits then agree to ~1e-5, far inside the gap between the
best and the second-best token at these seeds, so the greedy tokens are
equal; that gap is asserted, never assumed.  The accelerator mode's rows
are integer-datapath outputs: bit for bit."""

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.convert import lm_params_from_reference, params_from_reference
from repro_torch.core.quant import QuantConfig
from repro_torch.launch.batcher import WaveBatcher
from repro_torch.models import transformer as T

try:  # the JAX reference; the card's machine has none
    import jax
    import repro
    from repro.configs import ARCH_CONFIGS as J_ARCHS
    from repro.configs import reduce_config as j_reduce
    from repro.core.quant import QuantConfig as JQuantConfig
    from repro.launch.batcher import WaveBatcher as JWaveBatcher
    from repro.models import transformer as JT
except ImportError:
    jax = None

REQUESTS = [(3, 4), (5, 2), (2, 6), (4, 3), (3, 3)]   # (prompt len, max_new): 2 waves
MIN_TOP2_GAP = 1e-3


@pytest.fixture(scope="module")
def ref():
    if jax is None:
        pytest.skip("the JAX reference package is not installed")


def _prompts(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, n).astype(np.int32), m)
            for n, m in REQUESTS]


def _run(batcher, prompts):
    rids = [batcher.submit(p, max_new=m) for p, m in prompts]
    out = batcher.run()
    return [out[r] for r in rids]


def _tiny(dtype="bfloat16"):
    cfg = reduce_config(ARCH_CONFIGS["qwen1.5-0.5b"]).replace(remat="none",
                                                              dtype=dtype)
    params, _ = T.init_model(cfg, torch.Generator().manual_seed(0))
    return cfg, params


def test_wave_batcher_drains_mixed_requests():
    cfg, params = _tiny()
    b = WaveBatcher(params, cfg, batch_size=4, max_seq=32)
    outs = _run(b, _prompts(cfg))
    assert [len(o) for o in outs] == [m for _, m in REQUESTS]
    assert all(0 <= t < cfg.vocab_size for o in outs for t in o)
    assert not b.queue


def test_wave_batcher_matches_single_request():
    """A batched slot produces the same tokens as a batch-of-one run,
    whatever the lengths of the other prompts in its wave."""
    cfg, params = _tiny()
    reqs = [(np.asarray([5, 9, 11], np.int32), 5), (np.asarray([1, 2], np.int32), 5),
            (np.asarray([7], np.int32), 6)]
    got = _run(WaveBatcher(params, cfg, batch_size=3, max_seq=32), reqs)
    for r, g in zip(reqs, got):
        (want,) = _run(WaveBatcher(params, cfg, batch_size=1, max_seq=32), [r])
        assert g == want


def test_wave_batcher_eos_and_budget():
    cfg, params = _tiny()
    b = WaveBatcher(params, cfg, batch_size=2, max_seq=32)
    (first,) = _run(b, [(np.asarray([4, 2], np.int32), 6)])
    eos = first[2]
    rid = b.submit(np.asarray([4, 2], np.int32), 6, eos_id=eos)
    cut = b.run()[rid]
    assert cut == first[:first.index(eos) + 1]
    b.submit(np.zeros(30, np.int32), max_new=8)
    with pytest.raises(ValueError, match="max_seq"):
        b.run()
    with pytest.raises(ValueError, match="max_seq"):
        WaveBatcher(params, cfg, max_seq=0)
    with pytest.raises(TypeError, match="ModelConfig"):
        WaveBatcher(params, None, max_seq=8)


def _ref_model(arch, quant=None):
    kw = dict(remat="none", dtype="float32")
    jcfg = j_reduce(J_ARCHS[arch]).replace(**kw)
    tcfg = reduce_config(ARCH_CONFIGS[arch]).replace(**kw)
    jp, jaxes = JT.init_model(jcfg, jax.random.key(0))
    if quant:
        jcfg = jcfg.replace(quant=JQuantConfig(quant))
        tcfg = tcfg.replace(quant=QuantConfig(quant))
        jp, _ = JT.quantize_model_params(jp, jaxes, jcfg)
    return jcfg, tcfg, jp, lm_params_from_reference(jax.tree.map(np.asarray, jp))


@pytest.mark.usefixtures("ref")
@pytest.mark.parametrize("arch,quant", [("qwen1.5-0.5b", None),
                                        ("qwen1.5-0.5b", "w8a8"),
                                        ("qwen2-vl-2b", None),
                                        ("recurrentgemma-2b", None)])
def test_wave_batcher_tokens_equal_reference(arch, quant):
    """The same requests (two waves of four, one padded): the port's
    batched tokens equal the reference's batch-of-one run of each request,
    and its batched run for the slots with their wave's longest prompt;
    with w8a8 serve weights the port's decode runs one integer product per
    quantised linear."""
    jcfg, tcfg, jp, tp = _ref_model(arch, quant)
    prompts = _prompts(tcfg, seed=3)
    want_batched = _run(JWaveBatcher(jp, jcfg, batch_size=4, max_seq=16), prompts)
    want = [_run(JWaveBatcher(jp, jcfg, batch_size=1, max_seq=16), [r])[0]
            for r in prompts]
    tb = WaveBatcher(tp, tcfg, batch_size=4, max_seq=16)
    from repro_torch.kernels import quant_matmul as qm
    real, calls = qm.quant_matmul, []

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    gaps = []
    real_decode = tb._decode

    def gap_recording(cache, tokens, pos):
        b = {"tokens": torch.as_tensor(tokens), "cache_pos": pos}
        if tcfg.attn and tcfg.attn.mrope_sections:
            b["position_ids"] = torch.full((3, 4, 1), pos, dtype=torch.int32)
        logits, _ = T.forward_decode(tp, cache, b, tcfg)
        top2 = torch.topk(logits[:, -1], 2, dim=-1).values
        gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
        return real_decode(cache, tokens, pos)

    tb._decode = gap_recording
    qm.quant_matmul = counting
    try:
        got = _run(tb, prompts)
    finally:
        qm.quant_matmul = real
    assert min(gaps) > MIN_TOP2_GAP, f"near-tie in the greedy choice: {min(gaps)}"
    assert got == want
    for w0 in (0, 4):   # the waves
        wave = range(w0, min(w0 + 4, len(prompts)))
        longest = max(len(prompts[i][0]) for i in wave)
        for i in wave:
            if len(prompts[i][0]) == longest:
                assert got[i] == want_batched[i]
    assert (len(calls) > 0) == (quant == "w8a8")


@pytest.mark.usefixtures("ref")
def test_for_accelerator_rows_equal_reference():
    """LSTM-accelerator mode: windows in, the integer datapath's rows out,
    equal to the reference's batcher on the same params (bit for bit),
    over a padded last wave."""
    jsess = repro.build(seed=0).quantize()
    params = params_from_reference(jax.tree.map(np.asarray, jsess.params))
    tsess = repro_torch.build(params=params, device="cpu").quantize()
    rng = np.random.default_rng(4)
    windows = rng.normal(0, 0.7, (11, 6, 1)).astype(np.float32)
    jb = JWaveBatcher.for_accelerator(jsess, batch_size=4)
    tb = WaveBatcher.for_accelerator(tsess, batch_size=4)
    jr = [jb.submit_window(w) for w in windows]
    tr = [tb.submit_window(w) for w in windows]
    jout, tout = jb.run(), tb.run()
    assert len(tout) == len(windows)
    want = tsess.infer(windows, path="int").numpy()
    for i, (a, b) in enumerate(zip(jr, tr)):
        np.testing.assert_array_equal(tout[b], np.asarray(jout[a]))
        np.testing.assert_array_equal(tout[b], want[i])
    cfg, params = _tiny()
    with pytest.raises(RuntimeError, match="for_accelerator"):
        WaveBatcher(params, cfg, max_seq=8).submit_window(windows[0])
