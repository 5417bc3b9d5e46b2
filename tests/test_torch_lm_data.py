"""The port's LM data: ``SyntheticLM`` against the reference's array for
array (both are numpy; the port keeps its own copy), and the prefetching
``Pipeline``: order, restart from a step, errors surfacing in the
consumer, ``close`` stopping its thread (the counterparts of
``tests/test_data_analysis.py``'s).  The CUDA copy path (pinned memory, a
side stream, the copy finished before the batch is handed out) is
checked by the ``gpu`` test.  Everything here is exact."""

import threading

import numpy as np
import pytest
import torch

from repro_torch.data import Pipeline, SyntheticLM

try:  # the JAX reference; the card's machine has none
    from repro.data.lm_data import SyntheticLM as JSyntheticLM
except ImportError:
    JSyntheticLM = None


@pytest.mark.parametrize("vocab,seed,step,b,s", [
    (1000, 5, 3, 4, 8), (151936, 0, 0, 2, 16), (32, 7, 11, 3, 5),
    (256000, 1, 1000, 1, 33)])
def test_synthetic_lm_equals_reference(vocab, seed, step, b, s):
    if JSyntheticLM is None:
        pytest.skip("the JAX reference package is not installed")
    got = SyntheticLM(vocab, seed=seed).batch(step, b, s)
    want = JSyntheticLM(vocab, seed=seed).batch(step, b, s)
    assert got.keys() == want.keys() == {"tokens", "labels"}
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_array_equal(got["labels"][:, :-1], got["tokens"][:, 1:])


def test_synthetic_lm_step_keyed_determinism():
    src = SyntheticLM(1000, seed=5)
    a, b = src.batch(3, 4, 8), src.batch(3, 4, 8)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert not np.array_equal(a["tokens"], src.batch(4, 4, 8)["tokens"])
    toks = src.batch(0, 64, 64)["tokens"]
    assert toks.min() >= 0 and toks.max() < 1000


def _threads():
    return {t for t in threading.enumerate() if t.name == "pipeline-prefetch"}


def test_pipeline_prefetch_order_and_restart():
    """Batches come in step order from ``start_step``, as tensors on the
    pipeline's device, equal to the source's; a pipeline restarted at a
    later step replays the same batches; ``close`` stops the thread."""
    seen = []
    src = SyntheticLM(100, seed=1)

    def source(step):
        seen.append(step)
        return src.batch(step, 2, 4)

    p = Pipeline(source, device="cpu", start_step=10, prefetch=2)
    b0, b1, b2 = next(p), next(p), next(p)
    assert p.step == 13
    p.close()
    assert not p._thread.is_alive()
    assert seen[:3] == [10, 11, 12]
    for got, step in ((b0, 10), (b1, 11), (b2, 12)):
        want = src.batch(step, 2, 4)
        for k in want:
            assert isinstance(got[k], torch.Tensor) and got[k].device.type == "cpu"
            np.testing.assert_array_equal(got[k].numpy(), want[k])
    again = Pipeline(lambda s: src.batch(s, 2, 4), device="cpu", start_step=11)
    try:
        np.testing.assert_array_equal(next(again)["tokens"].numpy(),
                                      b1["tokens"].numpy())
    finally:
        again.close()


def test_pipeline_surfaces_source_errors_in_the_consumer():
    def source(step):
        if step == 2:
            raise KeyError("no batch 2")
        return {"x": np.full((2,), step)}

    p = Pipeline(source, device="cpu", prefetch=4)
    try:
        assert int(next(p)["x"][0]) == 0
        assert int(next(p)["x"][0]) == 1
        with pytest.raises(KeyError, match="no batch 2"):
            next(p)
    finally:
        p.close()
    assert not p._thread.is_alive()


def test_pipeline_close_stops_a_blocked_worker():
    """The worker blocks on a full queue; ``close`` still ends it and
    drops what it queued."""
    before = len(_threads())
    p = Pipeline(lambda s: {"x": np.zeros(3)}, device="cpu", prefetch=1)
    next(p)
    p.close(timeout=5)
    assert not p._thread.is_alive() and p._q.empty()
    assert len(_threads()) == before


def test_pipeline_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Pipeline(lambda s: {"x": np.zeros(1)})


@pytest.mark.gpu
def test_pipeline_copies_to_the_card_from_pinned_memory():
    """On a CUDA device the batches arrive on the card, complete, equal to
    the source, while the default stream is busy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    src = SyntheticLM(151936, seed=2)
    p = Pipeline(lambda s: src.batch(s, 8, 512), prefetch=2)
    try:
        busy = torch.randn(4096, 4096, device=dev)
        for step in range(4):
            for _ in range(4):
                busy = busy @ busy / 64.0
            got = next(p)
            want = src.batch(step, 8, 512)
            for k in want:
                assert got[k].device.type == "cuda"
                np.testing.assert_array_equal(got[k].cpu().numpy(), want[k])
    finally:
        p.close()
