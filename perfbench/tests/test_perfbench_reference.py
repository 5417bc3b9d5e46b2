"""The plain reference against the port's own engines on the CPU: the
``ref`` engine for the paper's pipelined datapath, the ``xla`` engine
for the per-step baseline (the ``ref`` engine does not run it), each
stream's windows in order with the carry between them."""

import numpy as np
import pytest
import torch

from perfbench.bench import Spec
from perfbench.reference import qlstm
from perfbench.systems import qlstm_server as sut
from perfbench.traffic import Windows

import repro_torch


def _port_codes(cfg, weights, backend, stream, k, x):
    """The port's stateful engine window by window on the CPU, each
    stream's carry kept between its windows: (n, P) output codes."""
    from repro_torch.core.accelerator import AcceleratorConfig
    from repro_torch.core.fixed_point import FixedPointConfig
    from repro_torch.core.qlstm import ActivationConfig, QLSTMConfig
    mc, ac = cfg["model"], cfg["accelerator"]
    model = QLSTMConfig(acts=ActivationConfig(gate=mc["gate"],
                                              cell=mc["cell_act"]))
    a, b = sut.fmt_bits(cfg)
    accel = AcceleratorConfig(hs_method=ac["hs_method"],
                              alu_mode=ac["alu_mode"],
                              fxp=FixedPointConfig(a, b))
    t = lambda n: torch.as_tensor(weights[n])
    sess = repro_torch.build(model, accel, device="cpu", params={
        "layers": [{"w_x": t("w_x"), "w_h": t("w_h"), "b": t("b")}],
        "dense": {"w": t("w_d"), "b": t("b_d")}}).quantize()
    fn = sess.compiled_stateful(backend)
    carry = {}
    out = np.zeros((len(stream), 1), np.int64)
    for kk in np.unique(k):
        rows = np.flatnonzero(k == kk)
        st = [carry.get(int(s), (np.zeros(20, np.int32),) * 2)
              for s in stream[rows]]
        state = ((torch.as_tensor(np.stack([h for h, _ in st])),
                  torch.as_tensor(np.stack([c for _, c in st]))),)
        y, ((h, c),) = fn(torch.as_tensor(x[rows]), state)
        for j, s in enumerate(stream[rows]):
            carry[int(s)] = (h[j].numpy(), c[j].numpy())
        out[rows] = np.round(y.numpy() * 2 ** a).astype(np.int64)
    return out


# The related work's design (Table 4, [15]): (8,16) codes, HardSigmoid*
# as a full table, the per-step ALU; the port runs it on its ``xla``
# engine only.
PER_STEP = {"hs_method": "1to1", "alu_mode": "per_step", "fxp": [8, 16]}


@pytest.mark.parametrize("accel,backend,scale", [
    ({}, "ref", 1.0), ({}, "ref", 3.0),
    (PER_STEP, "xla", 1.0), (PER_STEP, "xla", 3.0)])
def test_reference_equals_the_ports_engine(accel, backend, scale):
    cfg = Spec().config("lstm-pems")
    cfg["accelerator"] = {**cfg["accelerator"], **accel}
    cfg["weights"] = {**cfg["weights"], "scale": scale}
    w = sut.make_weights(cfg, 987654321987, "cpu")
    rng = np.random.default_rng(5)
    streams, per = 24, 5
    stream = np.tile(rng.permutation(streams), per)
    k = np.repeat(np.arange(per), streams)
    x = Windows(77, streams, 6, 1).take(stream, k)
    x = x * 3.0 - 1.0 if scale > 1 else x      # reach the input clamp too
    want, frac = qlstm.predict(cfg, w, stream, k, x)
    assert frac == sut.fmt_bits(cfg)[0]
    got = _port_codes(cfg, w, backend, stream, k, x)
    assert np.array_equal(got, want)
    assert len(np.unique(want)) > 5            # not a trivial output


def test_carry_is_kept_per_stream():
    """Running each stream alone gives the same codes as interleaved."""
    cfg = Spec().config("lstm-pems")
    w = sut.make_weights(cfg, 3, "cpu")
    stream = np.array([2, 0, 1, 0, 2, 1, 1, 0])
    k = np.array([0, 0, 0, 1, 1, 1, 2, 2])
    x = Windows(9, 3, 6, 1).take(stream, k)
    model = qlstm.model_of(cfg)
    both = qlstm.run_streams(model, w, stream, k, x)
    for s in range(3):
        sel = stream == s
        alone = qlstm.run_streams(model, w, stream[sel], k[sel], x[sel])
        assert np.array_equal(alone, both[sel])
