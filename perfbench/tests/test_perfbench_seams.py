"""``pems-steady`` reads the same through the system module's seams as it
did when the harness drew the windows, compared, counted and broke the
datapath itself: the same windows byte for byte (their digests were
taken from the harness before the seams), the same three exact numbers
and limits, the same counters, and the fault hook breaking every
callable of the server's ladder."""

import hashlib

import numpy as np
import pytest

from perfbench import compare
from perfbench.arrivals.poisson import schedule
from perfbench.bench import Spec, run_cell
from perfbench.reference import qlstm
from perfbench.systems import qlstm_server
from perfbench.traffic import Windows

SEED = 2 ** 31 + 4242
ROUNDS_SHA256 = \
    "8ad94fcdcf34ac638bc7733fc501f8f794264c1a829553bec452dceed99e14e2"
TAKE_SHA256 = \
    "e3b59054e68f6bdc82aabb2def592cb452729f254daf1e7332d3fc9abc53d35c"


def _mix():
    spec = Spec()
    return spec.mix("open8600-3200", qlstm_server, streams=300,
                    rate_per_s=3000)


def test_the_payload_is_the_windows_byte_for_byte():
    cfg, mix = Spec().config("lstm-pems"), _mix()
    got = qlstm_server.payload(cfg, mix, SEED)
    was = Windows(SEED, mix.streams, 6, 1)
    h = hashlib.sha256()
    for k in range(3):
        assert got.round(k).tobytes() == was.round(k).tobytes()
        h.update(got.round(k).tobytes())
    assert h.hexdigest() == ROUNDS_SHA256
    s = schedule(mix, SEED, 0.5)
    x = got.take(s.stream, s.k)
    assert x.shape == (1544, 6, 1) and x.dtype == np.float32
    assert hashlib.sha256(x.tobytes()).hexdigest() == TAKE_SHA256
    assert qlstm_server.answer_width(cfg) == 1


def _before(y, want, frac):
    """The comparison as the harness made it before the seams."""
    answered = ~np.isnan(y).any(axis=1)
    gap = np.abs(y[answered].astype(np.float64) * 2.0 ** frac
                 - want[answered])
    got = {"unanswered": int(np.count_nonzero(~answered)),
           "mismatched": int(np.count_nonzero(gap.max(axis=1) > 0))
           if len(gap) else 0,
           "max_code_gap": float(gap.max()) if gap.size else 0.0}
    limits = {"unanswered": 0, "mismatched": 0, "max_code_gap": 0}
    return {n: {"value": got[n], "limit": limits[n]} for n in limits}


@pytest.mark.parametrize("case", ["exact", "off", "unanswered", "none"])
def test_qlstm_is_compared_by_the_same_three_exact_numbers(case):
    cfg, mix = Spec().config("lstm-pems"), _mix()
    w = qlstm_server.make_weights(cfg, SEED, "cpu")
    s = schedule(mix, SEED, 0.2)
    x = qlstm_server.payload(cfg, mix, SEED).take(s.stream, s.k)
    want, frac = qlstm.predict(cfg, w, s.stream, s.k, x)
    y = (want * 2.0 ** -frac).astype(np.float32)
    if case == "off":
        y[::7] += 3 * 2.0 ** -frac
    elif case == "unanswered":
        y[::5] = np.nan
    elif case == "none":
        y[:] = np.nan
    got = compare.check(qlstm, cfg, w, s.stream, s.k, x, y)
    assert got == _before(y, want, frac)
    assert list(got) == ["unanswered", "mismatched", "max_code_gap"]
    assert all(c["limit"] == 0 for c in got.values())
    assert (got["mismatched"]["value"] > 0) == (case == "off")


def test_the_counters_are_the_serving_layers_snapshot():
    cfg = Spec().config("lstm-pems")
    mix = Spec().mix("open8600-3200", qlstm_server, streams=20, batch=4,
                     deadline_s=0.5)
    w = qlstm_server.make_weights(cfg, SEED, "cpu")
    _, server = qlstm_server.build_server(cfg, w, mix, "cpu")
    try:
        x = np.full((6, 1), 0.25, np.float32)
        for i in range(6):
            server.submit(i, x)
        server.drain(timeout=60)
        snap = server.metrics._snapshot()
        assert qlstm_server.counters(server) == {
            "waves": snap["n_waves"], "samples": snap["n_samples"],
            "padded_slots": snap["n_padded_slots"],
            "deadline_flushes": snap["n_deadline_flushes"],
            "compute_s_total": snap["compute_s_total"]}
        assert qlstm_server.counters(server)["samples"] == 6
    finally:
        assert not server.close(timeout=30.0)


def test_the_fault_hook_wraps_every_callable_of_the_ladder():
    class Server:
        _fns = [[("pallas", 1), ("xla", 2)], [("pallas", 3)]]

    server = Server()
    qlstm_server.inject(server, lambda fn: -fn)
    assert server._fns == [[("pallas", -1), ("xla", -2)], [("pallas", -3)]]


def test_a_planted_fault_reaches_the_datapath_through_the_hook():
    seen = []

    def fault(fn):
        def f(*args):
            seen.append(1)
            return fn(*args)
        return f

    out = run_cell("pems-steady", SEED, 0.5, False, device="cpu", fault=fault,
                   mix_overrides={"streams": 24, "batch": 8,
                                  "deadline_s": 0.5, "rate_per_s": 400})[0]
    assert out["correct"], out["checks"]
    assert len(seen) >= out["attempted"] // 8


def test_the_cluster_configuration_is_lstm_pems_with_four_replicas():
    """``lstm-pems-cluster4`` is ``lstm-pems`` field for field, with
    ``qlstm_cluster`` as its system, four replicas, the ring's settings
    and the layout among its assumptions; it loads that system, which
    takes ``qlstm_server``'s requests, weights, answer and counts by
    import."""
    spec = Spec()
    cfg, base = spec.config("lstm-pems-cluster4"), spec.config("lstm-pems")
    assert cfg.pop("system") == "qlstm_cluster" and cfg.pop("replicas") == 4
    assert (cfg.pop("vnodes"), cfg.pop("ring_seed")) == (64, 0)
    assert cfg["assumed"].pop().startswith("the layout: 4 replicas")
    assert {**cfg, "name": "lstm-pems"} == {k: v for k, v in base.items()
                                            if k != "system"}
    assert cfg["reference"] == "qlstm"
    system = spec.module("systems", "qlstm_cluster")
    for name in ("payload", "make_weights", "dims", "fmt_bits",
                 "ops_per_window", "answer_width"):
        assert getattr(system, name) is getattr(qlstm_server, name)
    for name in ("build_server", "warm", "counters", "sink", "checks",
                 "instrument", "inject"):
        assert callable(getattr(system, name))
    wl = spec.workload("pems-cluster4")
    assert (wl["config"], wl["traffic"], wl["chips"]) == \
        ("lstm-pems-cluster4", spec.workload("pems-steady")["traffic"], 1)
    assert {m["name"] for m in spec.metrics("pems-cluster4", True)} == \
        {m["name"] for m in spec.metrics("pems-steady", True)}


def test_the_clusters_ring_is_the_routers_rule():
    """The replica each stream hashes to, as ``qlstm_cluster`` computes it
    from the ring's published rule, is the one the program's router
    picks for every stream of the cell."""
    from perfbench.systems import qlstm_cluster
    from repro_torch.serving.routing import HashRing
    cfg = Spec().config("lstm-pems-cluster4")
    names = qlstm_cluster.names(cfg)
    assert names == ["r0", "r1", "r2", "r3"]
    ring = HashRing(names, vnodes=cfg["vnodes"], seed=cfg["ring_seed"])
    homes = qlstm_cluster.ring_homes(names, range(8600), cfg["vnodes"],
                                     cfg["ring_seed"])
    assert all(homes[s] == ring.route(s) for s in range(8600))
    share = np.bincount([names.index(h) for h in homes.values()]) / 8600
    assert share.min() > 0.15 and share.max() < 0.35
