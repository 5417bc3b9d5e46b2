"""LFM2-8B-A1B in the port (``configs/lfm2_8b_a1b.py``, ``models/
short_conv.py``, ``models/moe.py``'s sigmoid router and dropless
dispatch, ``transformer.forward_extend``, ``serving/sessions.py``) held
against its plain reference ``perfbench/reference/lfm2.py`` at
``reduce_config``'s size on seeded random weights.  The JAX package has
no LFM2.

Tolerances: the port and the reference both run f32 here; their sums
are taken in other orders (chunked online softmax against one softmax,
the conv's taps, the MoE's gates combined per token against an
``index_add`` per expert), so 1e-4 relative holds them.  Where the port
keeps its cache in bf16 as it serves (``init_cache``'s KV and conv
state), the cached k, v and conv inputs are rounded to bf16 (2^-9
relative) and 1e-2 relative on the logits bounds what that moves."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench.reference import lfm2 as R
from repro_torch.configs import ARCH_CONFIGS, reduce_config
from repro_torch.launch import serve
from repro_torch.launch.batcher import WaveBatcher
from repro_torch.models import moe as MOE
from repro_torch.models import transformer as T
from repro_torch.serving import SessionServer, WaveScheduler

ARCH = "lfm2-8b-a1b"
F32_REL = 1e-4
BF16_CACHE_REL = 1e-2


def _cfg(dtype="float32"):
    return reduce_config(ARCH_CONFIGS[ARCH]).replace(dtype=dtype)


def hf(cfg):
    """The published config's keys, as the reference reads them."""
    return dict(
        hidden_size=cfg.d_model, vocab_size=cfg.vocab_size,
        layer_types=["conv" if k == "conv" else "full_attention"
                     for k in cfg.layer_kinds()],
        num_dense_layers=cfg.num_dense_layers, intermediate_size=cfg.d_ff,
        num_experts=cfg.moe.num_experts, num_experts_per_tok=cfg.moe.top_k,
        moe_intermediate_size=cfg.moe.d_ff, conv_L_cache=cfg.conv_width,
        norm_eps=cfg.norm_eps, rope_theta=cfg.attn.rope_theta,
        routed_scaling_factor=1, use_expert_bias=True,
        num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads)


def _params(cfg, seed=0, bias=0.1):
    """The port's init, with the expert bias drawn (the init's is 0) and
    the norms moved off 1, so that both act."""
    gen = torch.Generator().manual_seed(seed)
    params, _ = T.init_model(cfg, gen)
    for layer in params["layers"]:
        for name in ("ln1", "ln2"):
            layer[name].uniform_(0.5, 1.5, generator=gen)
        if "expert_bias" in layer["mlp"]:
            layer["mlp"]["expert_bias"].normal_(0.0, bias, generator=gen)
    return params


def _rel(a, b):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    return float((a - b).norm() / b.norm())


def _f32_cache(cfg, rows, positions):
    return {k: v.float() for k, v in T.init_cache(cfg, rows, positions).items()}


# ---------------------------------------------------------------------------
# the configuration
# ---------------------------------------------------------------------------

def test_published_config_and_counts():
    """24 layers (18 conv, 6 attention at 2, 6, 10, 14, 18, 21), layers
    0-1 dense, 8.34 B parameters with the head tied, 1.56 B active."""
    cfg = ARCH_CONFIGS[ARCH]
    kinds = cfg.layer_kinds()
    assert [i for i, k in enumerate(kinds) if k == "attn"] == \
        [2, 6, 10, 14, 18, 21]
    assert kinds.count("conv") == 18 and cfg.head_dim * cfg.n_heads == 2048
    assert [cfg.moe_layer(i) for i in range(24)] == [False] * 2 + [True] * 22
    assert round(T.num_params(cfg) / 1e9, 2) == 8.34
    assert round(T.num_active_params(cfg) / 1e9, 2) == 1.56
    small = reduce_config(cfg)
    assert {"conv", "attn"} <= set(small.layer_kinds())
    assert not small.moe_layer(0) and small.moe_layer(small.n_layers - 1)


def test_cache_spec_holds_conv_state_beside_kv():
    """(18, B, 2, 2048) bf16 conv state (147 KB a session) beside the
    (6, B, S, 8, 64) KV (12,288 bytes a token a session)."""
    spec = T.cache_spec(ARCH_CONFIGS[ARCH], 256, 8192)
    assert spec["conv"][:2] == ((18, 256, 2, 2048), torch.bfloat16)
    assert spec["k"][0] == spec["v"][0] == (6, 256, 8192, 8, 64)
    assert 18 * 2 * 2048 * 2 == 147456 and 2 * 6 * 8 * 64 * 2 == 12288


def test_reference_imports_only_torch_and_numpy():
    """The plain reference is a file of its own that imports nothing of
    the port (nor of the benchmark around it)."""
    tree = ast.parse(Path(R.__file__).read_text())
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0}
    assert names <= {"__future__", "typing", "numpy", "torch"}


# ---------------------------------------------------------------------------
# the model against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("t", [1, 9, 40])
def test_prefill_logits_match_reference(t):
    cfg = _cfg()
    params = _params(cfg)
    toks = np.random.default_rng(t).integers(0, cfg.vocab_size, (2, t))
    got = T.forward_prefill(params, {"tokens": torch.as_tensor(toks)}, cfg)
    for b in range(2):
        want = R.forward(hf(cfg), params, toks[b], [t - 1])[0]
        assert _rel(got[b, 0], want) < F32_REL


def test_ragged_extend_then_decode_match_reference():
    """Three rows extended by ragged chunks at their own positions (one
    row twice idle), then decode steps through ``forward_decode``: every
    row's logits after every call against the reference's full forward
    of that row's tokens so far."""
    cfg = _cfg()
    params = _params(cfg, seed=1)
    rng = np.random.default_rng(2)
    seqs = [rng.integers(0, cfg.vocab_size, 40) for _ in range(3)]
    cache = _f32_cache(cfg, 3, 48)
    at = [0, 0, 0]
    for chunk in ({0: 5, 1: 1, 2: 17}, {2: 3, 0: 11}, {1: 20, 0: 1},
                  {1: 2, 2: 9, 0: 12}):
        rows = list(chunk)
        toks = np.concatenate([seqs[r][at[r]:at[r] + n]
                               for r, n in chunk.items()])
        got = T.forward_extend(params, cache, {
            "tokens": torch.as_tensor(toks), "rows": rows,
            "starts": [at[r] for r in rows], "lens": list(chunk.values())},
            cfg)
        for i, r in enumerate(rows):
            at[r] += chunk[r]
            want = R.forward(hf(cfg), params, seqs[r][:at[r]], [at[r] - 1])
            assert _rel(got[i], want[0]) < F32_REL, (chunk, r)
    # rows 0 and 2, both at position 29, continue by decode steps
    assert at == [29, 23, 29]
    cache = {k: v[:, [0, 2]].clone() for k, v in cache.items()}
    seq = [seqs[0][:29], seqs[2][:29]]
    for pos in range(29, 33):
        nxt = rng.integers(0, cfg.vocab_size, 2)
        logits, cache = T.forward_decode(params, cache, {
            "tokens": torch.as_tensor(nxt[:, None]), "cache_pos": pos}, cfg)
        seq = [np.r_[s, t] for s, t in zip(seq, nxt)]
        for b in range(2):
            want = R.forward(hf(cfg), params, seq[b], [pos])[0]
            assert _rel(logits[b, 0], want) < F32_REL, (pos, b)


def test_packed_attention_route_gathers_each_rows_cache(monkeypatch):
    """The card's route: every row's cached k, v gathered packed
    (``kv_at``) and one call over the rows' offsets, here with the flash
    call emulated row by row, gives the per-row route's logits."""
    cfg = _cfg()
    params = _params(cfg, seed=13)
    rng = np.random.default_rng(13)
    seqs = [rng.integers(0, cfg.vocab_size, 30) for _ in range(3)]

    def emulated(q, k, v, cu_q, cu_k, max_q, max_k, scale):
        cq, ck = cu_q.tolist(), cu_k.tolist()
        assert max_q == max(b - a for a, b in zip(cq, cq[1:]))
        assert max_k == max(b - a for a, b in zip(ck, ck[1:]))
        return torch.cat([T._lower_right(q[a:b], k[c:e], v[c:e], scale)
                          for a, b, c, e in zip(cq, cq[1:], ck, ck[1:])])

    def run(packed):
        meta_fn = T._ragged_meta
        monkeypatch.setattr(T, "_ragged_meta", lambda *a: meta_fn(
            *a[:-1], packed))
        cache = _f32_cache(cfg, 4, 32)
        outs = []
        at = [0, 0, 0]
        for chunk in ({0: 7, 2: 1, 1: 12}, {1: 5, 0: 9}, {2: 20, 0: 1}):
            rows = list(chunk)
            toks = np.concatenate([seqs[r][at[r]:at[r] + n]
                                   for r, n in chunk.items()])
            outs.append(T.forward_extend(params, cache, {
                "tokens": torch.as_tensor(toks), "rows": [r + 1 for r in rows],
                "starts": [at[r] for r in rows],
                "lens": list(chunk.values())}, cfg))
            for r in rows:
                at[r] += chunk[r]
        return outs
    monkeypatch.setattr(T, "_varlen", emulated)
    for got, want in zip(run(True), run(False)):
        assert _rel(got, want) < F32_REL


def test_decode_leaves_the_cache_passed_in_as_it_was():
    cfg = _cfg()
    params = _params(cfg)
    cache = T.init_cache(cfg, 2, 16)
    before = {k: v.clone() for k, v in cache.items()}
    _, new = T.forward_decode(params, cache, {
        "tokens": torch.tensor([[3], [4]]), "cache_pos": 0}, cfg)
    assert all(torch.equal(before[k], cache[k]) for k in cache)
    assert not torch.equal(new["k"], cache["k"])


def test_bf16_cache_extend_stays_near_reference():
    """As served: bf16 cache entries, f32 activations."""
    cfg = _cfg()
    params = _params(cfg, seed=3)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, 30)
    cache = T.init_cache(cfg, 1, 32)
    for a, n in ((0, 12), (12, 1), (13, 17)):
        got = T.forward_extend(params, cache, {
            "tokens": torch.as_tensor(toks[a:a + n]), "rows": [0],
            "starts": [a], "lens": [n]}, cfg)
    assert _rel(got[0], R.forward(hf(cfg), params, toks, [29])[0]) \
        < BF16_CACHE_REL


# ---------------------------------------------------------------------------
# the router and the dropless dispatch
# ---------------------------------------------------------------------------

def test_bias_changes_selection_but_not_gates():
    """A bias that lifts expert 0 into the top k selects it; the gates
    are the unbiased sigmoid scores of the chosen experts over their sum
    (+1e-6); the order is a stable sort."""
    cfg = _cfg()
    m = cfg.moe
    d = cfg.d_model
    logits = torch.tensor([[-3.0, 2.0, 1.0, 0.5, 0.2, 0.1, -1.0, -2.0]])
    router = torch.linalg.lstsq(torch.ones(1, d) / d ** 0.5,
                                logits).solution
    x = torch.ones(1, d) / d ** 0.5
    p = {"router": router, "expert_bias": torch.zeros(m.num_experts)}
    gates, idx = MOE.route_sigmoid(p, x, cfg)
    assert idx.tolist() == [[1, 2, 3, 4]]
    p["expert_bias"] = torch.tensor([5.0] + [0.0] * (m.num_experts - 1))
    gates, idx = MOE.route_sigmoid(p, x, cfg)
    assert idx.tolist() == [[0, 1, 2, 3]]
    s = torch.sigmoid(logits[0, [0, 1, 2, 3]])
    assert torch.allclose(gates[0], s / (s.sum() + 1e-6), rtol=1e-6)
    assert abs(float(gates.sum()) - 1.0) < 1e-5


def test_dropless_when_every_token_claims_one_expert():
    """64 tokens all routed to expert 5 first: every claim is computed
    (no capacity drops), expert 5 takes 64, and the output equals the
    reference's exact top-k."""
    cfg = _cfg()
    params = _params(cfg, seed=4)
    layer = params["layers"][1]["mlp"]
    layer["expert_bias"].zero_()
    layer["expert_bias"][5] = 10.0
    x = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(5))
    claims = torch.zeros(cfg.moe.num_experts, dtype=torch.int64)
    y = MOE.moe_dropless(layer, x, cfg, claims)
    assert int(claims[5]) == 64 and int(claims.sum()) == 64 * cfg.moe.top_k
    want = R._moe(x, layer, hf(cfg), lambda t: t.float())
    assert _rel(y, want) < F32_REL


def test_expert_products_compute_only_the_claims():
    """One product per expert that has claims, over its claims alone."""
    cfg = _cfg()
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff
    g = torch.Generator().manual_seed(6)
    wg, wu = torch.randn(e, d, f, generator=g), torch.randn(e, d, f, generator=g)
    wd = torch.randn(e, f, d, generator=g)
    counts = torch.tensor([3, 0, 0, 5, 1, 0, 0, 2])
    xs = torch.randn(int(counts.sum()), d, generator=g)
    seen = []
    act = torch.nn.functional.silu

    def counting(t):
        seen.append(t.shape[0])
        return act(t)
    out = MOE.expert_products(xs, counts, wg, wu, wd, counting)
    assert seen == [3, 5, 1, 2]
    at = 0
    for ex, n in enumerate(counts.tolist()):
        rows = xs[at:at + n]
        ref = R._swiglu(rows, wg[ex], wu[ex], wd[ex])
        assert _rel(out[at:at + n], ref) < F32_REL if n else True
        at += n


# ---------------------------------------------------------------------------
# the session server
# ---------------------------------------------------------------------------

def _served(cfg, params, turns, *, sessions, positions, batch, f32=True):
    srv = SessionServer(params, cfg, max_sessions=sessions,
                        max_positions=positions, batch=batch,
                        deadline_s=0.005, device="cpu")
    if f32:
        srv.table = {k: v.float() for k, v in srv.table.items()}
    for j in range(max(len(t) for t in turns.values())):
        for s, ts in turns.items():
            if j < len(ts):
                srv.submit(s, ts[j])
    srv.flush(timeout=120)
    res = srv.poll()
    counters = srv.counters()
    assert srv.close() == []
    return res, counters


def test_session_turns_with_restarts_match_one_forward_per_session():
    """Five sessions over a 3-row table of 24 positions (LRU rows, so two
    sessions are evicted and start over), turns of 1-9 tokens, waves of
    2: each turn's last logits against the reference's full forward of
    its session (history, turns, a new chat where a turn would pass 24
    positions or the row was taken)."""
    cfg = _cfg()
    params = _params(cfg, seed=7)
    rng = np.random.default_rng(7)
    turns = {s: [rng.integers(0, cfg.vocab_size, rng.integers(1, 10))
                 for _ in range(6)] for s in range(3)}
    res, c = _served(cfg, params, turns, sessions=3, positions=24, batch=2)
    assert len(res) == 18 and all(r.error is None for r in res)
    assert c["restarts"] >= 2 and c["tokens"] == sum(
        len(t) for ts in turns.values() for t in ts)
    assert c["samples"] == 18 and c["waves"] >= 9
    for s, ts in turns.items():
        got = np.stack([r.y for r in sorted(
            (r for r in res if r.stream_id == s), key=lambda r: r.seq)])
        want = R.session_logits(hf(cfg), params, [], ts, 24)
        assert _rel(got, want) < F32_REL, s


def test_session_server_counts_context_and_claims():
    cfg = _cfg()
    params = _params(cfg, seed=8)
    turns = {0: [np.arange(5) % cfg.vocab_size, np.arange(3)],
             1: [np.arange(2)]}
    res, c = _served(cfg, params, turns, sessions=2, positions=16, batch=2)
    # session 0: 5 tokens from 0 (1+..+5), then 3 from 5 (6+7+8);
    # session 1: 2 tokens from 0 (1+2)
    assert c["attn_ctx_tokens"] == 15 + 21 + 3
    assert c["tokens"] == 10 and c["padded_tokens"] == 0
    n_moe = cfg.n_layers - cfg.num_dense_layers
    assert np.asarray(c["expert_claims"]).shape == (n_moe, cfg.moe.num_experts)
    assert np.asarray(c["expert_claims"]).sum(1).tolist() == \
        [10 * cfg.moe.top_k] * n_moe


def test_session_server_answers_at_report_ids_and_times_sections():
    """Answers at ``report_ids``, then the row's max and argmax; the
    extend call's sections open in turn, and with the probe's ``marks``
    on (on the card; forced here) each MoE section, and only those, is
    bracketed by its two marks, the begin mark before the layer's claims
    and the end mark after them, for the device trace to time."""
    cfg = _cfg()
    params = _params(cfg, seed=9)
    ids = torch.tensor([3, 7, 100])
    srv = SessionServer(params, cfg, max_sessions=2, max_positions=16,
                        batch=2, deadline_s=0.005, device="cpu",
                        report_ids=ids)
    probe, seen, marks = srv.probe, [], []
    section = probe.section
    probe.section = lambda name: seen.append(name) or section(name)
    probe.marks = probe.on_card = True
    probe.begin = lambda: marks.append(("begin", int(probe.claims.sum())))
    probe.end = lambda: marks.append(("end", int(probe.claims.sum())))
    toks = np.arange(6) % cfg.vocab_size
    srv.submit("a", toks)
    srv.flush(timeout=60)
    (r,) = srv.poll()
    srv.close()
    cache = T.init_cache(cfg, 1, 16)
    full = T.forward_extend(params, cache, {
        "tokens": torch.as_tensor(toks), "rows": [0], "starts": [0],
        "lens": [6]}, cfg)[0]
    assert np.allclose(r.y[:3], full[ids].numpy(), rtol=1e-5)
    assert r.y[3] == pytest.approx(float(full.max()), rel=1e-5)
    assert r.y[4] == float(full.argmax())
    assert {"lfm2.conv", "lfm2.attn", "lfm2.moe", "lfm2.mlp",
            "lfm2.extend"} <= set(seen)
    n_moe, claims = seen.count("lfm2.moe"), 6 * cfg.moe.top_k
    assert n_moe == cfg.n_layers - cfg.num_dense_layers
    assert marks == [(w, claims * (i + (w == "end"))) for i in range(n_moe)
                     for w in ("begin", "end")]


def test_session_server_refuses_bad_turns():
    cfg = _cfg()
    srv = SessionServer(_params(cfg), cfg, max_sessions=1, max_positions=8,
                        batch=1, deadline_s=0.005, device="cpu")
    try:
        for bad in (np.zeros(0, np.int64), np.zeros(9, np.int64),
                    np.array([cfg.vocab_size]), np.zeros((2, 2), np.int64),
                    np.array([0.5])):
            with pytest.raises(ValueError):
                srv.submit(0, bad)
    finally:
        srv.close()


def test_pems_wave_assembly_unchanged_by_the_assemble_hook():
    """``StreamServer``'s waves (no ``assemble``): the real windows padded
    to ``batch`` by repeating the last and stacked, byte for byte as
    before; with ``assemble=list`` the wave is the real rows alone."""
    waves = []
    rng = np.random.default_rng(11)
    windows = [rng.random((6, 1), dtype=np.float32) for _ in range(5)]
    for assemble in (None, list):
        got = []
        sched = WaveScheduler(8, got.append, one_per_stream=True,
                              deadline_s=None, assemble=assemble)
        for i, w in enumerate(windows):
            sched.submit(i, w, lambda: 0)
        sched.flush(timeout=10)
        assert sched.close() == []
        waves.append(got)
    (stacked,), (ragged,) = waves
    want = np.stack(windows + [windows[-1]] * 3)
    assert stacked.x.dtype == np.float32 and stacked.x.shape == (8, 6, 1)
    assert stacked.x.tobytes() == want.tobytes()
    assert [w.tobytes() for w in ragged.x] == [w.tobytes() for w in windows]
    assert [s.stream_id for s in stacked.slots] == list(range(5))


# ---------------------------------------------------------------------------
# the other serving entry points
# ---------------------------------------------------------------------------

def test_wave_batcher_serves_lfm2_through_decode():
    """``WaveBatcher`` (``forward_decode``) generates for each request what
    greedy decoding through the reference's full forward gives."""
    cfg = _cfg()
    params = _params(cfg, seed=12)
    wb = WaveBatcher(params, cfg, batch_size=2, max_seq=16)
    prompts = [np.array([5, 9, 2], np.int32), np.array([7, 1], np.int32)]
    rids = [wb.submit(p, max_new=4) for p in prompts]
    out = wb.run()
    for rid, p in zip(rids, prompts):
        seq = list(p)
        for _ in range(4):
            logits = R.forward(hf(cfg), params, seq, [len(seq) - 1])[0]
            seq.append(int(logits.argmax()))
        assert out[rid] == seq[len(p):]


def test_serve_launcher_runs_lfm2(capsys):
    toks = serve.main(["--arch", ARCH, "--device", "cpu", "--gen", "4"])
    assert toks.shape == (4, 4)
    assert "lfm2-8b-a1b (4L d=64)" in capsys.readouterr().out
