"""``lfm2_sessions``: LFM2-8B-A1B serving chat sessions through
``repro_torch.serving.SessionServer``; a configuration's file in, a warm
server out.

A configuration that names this system gives the published config's
keys (``perfbench/configs/lfm2-8b-a1b.json``), the activation dtype, how
the weights are drawn (``weights``), how many vocabulary ids an answer
reports (``answer_ids``) and how many sessions the reference recomputes
(``compare_sessions``).  The port's ``ModelConfig`` is built from those
keys, so the file is the configuration as run.

Requests are chat turns: session ``s``'s turn ``k`` is ``turn_min`` to
``turn_max`` token ids, log-uniform, drawn from the seed; before the
measured window each session's history of ``history_min`` to
``history_max`` tokens (uniform) is prefilled through the same server
path.  A session's table row holds ``max_positions`` positions; a turn
that would pass them starts the session over (``SessionServer``).  An
answer is the turn's last-token logits at ``answer_ids`` vocabulary ids
drawn from the seed, then that row's max logit and argmax.

Its counters are ``SessionServer.counters()``; its spans the compute
thread's wave (``server.execute``), within it the datapath (the extend
call, ``DATAPATH``), and the assembler's wave (``server.assemble``);
``instrument`` also has the server mark its MoE sections on the device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.traffic import seed64

PARAMS = ("max_positions", "history_min", "history_max", "turn_min",
          "turn_max")
DATAPATH = "server.datapath"
SPANS = (DATAPATH, "server.execute", "server.assemble")


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` from the published keys."""
    from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig
    kinds = tuple("attn" if t == "full_attention" else t
                  for t in cfg["layer_types"])
    if set(kinds) - {"conv", "attn"} or cfg["conv_bias"] \
            or not cfg["norm_topk_prob"] or not cfg["use_expert_bias"] \
            or cfg["routed_scaling_factor"] != 1 \
            or not cfg["tie_word_embeddings"]:
        raise ValueError("lfm2_sessions runs LFM2's conv and attention "
                         "blocks, no conv bias, a renormalised top-k on "
                         "biased scores at scale 1, a tied head")
    d, h = cfg["hidden_size"], cfg["num_attention_heads"]
    return ModelConfig(
        name=cfg["name"], family="moe", n_layers=cfg["num_hidden_layers"],
        d_model=d, n_heads=h, n_kv_heads=cfg["num_key_value_heads"],
        head_dim=d // h, d_ff=cfg["intermediate_size"],
        vocab_size=cfg["vocab_size"], act="silu", mlp_type="swiglu",
        tie_embeddings=True, dtype=cfg["dtype"],
        attn=AttnConfig(rope_theta=float(cfg["rope_theta"]), qk_norm=True),
        moe=MoEConfig(num_experts=cfg["num_experts"],
                      top_k=cfg["num_experts_per_tok"],
                      d_ff=cfg["moe_intermediate_size"], router="sigmoid"),
        layer_types=kinds, num_dense_layers=cfg["num_dense_layers"],
        conv_width=cfg["conv_L_cache"], norm_eps=cfg["norm_eps"])


def _std(path: str, shape, w: Dict) -> float:
    """A leaf's draw: the embedding ``embed_std``, the expert bias
    ``expert_bias_std``, the conv taps 3^-0.5, every other matrix
    fan_in^-0.5 (its first dim after the experts'), the FFNs' output
    projections (``w_down``, dense and experts) that times
    ``ffn_out_scale``; 0 for norms (ones)."""
    leaf = path.rsplit("/", 1)[-1]
    if leaf == "embed":
        return w["embed_std"]
    if leaf == "expert_bias":
        return w["expert_bias_std"]
    if leaf == "conv_w":
        return shape[0] ** -0.5
    if len(shape) < 2:
        return 0.0
    std = shape[-2 if leaf.startswith("w_") and len(shape) == 3 else 0] \
        ** -0.5
    return std * w["ffn_out_scale"] if leaf == "w_down" else std


def make_weights(cfg: Dict, seed: int, device) -> Dict:
    """``{"params", "seed", "answer_ids"}``: the port's parameter tree in
    the configuration's dtype, each leaf drawn on ``device`` from one
    generator seeded with ``seed``, and the vocabulary ids an answer
    reports, drawn from the seed."""
    from repro_torch.models import transformer as T
    mcfg = model_config(cfg)
    dt = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def draw(tree, path=""):
        if isinstance(tree, dict):
            return {k: draw(v, f"{path}/{k}") for k, v in tree.items()}
        if isinstance(tree, list):
            return [draw(v, f"{path}/{i}") for i, v in enumerate(tree)]
        std = _std(path, tuple(tree.shape), cfg["weights"])
        if std == 0.0:
            return torch.ones(tree.shape, dtype=dt, device=device)
        out = torch.empty(tree.shape, dtype=dt, device=device)
        return out.normal_(0.0, std, generator=gen)
    params = draw(T.init_model(mcfg, None)[0])
    rng = np.random.default_rng([seed64(seed), 0x1D5])
    ids = np.sort(rng.choice(cfg["vocab_size"], cfg["answer_ids"], False))
    return {"params": params, "seed": int(seed), "answer_ids": ids}


class TurnList(list):
    """Turns for the reference: each row's token ids, with every
    session's ``history``, the table's ``max_positions`` and the number
    of ``sessions``."""

    history: Dict[int, np.ndarray]
    max_positions: int
    sessions: int


class Turns:
    """Turn ``k`` of each of ``sessions`` sessions and each session's
    history, drawn from the seed (a turn kept once drawn)."""

    def __init__(self, seed: int, sessions: int, vocab: int, params: Dict):
        self.seed, self.sessions, self.vocab = seed64(seed), sessions, vocab
        self.p = params
        rng = np.random.default_rng([self.seed, 0x415])
        n = rng.integers(params["history_min"], params["history_max"] + 1,
                         sessions)
        ids = rng.integers(0, vocab, int(n.sum()))
        self.history = dict(enumerate(np.split(ids, np.cumsum(n)[:-1])))
        self._rounds: List[List[np.ndarray]] = []

    def round(self, k: int) -> List[np.ndarray]:
        while len(self._rounds) <= k:
            j = len(self._rounds)
            rng = np.random.default_rng([self.seed, 0x7A2, j])
            lo, hi = np.log(self.p["turn_min"]), np.log(self.p["turn_max"])
            n = np.rint(np.exp(rng.uniform(lo, hi, self.sessions))) \
                .astype(np.int64)
            ids = rng.integers(0, self.vocab, int(n.sum()))
            self._rounds.append(np.split(ids, np.cumsum(n)[:-1]))
        return self._rounds[k]

    def take(self, stream: np.ndarray, k: np.ndarray) -> TurnList:
        out = TurnList(self.round(int(kk))[int(s)] for s, kk in zip(stream, k))
        out.history, out.sessions = self.history, self.sessions
        out.max_positions = int(self.p["max_positions"])
        return out


def payload(cfg: Dict, mix, seed: int) -> Turns:
    return Turns(seed, mix.streams, cfg["vocab_size"], mix.params)


def answer_width(cfg: Dict) -> int:
    """The reported logits, the max and the argmax."""
    return cfg["answer_ids"] + 2


def build_server(cfg: Dict, weights: Dict, mix, device):
    """The session server over ``mix.streams`` sessions of
    ``max_positions`` positions; the sessions' histories (drawn from the
    seed, as ``payload`` draws them) wait on it for ``warm``."""
    from repro_torch.serving import SessionServer
    server = SessionServer(
        weights["params"], model_config(cfg), max_sessions=mix.streams,
        max_positions=int(mix.params["max_positions"]), batch=mix.batch,
        deadline_s=mix.deadline_s, device=device,
        report_ids=torch.as_tensor(weights["answer_ids"]))
    server.bench_history = Turns(weights["seed"], mix.streams,
                                 cfg["vocab_size"], mix.params).history
    return None, server


def _answer_all(server, sent: int, what: str) -> None:
    got = 0
    while got < sent:
        res = server.poll(timeout=300.0)
        if not res:
            raise RuntimeError(f"{what}: {got} of {sent} turns answered")
        bad = [r.error for r in res if r.error is not None]
        if bad:
            raise RuntimeError(f"{what}: {bad[0]}")
        got += len(res)


def warm(server, mix, cfg: Dict, device) -> None:
    """Two turns of every session at the cell's turn lengths (waves of the
    measured window's shapes), every session forgotten, then each
    session's history prefilled from position 0, and the turns numbered
    from 0 again with a fresh record and counters."""
    warm_turns = Turns(0x3A5E, mix.streams,
                       cfg["vocab_size"], mix.params)
    for k in range(2):
        for s, t in enumerate(warm_turns.round(k)):
            server.submit(s, t)
    _answer_all(server, 2 * mix.streams, "warm turns")
    server.reset_sessions()
    for s, t in server.bench_history.items():
        server.submit(s, t)
    _answer_all(server, mix.streams, "history prefill")
    server.restart_numbering()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def counters(server) -> Dict:
    return server.counters()


def instrument(spans, server) -> None:
    """Spans around the compute thread's wave, the assembler's wave and
    the extend call within a wave, by the server's own method names; and
    the server's marker kernels around each MoE section on
    (``metrics/moe_share.py`` finds them in the device trace)."""
    spans.wrap(server._sched, "_execute", "server.execute")
    spans.wrap(server._sched, "_build_wave", "server.assemble")
    spans.wrap(server, "_forward", DATAPATH)
    server.probe.marks = True
