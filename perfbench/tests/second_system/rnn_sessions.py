"""``rnn_sessions``: a second system, for the harness's own tests, which
show that a configuration other than the quantised LSTM runs a cell by
new files only (``tests/test_perfbench_datadriven.py`` copies this file
into a copy of the benchmark as ``systems/rnn_sessions.py``).

A small stateful float model: each session carries a state vector from
one request to its next.  A request is one turn of a session, 1 to the
mix's ``max_tokens`` token ids; per token the state becomes ``tanh(state
@ w + emb[token])``, and the answer is the ``out`` floats ``state @
head`` after the turn's last token.  Its server batches the requests
that arrive within ``deadline_s`` of the first, up to ``batch``, runs
them in arrival order on one worker thread, and counts its calls,
requests and tokens.  It gives no spans and no fault hook.
"""

from __future__ import annotations

import queue
import threading
import time
from collections import namedtuple
from typing import Dict, List

import numpy as np
import torch

from perfbench.traffic import seed64

PARAMS = ("max_tokens",)

Result = namedtuple("Result", "stream_id seq y error")


class Turns:
    """Turn ``k`` of each of ``sessions`` sessions: int64 token ids below
    ``vocab``, 1 to ``max_tokens`` of them, drawn per ``k`` from the
    seed and kept once drawn."""

    def __init__(self, seed: int, sessions: int, vocab: int,
                 max_tokens: int):
        self.seed, self.sessions = seed64(seed), sessions
        self.vocab, self.max_tokens = vocab, max_tokens
        self._rounds: List[List[np.ndarray]] = []

    def round(self, k: int) -> List[np.ndarray]:
        while len(self._rounds) <= k:
            j = len(self._rounds)
            rng = np.random.default_rng([self.seed, 0x7E27, j])
            n = rng.integers(1, self.max_tokens + 1, self.sessions)
            ids = rng.integers(0, self.vocab, int(n.sum()))
            self._rounds.append(np.split(ids, np.cumsum(n)[:-1]))
        return self._rounds[k]

    def take(self, stream: np.ndarray, k: np.ndarray) -> List[np.ndarray]:
        return [self.round(int(kk))[int(s)] for s, kk in zip(stream, k)]


def payload(cfg: Dict, mix, seed: int) -> Turns:
    return Turns(seed, mix.streams, cfg["model"]["vocab"],
                 int(mix.params["max_tokens"]))


def answer_width(cfg: Dict) -> int:
    return cfg["model"]["out"]


def make_weights(cfg: Dict, seed: int, device) -> Dict[str, np.ndarray]:
    """Float32 weights in one draw on ``device``: the embedding normal,
    the recurrence scaled to a contraction, the head to unit scale."""
    m = cfg["model"]
    v, d, p = m["vocab"], m["state"], m["out"]
    shapes = {"emb": (v, d), "w": (d, d), "head": (d, p)}
    scale = {"emb": 1.0, "w": 0.5 / d ** 0.5, "head": 1.0 / d ** 0.5}
    sizes = [int(np.prod(s)) for s in shapes.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    u = torch.randn(sum(sizes), generator=gen, device=device)
    out, at = {}, 0
    for (name, shape), size in zip(shapes.items(), sizes):
        out[name] = (u[at:at + size] * scale[name]).reshape(shape) \
            .cpu().numpy()
        at += size
    return out


class Server:
    """Sessions' states on ``device``, one worker thread."""

    def __init__(self, weights: Dict[str, np.ndarray], batch: int,
                 deadline_s: float, device):
        self.w = {n: torch.as_tensor(a, device=device)
                  for n, a in weights.items()}
        self.batch, self.deadline_s = batch, deadline_s
        self._in: queue.Queue = queue.Queue()
        self._out: queue.Queue = queue.Queue()
        self.reset()
        self._worker = threading.Thread(target=self._loop,
                                        name="rnn-sessions", daemon=True)
        self._worker.start()

    def reset(self) -> None:
        """Every session and counter back to the start (the worker idle)."""
        self._state: Dict = {}
        self._seq: Dict = {}
        self.calls = self.requests = self.tokens = 0

    def submit(self, stream_id, tokens: np.ndarray) -> int:
        seq = self._seq.get(stream_id, 0)
        self._seq[stream_id] = seq + 1
        self._in.put((stream_id, seq, tokens))
        return seq

    def poll(self, timeout: float = 0.0) -> List[Result]:
        out = []
        try:
            out.append(self._out.get(timeout=timeout))
            while True:
                out.append(self._out.get_nowait())
        except queue.Empty:
            return out

    def close(self, timeout: float = 30.0) -> List[str]:
        """Stop the worker; the names of threads left running."""
        self._in.put(None)
        self._worker.join(timeout)
        return [self._worker.name] if self._worker.is_alive() else []

    def _loop(self) -> None:
        while True:
            first = self._in.get()
            if first is None:
                return
            todo = [first]
            end = time.perf_counter() + self.deadline_s
            while len(todo) < self.batch:
                try:
                    item = self._in.get(
                        timeout=max(0.0, end - time.perf_counter()))
                except queue.Empty:
                    break
                if item is None:
                    self._in.put(None)
                    break
                todo.append(item)
            self._run(todo)

    def _run(self, todo) -> None:
        w = self.w
        for stream_id, seq, tokens in todo:
            s = self._state.get(stream_id)
            if s is None:
                s = torch.zeros(w["w"].shape[0], device=w["w"].device)
            for t in tokens.tolist():
                s = torch.tanh(s @ w["w"] + w["emb"][t])
            self._state[stream_id] = s
            self._out.put(Result(stream_id, seq,
                                 (s @ w["head"]).cpu().numpy(), None))
            self.tokens += len(tokens)
        self.calls += 1
        self.requests += len(todo)


def build_server(cfg: Dict, weights, mix, device):
    return None, Server(weights, mix.batch, mix.deadline_s, device)


def warm(server: Server, mix, cfg: Dict, device) -> None:
    """One turn through the model, then every session and counter reset."""
    server.submit("warm", np.arange(3) % cfg["model"]["vocab"])
    if not server.poll(timeout=10.0):
        raise RuntimeError("the warm turn was not answered")
    server.reset()


def counters(server: Server) -> Dict:
    return {"calls": server.calls, "requests": server.requests,
            "tokens": server.tokens}
