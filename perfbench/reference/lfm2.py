"""``lfm2``: the plain reference of LFM2-8B-A1B (Liquid AI), from its
published equations: float32 torch with TF32 off, no cache, no
batching, the experts' top-k computed exactly, each layer's bf16
weights upcast as it runs (so that it fits on the card beside them).
It imports only torch and numpy, nothing of the program: the
benchmark's comparison that decides ``correct`` (``predict``,
``LIMITS``, ``readings``, ``answers``) and the port's own tests
(``tests/test_torch_lfm2.py``) and ``chip_smoke.py`` hold the port to it.

The configuration is the published ``config.json``'s keys
(``hidden_size``, ``layer_types`` with ``"conv"`` and
``"full_attention"``, ``num_dense_layers``, ``num_experts``,
``num_experts_per_tok``, ``moe_intermediate_size``,
``intermediate_size``, ``conv_L_cache``, ``norm_eps``, ``rope_theta``,
``routed_scaling_factor``, ``use_expert_bias``, ``num_attention_heads``,
``num_key_value_heads``, ``vocab_size``); the weights a tree of tensors
``{"embed": (V, d), "layers": [{"ln1", "ln2", "mixer", "mlp"}, ...],
"final_norm"}`` with the head tied to the embedding:

* RMSNorm ``x * rsqrt(mean(x^2) + eps) * w`` before each mixer and each
  FFN, and on the output;
* conv layer (``mixer``: ``in_proj`` (d, 3, d), ``conv_w`` (L, d),
  ``out_proj`` (d, d)): ``B, C, x = split(h @ in_proj)``, ``u = B * x``,
  ``conv(u)[t] = sum_j conv_w[j] * u[t - (L-1) + j]`` (zeros before the
  sequence), ``y = (C * conv(u)) @ out_proj``;
* attention layer (``wq`` (d, H, hd), ``wk``/``wv`` (d, KV, hd), ``wo``
  (H*hd, d), ``q_norm``/``k_norm`` (hd,)): per-head RMSNorm on q and k,
  then RoPE on the two halves of each head (base ``rope_theta``), causal
  softmax attention with H/KV query heads per KV head, scale hd^-0.5;
* FFN: SwiGLU ``(silu(x @ w_gate) * (x @ w_up)) @ w_down`` of width
  ``intermediate_size`` in the first ``num_dense_layers`` layers; in the
  others the MoE (``router`` (d, E), ``expert_bias`` (E,), experts'
  ``w_gate``/``w_up`` (E, d, f), ``w_down`` (E, f, d)): sigmoid of the
  router's logits, the top k of the scores plus the bias (a stable sort,
  ties to the lower expert), gates the chosen unbiased scores over their
  sum plus 1e-6 (the published ``norm_topk_prob``) times
  ``routed_scaling_factor``, each expert's SwiGLU over its own tokens.

A chat session (:func:`session_logits`) is its history and its turns in
order in one causal sequence; a turn that would take the sequence past
``max_positions`` starts a new one at position 0, as a new chat of the
same client.

What is compared: every turn of ``compare_sessions`` sessions drawn from
the seed (a different sample for each seed; the configuration's file
states how many), each session recomputed whole, its history then its
turns, one causal forward per chat (a turn that would pass the table's
``max_positions`` starts a new chat at position 0, as the server does).
An answer is the turn's last-token logits at the configuration's
``answer_ids`` vocabulary ids, then the row's max logit and its argmax;
the argmax is not compared, since with random weights the largest logit
changes on rounding.  ``unanswered`` (``compare.py``) and ``nonfinite``
cover every answer of every session.  ``lower`` rounds every weight
matrix to float8 e4m3 (one scale a tensor): the control a step below the
configuration's bf16.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

Tensor = torch.Tensor
# queries per block of the attention's scores (bounds their memory)
Q_BLOCK = 512


def exact() -> None:
    """Float32 products in float32: TF32 off for matmuls and convs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: Tensor) -> Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor."""
    s = t.abs().amax().clamp_min(1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).float() * s


def _w(t: Tensor, device, lower: bool) -> Tensor:
    """A weight upcast to float32 on ``device`` (rounded to float8 first
    for a matrix under ``lower``)."""
    t = t.to(device=device, dtype=torch.float32)
    return _fp8(t) if lower and t.ndim >= 2 else t


def _rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _rope(x: Tensor, theta: float) -> Tensor:
    """(T, H, hd) rotated by positions 0..T-1 on the two halves of hd."""
    t, _, hd = x.shape
    freq = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                   device=x.device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, -1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def _attention(x: Tensor, p: Dict, cfg: Dict, w) -> Tensor:
    t, d = x.shape
    h, kv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // h
    eps = cfg["norm_eps"]
    q = (x @ w(p["wq"]).reshape(d, -1)).reshape(t, h, hd)
    k = (x @ w(p["wk"]).reshape(d, -1)).reshape(t, kv, hd)
    v = (x @ w(p["wv"]).reshape(d, -1)).reshape(t, kv, hd)
    q = _rope(_rms(q, w(p["q_norm"]), eps), cfg["rope_theta"])
    k = _rope(_rms(k, w(p["k_norm"]), eps), cfg["rope_theta"])
    k = k.repeat_interleave(h // kv, 1).transpose(0, 1)    # (H, T, hd)
    v = v.repeat_interleave(h // kv, 1).transpose(0, 1)
    q = q.transpose(0, 1)
    out = torch.empty_like(q)
    keys = torch.arange(t, device=x.device)
    for a in range(0, t, Q_BLOCK):
        b = min(t, a + Q_BLOCK)
        s = (q[:, a:b] @ k[:, :b].transpose(1, 2)) * hd ** -0.5
        s = s.masked_fill(keys[None, None, :b] > keys[a:b, None], -torch.inf)
        out[:, a:b] = torch.softmax(s, -1) @ v[:, :b]
    return out.transpose(0, 1).reshape(t, d) @ w(p["wo"])


def _conv(x: Tensor, p: Dict, cfg: Dict, w) -> Tensor:
    t, d = x.shape
    taps = cfg["conv_L_cache"]
    b, c, xx = (x @ w(p["in_proj"]).reshape(d, 3 * d)).reshape(t, 3, d) \
        .unbind(1)
    u = torch.cat([x.new_zeros(taps - 1, d), b * xx])
    cw = w(p["conv_w"])
    conv = sum(cw[j] * u[j:j + t] for j in range(taps))
    return (c * conv) @ w(p["out_proj"])


def _swiglu(x: Tensor, wg: Tensor, wu: Tensor, wd: Tensor) -> Tensor:
    return (torch.nn.functional.silu(x @ wg) * (x @ wu)) @ wd


def _moe(x: Tensor, p: Dict, cfg: Dict, w) -> Tensor:
    k = cfg["num_experts_per_tok"]
    scores = torch.sigmoid(x @ w(p["router"]))
    pick = scores + w(p["expert_bias"]) if cfg["use_expert_bias"] else scores
    idx = torch.sort(pick, dim=-1, descending=True, stable=True)[1][:, :k]
    gates = torch.gather(scores, 1, idx)
    gates = gates / (gates.sum(-1, keepdim=True) + 1e-6) \
        * cfg["routed_scaling_factor"]
    y = torch.zeros_like(x)
    for e in range(cfg["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if len(tok):
            out = _swiglu(x[tok], w(p["w_gate"][e]), w(p["w_up"][e]),
                          w(p["w_down"][e]))
            y.index_add_(0, tok, out * gates[tok, slot, None])
    return y


def forward(cfg: Dict, params: Dict, tokens: Sequence[int], at: Sequence[int],
            device=None, lower: bool = False) -> Tensor:
    """Float32 logits (len(at), V) at positions ``at`` of one causal
    sequence of ``tokens`` from position 0, computed layer by layer with
    each layer's weights upcast as it runs."""
    device = device or params["embed"].device
    w = lambda t: _w(t, device, lower)
    eps = cfg["norm_eps"]
    tok = torch.as_tensor(np.asarray(tokens, np.int64), device=device)
    h = w(params["embed"])[tok]
    for i, (p, kind) in enumerate(zip(params["layers"], cfg["layer_types"])):
        x = _rms(h, w(p["ln1"]), eps)
        h = h + (_conv(x, p["mixer"], cfg, w) if kind == "conv"
                 else _attention(x, p["mixer"], cfg, w))
        x = _rms(h, w(p["ln2"]), eps)
        m = p["mlp"]
        h = h + (_swiglu(x, w(m["w_gate"]), w(m["w_up"]), w(m["w_down"]))
                 if i < cfg["num_dense_layers"] else _moe(x, m, cfg, w))
    at = torch.as_tensor(np.asarray(at, np.int64), device=device)
    return _rms(h[at], w(params["final_norm"]), eps) @ w(params["embed"]).T


def session_logits(cfg: Dict, params: Dict, history: Sequence[int],
                   turns: List[Sequence[int]], max_positions: int,
                   device=None, lower: bool = False) -> Tensor:
    """Float32 logits (len(turns), V) at each turn's last token: the
    session's ``history`` then its ``turns`` in order, one causal forward
    per chat, a turn that would pass ``max_positions`` starting a new
    chat at position 0."""
    out: List = [None] * len(turns)
    seq, ends = list(history), []

    def run():
        if ends:
            got = forward(cfg, params, seq, [e for _, e in ends], device,
                          lower)
            for (j, _), row in zip(ends, got):
                out[j] = row
    for j, turn in enumerate(turns):
        if len(seq) + len(turn) > max_positions:
            run()
            seq, ends = [], []
        seq.extend(int(t) for t in turn)
        ends.append((j, len(seq) - 1))
    run()
    return torch.stack(out) if out else torch.zeros(0)


# --- the comparison ---------------------------------------------------------

# The program runs bf16 weights (the same numbers the reference upcasts)
# with bf16 activations and caches, f32 norms, softmax and gates: its
# logits at the sampled ids differ from these float32 ones by the
# activations' rounding through 24 layers, and where that rounding flips
# a token's top-4 selection between near-equal experts, by the change it
# carries into every later layer and token.  The float8 control's
# weights move every product by some 3%, and every row with them.  At
# full size (PERF.md §6, on an H100): the program's rows read a median
# relative L2 gap of 0.09 and a 90th percentile of 0.12, the control's
# 0.63-0.65 and 0.70-0.71; each limit lies between, with room of about
# 2.5 times on both sides.
LIMITS = {
    # Answers that are infinite: none may be.
    "nonfinite": 0,
    # The median over the compared rows of the relative L2 gap of a
    # row's logits at the sampled ids.
    "rel_err_median": 0.25,
    # Their 90th percentile.
    "rel_err_p90": 0.3,
}


def answer(logits: Tensor, ids) -> np.ndarray:
    """(n, len(ids) + 2): logits at ``ids``, the row's max and argmax."""
    top = logits.max(-1)
    return torch.cat([logits[:, torch.as_tensor(ids, device=logits.device)],
                      top.values[:, None], top.indices[:, None].float()],
                     1).double().cpu().numpy()


def sample(weights: Dict, sessions: int, n: int) -> np.ndarray:
    """The sessions the comparison recomputes, drawn from the seed."""
    rng = np.random.default_rng([int(weights["seed"]) % (1 << 64), 0xC0DE])
    return np.sort(rng.choice(sessions, min(n, sessions), replace=False))


def predict(cfg: Dict, weights: Dict, stream, k, x, device="cpu",
            lower=False):
    """``(want, compared)``: the answers wanted for rows of the sampled
    sessions (NaN elsewhere) and which rows those are; ``x`` the turns
    with every session's history and the table's positions."""
    exact()
    stream, k = np.asarray(stream), np.asarray(k)
    ids = weights["answer_ids"]
    want = np.full((len(stream), len(ids) + 2), np.nan)
    compared = np.zeros(len(stream), bool)
    with torch.no_grad():
        for s in sample(weights, x.sessions, cfg["compare_sessions"]):
            rows = np.flatnonzero(stream == s)
            rows = rows[np.argsort(k[rows], kind="stable")]
            if not len(rows):
                continue
            logits = session_logits(cfg, weights["params"], x.history[s],
                                    [x[j] for j in rows], x.max_positions,
                                    device, lower)
            want[rows] = answer(logits, ids)
            compared[rows] = True
    return want, compared


def readings(y: np.ndarray, want: np.ndarray,
             compared: np.ndarray) -> Dict[str, float]:
    """The numbers compared for the program's answers ``y`` (NaN rows:
    unanswered)."""
    m = want.shape[1] - 2
    answered = ~np.isnan(y).any(axis=1)
    finite = np.isfinite(y).all(axis=1)
    sel = compared & answered & finite
    a, b = y[sel, :m].astype(np.float64), want[sel, :m]
    rel = np.linalg.norm(a - b, axis=1) / np.linalg.norm(b, axis=1)
    q50, q90 = np.percentile(rel, [50, 90]) if len(rel) else (0.0, 0.0)
    return {"nonfinite": int(np.count_nonzero(answered & ~finite)),
            "rel_err_median": float(q50), "rel_err_p90": float(q90)}


def answers(want: np.ndarray, compared: np.ndarray) -> np.ndarray:
    """The control's prediction as the program answers: the compared
    rows' answers, zeros for the rows not recomputed."""
    return np.where(compared[:, None], want, 0.0)
