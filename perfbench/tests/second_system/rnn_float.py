"""Plain reference for ``rnn_sessions`` (``tests/test_perfbench_datadriven.py``
copies it into a copy of the benchmark as ``reference/rnn_float.py``):
the same model in numpy float64, each session's turns in order from the
zero state, on the weights and token ids the benchmark made.  It brings
its own numbers and limits, and for the control the answers as the
program returns them."""

from __future__ import annotations

from typing import Dict

import numpy as np

# The program runs float32, this reference float64: over a turn's few
# steps of a contracting update the answers differ by some 1e-7.  The
# limit leaves room above that and stays below the control's (the same
# model in float16, gaps of some 1e-3).
LIMITS = {"max_abs_gap": 1e-4}


def predict(cfg: Dict, params, stream, k, x, device="cpu", lower=False):
    """``(answers,)``: (n, out) answers for the turns ``x``, turn ``k[j]``
    of session ``stream[j]``; with ``lower`` in float16."""
    dt = np.float16 if lower else np.float64
    w = {n: np.asarray(a).astype(dt) for n, a in params.items()}
    out = np.zeros((len(stream), cfg["model"]["out"]))
    state: Dict[int, np.ndarray] = {}
    for j in np.argsort(k, kind="stable"):
        s = state.get(int(stream[j]), np.zeros(w["w"].shape[0], dt))
        for t in x[j]:
            s = np.tanh(s @ w["w"] + w["emb"][t])
        state[int(stream[j])] = s
        out[j] = s @ w["head"]
    return (out,)


def readings(y: np.ndarray, want: np.ndarray) -> Dict[str, float]:
    """The widest gap of an answered row from the reference's answer."""
    answered = ~np.isnan(y).any(axis=1)
    gap = np.abs(y[answered].astype(np.float64) - want[answered])
    return {"max_abs_gap": float(gap.max()) if gap.size else 0.0}


def answers(want: np.ndarray) -> np.ndarray:
    return want
