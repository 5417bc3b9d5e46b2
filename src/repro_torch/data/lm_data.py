"""Synthetic LM token stream — counterpart of ``repro/data/lm_data.py``,
in numpy alone, so its batches equal the reference's array for array.

A Zipf-distributed vocabulary with first-order Markov structure (so
cross-entropy has real headroom below the unigram entropy and training
curves are meaningful), generated deterministically from (seed, step):
the restart-reproducibility contract the checkpoint tests rely on.
"""

from __future__ import annotations

import numpy as np


class SyntheticLM:
    """Step-keyed batch source: batch(step) is a pure function."""

    def __init__(self, vocab_size: int, seed: int = 0, n_states: int = 64):
        self.vocab = vocab_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        # Hidden-state Markov chain; each state emits a distinct Zipf slice.
        self.n_states = n_states
        self.trans = rng.dirichlet(np.ones(n_states) * 0.3, n_states)
        self.state_shift = rng.integers(0, vocab_size, n_states)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self.zipf = p / p.sum()

    def batch(self, step: int, batch_size: int, seq_len: int) -> dict:
        """{"tokens", "labels"}: (batch_size, seq_len) int32 numpy arrays,
        labels the tokens shifted left by one."""
        rng = np.random.default_rng((self.seed, step))
        states = rng.integers(0, self.n_states, batch_size)
        toks = np.empty((batch_size, seq_len + 1), np.int32)
        base = rng.choice(self.vocab, (batch_size, seq_len + 1), p=self.zipf)
        for t in range(seq_len + 1):
            toks[:, t] = (base[:, t] + self.state_shift[states]) % self.vocab
            nxt = rng.random(batch_size)
            cum = np.cumsum(self.trans[states], axis=1)
            states = (cum < nxt[:, None]).sum(1).clip(0, self.n_states - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].astype(np.int32)}
