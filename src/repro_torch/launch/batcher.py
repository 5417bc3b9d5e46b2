"""Batched request serving — wave scheduling over the decode step;
counterpart of ``repro/launch/batcher.py``.

Requests queue up, are assembled into fixed-size WAVES (padding with
inactive slots), and each wave decodes in lockstep against one shared
cache allocation.  Finished sequences (EOS or length) retire at wave
boundaries; per-slot retirement within a wave masks the slot's output.

Prompts of one wave may differ in length.  Each slot is teacher-forced
through its own prompt and then fed back its own tokens, so every slot
generates what it would alone (a batch-of-one run).  The reference feeds
a shorter prompt's slot the padding token until the wave's longest prompt
is consumed and starts every slot's output there, so only the slots with
the wave's longest prompt continue as they would alone; where a wave's
prompts have one length the two batchers agree token for token.

Two modes share the queue/wave machinery:

  * LM decode (default): ``WaveBatcher(params, cfg, ...)`` —
    autoregressive lockstep decoding over ``transformer.forward_decode``
    with a greedy argmax per slot.  Given w8a8 serve weights
    (``quantize_model_params``), every quantised ``linear`` of a step runs
    its int8 product on the card's integer GEMM kernel.
  * LSTM accelerator: ``WaveBatcher.for_accelerator(session, batch_size)``
    — requests are (T, M) windows; waves run through the streaming
    subsystem (``repro_torch.serving.serve_windows``, the paper's integer
    datapath: the fused LSTM kernel on the card), one static batch shape,
    results per-window predictions.  For named streams with cross-window
    state carry use ``repro_torch.serving.StreamServer`` directly.

The cache lives on the params' device.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Deque, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # LM: (prompt_len,) int32; LSTM: (T, M) float
    max_new: int
    eos_id: Optional[int] = None
    output: Any = dataclasses.field(default_factory=list)
    done: bool = False


class WaveBatcher:
    def __init__(self, params, cfg: ModelConfig, batch_size: int = 8,
                 max_seq: int = 0, *, _lstm_mode: bool = False):
        self.params = params
        self.cfg = cfg
        self.bs = batch_size
        self.max_seq = max_seq
        self.queue: Deque[Request] = deque()
        self._next_id = 0
        self.accelerator = None     # set by for_accelerator()

        if _lstm_mode:
            return  # LSTM-accelerator mode: no decode graph
        if cfg is None:
            raise TypeError("LM mode needs a ModelConfig; for the LSTM-"
                            "accelerator mode use WaveBatcher.for_accelerator")
        if max_seq <= 0:
            raise ValueError("LM mode needs max_seq > 0 (the cache budget)")
        self.device = tree_leaves(params)[0].device

    @classmethod
    def for_accelerator(cls, session, batch_size: int = 256,
                        path: str = "int") -> "WaveBatcher":
        """LSTM-accelerator mode over a built ``repro_torch.Accelerator``
        session.

        Requests are (T, M) float windows submitted with
        ``submit_window``; ``run()`` drains them in fixed-size waves
        through the streaming subsystem (``serving.serve_windows``) and
        returns {rid: (P,) prediction}."""
        b = cls(None, None, batch_size=batch_size, _lstm_mode=True)
        b.accelerator = session
        b._serve_path = path
        return b

    def submit(self, prompt: np.ndarray, max_new: int,
               eos_id: Optional[int] = None) -> int:
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, np.asarray(prompt, np.int32),
                                  max_new, eos_id))
        return rid

    def submit_window(self, window: np.ndarray) -> int:
        """LSTM mode: enqueue one (T, M) float window."""
        if self.accelerator is None:
            raise RuntimeError("submit_window needs for_accelerator()")
        rid = self._next_id
        self._next_id += 1
        self.queue.append(Request(rid, np.asarray(window, np.float32),
                                  max_new=0))
        return rid

    @torch.inference_mode()
    def _decode(self, cache, tokens: np.ndarray, pos: int):
        """One lockstep step: the argmax token of every slot (numpy)."""
        batch = {"tokens": torch.as_tensor(tokens, device=self.device),
                 "cache_pos": pos}
        if self.cfg.attn and self.cfg.attn.mrope_sections:
            batch["position_ids"] = torch.full((3, self.bs, 1), pos,
                                               dtype=torch.int32,
                                               device=self.device)
        logits, cache = T.forward_decode(self.params, cache, batch, self.cfg)
        return logits[:, -1].argmax(-1).to(torch.int32).cpu().numpy(), cache

    def _run_wave(self, wave: List[Request]) -> None:
        bs = self.bs
        plen = max(len(r.prompt) for r in wave)
        total = plen + max(r.max_new for r in wave)
        if total > self.max_seq:
            raise ValueError(f"a request needs {total} cache positions, "
                             f"more than max_seq={self.max_seq}")
        cache = T.init_cache(self.cfg, bs, self.max_seq, device=self.device)

        # left-align prompts; each slot leaves its prompt at its own length
        toks = np.zeros((bs, plen), np.int32)
        for i, r in enumerate(wave):
            toks[i, :len(r.prompt)] = r.prompt
        in_prompt = np.asarray([len(r.prompt) for r in wave])[:, None]
        cur = toks[:, :1]
        for t in range(total - 1):
            nxt, cache = self._decode(cache, cur, t)
            cur = nxt[:, None]
            if t + 1 < plen:             # teacher-force the prompts
                cur = np.where(t + 1 < in_prompt, toks[:, t + 1:t + 2], cur)
            for i, r in enumerate(wave):
                if r.done or t + 1 < len(r.prompt):
                    continue
                tok = int(nxt[i])
                r.output.append(tok)
                if (r.eos_id is not None and tok == r.eos_id) or \
                        len(r.output) >= r.max_new:
                    r.done = True
            if all(r.done for r in wave):
                break
        for r in wave:
            r.done = True

    def run(self) -> Dict[int, Any]:
        """Drain the queue.

        LM mode: {rid: generated tokens}.  LSTM-accelerator mode:
        {rid: (P,) float prediction} via ``serving.serve_windows``."""
        if self.accelerator is not None:
            return self._run_lstm()
        results: Dict[int, List[int]] = {}
        while self.queue:
            wave = []
            while self.queue and len(wave) < self.bs:
                wave.append(self.queue.popleft())
            while len(wave) < self.bs:   # pad with a dummy slot
                wave.append(Request(-1, np.zeros(1, np.int32), 1))
            self._run_wave(wave)
            for r in wave:
                if r.rid >= 0:
                    results[r.rid] = r.output
        return results

    def _run_lstm(self) -> Dict[int, np.ndarray]:
        from repro_torch.serving import serve_windows
        reqs: List[Request] = []
        while self.queue:
            reqs.append(self.queue.popleft())
        preds = serve_windows(self.accelerator, (r.prompt for r in reqs),
                              batch=self.bs, path=self._serve_path)
        results: Dict[int, np.ndarray] = {}
        for r, y in zip(reqs, preds):
            r.output = y
            r.done = True
            results[r.rid] = y
        return results
