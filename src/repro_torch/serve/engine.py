"""Batched serving engine: prefill + decode with slot-based batching.

A fixed pool of B slots, filled in waves: each wave takes up to B queued
requests, left-pads their prompts with token 0 to the longest (the pads
get positions from 0 and are attended, as in the reference), prefills
fresh caches, and decodes on one shared clock until the wave's longest
``max_new_tokens``; a request stops collecting tokens at its own limit.
A step's tokens are read to the host with one ``.tolist()``: one wait for
the card a step, not one per slot.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


@dataclass
class Request:
    prompt: np.ndarray            # (S,) int32
    max_new_tokens: int = 16
    out_tokens: List[int] = field(default_factory=list)
    done: bool = False


def greedy_sample(logits):
    return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)


class ServeEngine:
    """Synchronous batched engine (one host). All slots share one decode
    length clock; per-slot completion is masked.

    ``times`` holds the host wall seconds of the last ``generate``: one
    entry per wave prefill and one per decode step, each ending in the
    step's read of its tokens (which waits for the card)."""

    def __init__(self, model: Model, batch_slots: int, max_len: int):
        self.model = model
        self.b = batch_slots
        self.max_len = max_len
        self.times: Dict[str, List[float]] = {"prefill_s": [], "decode_s": []}

    def _prefill(self, params, tokens, caches):
        logits, caches, _ = self.model.prefill(params, {"tokens": tokens},
                                               caches)
        return greedy_sample(logits), caches

    def _decode(self, params, tok, caches, index: int):
        logits, caches = self.model.decode_step(
            params, {"tokens": tok[:, None]}, caches, index)
        return greedy_sample(logits), caches

    @torch.no_grad()
    def generate(self, params, requests: List[Request]) -> List[Request]:
        """Run all requests to completion with slot reuse."""
        self.times = {"prefill_s": [], "decode_s": []}
        pending = list(requests)
        active: List[Optional[Request]] = [None] * self.b
        while pending or any(a is not None for a in active):
            # fill free slots with the next wave (simple: waves of B)
            wave = []
            for i in range(self.b):
                if active[i] is None and pending:
                    active[i] = pending.pop(0)
                wave.append(active[i])
            live = [r for r in wave if r is not None]
            if not live:
                break
            plen = max(len(r.prompt) for r in live)
            toks = np.zeros((self.b, plen), np.int32)
            for i, r in enumerate(wave):
                if r is not None:
                    toks[i, -len(r.prompt):] = r.prompt  # left-pad
            t0 = time.perf_counter()
            caches = self.model.init_caches(self.b, self.max_len)
            tok, caches = self._prefill(
                params, torch.from_numpy(toks).to(self.model.device), caches)
            step = tok.tolist()
            self.times["prefill_s"].append(time.perf_counter() - t0)
            for i, r in enumerate(wave):
                if r is not None:
                    r.out_tokens.append(step[i])
            steps = max(r.max_new_tokens for r in live) - 1
            for s in range(steps):
                t0 = time.perf_counter()
                tok, caches = self._decode(params, tok, caches, plen + s)
                step = tok.tolist()
                self.times["decode_s"].append(time.perf_counter() - t0)
                for i, r in enumerate(wave):
                    if r is not None and len(r.out_tokens) < r.max_new_tokens:
                        r.out_tokens.append(step[i])
            for i, r in enumerate(wave):
                if r is not None:
                    r.done = True
                    active[i] = None
        return requests
