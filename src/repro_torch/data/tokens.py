"""Synthetic LM data pipeline, as the reference's ``src/repro/data/tokens.py``.

Deterministic, seekable token stream (restart-safe: the checkpoint stores
the step counter and the pipeline resumes at exactly the next batch),
zipf-like unigram statistics plus local structure so losses actually
decrease. Generation is the reference's numpy code, so the tokens are the
same bits by construction. A prefetch thread generates ahead; ``__next__``
moves a batch to the device (pinned and asynchronous on the card, so the
host does not wait for the copy). With a mesh, ``shard_batch`` gives
each rank its share of the rows by ``ACT_RULES["batch"]`` (the
reference's batch sharding), marked with that spec for the sharded train
step, and placed so that each of the step's microbatches on a rank is its
share of the reference's microbatch.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Iterator

import numpy as np
import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.core.distributed import mesh_device
from repro_torch.device import resolve_device
from repro_torch.parallel import sharding as S
from repro_torch.parallel.fsdp import mark
from repro_torch.parallel.sharding import ACT_RULES, named_sharding


def _batch_rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def synth_tokens(rng: np.random.Generator, batch: int, seq: int,
                 vocab: int) -> np.ndarray:
    """Zipf-ish tokens with Markov-ish local structure (learnable)."""
    base = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
    toks = (base - 1) % vocab
    # inject copy structure: second half partially repeats the first half
    half = seq // 2
    mask = rng.random((batch, half)) < 0.5
    toks[:, half:half * 2][mask] = toks[:, :half][mask]
    return toks.astype(np.int32)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int,
               step: int) -> Dict[str, np.ndarray]:
    rng = _batch_rng(seed, step)
    b, s = shape.global_batch, shape.seq_len
    batch: Dict[str, Any] = {}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        f = cfg.frontend_tokens
        s_text = s - f
        batch["tokens"] = synth_tokens(rng, b, s_text, cfg.vocab_size)
        batch["frontend_embeds"] = rng.standard_normal(
            (b, f, cfg.d_model), dtype=np.float32)
    elif cfg.is_encoder_decoder:
        batch["tokens"] = synth_tokens(rng, b, s, cfg.vocab_size)
        batch["enc_embeds"] = rng.standard_normal(
            (b, s, cfg.d_model), dtype=np.float32) * 0.02
    else:
        batch["tokens"] = synth_tokens(rng, b, s, cfg.vocab_size)
    return batch


def to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, Any]:
    """A numpy batch as tensors on ``device``; on the card through pinned
    memory without a wait."""
    dev = torch.device(device)
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda":
            t = t.pin_memory().to(dev, non_blocking=True)
        else:
            t = t.to(dev)
        out[k] = t
    return out


#: the logical dim names of each batch entry
BATCH_NAMES = {
    "tokens": ("batch", None),
    "frontend_embeds": ("batch", None, None),
    "enc_embeds": ("batch", None, None),
    "loss_mask": ("batch", None),
}


#: attribute under which a placed batch entry carries the microbatch count
#: its rows are placed for
_MICRO_ATTR = "_repro_microbatches"


def placed_microbatches(t) -> int:
    """The microbatch count ``shard_batch`` placed ``t``'s rows for (1
    where it was not placed)."""
    return getattr(t, _MICRO_ATTR, 1)


def _microbatch_order(v: np.ndarray, microbatches: int, blocks: int):
    """The rows of ``v`` (B, ...) reordered so that block r of ``blocks``
    holds, microbatch after microbatch, its block of each microbatch's
    rows: the global rows (n, R, B / (n R)) as (R, n, B / (n R))."""
    if microbatches == 1 or blocks == 1:
        return v
    b = v.shape[0]
    if b % (microbatches * blocks):
        raise ValueError(f"batch {b} not divisible by {microbatches} "
                         f"microbatches of {blocks} row blocks")
    return v.reshape(microbatches, blocks, b // (microbatches * blocks),
                     *v.shape[1:]).swapaxes(0, 1).reshape(v.shape)


def shard_batch(batch: Dict[str, np.ndarray], mesh=None, device="cuda",
                microbatches: int = 1):
    """The batch on ``device``; with a mesh, this rank's rows of it on the
    mesh's device, each entry marked with its spec.

    The reference's microbatch i is the global rows [i B / n, (i + 1) B /
    n) of its ``n`` microbatches. With ``microbatches`` n, the rank whose
    rows are block r of R holds, for each i in order, block r of
    microbatch i's rows, so that the step's microbatch i on that rank is
    its share of the reference's (its rows are then not block r of the
    batch, whatever the spec says; a train step reads them only by its
    microbatches, and ``train_step`` checks the count they were placed
    for). With one microbatch, or one block, the rows are the spec's
    block."""
    if mesh is None:
        return to_device(batch, device)
    out = {}
    for k, v in batch.items():
        sh = named_sharding(v.shape, BATCH_NAMES[k], ACT_RULES, mesh)
        blocks = S.block_index(sh.spec[0], mesh, S.mesh_shape(mesh))[0]
        v = _microbatch_order(np.ascontiguousarray(v), microbatches, blocks)
        rows = sh.shard(torch.from_numpy(np.ascontiguousarray(v))).numpy()
        t = mark(to_device({k: rows}, mesh_device(mesh))[k], sh.spec)
        setattr(t, _MICRO_ATTR, microbatches)
        out[k] = t
    return out


class DataPipeline:
    """Prefetching, seekable pipeline. `state()` -> step for checkpointing.
    With a mesh each batch comes as this rank's share, placed for the
    step's ``microbatches`` (``shard_batch``)."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
                 start_step: int = 0, prefetch: int = 2, device="cuda",
                 mesh=None, microbatches: int = 1):
        self.cfg, self.shape, self.seed = cfg, shape, seed
        self.step = start_step
        self.mesh, self.microbatches = mesh, microbatches
        self.device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = make_batch(self.cfg, self.shape, self.seed, step)
            try:
                self._q.put((step, batch), timeout=1.0)
                step += 1
            except queue.Full:
                continue

    def __next__(self):
        while True:
            step, batch = self._q.get()
            if step < self.step:
                continue  # discard stale prefetches after a seek
            self.step = step + 1
            return shard_batch(batch, self.mesh, self.device,
                               self.microbatches)

    def __iter__(self) -> Iterator:
        return self

    def state(self) -> int:
        return self.step

    def close(self):
        self._stop.set()
        self._thread.join(timeout=5.0)
