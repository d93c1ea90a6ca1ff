"""Serving launcher of the PyTorch/CUDA port:

    python -m repro_torch.launch.serve --arch qwen3-32b --smoke --device cpu
    python -m repro_torch.launch.serve --arch gemma2-2b --no-smoke   # card

Batched request serving with the slot engine (greedy sampling), the
counterpart of the reference's ``repro.launch.serve``: the same flags, plus
``--device`` (default ``cuda``; raises without a card instead of falling
back). Parameters are random, drawn from ``prng.key(0)``; the prompts are
``--requests`` uniform draws of ``--prompt-len`` tokens from
``numpy.random.default_rng(0)``, as the reference's are. The port serves
the dense and vlm families; the others raise (ROADMAP item 17(b)).
"""
from __future__ import annotations

import argparse
import statistics
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import get_config, list_archs
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.serve.engine import Request, ServeEngine


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list(list_archs()))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="use the smoke-scale config (--no-smoke for full)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs on the host)")
    return ap


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_model(args) -> Tuple[Model, float]:
    """The ``--arch`` model on ``--device`` with parameters from
    ``prng.key(0)``, and the seconds their draw took."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if cfg.family == "lartpc":
        raise SystemExit("use repro_torch.launch.sim for the lartpc workload")
    model = Model(cfg, device)
    _sync(device)
    t0 = time.perf_counter()
    model.init(prng.key(0))
    _sync(device)
    return model, time.perf_counter() - t0


def make_requests(args, vocab_size: int) -> List[Request]:
    rng = np.random.default_rng(0)
    return [Request(prompt=rng.integers(0, vocab_size,
                                        size=(args.prompt_len,),
                                        dtype=np.int32),
                    max_new_tokens=args.new_tokens)
            for _ in range(args.requests)]


def run(args, model: Optional[Model] = None
        ) -> Tuple[List[Request], Dict[str, Any]]:
    """Serve the seeded requests; returns (requests, stats). ``model``
    (with its parameters registered) skips building and drawing one.

    stats: the device, ``init_s`` (None for a given model), generation
    seconds, tokens and tokens/s, each wave's prefill ms, each decode
    step's ms and their median."""
    init_s = None
    if model is None:
        model, init_s = build_model(args)
    device = model.device
    params = model.params()
    engine = ServeEngine(model, batch_slots=args.slots, max_len=args.max_len)
    reqs = make_requests(args, model.cfg.vocab_size)
    _sync(device)
    t0 = time.perf_counter()
    done = engine.generate(params, reqs)
    seconds = time.perf_counter() - t0
    tokens = sum(len(r.out_tokens) for r in done)
    decode_ms = [1e3 * s for s in engine.times["decode_s"]]
    stats = {
        "device": (torch.cuda.get_device_name(device)
                   if device.type == "cuda" else "cpu"),
        "init_s": init_s, "seconds": seconds, "tokens": tokens,
        "tokens_per_s": tokens / seconds,
        "prefill_ms": [1e3 * s for s in engine.times["prefill_s"]],
        "decode_ms": decode_ms,
        "decode_ms_median": statistics.median(decode_ms) if decode_ms
        else None}
    return done, stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    done, stats = run(args)
    print(f"{len(done)} requests, {stats['tokens']} tokens in "
          f"{stats['seconds']:.2f}s ({stats['tokens_per_s']:.1f} tok/s) on "
          f"{stats['device']}; init {stats['init_s']:.2f}s, prefill ms "
          f"{', '.join(f'{t:.1f}' for t in stats['prefill_ms'])}, decode "
          f"median {stats['decode_ms_median'] or 0.0:.2f} ms/step")
    for i, r in enumerate(done[:4]):
        print(f"  req{i}: {r.out_tokens}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
