"""How far mamba2's bfloat16 cache path departs from its own forward, in
the reference and in the port, at mamba2-780m's full width and a chosen
depth.

The traffic is the first wave of ``chip_smoke.py``'s serve traffic (A): 4
requests of 128 prompt tokens from ``numpy.random.default_rng(0)``, as
``launch.serve`` draws them, then greedy decode steps. Every recorded
call (the prefill and each decode step) gives its last position's logits;
each is held against ``Model.forward`` over the tokens fed so far, at the
same position, as ``chip_smoke.py``'s check 1 does. Printed per package:
the largest |delta logit| as a fraction of max|logit| beside
``parity.lm_bf16_atol_frac(L)``, and the steps whose argmax agrees.

Parameters are float32, drawn by the reference from ``jax.random.key(0)``
and handed to the port through numpy; with ``--no-reference`` the port
runs alone (no JAX import) on its own draw from ``prng.key(0)``, as
``chip_smoke.py`` does. The reference runs on the CPU, jitted as its
engine runs. Logits are compared over the vocabulary, the padded columns
left out. E.g.::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_ssm_drift.py \\
        --layers 12 --device cpu
    PYTHONPATH=src python tests/torch_ssm_drift.py --layers 12 24 48 \\
        --no-reference --device cuda
"""
import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch import config as tconfig
from repro_torch.core import prng
from repro_torch.models.model import Model as TModel
from repro_torch.testing import parity

ARCH = "mamba2-780m"
REQUESTS, PROMPT, MAX_LEN = 4, 128, 256


def prompts(vocab: int) -> np.ndarray:
    rng = np.random.default_rng(0)
    return np.stack([rng.integers(0, vocab, size=(PROMPT,), dtype=np.int32)
                     for _ in range(REQUESTS)])


def departure(calls, forward, vocab: int):
    """calls: [(tokens fed by the call (B, s) int32 numpy, last-position
    logits (B, V) float32 numpy)]; forward(tokens (B, n)) -> (B, n, V)
    float32 numpy. Returns (per-step max |delta logit| as fractions of
    max|logit|, max|logit|, steps with equal argmax), over the first
    ``vocab`` columns."""
    seq, worst, top, agree = None, [], 0.0, 0
    for tokens, logits in calls:
        seq = tokens if seq is None else np.concatenate([seq, tokens], 1)
        ref = forward(seq)[:, -1, :vocab]
        got = logits[:, :vocab]
        top = max(top, float(np.abs(ref).max()))
        worst.append(float(np.abs(got - ref).max()))
        agree += int(np.all(got.argmax(-1) == ref.argmax(-1)))
    return [w / top for w in worst], top, agree


def run_port(cfg, steps, device, params=None):
    """The port's cache path and forward; ``params``: a numpy tree (the
    reference's draw), else the port's own draw from prng.key(0)."""
    from repro_torch import interop

    model = TModel(cfg, device)
    if params is None:
        params = model.init(prng.key(0))
    else:
        params = model.load_params(interop.model_params_from_numpy(params,
                                                                   device))
    toks = torch.from_numpy(prompts(cfg.vocab_size)).to(device)
    calls = []
    with torch.no_grad():
        caches = model.init_caches(REQUESTS, MAX_LEN)
        logits, caches, _ = model.prefill(params, {"tokens": toks}, caches)
        fed = toks
        for i in range(steps):
            last = logits[:, -1, :cfg.vocab_size].float()
            calls.append((fed.cpu().numpy(), last.cpu().numpy()))
            if i == steps - 1:
                break
            fed = last.argmax(-1).to(torch.int32)[:, None]
            logits, caches = model.decode_step(params, {"tokens": fed},
                                               caches, PROMPT + i)

        def forward(seq):
            out, _ = model.forward(params, {
                "tokens": torch.from_numpy(seq).to(device)})
            return out.float().cpu().numpy()

        return departure(calls, forward, cfg.vocab_size), calls


def run_reference(layers, steps):
    """The reference's cache path and forward on the CPU, jitted; also
    returns its parameters as a numpy tree."""
    import jax
    import jax.numpy as jnp

    from repro import config as jconfig
    from repro.models.model import Model as JModel

    cfg = dataclasses.replace(jconfig.get_config(ARCH), num_layers=layers)
    model = JModel(cfg)
    params = model.init(jax.random.key(0))
    prefill = jax.jit(model.prefill)
    decode = jax.jit(model.decode_step)
    forward = jax.jit(model.forward)
    toks = jnp.asarray(prompts(cfg.vocab_size))
    calls = []
    caches = model.init_caches(REQUESTS, MAX_LEN)
    logits, caches, _ = prefill(params, {"tokens": toks}, caches)
    fed = toks
    for i in range(steps):
        last = np.asarray(logits[:, -1, :cfg.vocab_size].astype(jnp.float32))
        calls.append((np.asarray(fed), last))
        if i == steps - 1:
            break
        fed = jnp.asarray(last.argmax(-1).astype(np.int32)[:, None])
        logits, caches = decode(params, {"tokens": fed}, caches,
                                jnp.asarray(PROMPT + i, jnp.int32))
    result = departure(calls, lambda seq: np.asarray(
        forward(params, {"tokens": jnp.asarray(seq)})[0].astype(jnp.float32)),
        cfg.vocab_size)
    return result, calls, jax.tree.map(np.asarray, params)


def report(package, layers, device, result, seconds, **more):
    fracs, top, agree = result
    limit = parity.lm_bf16_atol_frac(layers)
    line = {"package": package, "layers": layers, "device": device,
            "steps": len(fracs), "max_frac": max(fracs),
            "limit_frac": limit, "over_limit": max(fracs) > limit,
            "max_abs_logit": top, "argmax_equal_steps": agree,
            "fracs": fracs, "seconds": seconds, **more}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[12])
    ap.add_argument("--steps", type=int, default=32,
                    help="recorded calls: the prefill and steps - 1 decodes")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--no-reference", action="store_true")
    args = ap.parse_args(argv)
    if args.device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    for layers in args.layers:
        cfg = dataclasses.replace(tconfig.get_config(ARCH), num_layers=layers)
        params = ref_calls = None
        if not args.no_reference:
            t0 = time.perf_counter()
            ref, ref_calls, params = run_reference(layers, args.steps)
            report("reference", layers, "cpu", ref, time.perf_counter() - t0)
        t0 = time.perf_counter()
        port, calls = run_port(cfg, args.steps, args.device, params)
        more = {}
        if ref_calls is not None:
            # the prefill's logits on the same tokens: the port against the
            # reference, as a fraction of the reference's max|logit|
            got, want = calls[0][1], ref_calls[0][1]
            more = {"prefill_vs_reference_frac": float(
                np.abs(got - want).max() / np.abs(want).max()),
                "tokens_equal_reference": all(
                    np.array_equal(a[0], b[0])
                    for a, b in zip(calls, ref_calls))}
        report("port", layers, args.device, port, time.perf_counter() - t0,
               **more)
        del params
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
