"""The port's slot engine and serving launcher against the live reference
(``repro.serve.engine``), on the same requests and parameters, at smoke
size on the CPU.

Untied configs in float32 must give the reference's tokens. Random tied
configs greedily repeat a prompt token, so their tokens prove little:
their logits are compared at every step of a wave, fed the reference's
tokens, within ``parity.LM_ATOL_FRAC`` of max|logit|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models.model import Model as JModel
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeEngine as JEngine
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model as TModel
from repro_torch.serve.engine import Request, ServeEngine, greedy_sample
from repro_torch.testing import parity

torch.set_num_threads(1)

#: (prompt length, max_new_tokens) of each request: more requests than
#: slots, mixed prompt lengths (left padding) and mixed limits
REQUESTS = ((6, 4), (9, 2), (4, 5), (7, 1), (5, 3))
SLOTS = 2
MAX_LEN = 24


def models(arch):
    jcfg = dataclasses.replace(jconfig.get_config(arch, smoke=True),
                               dtype="float32")
    tcfg = dataclasses.replace(tconfig.get_config(arch, smoke=True),
                               dtype="float32")
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(4))
    tm = TModel(tcfg, "cpu")
    tp = tm.load_params(interop.model_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    return jm, jp, tm, tp


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32)
            for n, _ in REQUESTS]


@pytest.mark.parametrize("arch", ["qwen3-32b", "nemotron-4-15b",
                                  "stablelm-12b"])
def test_engine_tokens_match_untied(arch):
    jm, jp, tm, tp = models(arch)
    ps = prompts(jm.cfg.vocab_size)
    ref = JEngine(jm, SLOTS, MAX_LEN).generate(
        jp, [JRequest(p, m) for p, (_, m) in zip(ps, REQUESTS)])
    engine = ServeEngine(tm, SLOTS, MAX_LEN)
    port = engine.generate(tp, [Request(p, m) for p, (_, m) in
                                zip(ps, REQUESTS)])
    assert [r.out_tokens for r in port] == [r.out_tokens for r in ref]
    assert [len(r.out_tokens) for r in port] == [m for _, m in REQUESTS]
    assert all(r.done for r in port)
    # three waves, one prefill each; a wave decodes to its longest limit
    assert len(engine.times["prefill_s"]) == 3
    assert len(engine.times["decode_s"]) == (4 - 1) + (5 - 1) + (3 - 1)


@pytest.mark.parametrize("arch", ["gemma2-2b", "internvl2-1b"])
def test_engine_logits_match_tied(arch):
    """The first wave's prefill and decode logits, both packages fed the
    reference engine's tokens (left-padded prompts of lengths 6 and 9)."""
    jm, jp, tm, tp = models(arch)
    ps = prompts(jm.cfg.vocab_size, seed=1)[:SLOTS]
    new = 3
    ref = JEngine(jm, SLOTS, MAX_LEN).generate(
        jp, [JRequest(p, new) for p in ps])
    port = ServeEngine(tm, SLOTS, MAX_LEN).generate(
        tp, [Request(p, new) for p in ps])
    plen = max(len(p) for p in ps)
    toks = np.zeros((SLOTS, plen), np.int32)
    for i, p in enumerate(ps):
        toks[i, -len(p):] = p
    fed = np.array([r.out_tokens for r in ref], np.int32)
    jc = jm.init_caches(SLOTS, MAX_LEN)
    tc = tm.init_caches(SLOTS, MAX_LEN)
    jl, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    v = jm.cfg.vocab_size
    for step in range(new):
        parity.assert_close(tl[:, -1, :v].numpy(), np.asarray(jl)[:, -1, :v],
                            rtol=0.0, atol_frac=parity.LM_ATOL_FRAC,
                            what=f"step {step}")
        np.testing.assert_array_equal(
            greedy_sample(tl).numpy(), np.asarray(jl[:, -1].argmax(-1)))
        if step == new - 1:
            break
        tok = fed[:, step:step + 1]
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jc,
                                jnp.asarray(plen + step, jnp.int32))
        tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, tc,
                                plen + step)
    assert [r.out_tokens for r in port] == fed.tolist()


def test_greedy_sample_takes_the_first_maximum():
    logits = np.zeros((3, 2, 7), np.float32)
    logits[0, -1, [2, 5]] = 1.0
    logits[1, -1, :] = 3.0
    logits[2, 0, 6] = 9.0            # an earlier position is ignored
    port = greedy_sample(torch.from_numpy(logits))
    ref = np.asarray(jnp.argmax(jnp.asarray(logits)[:, -1], axis=-1))
    assert port.dtype == torch.int32
    np.testing.assert_array_equal(port.numpy(), ref)
    assert port.tolist() == [2, 0, 0]


def test_launch_serve_runs_on_the_cpu(capsys):
    assert launch_serve.main(["--arch", "qwen3-32b", "--smoke", "--device",
                              "cpu", "--requests", "3", "--slots", "2",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("3 requests, 9 tokens in ")
    assert out.count("  req") == 3


def test_launch_serve_run_returns_stats():
    args = launch_serve.build_parser().parse_args(
        ["--arch", "gemma2-2b", "--device", "cpu", "--requests", "3",
         "--slots", "2", "--prompt-len", "5", "--new-tokens", "4"])
    done, stats = launch_serve.run(args)
    assert [len(r.out_tokens) for r in done] == [4, 4, 4]
    assert stats["tokens"] == 12 and stats["device"] == "cpu"
    assert len(stats["prefill_ms"]) == 2 and len(stats["decode_ms"]) == 6
    assert stats["tokens_per_s"] == 12 / stats["seconds"]
    # a given model is served as it is, without a new draw
    model, _ = launch_serve.build_model(args)
    again, stats2 = launch_serve.run(args, model=model)
    assert stats2["init_s"] is None
    assert [r.out_tokens for r in again] == [r.out_tokens for r in done]


@pytest.mark.parametrize("argv,error", [
    (["--arch", "lartpc-uboone", "--device", "cpu"], SystemExit),
    (["--arch", "mamba2-780m", "--device", "cpu"], NotImplementedError),
    (["--arch", "seamless-m4t-large-v2", "--device", "cpu"],
     NotImplementedError),
    (["--arch", "qwen3-32b"], RuntimeError)])
def test_launch_serve_refuses(argv, error, monkeypatch):
    """The simulator's config, an unported family, and the default card
    when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(error):
        launch_serve.main(argv)
