"""The slot engine and the serving launcher on the moe (GQA and MLA), ssm
and hybrid families against the live reference's engine, the enc-dec
refusal, the reference's ring quirk after a bulk prefill, and the host
reads of a decode step of every family, at smoke size on the CPU, one
thread. Float32, ``parity.LM_ATOL_FRAC`` of max|logit|; untied configs give
the reference's tokens.
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
from repro_torch.analysis.census import Census
from repro_torch.core import prng
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import Model as TModel
from repro_torch.serve.engine import Request, ServeEngine, greedy_sample
from repro_torch.testing import parity

torch.set_num_threads(1)

FAMILIES = ("deepseek-moe-16b", "deepseek-v2-236b", "mamba2-780m",
            "recurrentgemma-2b", "seamless-m4t-large-v2")
B, MAX_LEN = 2, 32


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def models(arch, seed=1):
    """(reference model, its params, port model, the same params), float32:
    the port's draw, handed to the reference through numpy (a copy each),
    so the reference compiles no draw (``tests/test_torch_families.py``
    holds the two draws against each other)."""
    jm = JModel(dataclasses.replace(jconfig.get_config(arch, smoke=True),
                                    dtype="float32"))
    tm = TModel(dataclasses.replace(tconfig.get_config(arch, smoke=True),
                                    dtype="float32"), "cpu")
    tp = tm.init(prng.key(seed))
    jp = jax.tree.map(lambda t: jnp.array(t.numpy()), tp)
    return jm, jp, tm, tp


def test_bulk_prefill_ring_matches_the_reference_quirk():
    """A prompt longer than a windowed cache takes the bulk path, which
    keeps its last S_max positions in slots 0..S_max-1; the next decode
    step writes slot index % S_max, which then holds a position inside the
    window, so the step attends to one key fewer than the forward does.
    The reference does this (ROADMAP queue 3, reference caveats), and the
    port does what it does: recurrentgemma smoke, window 8, prompt 9."""
    jm, jp, tm, tp = models("recurrentgemma-2b")
    rng = np.random.default_rng(3)
    toks = rng.integers(0, 128, (B, 10)).astype(np.int32)
    jc, tc = jm.init_caches(B, MAX_LEN), tm.init_caches(B, MAX_LEN)
    _, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks[:, :9])}, jc)
    _, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks[:, :9])}, tc)
    jl, _ = jm.decode_step(jp, {"tokens": jnp.asarray(toks[:, 9:])}, jc,
                           jnp.asarray(9, jnp.int32))
    tl, _ = tm.decode_step(tp, {"tokens": torch.from_numpy(toks[:, 9:])}, tc,
                           9)
    jfull, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    v = jm.cfg.vocab_size
    ref, port = to_np(jl)[:, -1, :v], to_np(tl)[:, -1, :v]
    parity.assert_close(port, ref, rtol=0.0, atol_frac=parity.LM_ATOL_FRAC)
    gap = np.abs(ref - to_np(jfull)[:, -1, :v]).max()
    assert gap > 100 * parity.LM_ATOL_FRAC * np.abs(ref).max()


# ---------------------------------------------------------------------------
# The engine and the launcher
# ---------------------------------------------------------------------------

#: (prompt length, max_new_tokens) of each request: more requests than
#: slots, mixed prompt lengths (left padding) and mixed limits
REQUESTS = ((6, 4), (9, 2), (4, 5), (7, 1), (5, 3))
SLOTS = 2
ENGINE_LEN = 24


def prompts(vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=(n,), dtype=np.int32)
            for n, _ in REQUESTS]


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_engine_tokens_match_untied(arch):
    """The untied deepseek configs in float32: the reference engine's
    tokens, three waves of two slots."""
    jm, jp, tm, tp = models(arch, seed=4)
    ps = prompts(jm.cfg.vocab_size)
    ref = JEngine(jm, SLOTS, ENGINE_LEN).generate(
        jp, [JRequest(p, m) for p, (_, m) in zip(ps, REQUESTS)])
    engine = ServeEngine(tm, SLOTS, ENGINE_LEN)
    port = engine.generate(tp, [Request(p, m) for p, (_, m) in
                                zip(ps, REQUESTS)])
    assert [r.out_tokens for r in port] == [r.out_tokens for r in ref]
    assert [len(r.out_tokens) for r in port] == [m for _, m in REQUESTS]
    assert len(engine.times["prefill_s"]) == 3


@pytest.mark.parametrize("arch", ["mamba2-780m", "recurrentgemma-2b"])
def test_engine_logits_match_tied(arch):
    """The tied configs repeat a prompt token, so their tokens prove little:
    the first wave's prefill and decode logits, both packages fed the
    reference engine's tokens, and the port's engine gives those tokens."""
    jm, jp, tm, tp = models(arch, seed=4)
    ps = prompts(jm.cfg.vocab_size, seed=1)[:SLOTS]
    new = 3
    ref = JEngine(jm, SLOTS, ENGINE_LEN).generate(
        jp, [JRequest(p, new) for p in ps])
    port = ServeEngine(tm, SLOTS, ENGINE_LEN).generate(
        tp, [Request(p, new) for p in ps])
    plen = max(len(p) for p in ps)
    toks = np.zeros((SLOTS, plen), np.int32)
    for i, p in enumerate(ps):
        toks[i, -len(p):] = p
    fed = np.array([r.out_tokens for r in ref], np.int32)
    jc, tc = jm.init_caches(SLOTS, ENGINE_LEN), tm.init_caches(SLOTS,
                                                               ENGINE_LEN)
    jl, jc, _ = jm.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tl, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    v = jm.cfg.vocab_size
    for step in range(new):
        parity.assert_close(to_np(tl)[:, -1, :v], to_np(jl)[:, -1, :v],
                            rtol=0.0, atol_frac=parity.LM_ATOL_FRAC,
                            what=f"step {step}")
        np.testing.assert_array_equal(greedy_sample(tl).numpy(),
                                      np.asarray(jl[:, -1].argmax(-1)))
        if step == new - 1:
            break
        tok = fed[:, step:step + 1]
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jc,
                                jnp.asarray(plen + step, jnp.int32))
        tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, tc,
                                plen + step)
    assert [r.out_tokens for r in port] == fed.tolist()


def test_engine_refuses_encdec_like_the_reference():
    """The reference's engine fails on seamless with KeyError 'enc_embeds'
    (ROADMAP queue 3's caveat); the port's refuses it up front, naming
    it."""
    jm, jp, tm, tp = models("seamless-m4t-large-v2")
    with pytest.raises(KeyError, match="enc_embeds"):
        JEngine(jm, SLOTS, ENGINE_LEN).generate(
            jp, [JRequest(np.arange(4, dtype=np.int32), 2)])
    with pytest.raises(ValueError, match="enc_embeds"):
        ServeEngine(tm, SLOTS, ENGINE_LEN)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b",
                                  "mamba2-780m", "recurrentgemma-2b"])
def test_launch_serve_runs_every_decoder_family(arch, capsys):
    assert launch_serve.main(["--arch", arch, "--device", "cpu",
                              "--requests", "3", "--slots", "2",
                              "--new-tokens", "3"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("3 requests, 9 tokens in ")
    assert out.count("  req") == 3


# ---------------------------------------------------------------------------
# Host reads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_step_reads_nothing_on_the_host(arch):
    """The census of one ``decode_step`` after a prefill records no host
    read at all: the cache index and the layer windows are host ints, the
    MoE counts a scatter_add_ (no bincount), its first-choice density a
    scatter_add_ (F.one_hot reads the ids' range on the CPU)."""
    tm = TModel(tconfig.get_config(arch, smoke=True), "cpu")
    tp = tm.init(prng.key(0))
    caches = tm.init_caches(B, MAX_LEN)
    batch = {"tokens": torch.zeros((B, 5), dtype=torch.int32)}
    if tm.is_encdec:
        batch["enc_embeds"] = torch.zeros((B, 7, tm.cfg.d_model))
    _, caches, extras = tm.prefill(tp, batch, caches)
    with Census() as census:
        tm.decode_step(tp, {"tokens": batch["tokens"][:, :1]}, caches, 5,
                       extras)
    assert dict(census.host_syncs) == {}
