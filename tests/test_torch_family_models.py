"""The moe (GQA and MLA), ssm, hybrid and audio (enc-dec) LM families as
models against the live reference: forward, prefill and decode with their
caches, at smoke size on the CPU, one thread
(``tests/test_torch_family_serve.py`` holds the engine, the launcher and
the host reads of a decode step).

Float32 is held to ``parity.LM_ATOL_FRAC`` of max|reference| and equal MoE
routing; bfloat16 to ``LM_BF16_ATOL_FRAC``, where an MoE top-k choice may
flip at a near-tie (``parity.moe_flips``): the reference's routing is
recorded through a ``jax.debug.callback`` wrapped around its
``apply_moe``, and a flipped token and the later positions of its sequence
(which attend to it) are left out of the comparison.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import moe as JMOE
from repro.models.model import Model as JModel
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.models import moe as TMOE
from repro_torch.models.model import Model as TModel
from repro_torch.testing import parity

torch.set_num_threads(1)

FAMILIES = ("deepseek-moe-16b", "deepseek-v2-236b", "mamba2-780m",
            "recurrentgemma-2b", "seamless-m4t-large-v2")
DTYPES = ("float32", "bfloat16")
#: batch, prompt length (one SSD chunk of mamba2 smoke), cache length
B, S, MAX_LEN = 2, 16, 32


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def frac(dtype: str) -> float:
    return parity.LM_BF16_ATOL_FRAC if dtype == "bfloat16" \
        else parity.LM_ATOL_FRAC


def models(arch, dtype="float32", seed=1):
    """(reference model, its params, port model, the same params): the
    port's draw, handed to the reference through numpy (a copy each), so
    the reference compiles no draw (``tests/test_torch_families.py`` holds
    the two draws against each other)."""
    jm = JModel(dataclasses.replace(jconfig.get_config(arch, smoke=True),
                                    dtype=dtype))
    tm = TModel(dataclasses.replace(tconfig.get_config(arch, smoke=True),
                                    dtype=dtype), "cpu")
    tp = tm.init(prng.key(seed))
    jp = jax.tree.map(lambda t: jnp.array(t.numpy()), tp)
    return jm, jp, tm, tp


@contextlib.contextmanager
def ref_routing():
    """Record the reference's (router probabilities, top-k ids) of every
    ``apply_moe`` call inside the block, in call order: its own routing
    lines on its own inputs, sent to the host by ``jax.debug.callback``
    from inside its layer scan."""
    log = []
    apply_moe = JMOE.apply_moe

    def recorded(params, x, cfg):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32),
                                          params["router"]), axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda p, i: log.append((np.asarray(p),
                                                    np.asarray(i))),
                           probs, ids, ordered=True)
        return apply_moe(params, x, cfg)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "apply_moe", recorded)
        yield log


class Reach:
    """(B, S) positions a bfloat16 MoE flip reaches: the flipped token and
    every later position of its sequence."""

    def __init__(self, b, s):
        self.mask = np.zeros((b, s), bool)

    def update(self, flipped):
        """Add the (B, S') flips of one MoE call (S' = 1 for a decode
        step, which lands at the sequence's next position)."""
        b, s = flipped.shape
        if s == 1:
            self.mask = np.concatenate([self.mask, np.zeros((b, 1), bool)], 1)
            self.mask[:, -1] = self.mask[:, -2] | flipped[:, 0]
            return
        hit = np.cumsum(flipped, axis=1) > 0
        self.mask |= hit


def check_routing(tlog, jlog, dtype, reach, b, s):
    """Every MoE call: router probabilities within the dtype's rule and
    equal ids (so equal drops) in float32; in bfloat16 flips only at
    near-ties, positions already reached left out, and a flip in a call
    that drops pairs reaches every position (the capacity couples the
    tokens). Returns the number of flips."""
    assert len(tlog) == len(jlog) > 0
    flips = 0
    for entry, (jprobs, jids) in zip(tlog, jlog):
        live = ~reach.mask[:, -s:].reshape(-1) if s > 1 else \
            ~reach.mask[:, -1]
        tprobs, tids = to_np(entry["probs"]), to_np(entry["ids"])
        parity.assert_close(tprobs[live], jprobs[live], rtol=0.0,
                            atol_frac=frac(dtype), what="router probs")
        if dtype == "float32":
            np.testing.assert_array_equal(tids, jids)
            continue
        flipped = np.zeros(b * s, bool)
        flipped[live] = parity.moe_flips(tids[live], jids[live],
                                         tprobs[live], jprobs[live])
        flips += int(flipped.sum())
        reach.update(flipped.reshape(b, s))
        ref_counts = np.bincount(jids.reshape(-1),
                                 minlength=jprobs.shape[-1])
        if flipped.any() and (TMOE.dropped_pairs(entry).item()
                              or np.any(ref_counts > entry["cap"])):
            # a flip moves other tokens across an expert's capacity
            reach.mask[:] = True
    return flips


def close_logits(port, ref, cfg, dtype, keep, what):
    """Logits over the real vocab within the dtype's rule at the (B, S)
    positions ``keep``; the padded rows -1e9 on both sides."""
    p, r = to_np(port), to_np(ref)
    v = cfg.vocab_size
    np.testing.assert_array_equal(p[..., v:], r[..., v:], err_msg=what)
    parity.assert_close(p[..., :v][keep], r[..., :v][keep], rtol=0.0,
                        atol_frac=frac(dtype), what=what)


def close_caches(tcaches, jcaches, dtype, reach, what):
    """Every cache field of every stack: floats within the dtype's rule
    (a position's slot left out once a flip reaches it; slot = position
    here, no ring wraps), integers exact."""
    port = interop.caches_to_numpy(tcaches)
    assert sorted(port) == sorted(jcaches)
    for stack, entries in port.items():
        for entry, fields in entries.items():
            ref = jcaches[stack][entry]._asdict()
            assert sorted(fields) == sorted(ref)
            for name, arr in fields.items():
                r = to_np(ref[name])
                tag = f"{what} {stack}.{entry}.{name}"
                if arr.dtype.kind != "f":
                    np.testing.assert_array_equal(arr, r, err_msg=tag)
                    continue
                assert arr.shape == r.shape, tag
                if arr.ndim >= 3 and reach.mask.any():
                    # (L, B, slots, ...): keep the unreached slots
                    n = reach.mask.shape[1]
                    keep = np.ones(arr.shape[1:3], bool)
                    keep[:, :n] = ~reach.mask
                    arr, r = arr[:, keep], r[:, keep]
                parity.assert_close(arr, r, rtol=0.0, atol_frac=frac(dtype),
                                    what=tag)


def batches(cfg, rng, s):
    toks = rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": torch.from_numpy(toks)}
    if cfg.is_encoder_decoder:
        frames = rng.standard_normal((B, 11, cfg.d_model)).astype(np.float32)
        jb["enc_embeds"] = jnp.array(frames)
        tb["enc_embeds"] = torch.from_numpy(frames)
    return jb, tb


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", FAMILIES)
def test_forward_prefill_and_decode_match(arch, dtype):
    """``Model.forward`` (logits and aux), ``prefill`` into caches longer
    than the prompt (MLA's absorbed form; recurrentgemma's window of 8
    keeps the last 8 of 16, the bulk path) and one ``decode_step``: logits,
    MoE routing and every cache field against the reference's."""
    jm, jp, tm, tp = models(arch, dtype)
    cfg = tm.cfg
    moe = cfg.family == "moe"
    rng = np.random.default_rng(6)
    jb, tb = batches(cfg, rng, S)

    reach = Reach(B, S)
    with ref_routing() as jlog, TMOE.routing_log() as tlog:
        jl, jaux = jm.forward(jp, jb)
        tl, taux = tm.forward(tp, tb)
    flips = check_routing(tlog, jlog, dtype, reach, B, S) if moe else 0
    close_logits(tl, jl, cfg, dtype, ~reach.mask, "forward")
    if not reach.mask.any():
        parity.assert_close(taux.item(), float(jaux), rtol=frac(dtype),
                            atol_frac=0.0, what="aux")
    assert (float(taux) > 0) == moe

    reach = Reach(B, S)
    jc, tc = jm.init_caches(B, MAX_LEN), tm.init_caches(B, MAX_LEN)
    with ref_routing() as jlog, TMOE.routing_log() as tlog:
        jl, jc, jx = jm.prefill(jp, jb, jc)
        tl, tc, tx = tm.prefill(tp, tb, tc)
    if moe:
        flips += check_routing(tlog, jlog, dtype, reach, B, S)
    close_logits(tl, jl, cfg, dtype, ~reach.mask, "prefill")
    close_caches(tc, jc, dtype, reach, "prefill")
    assert sorted(tx) == sorted(jx)

    tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    with ref_routing() as jlog, TMOE.routing_log() as tlog:
        jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jc,
                                jnp.asarray(S, jnp.int32), jx)
        tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, tc, S,
                                tx)
    if moe:
        flips += check_routing(tlog, jlog, dtype, reach, B, 1)
    close_logits(tl, jl, cfg, dtype, ~reach.mask[:, -1:], "decode")
    close_caches(tc, jc, dtype, reach, "decode")
    assert dtype == "bfloat16" or flips == 0


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_equals_forward(arch):
    """The port's cache path against its own forward, the check
    chip_smoke.py makes at full width: each decode step's logits equal the
    forward's at that position over the tokens fed so far. The MoE configs
    run at capacity factor E / k, where no expert drops a pair (at 1.25 a
    forward over more tokens drops pairs that a decode step never does:
    two different functions). mamba2's forward runs over the tokens padded
    at the end to a multiple of its chunk (16): the model is causal, so the
    padding leaves the earlier positions as they are. recurrentgemma's
    prompt of 6 fits its window of 8, and its decode wraps the ring."""
    tcfg = dataclasses.replace(tconfig.get_config(arch, smoke=True),
                               dtype="float32")
    if tcfg.moe is not None:
        tcfg = dataclasses.replace(tcfg, moe=dataclasses.replace(
            tcfg.moe, capacity_factor=tcfg.moe.num_experts / tcfg.moe.top_k))
    tm = TModel(tcfg, "cpu")
    tp = tm.init(prng.key(2))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, tcfg.vocab_size,
                                         (B, 12)).astype(np.int32))
    extra = {}
    if tm.is_encdec:
        extra["enc_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, 9, tcfg.d_model)).astype(np.float32))
    caches = tm.init_caches(B, MAX_LEN)
    logits, caches, ext = tm.prefill(tp, {"tokens": toks[:, :6], **extra},
                                     caches)
    chunk = tcfg.ssm.chunk if tcfg.ssm is not None else 1
    v = tcfg.vocab_size
    for i in range(6, 12):
        padded = torch.nn.functional.pad(toks[:, :i], (0, -i % chunk))
        full, _ = tm.forward(tp, {"tokens": padded, **extra})
        parity.assert_close(to_np(logits[:, -1, :v]),
                            to_np(full[:, i - 1, :v]), rtol=0.0,
                            atol_frac=parity.LM_ATOL_FRAC, what=str(i))
        logits, caches = tm.decode_step(tp, {"tokens": toks[:, i:i + 1]},
                                        caches, i, ext)


def test_ssm_forward_length_rule():
    """A forward longer than mamba2's chunk must be a multiple of it: both
    packages raise for 20 tokens at chunk 16."""
    jm, jp, tm, tp = models("mamba2-780m")
    toks = np.zeros((1, 20), np.int32)
    with pytest.raises(AssertionError):
        jm.forward(jp, {"tokens": jnp.asarray(toks)})
    with pytest.raises(AssertionError):
        tm.forward(tp, {"tokens": torch.from_numpy(toks)})
