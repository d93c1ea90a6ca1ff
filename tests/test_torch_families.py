"""The modules of the moe (MLA), ssm, hybrid and audio (enc-dec) LM families
against the live reference, one by one, on the same inputs made from numpy
seeds, at smoke size on the CPU, one thread.

Tolerances come from ``repro_torch.testing.parity``: ``LM_ATOL_FRAC`` of
max|reference| in float32, ``LM_BF16_ATOL_FRAC`` in bfloat16; the
``uniform_angle`` draws and the RG-LRU scan are compared bit for bit.
``tests/test_torch_family_models.py`` holds the models, the engine and the
census.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import attention as JA
from repro.models import encdec as JE
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import params as JP
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models.model import Model as JModel
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.models import attention as TA
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import params as TP
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models.model import Model as TModel
from repro_torch.testing import parity

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16")
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
#: the reference's functions jitted, as its model runs them (inside its
#: layer scan): one XLA compile a case, and XLA's own contractions
JMLA = jax.jit(JA.mla_attention, static_argnames=("cfg",))
JLRU = jax.jit(JR._lru_scan)


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).cpu().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(port, ref, dtype: str, what: str = ""):
    frac = parity.LM_BF16_ATOL_FRAC if dtype == "bfloat16" \
        else parity.LM_ATOL_FRAC
    return parity.assert_close(to_np(port), to_np(ref), rtol=0.0,
                               atol_frac=frac, what=what)


def pair(x, dtype: str):
    """One float32 numpy array as (reference array, port tensor) of
    ``dtype`` (both round to nearest even), each its own copy: the port
    writes caches in place, and JAX may still read a buffer it shares with
    numpy (its dispatch is asynchronous)."""
    return jnp.array(x, JDT[dtype]), torch.from_numpy(np.array(x)).to(
        TDT[dtype])


def smoke(arch, dtype="float32", **over):
    return (dataclasses.replace(jconfig.get_config(arch, smoke=True),
                                dtype=dtype, **over),
            dataclasses.replace(tconfig.get_config(arch, smoke=True),
                                dtype=dtype, **over))


def models(arch, dtype="float32", seed=0):
    """(reference model, its params, port model, the same params)."""
    jcfg, tcfg = smoke(arch, dtype)
    jm = JModel(jcfg)
    jp = jm.init(jax.random.key(seed))
    tm = TModel(tcfg, "cpu")
    tp = tm.load_params(interop.model_params_from_numpy(
        jax.tree.map(np.asarray, jp), "cpu"))
    return jm, jp, tm, tp


def flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


FAMILIES = ("deepseek-moe-16b", "deepseek-v2-236b", "mamba2-780m",
            "recurrentgemma-2b", "seamless-m4t-large-v2")


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def test_uniform_angle_bits():
    """``jax.random.uniform(k, shape, float32, -3.14159, 3.14159)`` of the
    RG-LRU's ``lam``, bit for bit, in one draw and in ranges of the
    counter."""
    def build(make):
        return {"lam": make("groups.g0.mix.lam", (3, 64), ("mlp",),
                            init="uniform_angle"),
                "wide": make("x.lam", (5000,), ("mlp",),
                             init="uniform_angle")}

    ref = jax.tree.map(np.asarray, JP.init_params(build, jax.random.key(7)))
    port = TP.init_params(build, prng.key(7), device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TP, "DRAW_CHUNK", 1000)
        ranged = TP.init_params(build, prng.key(7), device="cpu")
    for k, r in ref.items():
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), r, err_msg=k)
        np.testing.assert_array_equal(ranged[k].numpy(), r, err_msg=k)
    assert r.min() >= np.float32(-3.14159) and r.max() < np.float32(3.14159)


@pytest.mark.parametrize("arch", FAMILIES)
def test_init_matches_reference(arch):
    """Keys, shapes and dtypes of ``Model.init``, the reference's; zeros,
    ones and uniform_angle draws exactly, normals within ``NORMAL_ATOL`` x
    their scale. ``model_params_from_numpy`` maps the reference's tree key
    for key."""
    jcfg, tcfg = smoke(arch)
    jtree = jax.tree.map(np.asarray, JModel(jcfg).init(jax.random.key(3)))
    ref = flatten(jtree)
    model = TModel(tcfg, "cpu")
    port = flatten(model.init(prng.key(3)))
    assert sorted(port) == sorted(ref)
    assert sorted(model.state_dict()) == sorted(ref)
    inits = flatten(model._build(
        lambda path, shape, names, scale=1.0, init="normal", dtype_=None:
        (init, scale)))
    for k, r in ref.items():
        p = port[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        init, scale = inits[k]
        if init == "normal":
            np.testing.assert_allclose(p, r, rtol=0,
                                       atol=parity.NORMAL_ATOL * scale,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(p, r, err_msg=k)
    carried = flatten(interop.model_params_from_numpy(jtree, "cpu"))
    assert sorted(carried) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(carried[k].numpy(), ref[k], err_msg=k)


# ---------------------------------------------------------------------------
# causal_conv1d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cached", [False, True])
def test_causal_conv1d(cached, dtype):
    """K = 4 shifted multiply-adds; the cache (cast to x's dtype) stands for
    the K-1 inputs before the first; the new cache is the last K-1."""
    rng = np.random.default_rng(1)
    jx, tx = pair(rng.standard_normal((2, 5, 24)).astype(np.float32), dtype)
    w = (rng.standard_normal((4, 24)) * 0.2).astype(np.float32)
    cache = rng.standard_normal((2, 3, 24)).astype(np.float32)
    jc, tc = (jnp.asarray(cache), torch.from_numpy(cache)) if cached \
        else (None, None)
    jout, jnew = JL.causal_conv1d(jx, jnp.asarray(w), jc)
    tout, tnew = TL.causal_conv1d(tx, torch.from_numpy(w), tc)
    assert tout.dtype == tnew.dtype == TDT[dtype]
    close(tout, jout, dtype, "out")
    np.testing.assert_array_equal(to_np(tnew), to_np(jnew))


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def _ref_routing(router, x, top_k):
    """The reference's routing lines (``repro.models.moe.apply_moe``,
    "route") on its own inputs: (probs, ids)."""
    xf = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(jnp.einsum("td,de->te", xf.astype(jnp.float32),
                                      router), axis=-1)
    _, ids = jax.lax.top_k(probs, top_k)
    return np.asarray(probs), np.asarray(ids)


def _moe_input(rng, drops: bool):
    """(4, 128, 64) tokens: random, or with 300 identical rows (as the
    engine's left pads are), which all route to the same two experts."""
    x = rng.standard_normal((4, 128, 64)).astype(np.float32)
    if drops:
        x.reshape(-1, 64)[:300] = x.reshape(-1, 64)[0]
    return x


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("drops", [False, True])
def test_apply_moe(drops, dtype):
    """deepseek-moe smoke's first MoE layer (8 experts, top 2, 2 shared) on
    512 tokens: capacity 168. Random tokens put at most ~143 pairs on an
    expert (no drop); 300 identical rows overflow two experts. Output, aux,
    routing ids and the dropped (token, expert) pairs equal the
    reference's."""
    jm, jp, tm, tp = models("deepseek-moe-16b", dtype)
    jl = jax.tree.map(lambda a: a[0], jp["moe_layers"]["ffn"])
    tl = {k: v[0] if isinstance(v, torch.Tensor) else
          {kk: vv[0] for kk, vv in v.items()}
          for k, v in tp["moe_layers"]["ffn"].items()}
    jx, tx = pair(_moe_input(np.random.default_rng(2), drops), dtype)
    jout, jaux = JMOE.apply_moe(jl, jx, jm.cfg)
    with TMOE.routing_log() as log:
        tout, taux = TMOE.apply_moe(tl, tx, tm.cfg)
    assert tout.dtype == TDT[dtype] and taux.dtype == torch.float32
    close(tout, jout, dtype, "out")
    parity.assert_close(taux.item(), float(jaux), rtol=parity.LM_ATOL_FRAC,
                        atol_frac=0.0, what="aux")
    probs, ids = _ref_routing(jl["router"], jx, jm.cfg.moe.top_k)
    (entry,) = log
    np.testing.assert_array_equal(entry["ids"].numpy(), ids)
    close(entry["probs"], probs, "float32", "probs")
    m = jm.cfg.moe
    cap = JMOE._capacity(512, m.num_experts, m.top_k, m.capacity_factor)
    counts = np.bincount(ids.reshape(-1), minlength=m.num_experts)
    ref_drops = int(np.maximum(counts - cap, 0).sum())
    assert entry["cap"] == cap == 168
    np.testing.assert_array_equal(entry["counts"].numpy(), counts)
    assert TMOE.dropped_pairs(entry).item() == ref_drops
    assert (ref_drops > 0) == drops


def test_moe_ties_rank_the_lower_expert_first():
    """``jax.lax.top_k`` ranks equal probabilities by the lower index; so
    does the port's stable sort. A zero router gives every expert 1/E."""
    _, tcfg = smoke("deepseek-moe-16b")
    router = torch.zeros((64, 8))
    probs, weights, ids = TMOE.route(router, torch.ones((3, 64)), 2)
    jids = jax.lax.top_k(jax.nn.softmax(jnp.zeros((3, 8))), 2)[1]
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))
    assert ids.tolist() == [[0, 1]] * 3
    np.testing.assert_array_equal(weights.numpy(), np.full((3, 2), 0.5))


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

def _mla_cache(jcfg, rng, b, smax, index, dtype):
    m = jcfg.mla
    c = rng.standard_normal((b, smax, m.kv_lora_rank)).astype(np.float32)
    r = rng.standard_normal((b, smax, m.rope_head_dim)).astype(np.float32)
    (jc_kv, tc_kv), (jk, tk) = pair(c, dtype), pair(r, dtype)
    return (JA.MLACache(c_kv=jc_kv, k_rope=jk,
                        index=jnp.asarray(index, jnp.int32)),
            TA.MLACache(c_kv=tc_kv, k_rope=tk, index=index))


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in ("no_cache", "bulk_prefill", "absorbed_prefill",
                             "decode", "clamped")] + [
    ("no_cache", "bfloat16"), ("absorbed_prefill", "bfloat16"),
    ("decode", "bfloat16")])
def test_mla_attention(case, dtype):
    """deepseek-v2 smoke's MLA (4 heads, latent 32, rope 8): no cache (the
    expanded form); a bulk prefill of 12 into 8 slots (expanded, the last 8
    latents kept); a prefill of 12 into 32 slots (the absorbed form through
    the blockwise flash, Sq > 8); one decode step at index 20 of a filled
    cache; and a write of 4 at index 14 of 16 slots, which the reference's
    dynamic_update_slice clamps to slot 12."""
    jm, jp, tm, tp = models("deepseek-v2-236b", dtype)
    jl = jax.tree.map(lambda a: a[0], jp["dense_layers"]["mix"])
    tl = {k: v[0] for k, v in tp["dense_layers"]["mix"].items()}
    rng = np.random.default_rng(5)
    b = 2
    sq, smax, index = {"no_cache": (12, 0, 0), "bulk_prefill": (12, 8, 0),
                       "absorbed_prefill": (12, 32, 0),
                       "decode": (1, 32, 20), "clamped": (4, 16, 14)}[case]
    jx, tx = pair(rng.standard_normal((b, sq, 64)).astype(np.float32), dtype)
    pos = np.broadcast_to(np.arange(index, index + sq, dtype=np.int32),
                          (b, sq)).copy()
    jc = tc = None
    if smax:
        jc, tc = _mla_cache(jm.cfg, rng, b, smax, index, dtype)
        before = to_np(tc.c_kv).copy()
    jout, jnew = JMLA(jl, jx, jnp.asarray(pos), cfg=jm.cfg, cache=jc)
    tout, tnew = TA.mla_attention(tl, tx, torch.from_numpy(pos), tm.cfg,
                                  cache=tc)
    assert tout.dtype == TDT[dtype]
    close(tout, jout, dtype, "out")
    if not smax:
        assert tnew is None and jnew is None
        return
    for field in ("c_kv", "k_rope"):
        close(getattr(tnew, field), getattr(jnew, field), dtype, field)
    assert tnew.index == int(jnew.index) == index + sq
    if case == "clamped":
        # the write landed at slots 12-15: 0-11 keep the cache's own
        after = to_np(tnew.c_kv)
        np.testing.assert_array_equal(after[:, :12], before[:, :12])
        assert not np.any(after[:, 12:] == before[:, 12:])


def test_mla_rescale_rounds_like_jax():
    """The absorbed form multiplies a bfloat16 q by a weak-typed Python
    float, which JAX rounds to bfloat16 first (sqrt(3) -> 1.734375); torch's
    ``x * float`` takes the float in full. The port's 0-d bfloat16 tensor
    gives JAX's bits."""
    scale = (576 ** 0.5) * (192 ** -0.5)
    x = np.float32([1.6667, -0.3, 2.5, 7.1])
    ref = np.asarray(jnp.asarray(x, jnp.bfloat16) * scale).astype(np.float32)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    port = tx * torch.full((), scale, dtype=torch.bfloat16)
    np.testing.assert_array_equal(port.float().numpy(), ref)
    assert ref[0] == np.float32(2.890625)
    assert (tx * scale).float()[0].item() == 2.875


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------

def _ssd_inputs(rng, b, l, h, p, n):
    x = rng.standard_normal((b, l, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, l, h)))).astype(np.float32)
    a = -np.exp(rng.standard_normal(h) * 0.5).astype(np.float32)
    bm = rng.standard_normal((b, l, 1, n)).astype(np.float32)
    cm = rng.standard_normal((b, l, 1, n)).astype(np.float32)
    return x, dt, a, bm, cm


@pytest.mark.parametrize("initial", [False, True])
def test_ssd_chunked(initial):
    """Four chunks of 8 over 4 heads of 8, state 16, from zeros and from a
    given state: y and the final state."""
    rng = np.random.default_rng(8)
    arrays = _ssd_inputs(rng, 2, 32, 4, 8, 16)
    s0 = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    jy, js = JS.ssd_chunked(*map(jnp.asarray, arrays), 8,
                            initial_state=jnp.asarray(s0) if initial
                            else None)
    ty, ts = TS.ssd_chunked(*map(torch.from_numpy, arrays), 8,
                            initial_state=torch.from_numpy(s0) if initial
                            else None)
    close(ty, jy, "float32", "y")
    close(ts, js, "float32", "state")


def test_ssd_decode_step_and_length_rule():
    """One recurrent step from a state; and a length that is no multiple of
    the chunk raises in both packages (the reference asserts)."""
    rng = np.random.default_rng(9)
    x, dt, a, bm, cm = _ssd_inputs(rng, 2, 1, 4, 8, 16)
    s0 = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    jy, js = JS.ssd_decode_step(*map(jnp.asarray, (x, dt, a, bm, cm, s0)))
    ty, ts = TS.ssd_decode_step(*map(torch.from_numpy,
                                     (x, dt, a, bm, cm, s0)))
    close(ty, jy, "float32", "y")
    close(ts, js, "float32", "state")
    long_ = _ssd_inputs(rng, 1, 20, 4, 8, 16)
    with pytest.raises(AssertionError):
        JS.ssd_chunked(*map(jnp.asarray, long_), 8)
    with pytest.raises(AssertionError):
        TS.ssd_chunked(*map(torch.from_numpy, long_), 8)


def test_softplus_is_logaddexp():
    """jax.nn.softplus = logaddexp(x, 0); F.softplus returns x itself above
    20, one ULP off it there."""
    x = np.float32([-30.0, -1.0, 0.0, 3.0, 20.5, 25.0, 40.0])
    ref = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(TS.softplus(torch.from_numpy(x)).numpy(), ref,
                               rtol=parity.LM_ATOL_FRAC, atol=0)


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("h0", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_lru_scan_bits(n, h0):
    """The odd/even recursion of jax.lax.associative_scan with the jitted
    reference's FMAs: bit for bit, with and without h0."""
    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 48)).astype(np.float32)
    b = rng.standard_normal((2, n, 48)).astype(np.float32)
    h = rng.standard_normal((2, 48)).astype(np.float32)
    ref = np.asarray(JLRU(jnp.asarray(a), jnp.asarray(b),
                          jnp.asarray(h) if h0 else None))
    port = TR._lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                        torch.from_numpy(h) if h0 else None)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["no_cache", "prefill", "decode"])
def test_apply_rglru(mode, dtype):
    """recurrentgemma smoke's first recurrent block: a prompt without a
    cache, a prompt from a cached state, and one decode step."""
    jm, jp, tm, tp = models("recurrentgemma-2b", dtype)
    jl = jax.tree.map(lambda a: a[0], jp["groups"]["g0_mix"])
    tl = {k: v[0] for k, v in tp["groups"]["g0_mix"].items()}
    rng = np.random.default_rng(11)
    s = 1 if mode == "decode" else 9
    jx, tx = pair(rng.standard_normal((2, s, 64)).astype(np.float32), dtype)
    jc = tc = None
    if mode != "no_cache":
        h = rng.standard_normal((2, 64)).astype(np.float32)
        conv = rng.standard_normal((2, 3, 64)).astype(np.float32)
        (jh, th), (jconv, tconv) = pair(h, "float32"), pair(conv, dtype)
        jc = JR.RGLRUCache(h=jh, conv=jconv)
        tc = TR.RGLRUCache(h=th, conv=tconv)
    jout, jnew = jax.jit(JR.apply_rglru, static_argnames=("cfg",))(
        jl, jx, cfg=jm.cfg, cache=jc)
    tout, tnew = TR.apply_rglru(tl, tx, tm.cfg, tc)
    close(tout, jout, dtype, "out")
    if tc is not None:
        # a float32 state of bfloat16 activations: the activations' rule
        close(tnew.h, jnew.h, dtype, "h")
        np.testing.assert_array_equal(to_np(tnew.conv), to_np(jnew.conv))


# ---------------------------------------------------------------------------
# Encoder-decoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
def test_encdec_forward(dtype):
    """seamless smoke: the forward without caches; then a prefill into
    caches and a decode step that reuses the prefill's encoder output, which
    gives the bits of passing the frames again."""
    jm, jp, tm, tp = models("seamless-m4t-large-v2", dtype)
    rng = np.random.default_rng(12)
    toks = rng.integers(0, 128, (2, 10)).astype(np.int32)
    frames = rng.standard_normal((2, 13, 64)).astype(np.float32)
    je, te = jnp.asarray(frames), torch.from_numpy(frames)
    jl, _, jaux, _ = JE.encdec_forward(jp, jnp.asarray(toks), je, jm.cfg)
    tl, _, taux, _ = TE.encdec_forward(tp, torch.from_numpy(toks), te,
                                       tm.cfg)
    close(tl[..., :128], jl[..., :128], dtype, "forward")
    assert float(taux) == float(jaux) == 0.0
    jc, tc = jm.init_caches(2, 16), tm.init_caches(2, 16)
    jl, jc, _, jenc = JE.encdec_forward(jp, jnp.asarray(toks), je, jm.cfg,
                                        caches=jc, start_index=jnp.zeros(
                                            (), jnp.int32))
    tl, tc, _, tenc = TE.encdec_forward(tp, torch.from_numpy(toks), te,
                                        tm.cfg, caches=tc, start_index=0)
    close(tl[..., :128], jl[..., :128], dtype, "prefill")
    close(tenc[0], jenc[0], dtype, "encoder states")
    tok = rng.integers(0, 128, (2, 1)).astype(np.int32)
    jl, jc, _, _ = JE.encdec_forward(jp, jnp.asarray(tok), None, jm.cfg,
                                     caches=jc, enc_out=jenc,
                                     start_index=jnp.asarray(10, jnp.int32))
    again = {k: {e: c._replace(k=c.k.clone(), v=c.v.clone(),
                               pos=c.pos.clone()) for e, c in v.items()}
             for k, v in tc.items()}
    tl, tc, _, _ = TE.encdec_forward(tp, torch.from_numpy(tok), None, tm.cfg,
                                     caches=tc, enc_out=tenc, start_index=10)
    close(tl[..., :128], jl[..., :128], dtype, "decode")
    port = interop.caches_to_numpy(tc)["layers"]["kv"]
    ref = jc["layers"]["kv"]
    for field in ("k", "v"):
        close(port[field], getattr(ref, field), dtype, field)
    np.testing.assert_array_equal(port["pos"], np.asarray(ref.pos))
    np.testing.assert_array_equal(port["index"], np.asarray(ref.index))
    fresh, _, _, _ = TE.encdec_forward(tp, torch.from_numpy(tok), te, tm.cfg,
                                       caches=again, start_index=10)
    assert torch.equal(fresh, tl)
