"""The LM substrate of the port (configs, params, layers, attention, the
decoder-only forward and its KV cache) against the live reference, on the
same inputs made from seeds with numpy, at smoke size on the CPU.

Tolerances come from ``repro_torch.testing.parity``: ``LM_ATOL_FRAC`` in
float32 and ``LM_BF16_ATOL_FRAC`` in bfloat16, each a fraction of
max|reference|; initial normals within ``NORMAL_ATOL`` x their scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import attention as JA
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.model import Model as JModel
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.models import attention as TA
from repro_torch.models import layers as TL
from repro_torch.models import params as TP
from repro_torch.models import transformer as TT
from repro_torch.models.model import Model as TModel
from repro_torch.testing import parity

torch.set_num_threads(1)

#: the dense and vlm smoke configs (tests/test_torch_families.py holds the
#: moe, ssm, hybrid and audio ones)
SERVED = ("gemma2-2b", "qwen3-32b", "nemotron-4-15b", "stablelm-12b",
          "internvl2-1b")
DTYPES = ("float32", "bfloat16")
ARCHS = ("lartpc-uboone", "mamba2-780m", "internvl2-1b", "qwen3-32b",
         "nemotron-4-15b", "gemma2-2b", "stablelm-12b", "deepseek-moe-16b",
         "deepseek-v2-236b", "recurrentgemma-2b", "seamless-m4t-large-v2")
LM_ARCHS = ARCHS[1:]
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
#: the reference's attention jitted: one XLA compile a case instead of one
#: per primitive (the eager form compiles ~50 per call at new shapes)
JFLASH = jax.jit(JA.flash_attention,
                 static_argnames=("causal", "window", "logit_cap",
                                  "kv_block"))
JGQA = jax.jit(JA.gqa_attention, static_argnames=("cfg", "causal", "window"))
JCROSS = jax.jit(JA.cross_attention, static_argnames=("cfg",))
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(x):
    """A port tensor or reference array as float32 (or integer) numpy."""
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


def close_logits(port, ref, cfg, dtype: str, what: str = ""):
    """Logits over the real vocab within the tolerance; the padded rows
    -1e9 on both sides, exactly."""
    p, r = to_np(port), to_np(ref)
    v = cfg.vocab_size
    np.testing.assert_array_equal(p[..., v:], r[..., v:], err_msg=what)
    return close(p[..., :v], r[..., :v], dtype, what)


def pair(x, dtype: str):
    """One float32 numpy array as (reference array, port tensor) of
    ``dtype``: both round to nearest even, so the bits agree."""
    return jnp.asarray(x, JDT[dtype]), torch.from_numpy(
        np.ascontiguousarray(x)).to(TDT[dtype])


def smoke(arch, dtype="float32"):
    return (dataclasses.replace(jconfig.get_config(arch, smoke=True),
                                dtype=dtype),
            dataclasses.replace(tconfig.get_config(arch, smoke=True),
                                dtype=dtype))


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


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["MoEConfig", "MLAConfig", "SSMConfig",
                                  "RGLRUConfig", "ModelConfig"])
def test_dataclass_fields_and_defaults(name):
    ref = {f.name: f.default for f in dataclasses.fields(getattr(jconfig,
                                                                 name))}
    port = {f.name: f.default for f in dataclasses.fields(getattr(tconfig,
                                                                  name))}
    assert port == ref


@pytest.mark.parametrize("smoke_", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_get_config_matches(arch, smoke_):
    ref = jconfig.get_config(arch, smoke=smoke_)
    port = tconfig.get_config(arch, smoke=smoke_)
    assert type(port).__name__ == type(ref).__name__
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


def test_registry_lists_every_arch():
    from repro.configs import ARCH_IDS as JIDS
    from repro_torch.configs import ARCH_IDS

    assert list(tconfig.list_archs()) == list(jconfig.list_archs())
    assert ARCH_IDS == JIDS


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_count_matches(arch):
    ref = jconfig.get_config(arch)
    port = tconfig.get_config(arch)
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert (port.padded_vocab, port.resolved_head_dim) == (
        ref.padded_vocab, ref.resolved_head_dim)


def test_apply_overrides_reaches_nested_fields():
    over = {"moe.top_k": "3", "dtype": "float32", "qk_norm": "true"}
    ref = jconfig.apply_overrides(jconfig.get_config("deepseek-moe-16b"),
                                  dict(over))
    port = tconfig.apply_overrides(tconfig.get_config("deepseek-moe-16b"),
                                   dict(over))
    assert port.moe.top_k == 3
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)


@pytest.mark.parametrize("arch", ["mamba2-780m", "deepseek-moe-16b",
                                  "deepseek-v2-236b", "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_formerly_unported_family_builds(arch):
    """The moe (GQA and MLA), ssm, hybrid and audio families, which raised
    before ROADMAP item 17(b), build with the reference's stacks."""
    jcfg, tcfg = smoke(arch)
    model = TModel(tcfg, "cpu")
    assert model.is_encdec == JModel(jcfg).is_encdec
    assert [tuple(s) for s in TT.stacks_for(tcfg)] == [
        tuple(s) for s in JT.stacks_for(jcfg)]


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", LM_ARCHS)
def test_param_shapes_match_at_full_width(arch):
    """Keys, shapes and dtypes of the full configs (no values drawn)."""
    ref = flatten(JModel(jconfig.get_config(arch)).shapes())
    port = flatten(TModel(tconfig.get_config(arch), "cpu").shapes())
    assert list(port) == list(ref)
    for k in ref:
        assert tuple(port[k].shape) == tuple(ref[k].shape), k
        assert str(port[k].dtype).split(".")[-1] == str(ref[k].dtype), k


@pytest.mark.parametrize("arch", SERVED)
def test_init_matches_reference(arch):
    """Same keys, shapes and dtypes as the reference's init, and the same
    values: zeros and ones exactly, normals within erfinv ULPs x scale."""
    jcfg, tcfg = smoke(arch)
    ref = flatten(jax.tree.map(np.asarray,
                               JModel(jcfg).init(jax.random.key(3))))
    model = TModel(tcfg, "cpu")
    port = flatten(model.init(prng.key(3)))
    assert sorted(port) == sorted(ref)
    assert sorted(model.state_dict()) == sorted(ref)
    # each parameter's init and scale, as the builder asks for them
    inits = flatten(model._build(
        lambda path, shape, names, scale=1.0, init="normal", dtype_=None:
        (init, scale)))
    for k, r in ref.items():
        p = port[k].numpy()
        assert p.shape == r.shape and p.dtype == r.dtype, k
        init, scale = inits[k]
        if init in ("zeros", "ones"):
            np.testing.assert_array_equal(p, r, err_msg=k)
        else:
            np.testing.assert_allclose(p, r, rtol=0,
                                       atol=parity.NORMAL_ATOL * scale,
                                       err_msg=k)


def test_chunked_draw_equals_one_draw(monkeypatch):
    """Drawing a parameter in ranges of the element counter gives the
    bits of one draw."""
    _, tcfg = smoke("gemma2-2b")
    model = TModel(tcfg, "cpu")
    one = flatten(TP.init_params(model._build, prng.key(5), device="cpu"))
    monkeypatch.setattr(TP, "DRAW_CHUNK", 1000)
    ranged = flatten(TP.init_params(model._build, prng.key(5), device="cpu"))
    assert max(v.numel() for v in one.values()) > 1000
    for k in one:
        assert torch.equal(one[k], ranged[k]), k


def test_params_from_numpy_map_key_for_key():
    jm, jp, tm, tp = models("qwen3-32b")
    ref = flatten(jax.tree.map(np.asarray, jp))
    port = flatten(tp)
    assert sorted(port) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(port[k].numpy(), ref[k], err_msg=k)
    assert TP.count_params(tp) == sum(v.size for v in ref.values())
    assert tm.unembed_table(tp) is tp["unembed"]["table"]


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms(kind, dtype):
    rng = np.random.default_rng(0)
    jx, tx = pair(rng.standard_normal((2, 5, 64)).astype(np.float32) * 3,
                  dtype)
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    jparams = {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}
    tparams = {"scale": torch.from_numpy(scale),
               "bias": torch.from_numpy(bias)}
    if kind == "rmsnorm":
        del jparams["bias"], tparams["bias"]
    out = TL.apply_norm(tparams, tx, kind)
    assert out.dtype == TDT[dtype]
    close(out, JL.apply_norm(jparams, jx, kind), dtype, kind)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["swiglu", "squared_relu", "gelu", "relu"])
def test_mlp(kind, dtype):
    rng = np.random.default_rng(1)
    jx, tx = pair(rng.standard_normal((2, 5, 32)).astype(np.float32), dtype)
    shapes = {"w_up": (32, 48), "w_down": (48, 32), "w_gate": (32, 48)}
    if kind != "swiglu":
        del shapes["w_gate"]
    w = {k: (rng.standard_normal(s) * 0.3).astype(np.float32)
         for k, s in shapes.items()}
    out = TL.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()}, tx,
                       kind)
    ref = JL.apply_mlp({k: jnp.asarray(v) for k, v in w.items()}, jx, kind)
    close(out, ref, dtype, kind)


def test_gelu_is_the_tanh_approximation():
    """jax.nn.gelu's default is the tanh form; erf-GELU differs by more
    than the float32 tolerance here."""
    x = np.linspace(-4, 4, 101, dtype=np.float32)
    ref = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    w = {"w_up": np.eye(101, dtype=np.float32),
         "w_down": np.eye(101, dtype=np.float32)}
    out = TL.apply_mlp({k: torch.from_numpy(v) for k, v in w.items()},
                       torch.from_numpy(x)[None], "gelu")[0]
    close(out, ref, "float32")
    erf = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(erf - ref)) > 1e-4


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope(dtype):
    rng = np.random.default_rng(2)
    pos = rng.integers(0, 5000, (2, 7)).astype(np.int32)
    jcos, jsin = JL.rope_table(jnp.asarray(pos), 16, 1e6)
    tcos, tsin = TL.rope_table(torch.from_numpy(pos), 16, 1e6)
    close(tcos, jcos, "float32", "cos")
    close(tsin, jsin, "float32", "sin")
    jx, tx = pair(rng.standard_normal((2, 7, 3, 16)).astype(np.float32),
                  dtype)
    out = TL.apply_rope(tx, tcos, tsin)
    assert out.dtype == TDT[dtype]
    close(out, JL.apply_rope(jx, jcos, jsin), dtype, "rope")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cap", [0.0, 30.0, 50.0])
def test_softcap(cap, dtype):
    rng = np.random.default_rng(3)
    jx, tx = pair(rng.standard_normal((4, 50)).astype(np.float32) * 60,
                  dtype)
    out = TL.softcap(tx, cap)
    assert out.dtype == TDT[dtype]
    close(out, JL.softcap(jx, cap), dtype, "softcap")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["gemma2-2b", "qwen3-32b"])
def test_embed_and_unembed(arch, dtype):
    """gemma2's embedding_scale and final softcap, qwen3's plain tables;
    both smoke vocabs (128) pad to 256 rows, which unembed masks."""
    jcfg, tcfg = smoke(arch, dtype)
    assert jcfg.padded_vocab != jcfg.vocab_size
    rng = np.random.default_rng(4)
    table = rng.standard_normal((jcfg.padded_vocab, 64)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab_size, (2, 6)).astype(np.int32)
    jx = JL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks), jcfg)
    tx = TL.embed({"table": torch.from_numpy(table)}, torch.from_numpy(toks),
                  tcfg)
    assert tx.dtype == TDT[dtype]
    np.testing.assert_array_equal(to_np(tx), to_np(jx))
    jl = JL.unembed({"table": jnp.asarray(table)}, jx, jcfg)
    tl = TL.unembed({"table": torch.from_numpy(table)}, tx, tcfg)
    close_logits(tl, jl, tcfg, dtype, "unembed")


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _qkv(rng, b, sq, skv, h, hkv, d, dtype):
    return [pair(rng.standard_normal(s).astype(np.float32), dtype)
            for s in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))]


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def _flash_both(q, k, v, qpos, kvpos, dtype, kv_valid=None, **kw):
    jout = JFLASH(q[0], k[0], v[0], jnp.asarray(qpos),
                              jnp.asarray(kvpos),
                              kv_valid=None if kv_valid is None
                              else jnp.asarray(kv_valid), **kw)
    tout = TA.flash_attention(q[1], k[1], v[1], torch.from_numpy(qpos),
                              torch.from_numpy(kvpos),
                              kv_valid=None if kv_valid is None
                              else torch.from_numpy(kv_valid), **kw)
    assert tout.dtype == TDT[dtype]
    return close(tout, jout, dtype, str(kw))


@pytest.mark.parametrize("s,h,hkv,d,blk", [
    (64, 4, 4, 16, 16), (64, 8, 2, 32, 32), (48, 6, 1, 8, 16),
    (128, 4, 2, 64, 128)])
def test_flash_matches_reference_flash(s, h, hkv, d, blk):
    rng = np.random.default_rng(s + h + d)
    q, k, v = _qkv(rng, 2, s, s, h, hkv, d, "float32")
    _flash_both(q, k, v, _pos(2, s), _pos(2, s), "float32", causal=True,
                kv_block=blk)


@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("win", [0, 8, 17, 1000])
def test_flash_masking(win, cap):
    rng = np.random.default_rng(win)
    q, k, v = _qkv(rng, 1, 32, 32, 2, 2, 8, "float32")
    _flash_both(q, k, v, _pos(1, 32), _pos(1, 32), "float32", causal=True,
                window=win or None, logit_cap=cap, kv_block=8)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("sq", [1, 8, 9])
def test_flash_ragged_cache(sq, dtype):
    """A ring cache: slots hold shuffled positions, some empty (-1,
    kv_valid False); Skv = 40 is no multiple of kv_block = 16; Sq of 1 and
    8 take the direct path, 9 the blockwise one; window 17 and a
    softcap."""
    rng = np.random.default_rng(sq)
    b, skv = 2, 40
    q, k, v = _qkv(rng, b, sq, skv, 4, 2, 16, dtype)
    slots = np.stack([rng.permutation(skv) for _ in range(b)]).astype(
        np.int32)
    kvpos = np.where(slots < 34, slots + 30, -1).astype(np.int32)
    qpos = _pos(b, sq, 64 - sq)
    _flash_both(q, k, v, qpos, kvpos, dtype, kv_valid=kvpos >= 0,
                causal=True, window=17, logit_cap=50.0, kv_block=16)


def test_flash_all_masked_block_is_cancelled():
    """A block whose every key is masked contributes exp(0) = 1 terms with
    NEG_INF scores; the next valid block's corr = 0 cancels them (with -inf
    they would be NaN)."""
    rng = np.random.default_rng(9)
    q, k, v = _qkv(rng, 1, 12, 32, 2, 1, 8, "float32")
    kvpos = _pos(1, 32)
    valid = np.ones((1, 32), bool)
    valid[:, :16] = False
    out = _flash_both(q, k, v, _pos(1, 12, 20), kvpos, "float32",
                      kv_valid=valid, causal=True, kv_block=16)
    assert np.isfinite(out)


def _gqa_case(dtype, seed=0):
    jcfg, tcfg = smoke("gemma2-2b", dtype)
    jm, jp, tm, tp = models("gemma2-2b", dtype, seed)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mix"])
    tl = {k: v[0] for k, v in tp["layers"]["mix"].items()}
    return jcfg, tcfg, jl, tl


def _caches(jcfg, tcfg, rng, b, smax, index):
    """One layer's cache in both packages, filled with the same random
    k/v and positions index - smax .. index - 1 (older slots -1)."""
    hkv, dh = jcfg.num_kv_heads, jcfg.resolved_head_dim
    dt = jcfg.dtype
    k = rng.standard_normal((b, smax, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, smax, hkv, dh)).astype(np.float32)
    pos = np.full(smax, -1, np.int32)
    for p in range(max(0, index - smax), index):
        pos[p % smax] = p
    jc = JA.KVCache(k=jnp.asarray(k, JDT[dt]), v=jnp.asarray(v, JDT[dt]),
                    pos=jnp.asarray(pos), index=jnp.asarray(index, jnp.int32))
    tc = TA.KVCache(k=torch.from_numpy(k).to(TDT[dt]),
                    v=torch.from_numpy(v).to(TDT[dt]),
                    pos=torch.from_numpy(pos), index=index)
    return jc, tc


@pytest.mark.parametrize("case,dtype", [
    (c, "float32") for c in ("no_cache", "bulk_prefill", "append",
                             "decode_wrap", "clamped")] + [
    ("no_cache", "bfloat16"), ("append", "bfloat16")])
def test_gqa_attention(case, dtype):
    """gemma2 smoke (softcap 50, window 8): no cache; bulk prefill (sq >=
    smax keeps the last smax tokens); append into a partly filled cache;
    one decode step wrapping the ring; and write + sq > smax, where the
    reference's dynamic_update_slice clamps the start to smax - sq. The
    branches share their dtype handling, so bfloat16 runs two."""
    jcfg, tcfg, jl, tl = _gqa_case(dtype)
    rng = np.random.default_rng(11)
    b = 2
    sq, smax, index, window = {
        "no_cache": (12, 0, 0, 8), "bulk_prefill": (12, 8, 0, 0),
        "append": (5, 16, 6, 8), "decode_wrap": (1, 8, 13, 8),
        "clamped": (4, 16, 14, 0)}[case]
    jx, tx = pair(rng.standard_normal((b, sq, jcfg.d_model)).astype(
        np.float32), dtype)
    pos = _pos(b, sq, index)
    jcache = tcache = None
    if smax:
        jcache, tcache = _caches(jcfg, tcfg, rng, b, smax, index)
    jout, jnew = JGQA(jl, jx, jnp.asarray(pos), cfg=jcfg, window=window,
                      cache=jcache)
    tout, tnew = TA.gqa_attention(tl, tx, torch.from_numpy(pos), tcfg,
                                  window=window, cache=tcache)
    close(tout, jout, dtype, "out")
    if smax:
        if case == "clamped":
            np.testing.assert_array_equal(to_np(tnew.pos)[12:],
                                          [14, 15, 16, 17])
        for field in ("k", "v"):
            close(getattr(tnew, field), getattr(jnew, field), dtype, field)
        np.testing.assert_array_equal(to_np(tnew.pos), to_np(jnew.pos))
        assert tnew.index == int(jnew.index) == index + sq


@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention(dtype):
    """encode_cross_kv of an encoder output, then cross_attention of 9
    decoder positions (the blockwise path) over its 11 keys, with qwen3's
    qk-norm."""
    jcfg, tcfg = smoke("qwen3-32b", dtype)
    jm, jp, tm, tp = models("qwen3-32b", dtype)
    jl = jax.tree.map(lambda a: a[0], jp["layers"]["mix"])
    tl = {k: v[0] for k, v in tp["layers"]["mix"].items()}
    rng = np.random.default_rng(12)
    jx, tx = pair(rng.standard_normal((2, 9, 64)).astype(np.float32), dtype)
    je, te = pair(rng.standard_normal((2, 11, 64)).astype(np.float32), dtype)
    jkv = JA.encode_cross_kv(jl, je, jcfg)
    tkv = TA.encode_cross_kv(tl, te, tcfg)
    for name, t, j in zip("kv", tkv, jkv):
        close(t, j, dtype, name)
    out = TA.cross_attention(tl, tx, tkv, torch.from_numpy(_pos(2, 9)),
                             torch.from_numpy(_pos(2, 11)), tcfg)
    ref = JCROSS(jl, jx, jkv, jnp.asarray(_pos(2, 9)),
                 jnp.asarray(_pos(2, 11)), cfg=jcfg)
    close(out, ref, dtype, "cross")


def test_window_schedule_matches():
    for arch in SERVED:
        jcfg, tcfg = smoke(arch)
        js = JT.stacks_for(jcfg)[0]
        ts = TT.stacks_for(tcfg)[0]
        assert tuple(ts) == tuple(js)[:len(ts)]
        np.testing.assert_array_equal(np.asarray(TT.windows_of(tcfg, ts)),
                                      np.asarray(JT.window_schedule(jcfg,
                                                                    js)))


# ---------------------------------------------------------------------------
# The decoder-only forward, prefill and decode
# ---------------------------------------------------------------------------

def _batch(cfg, rng, b, s, with_frontend=True):
    toks = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    jb = {"tokens": jnp.asarray(toks)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend_tokens and with_frontend:
        fe = rng.standard_normal((b, cfg.frontend_tokens,
                                  cfg.d_model)).astype(np.float32)
        jb["frontend_embeds"] = jnp.asarray(fe)
        tb["frontend_embeds"] = torch.from_numpy(fe)
    return jb, tb


def _ref_cache(jcaches):
    c = jcaches["layers"]["kv"]
    return {"k": to_np(c.k), "v": to_np(c.v), "pos": np.asarray(c.pos),
            "index": np.asarray(c.index)}


def _close_caches(tcaches, jcaches, dtype, what):
    port = interop.caches_to_numpy(tcaches)["layers"]["kv"]
    ref = _ref_cache(jcaches)
    for field in ("k", "v"):
        close(port[field], ref[field], dtype, f"{what} cache {field}")
    for field in ("pos", "index"):
        np.testing.assert_array_equal(port[field], ref[field],
                                      err_msg=f"{what} cache {field}")


#: (arch, max_len, dtype): every served config appends its prompt into a
#: cache longer than it; gemma2 (local/global windows) and qwen3 (qk-norm)
#: also run a cache shorter than the prompt (bulk prefill keeps its last
#: max_len tokens, and decode wraps the ring), in float32
CACHE_CASES = [(a, 32, dt) for a in SERVED for dt in DTYPES] + [
    ("gemma2-2b", 8, "float32"), ("qwen3-32b", 8, "float32")]


@pytest.mark.parametrize("arch,max_len,dtype", CACHE_CASES)
def test_forward_prefill_and_decode_match(arch, max_len, dtype):
    """The forward without a cache (logits and features_only), then
    prefill (internvl2 with its frontend embeddings) and a decode step:
    equal logits and caches at each (the engine tests decode on)."""
    jm, jp, tm, tp = models(arch, dtype, seed=1)
    rng = np.random.default_rng(6)
    b = 2
    jb, tb = _batch(jm.cfg, rng, b, 10)
    if max_len == 32:
        close_logits(tm.forward(tp, tb)[0], jm.forward(jp, jb)[0], tm.cfg,
                     dtype, "forward")
    if max_len == 32 and dtype == "float32":
        close(tm.forward(tp, tb, features_only=True)[0],
              jm.forward(jp, jb, features_only=True)[0], dtype, "features")
    jc = jm.init_caches(b, max_len)
    tc = tm.init_caches(b, max_len)
    jl, jc, _ = jm.prefill(jp, jb, jc)
    tl, tc, _ = tm.prefill(tp, tb, tc)
    close_logits(tl, jl, tm.cfg, dtype, "prefill")
    _close_caches(tc, jc, dtype, "prefill")
    index = 10 + jm.cfg.frontend_tokens
    tok = rng.integers(0, jm.cfg.vocab_size, (b, 1)).astype(np.int32)
    jl, jc = jm.decode_step(jp, {"tokens": jnp.asarray(tok)}, jc,
                            jnp.asarray(index, jnp.int32))
    tl, tc = tm.decode_step(tp, {"tokens": torch.from_numpy(tok)}, tc, index)
    close_logits(tl, jl, tm.cfg, dtype, "decode")
    _close_caches(tc, jc, dtype, "decode")


@pytest.mark.parametrize("arch,dtype,layers", [
    ("gemma2-2b", "float32", 2), ("qwen3-32b", "float32", 2),
    ("gemma2-2b", "bfloat16", 26)])
def test_decode_equals_forward_last_position(arch, dtype, layers):
    """The port's cache path against its own forward: the decode step's
    logits equal the forward's last position over prompt + fed tokens, the
    check chip_smoke.py makes at full width. In bfloat16 at gemma2-2b's
    depth of 26 layers (smoke width) within ``lm_bf16_atol_frac(26)``."""
    _, tcfg = smoke(arch, dtype)
    tm = TModel(dataclasses.replace(tcfg, num_layers=layers), "cpu")
    tp = tm.init(prng.key(2))
    rng = np.random.default_rng(7)
    toks = torch.from_numpy(rng.integers(0, tm.cfg.vocab_size,
                                         (2, 14)).astype(np.int32))
    caches = tm.init_caches(2, 16)
    logits, caches, _ = tm.prefill(tp, {"tokens": toks[:, :11]}, caches)
    v = tm.cfg.vocab_size
    frac = (parity.lm_bf16_atol_frac(layers) if dtype == "bfloat16"
            else parity.LM_ATOL_FRAC)
    for i in range(11, 14):
        full, _ = tm.forward(tp, {"tokens": toks[:, :i]})
        parity.assert_close(to_np(logits[:, -1, :v]), to_np(full[:, -1, :v]),
                            rtol=0.0, atol_frac=frac, what=str(i))
        logits, caches = tm.decode_step(tp, {"tokens": toks[:, i:i + 1]},
                                        caches, i)
