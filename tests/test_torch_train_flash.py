"""The training slice's hand-written derivatives and losses against the
live reference, on the CPU at small shapes: the blockwise attention's
backward (``_FlashCore`` against ``jax.vjp`` of the reference's
``flash_attention``, whose ``custom_vjp`` is ``_flash_bwd``), a float64
``gradcheck`` of it, the RG-LRU scan's gradient, and ``chunked_lm_loss`` /
``lm_loss`` with their gradients.

Tolerances: ``parity.LM_GRAD_ATOL_FRAC`` of max|reference| per gradient
in float32, ``parity.lm_bf16_grad_atol_frac`` in bfloat16.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import rglru as JR
from repro_torch import config as tconfig
from repro_torch.models import attention as TA
from repro_torch.models.layers import softcap
from repro_torch.models import model as TM
from repro_torch.models import rglru as TR
from repro_torch.testing import parity

torch.set_num_threads(1)

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def pair(x, dtype="float32", grad=True):
    """One float32 numpy array as (reference array, port leaf) of
    ``dtype`` (both round to nearest even)."""
    t = torch.from_numpy(np.ascontiguousarray(x)).to(TDT[dtype])
    return jnp.asarray(x, JDT[dtype]), t.requires_grad_(grad)


def grad_close(port, ref, dtype, what):
    frac = (parity.LM_GRAD_ATOL_FRAC if dtype == "float32"
            else parity.lm_bf16_grad_atol_frac(2))
    return parity.assert_close(to_np(port), to_np(ref), rtol=0.0,
                               atol_frac=frac, what=what)


# ---------------------------------------------------------------------------
# Flash attention backward
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_vjp(causal, window, cap, kv_block):
    """The reference's (out, dq, dk, dv) jitted for one static setting."""
    def f(q, k, v, qp, kp, dout):
        out, vjp = jax.vjp(
            lambda q, k, v: JA.flash_attention(
                q, k, v, qp, kp, causal=causal, window=window,
                logit_cap=cap, kv_block=kv_block), q, k, v)
        return (out,) + vjp(dout)
    return jax.jit(f)


#: (Sq, Skv, H, Hkv, window, softcap, kv_block, causal): windows 0, 8 and
#: 17, softcap on and off, GQA groups 1-4, Skv a multiple of kv_block and
#: not (padded rows), several blocks and one
FLASH_CASES = [
    (32, 32, 4, 2, 0, 0.0, 8, True),
    (32, 32, 4, 2, 8, 50.0, 8, True),
    (40, 40, 4, 1, 17, 0.0, 16, True),
    (24, 37, 2, 2, 0, 50.0, 16, False),
    (45, 45, 8, 2, 8, 0.0, 32, True),
    (16, 16, 4, 4, 17, 30.0, 1024, True),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=[f"sq{c[0]}-skv{c[1]}-h{c[2]}-kv{c[3]}-w{c[4]}"
                              f"-cap{c[5]:g}-blk{c[6]}" for c in FLASH_CASES])
def test_flash_backward_matches_reference(case, dtype):
    sq, skv, h, hkv, window, cap, blk, causal = case
    rng = np.random.default_rng(sq * 100 + skv)
    d, b = 16, 2
    q = rng.standard_normal((b, sq, h, d), np.float32)
    k = rng.standard_normal((b, skv, hkv, d), np.float32)
    v = rng.standard_normal((b, skv, hkv, d), np.float32)
    dout = rng.standard_normal((b, sq, h, d), np.float32)
    qp = np.broadcast_to(np.arange(skv - sq, skv, dtype=np.int32),
                         (b, sq)).copy()
    kp = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    (jq, tq), (jk, tk), (jv, tv) = (pair(x, dtype) for x in (q, k, v))
    jdo, tdo = pair(dout, dtype, grad=False)
    ref = _ref_vjp(causal, window, cap, blk)(jq, jk, jv, jnp.asarray(qp),
                                            jnp.asarray(kp), jdo)
    out = TA.flash_attention(tq, tk, tv, torch.from_numpy(qp),
                             torch.from_numpy(kp), causal=causal,
                             window=window, logit_cap=cap, kv_block=blk)
    assert out.grad_fn is not None and "FlashCore" in out.grad_fn.name()
    dq, dk, dv = torch.autograd.grad(out, (tq, tk, tv), tdo)
    assert dk.shape == tk.shape and dv.shape == tv.shape
    frac = (parity.LM_ATOL_FRAC if dtype == "float32"
            else parity.LM_BF16_ATOL_FRAC)
    parity.assert_close(to_np(out), to_np(ref[0]), rtol=0.0, atol_frac=frac,
                        what="out")
    for name, port, r in (("dq", dq, ref[1]), ("dk", dk, ref[2]),
                          ("dv", dv, ref[3])):
        assert port.dtype == TDT[dtype], name
        grad_close(port, r, dtype, name)


def test_flash_backward_gradcheck():
    """float64 finite differences at a tiny shape: two blocks with a padded
    tail, a window and the softcap."""
    rng = np.random.default_rng(5)
    b, sq, h, hkv, d = 1, 10, 2, 1, 4
    q, k, v = (torch.from_numpy(rng.standard_normal(s)).double()
               .requires_grad_() for s in ((b, sq, h, d), (b, sq, hkv, d),
                                           (b, sq, hkv, d)))
    pos = torch.arange(sq, dtype=torch.int32)[None]

    def f(q, k, v):
        return TA.flash_attention(q, k, v, pos, pos, causal=True, window=6,
                                  logit_cap=3.0, kv_block=4)

    assert torch.autograd.gradcheck(f, (q, k, v), eps=1e-6, atol=1e-7)


def test_direct_attention_keeps_autograd():
    """Sq <= 8 takes the direct form under plain autograd."""
    q = torch.randn(1, 4, 2, 8, requires_grad=True)
    kv = torch.randn(1, 4, 2, 8)
    pos = torch.arange(4, dtype=torch.int32)[None]
    out = TA.flash_attention(q, kv, kv, pos, pos, causal=True)
    assert "FlashCore" not in out.grad_fn.name()
    (g,) = torch.autograd.grad(out.sum(), (q,))
    assert torch.isfinite(g).all()


# ---------------------------------------------------------------------------
# RG-LRU scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_h0", [False, True])
def test_lru_scan_gradient(with_h0):
    """The scan's gradient (through ``_FusedMulAdd``) against the jitted
    reference's, with and without an initial state; the forward still
    equals it bit for bit."""
    rng = np.random.default_rng(7)
    bsz, s, w = 2, 13, 6
    a = rng.uniform(0.5, 0.99, (bsz, s, w)).astype(np.float32)
    bb = rng.standard_normal((bsz, s, w), np.float32)
    h0 = rng.standard_normal((bsz, w), np.float32)
    dh = rng.standard_normal((bsz, s, w), np.float32)

    def f(a, b, h0):
        out, vjp = jax.vjp(lambda a, b, h0: JR._lru_scan(
            a, b, h0 if with_h0 else None), a, b, h0)
        return (out,) + vjp(dh)

    ref = jax.jit(f)(a, bb, h0)
    ta, tb, th = (torch.from_numpy(x.copy()).requires_grad_()
                  for x in (a, bb, h0))
    out = TR._lru_scan(ta, tb, th if with_h0 else None)
    np.testing.assert_array_equal(to_np(out), np.asarray(ref[0]))
    grads = torch.autograd.grad(out, (ta, tb, th) if with_h0 else (ta, tb),
                                torch.from_numpy(dh))
    for name, g, r in zip(("da", "db", "dh0"), grads, ref[1:]):
        grad_close(g, r, "float32", name)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------

def _loss_cfgs(vocab, cap, dtype):
    kw = dict(vocab_size=vocab, final_logit_softcap=cap, dtype=dtype,
              d_model=16)
    return jconfig.ModelConfig(**kw), tconfig.ModelConfig(**kw)


def test_chunk_count_rule():
    """S - 1 = 4 095 features give 7 chunks of 585; 8 divides 64."""
    seen = []

    def record(xb, *a):
        seen.append(xb.shape[1])
        return (torch.zeros((), dtype=torch.float32),) * 2

    cfg = tconfig.ModelConfig(vocab_size=8)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(TM, "_chunk_nll", record)
        for s in (4095, 64):
            seen.clear()
            TM.chunked_lm_loss(torch.zeros(1, s, 1), torch.zeros(8, 1),
                               torch.zeros(1, s, dtype=torch.int32), cfg)
            assert seen == ([585] * 7 if s == 4095 else [8] * 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab,cap,masked", [(250, 30.0, False),
                                              (256, 0.0, True)])
def test_chunked_lm_loss_matches_reference(vocab, cap, masked, dtype):
    """Value and gradients (features, table) against the reference's
    ``chunked_lm_loss``, over 7 chunks, with the softcap and a padded vocab
    (250 -> 256) or a loss mask; and against ``lm_loss`` of the full
    logits."""
    jcfg, tcfg = _loss_cfgs(vocab, cap, dtype)
    rng = np.random.default_rng(vocab)
    b, s, d, v = 2, 21, 16, tcfg.padded_vocab
    feats = rng.standard_normal((b, s, d), np.float32)
    table = rng.standard_normal((v, d), np.float32)
    labels = rng.integers(0, vocab, (b, s)).astype(np.int32)
    mask = ((rng.random((b, s)) < 0.7).astype(np.float32) if masked
            else None)
    jf, tf = pair(feats, dtype)
    jt, tt = pair(table)

    def ref_fn(f, t):
        return JM.chunked_lm_loss(f, t, jnp.asarray(labels), jcfg,
                                  None if mask is None else jnp.asarray(mask))

    jl, (jgf, jgt) = jax.jit(jax.value_and_grad(ref_fn, argnums=(0, 1)))(
        jf, jt)
    tmask = None if mask is None else torch.from_numpy(mask)
    tl = TM.chunked_lm_loss(tf, tt, torch.from_numpy(labels), tcfg, tmask)
    gf, gt = torch.autograd.grad(tl, (tf, tt))
    loss_tol = (parity.LM_GRAD_ATOL_FRAC if dtype == "float32"
                else parity.lm_bf16_atol_frac(2))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=loss_tol)
    grad_close(gf, jgf, dtype, "d features")
    grad_close(gt, jgt, dtype, "d table")

    # lm_loss of the full logits (the reference's, on its own unembed)
    logits = softcap(torch.matmul(tf.detach(), tt.detach().to(tf.dtype).t()),
                     cap).float()
    logits[..., vocab:] = -1e9
    full = TM.lm_loss(logits, torch.from_numpy(labels), tmask)
    np.testing.assert_allclose(float(full), float(tl.detach()),
                               rtol=loss_tol)
    jfull = JM.lm_loss(jnp.asarray(logits.numpy()), jnp.asarray(labels),
                       None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(float(full), float(jfull),
                               rtol=parity.LM_GRAD_ATOL_FRAC)
