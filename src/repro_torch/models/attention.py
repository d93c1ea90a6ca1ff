"""Attention: GQA (+qk-norm, softcap, sliding window), MLA, cross-attention.

All softmax attention goes through ``flash_attention``: for ``Sq > 8`` the
reference's blockwise forward, an online softmax over KV blocks of
``kv_block`` keys written in torch ops (O(Sq * block) score memory, no
library attention kernel), and for ``Sq <= 8`` (every decode step) the
direct form. Scores and the softmax state are float32; the probabilities
are rounded to the values' dtype before the PV product, as the reference's
``p.astype(vblk.dtype)`` does. The products of bfloat16 inputs are taken in
float32 (the reference's ``preferred_element_type``): the inputs are
widened, which is exact. float64 inputs stay float64 (``_wide``), so a
float64 ``gradcheck`` sees the function itself.

The blockwise form runs as ``_FlashCore``, an autograd function: its
forward also keeps the log-sum-exp, and its backward is the reference's
``_flash_bwd``, which recomputes each block's scores instead of keeping the
(Sq x Skv) probabilities autograd would save. Where no input takes a
gradient, ``apply`` runs the forward alone and records nothing.
Under a step that splits its products over ``model`` (``parallel.fsdp``:
the train step and the serving steps), ``gqa_attention`` computes this
rank's heads only: wq and wo arrive as their ``model`` blocks, and wk and
wv too where ``model`` divides the kv heads. Where it does not (8 kv heads
on 16 ranks), the reference repeats the kv heads to the full head count
(``_maybe_repeat_kv``, called where the reference calls it: the cache-less
forward and the bulk prefill) and shards the repeat by heads; the port
projects only the kv heads this rank's q heads read, repeats them, and
takes its own heads of the repeat: the same values. ``wo``'s product is
then this rank's partial sum, which the segment reduce-scatters or sums
(``models.transformer``). A split step's cache meets the layout of
``parallel.kvcache``, where a rank's block holds every kv head of its
slots: a bulk prefill also projects every kv head, with wk and wv
gathered whole, on the positions of this rank's slots only; a decode or
append step gathers the new token's kv heads over ``model`` before the
write, and, where the slots split over ``model``, every rank's q heads,
so that it attends with every head over its own slots and keeps its own
heads of the combined output (``kvcache.combine_heads``).
``mla_attention`` splits its heads the same way; its latent and rope key
have no head dim, so every rank computes and writes them whole.

A cache's ``index`` (the tokens written so far) is a Python int, the same
for every layer of a stacked cache: it picks the slots a step writes, which
the reference's ``dynamic_update_slice`` takes as a traced value, so no
step reads the card to find them.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import MLAConfig, ModelConfig
from repro_torch.device import scalar
from repro_torch.models.layers import apply_rope, rmsnorm, rope_table, softcap
from repro_torch.parallel import fsdp, kvcache
from repro_torch.parallel.sharding import (current_act_rules, current_mesh,
                                           mesh_shape)

NEG_INF = -2.0e38


# ---------------------------------------------------------------------------
# Flash-style blocked attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, q_pos, kv_pos, *, causal: bool,
                    window=None, logit_cap: float = 0.0,
                    kv_block: int = 1024,
                    kv_valid: Optional[torch.Tensor] = None):
    """q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D); positions: (B,Sq)/(B,Skv) int32.

    window: sliding-window width, an int (0/None = global).
    kv_valid: (B,Skv) bool — False entries masked (decode cache padding).
    Returns (B,Sq,H,D).
    """
    window = int(window or 0)
    blocked = _blocked(q, k, v, kv_pos, kv_valid, kv_block)
    if blocked is None:
        return _direct_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window or None, logit_cap=logit_cap,
                                 kv_valid=kv_valid)
    # the pad's own backward drops the padded rows of dk and dv
    k, v, kv_pos, kv_valid, kv_block = blocked
    return _FlashCore.apply(q, k, v, q_pos, kv_pos, kv_valid, window,
                            causal, logit_cap, kv_block)


def _blocked(q, k, v, kv_pos, kv_valid, kv_block):
    """None where Sq is small enough for the unblocked direct form
    (decode); else (k, v, kv_pos, kv_valid, kv_block) for the blockwise
    form: the keys padded (position -1, invalid) to whole blocks of
    ``min(kv_block, Skv)``."""
    if q.shape[1] <= 8:
        return None
    b, skv = k.shape[0], k.shape[1]
    kv_block = min(kv_block, skv)
    nblk = (skv + kv_block - 1) // kv_block
    pad = nblk * kv_block - skv
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=k.device)
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
        kv_valid = torch.nn.functional.pad(kv_valid, (0, pad), value=False)
    return k, v, kv_pos, kv_valid, kv_block


def _blk_mask(pblk, q_pos, vldblk, causal, window):
    """(B,1,1,Sq,C) mask of keys at ``pblk`` (B,C): valid, causal, inside
    the window (0 = global)."""
    mask = vldblk[:, None, None, None, :]
    kp = pblk[:, None, None, None, :]
    qp = q_pos[:, None, None, :, None]
    if causal:
        mask = mask & (kp <= qp)
    if window:
        mask = mask & (kp > qp - window)
    return mask


def _wide(x):
    """``x`` widened to float32 (float64 stays)."""
    return x if x.dtype == torch.float64 else x.float()


def _grouped(q, hkv):
    """(B,Sq,H,D) -> float32 (B,Hkv,G*Sq,D): the query heads of each kv
    head stacked, so one batched product serves the group."""
    b, sq, h, d = q.shape
    g = h // hkv
    return _wide(q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, d))


def _blk_scores(qf, kblk, scale, logit_cap, g):
    """(B,Hkv,G,Sq,C) float32 scores of qf (B,Hkv,G*Sq,D) against kblk
    (B,Hkv,C,D)."""
    b, hkv, gsq, _ = qf.shape
    s = torch.matmul(qf, _wide(kblk).transpose(-1, -2)) * scale
    s = s.view(b, hkv, g, gsq // g, -1)
    if logit_cap:
        s = softcap(s, logit_cap)
    return s


def _weighted(p, vblk):
    """sum_c p[..., q, c] v[..., c, :] in float32, with ``p`` (B,Hkv,G,Sq,C)
    rounded to ``vblk``'s dtype first; vblk (B,Hkv,C,D)."""
    b, hkv, g, sq, c = p.shape
    pv = torch.matmul(_wide(p.to(vblk.dtype)).reshape(b, hkv, g * sq, c),
                      _wide(vblk))
    return pv.view(b, hkv, g, sq, -1)


def _to_blocks(k, v, kv_pos, kv_valid, nblk, kv_block):
    """Per-block views: k, v (nblk, B, Hkv, C, D); pos, valid (nblk, B, C)."""
    b, _, hkv, d = k.shape
    kb = k.permute(0, 2, 1, 3).reshape(b, hkv, nblk, kv_block, d)
    vb = v.permute(0, 2, 1, 3).reshape(b, hkv, nblk, kv_block, d)
    posb = kv_pos.reshape(b, nblk, kv_block)
    validb = kv_valid.reshape(b, nblk, kv_block)
    return (kb.movedim(2, 0), vb.movedim(2, 0), posb.movedim(1, 0),
            validb.movedim(1, 0))


def _flash_state(q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                 logit_cap, kv_block):
    """The online softmax over the KV blocks, one block a step (the
    reference's ``lax.scan``): (the float32 output (B,Hkv,G,Sq,D) of each
    query head, the float32 log-sum-exp (B,Hkv,G,Sq) of its scores)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nblk = skv // kv_block
    scale = d ** -0.5
    qf = _grouped(q, hkv)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=qf.dtype, device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=qf.dtype, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=qf.dtype, device=q.device)
    neg = torch.full((), NEG_INF, dtype=qf.dtype, device=q.device)
    for kblk, vblk, pblk, vldblk in zip(*_to_blocks(k, v, kv_pos, kv_valid,
                                                    nblk, kv_block)):
        s = _blk_scores(qf, kblk, scale, logit_cap, g)
        s = torch.where(_blk_mask(pblk, q_pos, vldblk, causal, window), s,
                        neg)
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _weighted(p, vblk)
        m = m_new
    lse = m + torch.log(torch.clamp_min(l, 1e-30))
    return acc / torch.clamp_min(l[..., None], 1e-30), lse


def _heads_last(out, q):
    """(B,Hkv,G,Sq,D) -> (B,Sq,H,D) in ``q``'s dtype."""
    b, sq, h, _ = q.shape
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, -1).to(q.dtype)


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                    logit_cap, kv_block):
    """(out (B,Sq,H,D), the float32 log-sum-exp (B,Hkv,G,Sq) of each
    query's scores, the backward's) of ``_flash_state``."""
    out, lse = _flash_state(q, k, v, q_pos, kv_pos, kv_valid, window,
                            causal, logit_cap, kv_block)
    return _heads_last(out, q), lse


def _flash_bwd_impl(q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                    logit_cap, kv_block, out, lse, dout):
    """The reference's ``_flash_bwd``: per KV block the scores again,
    p = exp(s - lse) (masked), delta = sum(dout * out), ds = p (dp - delta)
    times the softcap's derivative 1 - (s / cap)**2; dq summed over the
    blocks, dk and dv a block each. Everything in float32; returns dq, dk,
    dv in their inputs' dtypes."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nblk = skv // kv_block
    scale = d ** -0.5
    qf = _grouped(q, hkv)                                  # (B,Hkv,G*Sq,D)
    dof = _grouped(dout, hkv)
    delta = torch.sum(dof * _grouped(out, hkv), dim=-1).view(b, hkv, g, sq)
    cap = scalar(logit_cap, qf).to(qf.dtype) if logit_cap else None
    dq = torch.zeros_like(qf)
    dks, dvs = [], []
    for kblk, vblk, pblk, vldblk in zip(*_to_blocks(k, v, kv_pos, kv_valid,
                                                    nblk, kv_block)):
        kf = _wide(kblk)
        s = _blk_scores(qf, kblk, scale, logit_cap, g)
        mask = _blk_mask(pblk, q_pos, vldblk, causal, window)
        p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
        pf = p.reshape(b, hkv, g * sq, -1)
        dvs.append(torch.matmul(pf.transpose(-1, -2), dof))   # (B,Hkv,C,D)
        dp = torch.matmul(dof, _wide(vblk).transpose(-1, -2)).view_as(p)
        ds = p * (dp - delta[..., None])
        if cap is not None:
            # d/dx softcap(x) = 1 - (softcap(x)/cap)^2; s holds softcap(x)
            ds = ds * (1.0 - torch.square(s / cap))
        ds = ds.reshape(b, hkv, g * sq, -1)
        dq = dq + torch.matmul(ds, kf) * scale
        dks.append(torch.matmul(ds.transpose(-1, -2), qf) * scale)
    dq = dq.view(b, hkv, g, sq, d).permute(0, 3, 1, 2, 4).reshape(b, sq, h, d)
    # (B,Hkv,C,D) blocks -> (B,Skv,Hkv,D)
    dk = torch.cat(dks, dim=2).permute(0, 2, 1, 3)
    dv = torch.cat(dvs, dim=2).permute(0, 2, 1, 3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _FlashCore(torch.autograd.Function):
    """The blockwise attention with the reference's custom VJP: the
    forward keeps q, k, v, out and the log-sum-exp, never a block's
    scores, so its memory is O(Sq * block) in the backward too."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                logit_cap, kv_block):
        out, lse = _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, window,
                                   causal, logit_cap, kv_block)
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, kv_valid, out, lse)
        ctx.static = (window, causal, logit_cap, kv_block)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, kv_valid, out, lse = ctx.saved_tensors
        window, causal, logit_cap, kv_block = ctx.static
        dq, dk, dv = _flash_bwd_impl(q, k, v, q_pos, kv_pos, kv_valid,
                                     window, causal, logit_cap, kv_block,
                                     out, lse, dout)
        return dq, dk, dv, None, None, None, None, None, None, None


def _direct_state(q, k, v, q_pos, kv_pos, *, causal, window, logit_cap,
                  kv_valid):
    """Unblocked attention for tiny Sq (decode): (the float32 output
    (B,Hkv,G,Sq,D), the scores' max and the sum of their exponentials
    (B,Hkv,G,Sq,1))."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    s = _blk_scores(_grouped(q, hkv), k.permute(0, 2, 1, 3), d ** -0.5,
                    logit_cap, g)
    if kv_valid is None:
        kv_valid = torch.ones((b, skv), dtype=torch.bool, device=q.device)
    mask = _blk_mask(kv_pos, q_pos, kv_valid, causal, int(window or 0))
    s = torch.where(mask, s, torch.full((), NEG_INF, dtype=torch.float32,
                                        device=q.device))
    # jax.nn.softmax: exp(s - max) / sum
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    l = torch.sum(e, dim=-1, keepdim=True)
    return _weighted(e / l, v.permute(0, 2, 1, 3)), m, l


def _direct_attention(q, k, v, q_pos, kv_pos, *, causal, window, logit_cap,
                      kv_valid):
    """Unblocked attention for tiny Sq (decode). q: (B,Sq,H,D)."""
    out, _, _ = _direct_state(q, k, v, q_pos, kv_pos, causal=causal,
                              window=window, logit_cap=logit_cap,
                              kv_valid=kv_valid)
    return _heads_last(out, q)


def attention_state(q, k, v, q_pos, kv_pos, *, causal: bool, window=None,
                    logit_cap: float = 0.0, kv_block: int = 1024,
                    kv_valid: Optional[torch.Tensor] = None):
    """``flash_attention`` over these keys only, stopped before its last
    step: (the float32 output (B,Hkv,G,Sq,D) normalised over them, the
    log-sum-exp (B,Hkv,G,Sq) of each query head's scores). Split-KV
    attention merges one such pair a rank (``parallel.kvcache.combine``);
    serving only, so no gradient is kept."""
    window = int(window or 0)
    blocked = _blocked(q, k, v, kv_pos, kv_valid, kv_block)
    if blocked is None:
        out, m, l = _direct_state(q, k, v, q_pos, kv_pos, causal=causal,
                                  window=window or None, logit_cap=logit_cap,
                                  kv_valid=kv_valid)
        return out, (m + torch.log(l))[..., 0]
    k, v, kv_pos, kv_valid, kv_block = blocked
    return _flash_state(q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                        logit_cap, kv_block)


def cache_attention(q, k, v, q_pos, kv_pos, axes, **kw):
    """Attention of ``q`` over a cache's keys: ``flash_attention`` where
    the cache's slots are whole on this rank (``axes`` empty); else
    split-KV over the slots of ``axes`` (``parallel.kvcache``)."""
    if not axes:
        return flash_attention(q, k, v, q_pos, kv_pos, **kw)
    out, lse = attention_state(q, k, v, q_pos, kv_pos, **kw)
    return _heads_last(kvcache.combine(out, lse, axes), q)


# ---------------------------------------------------------------------------
# GQA block
# ---------------------------------------------------------------------------

def make_gqa(make, path: str, cfg: ModelConfig):
    d, h, hkv = cfg.d_model, cfg.num_heads, cfg.num_kv_heads
    dh = cfg.resolved_head_dim
    s = d ** -0.5
    p = {
        "wq": make(f"{path}.wq", (d, h, dh), ("embed", "heads", "head_dim"), s),
        "wk": make(f"{path}.wk", (d, hkv, dh),
                   ("embed", "kv_heads", "head_dim"), s),
        "wv": make(f"{path}.wv", (d, hkv, dh),
                   ("embed", "kv_heads", "head_dim"), s),
        "wo": make(f"{path}.wo", (h, dh, d), ("heads", "head_dim", "embed"),
                   (h * dh) ** -0.5),
    }
    if cfg.qk_norm:
        p["q_norm"] = make(f"{path}.q_norm", (dh,), ("head_dim",),
                           init="zeros")
        p["k_norm"] = make(f"{path}.k_norm", (dh,), ("head_dim",),
                           init="zeros")
    return p


def _maybe_repeat_kv(k, v, num_heads: int, heads=None,
                     num_kv_heads: Optional[int] = None):
    """The reference's repeat of the kv heads to the full head count: under
    a mesh whose ``model`` axis takes the heads and does not divide the
    kv-head count (8 kv heads on a 16-way axis), it repeats them so every
    tensor stays sharded by ``heads``. The attention's values do not
    change.

    ``heads`` = (first, n): this rank's q heads under a step that splits
    them (``gqa_attention``); ``k`` and ``v`` then hold only the kv heads
    those read, from kv head ``first // g`` on, of ``num_kv_heads``, and
    the result is the repeat's heads ``first`` to ``first + n``."""
    mesh = current_mesh()
    sizes = mesh_shape(mesh)
    if mesh is None or "model" not in sizes:
        return k, v
    if current_act_rules().get("heads") != "model":
        return k, v
    m = sizes["model"]
    hkv = num_kv_heads or k.shape[2]
    if hkv % m == 0 or num_heads % m != 0 or num_heads == hkv:
        return k, v
    rep = num_heads // hkv
    k = torch.repeat_interleave(k, rep, dim=2)
    v = torch.repeat_interleave(v, rep, dim=2)
    if heads is not None:
        first, n = heads
        off = first - first // rep * rep
        k, v = k[:, :, off:off + n], v[:, :, off:off + n]
    return k, v


def _kv_range(cfg: ModelConfig, idx: int, n: int):
    """(the first q head of rank ``idx`` of the ``n`` that split the heads,
    their count, and the kv heads [kv0, kv1) they read: q head i reads kv
    head i // g, as ``_grouped`` groups them)."""
    hl = cfg.num_heads // n
    first, g = idx * hl, cfg.num_heads // cfg.num_kv_heads
    return first, hl, first // g, (first + hl - 1) // g + 1


def _split_kv(params, cfg: ModelConfig):
    """(wk, wv, heads) of this rank under a step that splits the heads:
    where wk and wv arrive whole (``model`` does not divide the kv heads),
    their columns of the kv heads this rank's q heads read, and ``heads``
    = (the first of those q heads, their count) for ``_maybe_repeat_kv``;
    else the blocks as they are and None."""
    wk, wv = params["wk"], params["wv"]
    if (wk.shape[1] != cfg.num_kv_heads
            or not fsdp.splits("heads", cfg.num_heads)):
        return wk, wv, None
    n, idx = fsdp.split_rank()
    first, hl, kv0, kv1 = _kv_range(cfg, idx, n)
    return wk[:, kv0:kv1], wv[:, kv0:kv1], (first, hl)


def _rank_kv(k, v, cfg: ModelConfig):
    """Of ``k``, ``v`` (B, S, Hkv, Dh) holding every kv head, those this
    rank's q heads read under a step that splits the heads, in
    ``_grouped``'s order: the kv heads [kv0, kv1), repeated where
    ``model`` does not divide them (``_maybe_repeat_kv``)."""
    n, idx = fsdp.split_rank()
    first, hl, kv0, kv1 = _kv_range(cfg, idx, n)
    k, v = k[:, :, kv0:kv1], v[:, :, kv0:kv1]
    if cfg.num_kv_heads % n:
        k, v = _maybe_repeat_kv(k, v, cfg.num_heads, (first, hl),
                                cfg.num_kv_heads)
    return k, v


def _all_kv_heads(t, cfg: ModelConfig):
    """(B, S, Hkv, Dh): every kv head of ``t``, this rank's kv heads
    [kv0, kv1) (``_kv_range``) under a step that splits the heads, from one
    all-gather over the split axis. Where ``model`` does not divide the kv
    heads, ranks share a kv head (their ranges may differ in width): each
    rank's range is padded to the widest and each kv head taken from the
    first rank that holds it."""
    n, _ = fsdp.split_rank()
    ranges = [_kv_range(cfg, r, n)[2:] for r in range(n)]
    pad = max(b - a for a, b in ranges) - t.shape[2]
    if pad:
        t = torch.nn.functional.pad(t, (0, 0, 0, pad))
    parts = fsdp.split_gather(t[None], 0)           # (n, B, S, width, Dh)
    owner = [next(r for r, (a, b) in enumerate(ranges) if a <= j < b)
             for j in range(cfg.num_kv_heads)]
    return torch.stack([parts[r, :, :, j - ranges[r][0]]
                        for j, r in enumerate(owner)], dim=2)


class KVCache(NamedTuple):
    """Ring-buffer KV cache. ``pos`` holds the absolute position in each
    slot (-1 = empty), so windowed layers can use a cache of only
    ``window_size`` slots and wrap around. ``index`` is the host int of
    tokens written so far (module docstring)."""

    k: torch.Tensor       # (B, S_max, Hkv, Dh)
    v: torch.Tensor
    pos: torch.Tensor     # (S_max,) int32 absolute position per slot, -1 empty
    index: int            # tokens written so far


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                  dtype, device) -> KVCache:
    dh = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.num_kv_heads, dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.full((layers, max_len), -1, dtype=torch.int32,
                                  device=device),
                   index=0)


def _project(x, w):
    """einsum("bsd,dhk->bshk", x, w) with ``w`` cast to ``x``'s dtype."""
    d, h, dh = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * dh)).unflatten(
        -1, (h, dh))


def gqa_attention(params, x, positions, cfg: ModelConfig, *,
                  causal: bool = True, window: int = 0,
                  cache: Optional[KVCache] = None, whole_kv=None):
    """x: (B,S,D); positions: (B,S). cache -> (out, new_cache_entry).

    A cache is written in place (its k, v and pos tensors, which may be
    views of a stacked cache) and returned with its new index. Under a
    step that splits the heads, ``whole_kv()`` gives (wk, wv) whole, for a
    bulk prefill's write of every kv head (module docstring).
    """
    b, sq, d = x.shape
    dh = cfg.resolved_head_dim
    wk, wv, heads = _split_kv(params, cfg)
    split = params["wq"].shape[1] != cfg.num_heads
    q = _project(x, params["wq"])
    k = _project(x, wk)
    v = _project(x, wv)
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    cos, sin = rope_table(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    index = 0 if cache is None else cache.index
    if cache is None:
        if heads is not None:
            k, v = _maybe_repeat_kv(k, v, cfg.num_heads, heads,
                                    cfg.num_kv_heads)
        out = flash_attention(q, k, v, positions, positions, causal=causal,
                              window=window, logit_cap=cfg.attn_logit_softcap)
        new_cache = None
    else:
        # under a mesh the cache is this rank's block (parallel.kvcache):
        # writes address global slots and keep the block's part of them;
        # slots are S_max of the whole cache
        slots = kvcache.split(cache.k, 1)
        smax = slots.full
        if sq >= smax:
            # bulk prefill: attend over the fresh k/v (identical to the
            # cache contents); keep the last S_max tokens in the cache
            kr, vr = (k, v) if heads is None else _maybe_repeat_kv(
                k, v, cfg.num_heads, heads, cfg.num_kv_heads)
            out = flash_attention(q, kr, vr, positions, positions,
                                  causal=causal, window=window,
                                  logit_cap=cfg.attn_logit_softcap)
            if split:
                _write_split_prefill(cache, x, positions, params, whole_kv,
                                     cfg, sq - smax)
            else:
                kvcache.write_slots(cache.k, k[:, sq - smax:], 0, 1)
                kvcache.write_slots(cache.v, v[:, sq - smax:], 0, 1)
                kvcache.write_slots(cache.pos, positions[0, sq - smax:], 0,
                                    0, rows=False)
        else:
            # decode/append: write k,v at slot index % S_max (ring buffer
            # for windowed caches; plain append while index < S_max). The
            # reference's dynamic_update_slice clamps the start so that the
            # update fits: a write past the end lands at S_max - sq
            write = min(index % smax, smax - sq)
            if split:
                # the rank that owns the write's slots writes every kv head
                k, v = _all_kv_heads(k, cfg), _all_kv_heads(v, cfg)
            kvcache.write_slots(cache.k, k.to(cache.k.dtype), write, 1)
            kvcache.write_slots(cache.v, v.to(cache.v.dtype), write, 1)
            kvcache.write_slots(cache.pos, index + torch.arange(
                sq, dtype=torch.int32, device=cache.pos.device), write, 0,
                rows=False)
            kc = kvcache.read(cache.k, (0, 1))
            vc = kvcache.read(cache.v, (0, 1))
            kv_pos = cache.pos[None].expand(b, kc.shape[1])
            kw = dict(causal=causal, window=window,
                      logit_cap=cfg.attn_logit_softcap, kv_valid=kv_pos >= 0)
            if not split:
                out = cache_attention(q, kc.to(q.dtype), vc.to(q.dtype),
                                      positions, kv_pos, slots.axes, **kw)
            elif slots.axes:
                # split-KV with every q head, keeping this rank's heads
                axis = fsdp.split_axis()
                if slots.axes != (axis,):
                    raise ValueError(
                        f"the cache's slots split over {slots.axes}, the "
                        f"heads over {axis!r}: a split step attends over "
                        "slots split over the heads' axis only")
                o, lse = attention_state(fsdp.split_gather(q, 2),
                                         kc.to(q.dtype), vc.to(q.dtype),
                                         positions, kv_pos, **kw)
                out = kvcache.combine_heads(o, lse, axis).to(q.dtype)
            else:
                kl, vl = _rank_kv(kc, vc, cfg)
                out = flash_attention(q, kl.to(q.dtype), vl.to(q.dtype),
                                      positions, kv_pos, **kw)
        new_cache = cache._replace(index=index + sq)

    wo = params["wo"]
    out = torch.matmul(out.flatten(-2), wo.to(x.dtype).reshape(-1, d))
    return out, new_cache


def _write_split_prefill(cache: KVCache, x, positions, params, whole_kv,
                         cfg: ModelConfig, start: int) -> None:
    """A split bulk prefill's cache write: slot j holds position ``start``
    + j, and this rank's block (its slots, and its kv heads where the cache
    splits them) is all it writes, so it projects k and v with wk and wv
    gathered whole (``whole_kv``, or as they arrived where ``model`` does
    not divide the kv heads) on the positions of its slots only, for the
    kv heads of its block."""
    slots, kvh = kvcache.split(cache.k, 1), kvcache.split(cache.k, 2)
    n, nh = cache.k.shape[1], cache.k.shape[2]
    wk, wv = ((params["wk"], params["wv"])
              if params["wk"].shape[1] == cfg.num_kv_heads else whole_kv())
    lo = start + slots.lo
    xs, ps = x[:, lo:lo + n], positions[:, lo:lo + n]
    k = _project(xs, wk[:, kvh.lo:kvh.lo + nh])
    v = _project(xs, wv[:, kvh.lo:kvh.lo + nh])
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"])
    k = apply_rope(k, *rope_table(ps, cfg.resolved_head_dim, cfg.rope_theta))
    cache.k.copy_(k)
    cache.v.copy_(v)
    cache.pos.copy_(ps[0])


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention(params, x, enc_kv, positions_q, positions_kv,
                    cfg: ModelConfig):
    """enc_kv: precomputed (k, v) from encoder output (B,Senc,Hkv,Dh).
    Under a step that splits the heads, wq and wo arrive as this rank's
    blocks and ``enc_kv`` holds the kv heads its q heads read
    (``encode_cross_kv``): the output is its partial sum."""
    k, v = enc_kv
    q = _project(x, params["wq"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
    out = flash_attention(q, k.to(q.dtype), v.to(q.dtype), positions_q,
                          positions_kv, causal=False,
                          logit_cap=cfg.attn_logit_softcap)
    return torch.matmul(out.flatten(-2),
                        params["wo"].to(x.dtype).reshape(-1, x.shape[-1]))


def encode_cross_kv(params, enc_out, cfg: ModelConfig):
    """The cross-attention (k, v) of the whole encoder states ``enc_out``.
    Under a step that splits the heads, those of this rank's q heads: wk
    and wv arrive as its blocks where ``model`` divides the kv heads, else
    whole, and then the kv heads its q heads read are projected and
    repeated (``_split_kv``, ``_maybe_repeat_kv``), as a split GQA layer
    takes them."""
    wk, wv, heads = _split_kv(params, cfg)
    k = _project(enc_out, wk)
    v = _project(enc_out, wv)
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"])
    if heads is not None:
        k, v = _maybe_repeat_kv(k, v, cfg.num_heads, heads, cfg.num_kv_heads)
    return k, v


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# ---------------------------------------------------------------------------

def make_mla(make, path: str, cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dn, dr, dv, dc = (m.nope_head_dim, m.rope_head_dim, m.v_head_dim,
                      m.kv_lora_rank)
    s = d ** -0.5
    return {
        "wq": make(f"{path}.wq", (d, h, dn + dr),
                   ("embed", "heads", "head_dim"), s),
        "w_dkv": make(f"{path}.w_dkv", (d, dc), ("embed", "kv_lora"), s),
        "w_kr": make(f"{path}.w_kr", (d, dr), ("embed", "head_dim"), s),
        "kv_norm": make(f"{path}.kv_norm", (dc,), ("kv_lora",),
                        init="zeros"),
        "w_uk": make(f"{path}.w_uk", (dc, h, dn),
                     ("kv_lora", "heads", "head_dim"), dc ** -0.5),
        "w_uv": make(f"{path}.w_uv", (dc, h, dv),
                     ("kv_lora", "heads", "head_dim"), dc ** -0.5),
        "wo": make(f"{path}.wo", (h, dv, d), ("heads", "head_dim", "embed"),
                   (h * dv) ** -0.5),
    }


class MLACache(NamedTuple):
    """The compressed cache: the latent and the shared rope key of every
    position (slot = position, no ring); ``index`` a host int as in
    ``KVCache``."""

    c_kv: torch.Tensor    # (B, S_max, dc)
    k_rope: torch.Tensor  # (B, S_max, dr)
    index: int


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                   dtype, device) -> MLACache:
    m = cfg.mla
    return MLACache(
        c_kv=torch.zeros((layers, batch, max_len, m.kv_lora_rank),
                         dtype=dtype, device=device),
        k_rope=torch.zeros((layers, batch, max_len, m.rope_head_dim),
                           dtype=dtype, device=device),
        index=0)


def _heads_in(x, w):
    """einsum("bshk,chk->bshc", x, w): every head's (B,S,k) against its
    (c,k) slice of ``w`` (cast to ``x``'s dtype), one batched product over
    the heads."""
    b, s, h, _ = x.shape
    out = torch.bmm(x.permute(2, 0, 1, 3).reshape(h, b * s, -1),
                    w.to(x.dtype).permute(1, 2, 0))          # (H, B*S, c)
    return out.reshape(h, b, s, -1).permute(1, 2, 0, 3)


def _heads_out(x, w):
    """einsum("bshc,chk->bshk", x, w), one batched product over the
    heads."""
    b, s, h, _ = x.shape
    out = torch.bmm(x.permute(2, 0, 1, 3).reshape(h, b * s, -1),
                    w.to(x.dtype).permute(1, 0, 2))          # (H, B*S, k)
    return out.reshape(h, b, s, -1).permute(1, 2, 0, 3)


def _latent_up(c_kv, w):
    """einsum("bsc,chk->bshk", c_kv, w): the latent expanded to every
    head."""
    c, h, k = w.shape
    return torch.matmul(c_kv, w.to(c_kv.dtype).reshape(c, h * k)).unflatten(
        -1, (h, k))


def _mla_expanded(params, x, qn, qr, kr, c_kv, positions, cfg: ModelConfig):
    """Expanded (training/prefill) MLA attention: (B,S,H,dv) of the heads
    ``qn`` holds (this rank's under a step that splits them)."""
    m: MLAConfig = cfg.mla
    b, sq = x.shape[0], x.shape[1]
    h = qn.shape[2]
    dn, dr, dv = m.nope_head_dim, m.rope_head_dim, m.v_head_dim
    kn = _latent_up(c_kv, params["w_uk"])
    v = _latent_up(c_kv, params["w_uv"])
    k_full = torch.cat([kn, kr[:, :, None, :].expand(b, sq, h, dr)], dim=-1)
    q_full = torch.cat([qn, qr], dim=-1)
    # pad v to the score head-dim so the flash kernel sees uniform D
    v_pad = torch.nn.functional.pad(v, (0, dn + dr - dv))
    return flash_attention(q_full, k_full, v_pad, positions, positions,
                           causal=True)[..., :dv]


def mla_attention(params, x, positions, cfg: ModelConfig, *,
                  cache: Optional[MLACache] = None):
    """x: (B,S,D); positions: (B,S). cache -> (out, new_cache_entry).

    Three branches, as the reference's: no cache runs the expanded form; a
    prefill of at least S_max tokens runs it too and keeps the last S_max
    latents; any shorter write (decode, and the engine's prefill) runs the
    absorbed form over the compressed cache, written in place at
    ``index`` (clamped so that the write fits, as ``dynamic_update_slice``
    clamps its start).

    Under a step that splits the heads over ``model`` (``fsdp.splits``),
    ``wq``, ``w_uk``, ``w_uv`` and ``wo`` arrive as this rank's heads and
    ``w_dkv``, ``kv_norm`` and ``w_kr`` whole: ``c_kv`` and the shared
    rope key are computed whole on every rank (and written as the
    single-device cache is), every product with a head dim on the rank's
    heads only, and ``wo``'s product is this rank's partial sum. Where the
    cache's slots split over the same axis, the absorbed form gathers
    every rank's q heads, attends with them over the rank's slots and
    keeps its own heads of the combined output
    (``kvcache.combine_heads``), as GQA does."""
    m: MLAConfig = cfg.mla
    b, sq, d = x.shape
    dn, dr = m.nope_head_dim, m.rope_head_dim
    dc = m.kv_lora_rank

    q = _project(x, params["wq"])
    qn, qr = q[..., :dn], q[..., dn:]
    cos, sin = rope_table(positions, dr, cfg.rope_theta)
    qr = apply_rope(qr, cos, sin)

    c_kv = rmsnorm(torch.matmul(x, params["w_dkv"].to(x.dtype)),
                   params["kv_norm"])
    kr = torch.matmul(x, params["w_kr"].to(x.dtype))
    kr = apply_rope(kr[:, :, None, :], cos, sin)[:, :, 0, :]  # shared head

    if cache is None:
        out, new_cache = _mla_expanded(params, x, qn, qr, kr, c_kv,
                                       positions, cfg), None
    elif sq >= (slots := kvcache.split(cache.c_kv, 1)).full:
        # bulk prefill: expanded attention + one-shot compressed cache write
        # (under a mesh, this rank's block of the slots: parallel.kvcache)
        smax = slots.full
        out = _mla_expanded(params, x, qn, qr, kr, c_kv, positions, cfg)
        kvcache.write_slots(cache.c_kv, c_kv[:, sq - smax:], 0, 1)
        kvcache.write_slots(cache.k_rope, kr[:, sq - smax:], 0, 1)
        new_cache = cache._replace(index=cache.index + sq)
    else:
        # absorbed form: score via latent space, cache stays compressed;
        # a slot is a position, numbered over the whole cache
        write = min(cache.index, slots.full - sq)
        kvcache.write_slots(cache.c_kv, c_kv.to(cache.c_kv.dtype), write, 1)
        kvcache.write_slots(cache.k_rope, kr.to(cache.k_rope.dtype), write, 1)
        new_index = cache.index + sq
        n = cache.c_kv.shape[1]
        kv_pos = torch.arange(slots.lo, slots.lo + n, dtype=torch.int32,
                              device=x.device)[None].expand(b, n)
        # absorb W_uk into q: q_lat (B,S,H,dc)
        q_lat = _heads_in(qn, params["w_uk"])
        q_cat = torch.cat([q_lat, qr], dim=-1)              # (B,S,H,dc+dr)
        k_cat = torch.cat([cache.c_kv, cache.k_rope], dim=-1).to(
            x.dtype)[:, :, None, :]                         # Hkv = 1
        # value = latent, padded to match score dim for the flash kernel
        v_lat = torch.nn.functional.pad(cache.c_kv.to(x.dtype),
                                        (0, dr))[:, :, None, :]
        # flash divides by sqrt(dc+dr); rescale so the net scale is the
        # expanded form's 1/sqrt(dn+dr). The reference multiplies by a
        # weak-typed Python float, which JAX rounds to q's dtype first: a
        # 0-d tensor of that dtype does the same
        rescale = torch.full((), ((dc + dr) ** 0.5) * ((dn + dr) ** -0.5),
                             dtype=q_cat.dtype, device=x.device)
        kw = dict(causal=True, kv_valid=kv_pos < new_index)
        if slots.axes and params["wq"].shape[1] != cfg.num_heads:
            # split-KV with every q head, keeping this rank's heads
            axis = fsdp.split_axis()
            if slots.axes != (axis,):
                raise ValueError(
                    f"the cache's slots split over {slots.axes}, the heads "
                    f"over {axis!r}: a split step attends over slots split "
                    "over the heads' axis only")
            o, lse = attention_state(fsdp.split_gather(q_cat * rescale, 2),
                                     k_cat, v_lat, positions, kv_pos, **kw)
            out_lat = kvcache.combine_heads(o, lse, axis).to(
                q_cat.dtype)[..., :dc]
        else:
            out_lat = cache_attention(q_cat * rescale, k_cat, v_lat,
                                      positions, kv_pos, slots.axes,
                                      **kw)[..., :dc]
        out = _heads_out(out_lat, params["w_uv"])
        new_cache = cache._replace(index=new_index)

    y = torch.matmul(out.flatten(-2), params["wo"].to(x.dtype).reshape(-1, d))
    return y, new_cache
