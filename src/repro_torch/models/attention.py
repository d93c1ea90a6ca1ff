"""Attention: GQA (+qk-norm, softcap, sliding window), cross-attention.

All softmax attention goes through ``flash_attention``: for ``Sq > 8`` the
reference's blockwise forward, an online softmax over KV blocks of
``kv_block`` keys written in torch ops (O(Sq * block) score memory, no
library attention kernel), and for ``Sq <= 8`` (every decode step) the
direct form. Scores and the softmax state are float32; the probabilities
are rounded to the values' dtype before the PV product, as the reference's
``p.astype(vblk.dtype)`` does. The products of bfloat16 inputs are taken in
float32 (the reference's ``preferred_element_type``): the inputs are
widened, which is exact.

The backward (the reference's ``_flash_bwd``) waits for the training slice
(ROADMAP item 17(c)); ``_maybe_repeat_kv`` and the sharding constraints for
the parallel slice (17(d)); MLA for 17(b).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import apply_rope, rmsnorm, rope_table, softcap

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
    if q.shape[1] <= 8:
        return _direct_attention(q, k, v, q_pos, kv_pos, causal=causal,
                                 window=window or None, logit_cap=logit_cap,
                                 kv_valid=kv_valid)
    b, sq, h, d = q.shape
    skv = k.shape[1]
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
    return _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, window,
                           causal, logit_cap, kv_block)


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


def _grouped(q, hkv):
    """(B,Sq,H,D) -> float32 (B,Hkv,G*Sq,D): the query heads of each kv
    head stacked, so one batched product serves the group."""
    b, sq, h, d = q.shape
    g = h // hkv
    return q.reshape(b, sq, hkv, g, d).permute(0, 2, 3, 1, 4).reshape(
        b, hkv, g * sq, d).float()


def _blk_scores(qf, kblk, scale, logit_cap, g):
    """(B,Hkv,G,Sq,C) float32 scores of qf (B,Hkv,G*Sq,D) against kblk
    (B,Hkv,C,D)."""
    b, hkv, gsq, _ = qf.shape
    s = torch.matmul(qf, kblk.float().transpose(-1, -2)) * scale
    s = s.view(b, hkv, g, gsq // g, -1)
    if logit_cap:
        s = softcap(s, logit_cap)
    return s


def _weighted(p, vblk):
    """sum_c p[..., q, c] v[..., c, :] in float32, with ``p`` (B,Hkv,G,Sq,C)
    rounded to ``vblk``'s dtype first; vblk (B,Hkv,C,D)."""
    b, hkv, g, sq, c = p.shape
    pv = torch.matmul(p.to(vblk.dtype).float().reshape(b, hkv, g * sq, c),
                      vblk.float())
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


def _flash_fwd_impl(q, k, v, q_pos, kv_pos, kv_valid, window, causal,
                    logit_cap, kv_block):
    """The online softmax over the KV blocks, one block a step (the
    reference's ``lax.scan``); (B,Sq,H,D). The log-sum-exp the reference
    also returns is its backward's, which the training slice adds."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    nblk = skv // kv_block
    scale = d ** -0.5
    qf = _grouped(q, hkv)
    m = torch.full((b, hkv, g, sq), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, hkv, g, sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, g, sq, d), dtype=torch.float32,
                      device=q.device)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=q.device)
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
    out = acc / torch.clamp_min(l[..., None], 1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


def _direct_attention(q, k, v, q_pos, kv_pos, *, causal, window, logit_cap,
                      kv_valid):
    """Unblocked attention for tiny Sq (decode). q: (B,Sq,H,D)."""
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
    e = torch.exp(s - torch.amax(s, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    out = _weighted(p, v.permute(0, 2, 1, 3))           # (B,Hkv,G,Sq,D)
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, d).to(q.dtype)


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


class KVCache(NamedTuple):
    """Ring-buffer KV cache. ``pos`` holds the absolute position in each
    slot (-1 = empty), so windowed layers can use a cache of only
    ``window_size`` slots and wrap around. ``index`` (the tokens written so
    far) lives on the host: it picks the slots a step writes, which the
    reference's ``dynamic_update_slice`` takes as a traced value."""

    k: torch.Tensor       # (B, S_max, Hkv, Dh)
    v: torch.Tensor
    pos: torch.Tensor     # (S_max,) int32 absolute position per slot, -1 empty
    index: torch.Tensor   # host int32 scalar: tokens written so far


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, layers: int,
                  dtype, device) -> KVCache:
    dh = cfg.resolved_head_dim
    shape = (layers, batch, max_len, cfg.num_kv_heads, dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   pos=torch.full((layers, max_len), -1, dtype=torch.int32,
                                  device=device),
                   index=torch.zeros((layers,), dtype=torch.int32))


def _project(x, w):
    """einsum("bsd,dhk->bshk", x, w) with ``w`` cast to ``x``'s dtype."""
    d, h, dh = w.shape
    return torch.matmul(x, w.to(x.dtype).reshape(d, h * dh)).unflatten(
        -1, (h, dh))


def gqa_attention(params, x, positions, cfg: ModelConfig, *,
                  causal: bool = True, window: int = 0,
                  cache: Optional[KVCache] = None):
    """x: (B,S,D); positions: (B,S). cache -> (out, new_cache_entry).

    A cache is written in place (its k, v and pos tensors, which may be
    views of a stacked cache) and returned with its new index.
    """
    b, sq, d = x.shape
    dh = cfg.resolved_head_dim
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if cfg.qk_norm:
        q = rmsnorm(q, params["q_norm"])
        k = rmsnorm(k, params["k_norm"])
    cos, sin = rope_table(positions, dh, cfg.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)

    index = 0 if cache is None else int(cache.index)
    if cache is None:
        out = flash_attention(q, k, v, positions, positions, causal=causal,
                              window=window, logit_cap=cfg.attn_logit_softcap)
        new_cache = None
    elif sq >= cache.k.shape[1]:
        # bulk prefill: attend over the fresh k/v (identical to the cache
        # contents); keep the last S_max tokens in the cache
        smax = cache.k.shape[1]
        out = flash_attention(q, k, v, positions, positions, causal=causal,
                              window=window, logit_cap=cfg.attn_logit_softcap)
        cache.k.copy_(k[:, sq - smax:])
        cache.v.copy_(v[:, sq - smax:])
        cache.pos.copy_(positions[0, sq - smax:])
        new_cache = cache._replace(index=cache.index + sq)
    else:
        # decode/append: write k,v at slot index % S_max (ring buffer for
        # windowed caches; plain append while index < S_max). The
        # reference's dynamic_update_slice clamps the start so that the
        # update fits: a write past the end lands at S_max - sq
        smax = cache.k.shape[1]
        write = min(index % smax, smax - sq)
        cache.k[:, write:write + sq] = k.to(cache.k.dtype)
        cache.v[:, write:write + sq] = v.to(cache.v.dtype)
        cache.pos[write:write + sq] = index + torch.arange(
            sq, dtype=torch.int32, device=cache.pos.device)
        kv_pos = cache.pos[None].expand(b, smax)
        out = flash_attention(q, cache.k.to(q.dtype), cache.v.to(q.dtype),
                              positions, kv_pos, causal=causal, window=window,
                              logit_cap=cfg.attn_logit_softcap,
                              kv_valid=kv_pos >= 0)
        new_cache = cache._replace(index=cache.index + sq)

    wo = params["wo"]
    out = torch.matmul(out.flatten(-2), wo.to(x.dtype).reshape(-1, d))
    return out, new_cache


# ---------------------------------------------------------------------------
# Cross-attention (encoder-decoder)
# ---------------------------------------------------------------------------

def cross_attention(params, x, enc_kv, positions_q, positions_kv,
                    cfg: ModelConfig):
    """enc_kv: precomputed (k, v) from encoder output (B,Senc,Hkv,Dh)."""
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
    k = _project(enc_out, params["wk"])
    v = _project(enc_out, params["wv"])
    if cfg.qk_norm:
        k = rmsnorm(k, params["k_norm"])
    return k, v
