"""Shared NN layers: norms, MLPs, RoPE, embeddings, softcap, causal conv.

Weights are float32 and are cast to the activations' dtype at each use, as
the reference's ``params[...].astype(x.dtype)`` does; elementwise math runs
in the reference's dtypes. Where the reference places a ``logical(...)``
sharding constraint, a step that splits its products over ``model``
(``parallel.fsdp``: the train step and the serving steps) hands these
functions blocks: ``apply_mlp`` gets the column blocks of ``w_up`` /
``w_gate`` and the row block of ``w_down``, so its output is this rank's
partial sum; ``embed`` gets the table's vocab block, so a token outside it
reads zeros and the sum over the ranks has one nonzero term; and
``unembed`` (a decode step's logits) gets it too, so its output is this
rank's vocab columns, masked on their global indices. None of them holds
a gradient rule or a train layout of its own.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.device import scalar
from repro_torch.parallel import fsdp


def dtype_of(name: str) -> torch.dtype:
    """A config's dtype string ("float32", "bfloat16") as a torch dtype."""
    return getattr(torch, name)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    out = x * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(dt)


def layernorm(x, scale, bias, eps: float = 1e-5):
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    out = (x - mu) * torch.rsqrt(var + eps)
    out = out * scale.float() + bias.float()
    return out.to(dt)


def make_norm(make, path: str, d: int, kind: str):
    if kind == "layernorm":
        return {
            "scale": make(f"{path}.scale", (d,), ("embed",), init="ones"),
            "bias": make(f"{path}.bias", (d,), ("embed",), init="zeros"),
        }
    return {"scale": make(f"{path}.scale", (d,), ("embed",), init="zeros")}


def apply_norm(params, x, kind: str):
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    return rmsnorm(x, params["scale"])


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def make_mlp(make, path: str, d_model: int, d_ff: int, kind: str,
             scale: Optional[float] = None):
    s_in = scale or d_model ** -0.5
    s_out = (d_ff) ** -0.5
    p = {
        "w_up": make(f"{path}.w_up", (d_model, d_ff), ("embed", "mlp"), s_in),
        "w_down": make(f"{path}.w_down", (d_ff, d_model), ("mlp", "embed"),
                       s_out),
    }
    if kind == "swiglu":
        p["w_gate"] = make(f"{path}.w_gate", (d_model, d_ff), ("embed", "mlp"),
                           s_in)
    return p


def apply_mlp(params, x, kind: str):
    up = torch.matmul(x, params["w_up"].to(x.dtype))
    if kind == "swiglu":
        gate = torch.matmul(x, params["w_gate"].to(x.dtype))
        h = F.silu(gate) * up
    elif kind == "squared_relu":
        h = torch.square(F.relu(up))
    elif kind == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(up, approximate="tanh")
    else:
        h = F.relu(up)
    return torch.matmul(h, params["w_down"].to(x.dtype))


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_table(positions, head_dim: int, theta: float):
    """positions (...,) -> (cos, sin) of shape (..., head_dim//2)."""
    half = head_dim // 2
    idx = torch.arange(0, half, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(scalar(theta, idx), -idx / scalar(half, idx))
    ang = positions[..., None].float() * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., seq, heads, head_dim); cos/sin: (..., seq, head_dim//2).
    Computed in float32 (the tables' dtype) and cast once."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# Misc
# ---------------------------------------------------------------------------

def softcap(x, cap: float):
    """``tanh(x / cap) * cap`` in ``x``'s dtype, dividing where the
    reference divides."""
    if not cap:
        return x
    return torch.tanh(x / scalar(cap, x).to(x.dtype)) * cap


def make_embedding(make, path: str, vocab: int, d_model: int):
    return {"table": make(f"{path}.table", (vocab, d_model),
                          ("vocab", "embed"), scale=1.0)}


def embed(params, tokens, cfg: ModelConfig):
    """The reference casts the whole table before it gathers rows; the cast
    is elementwise, so gathering first gives the same bits without casting
    every row on every call. A table of fewer rows than the padded vocab is
    this rank's vocab block (module docstring): a token outside it reads
    zeros."""
    table = params["table"]
    rows = table.shape[0]
    if rows == cfg.padded_vocab:
        x = table[tokens]
    else:
        first = fsdp.split_rank()[1] * rows
        local = tokens - first
        inside = (local >= 0) & (local < rows)
        x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)],
                        torch.zeros((), dtype=table.dtype,
                                    device=table.device))
    x = x.to(dtype_of(cfg.dtype))
    if cfg.embedding_scale:
        x = x * torch.full((), cfg.d_model ** 0.5, dtype=x.dtype,
                           device=x.device)
    return x


def unembed(params, x, cfg: ModelConfig):
    """The logits of ``x`` against the table; a table of fewer rows than
    the padded vocab is this rank's vocab block (module docstring), whose
    columns the padding mask takes at their global indices."""
    rows = params["table"].shape[0]
    first = 0 if rows == cfg.padded_vocab else fsdp.split_rank()[1] * rows
    logits = torch.matmul(x, params["table"].to(x.dtype).t())
    logits = softcap(logits, cfg.final_logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        # vocab-padding rows never win: mask to a large negative
        viota = torch.arange(first, first + rows, device=logits.device)
        logits = torch.where(viota < cfg.vocab_size, logits,
                             torch.full((), -1e9, dtype=logits.dtype,
                                        device=logits.device))
    return logits


def causal_conv1d(x, w, cache=None):
    """Depthwise causal temporal conv. x (B,S,C), w (K,C); cache (B,K-1,C).

    The reference's K shifted multiply-adds in the same order, in ``x``'s
    dtype (the weight and the cache cast to it); the new cache is the last
    K-1 inputs. Returns (out, new_cache)."""
    k = w.shape[0]
    if cache is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = cache.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + xp[:, i:i + x.shape[1]] * w[i][None, None, :].to(x.dtype)
    new_cache = xp[:, xp.shape[1] - (k - 1):] if k > 1 else torch.zeros(
        (x.shape[0], 0, x.shape[2]), dtype=x.dtype, device=x.device)
    return out, new_cache
