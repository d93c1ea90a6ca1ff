"""Fine-grained Mixture-of-Experts (DeepSeekMoE-style: shared + routed top-k).

Dispatch is sort-based, as the reference's (``src/repro/models/moe.py``):

  1. router logits (float32) -> top-k expert ids + weights per token
  2. (token, expert) pairs sorted stably by expert id -> per-expert runs
  3. every expert gathers up to CAPACITY tokens from its run (static
     shapes; the pairs past an expert's capacity are dropped, the
     reference's capacity-factor semantics)
  4. batched expert FFN: one ``bmm`` over the expert dim
  5. weighted scatter back to token order + the shared experts

The aux load-balance loss (switch-style) is returned for the trainer.

Where torch's defaults differ from the reference's ops:

* ``jax.lax.top_k`` ranks ties by the lower index: a stable descending
  sort does too (``torch.topk`` promises no order for ties).
* ``jnp.argsort`` is stable, and the order of tokens inside an expert's
  run decides which pairs overflow the capacity: ``stable=True``.
* ``jnp.bincount``: ``torch.bincount`` on the card reads its maximum to
  the host; a ``scatter_add_`` into ``zeros(E)`` counts the same integers
  without a wait.
* the scatter back (``out.at[idx].add``): ``index_put_(accumulate=True)``,
  whose adds are ordered (``index_add_`` adds with atomics on the card and
  varies from run to run).

``routing_log()`` records each call's routing for tests and for the
dropped-pair counts ``chip_smoke.py`` prints; it costs nothing when off.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig, MoEConfig
from repro_torch.device import scalar
from repro_torch.models.layers import apply_mlp, make_mlp

#: the open routing log (``routing_log``), or None
_LOG: Optional[List[dict]] = None


def make_moe(make, path: str, cfg: ModelConfig):
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.expert_ff
    s_in, s_out = d ** -0.5, f ** -0.5
    p = {
        "router": make(f"{path}.router", (d, e), ("embed", "experts"), s_in,
                       dtype_=torch.float32),
        "w_gate": make(f"{path}.w_gate", (e, d, f),
                       ("experts", "embed", "expert_mlp"), s_in),
        "w_up": make(f"{path}.w_up", (e, d, f),
                     ("experts", "embed", "expert_mlp"), s_in),
        "w_down": make(f"{path}.w_down", (e, f, d),
                       ("experts", "expert_mlp", "embed"), s_out),
    }
    if m.num_shared:
        p["shared"] = make_mlp(make, f"{path}.shared", d,
                               m.expert_ff * m.num_shared, cfg.mlp_kind)
    return p


def _capacity(tokens: int, num_experts: int, top_k: int,
              factor: float = 1.25) -> int:
    cap = int(tokens * top_k / num_experts * factor) + 1
    return max(8, (cap + 7) // 8 * 8)


@contextlib.contextmanager
def routing_log():
    """Record every ``apply_moe`` call inside the block: yields a list that
    gets one dict a call, ``{"probs": (T, E) router probabilities, "ids":
    (T, k) expert ids, "counts": (E,) pairs an expert, "cap": capacity}``,
    tensors left where they were computed
    (no host read). ``dropped_pairs`` reads the drops of an entry."""
    global _LOG
    saved, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = saved


def dropped_pairs(entry: dict) -> torch.Tensor:
    """The (token, expert) pairs past their expert's capacity in one
    ``routing_log`` entry, as a 0-d int64 tensor."""
    return torch.clamp_min(entry["counts"] - entry["cap"], 0).sum()


def route(router, xf, top_k: int):
    """(probs (T,E), weights (T,k), ids (T,k)) of tokens ``xf`` (T,D): the
    float32 router's softmax, its top k (ties to the lower expert id) and
    the renormalised weights."""
    logits = torch.matmul(xf.float(), router)
    # jax.nn.softmax: exp(x - max) / sum (torch.softmax multiplies by the
    # reciprocal of the sum on the CPU)
    ex = torch.exp(logits - torch.amax(logits, dim=-1, keepdim=True))
    probs = ex / torch.sum(ex, dim=-1, keepdim=True)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :top_k], ids[:, :top_k]
    weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return probs, weights, ids


def apply_moe(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss float32 scalar)."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d)

    # --- route ---
    probs, weights, ids = route(params["router"], xf, k)

    # --- aux load-balance loss (switch-style) ---
    # mean(one_hot(ids[:, 0])): the count of each first choice over T, an
    # exact sum divided as the reference divides (F.one_hot reads the ids'
    # range to the host on the CPU)
    first = torch.zeros(e, dtype=torch.float32, device=x.device).scatter_add_(
        0, ids[:, 0], torch.ones((t,), dtype=torch.float32, device=x.device))
    density = first / scalar(t, first)
    density_prob = torch.mean(probs, dim=0)
    aux = torch.sum(density * density_prob) * e * m.router_aux_weight

    # --- sort (token, expert) pairs by expert ---
    flat_e = ids.reshape(-1)                                     # (T*k,)
    flat_t = torch.arange(t, dtype=torch.int64,
                          device=x.device)[:, None].expand(t, k).reshape(-1)
    flat_w = weights.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], flat_w[order]

    # --- per-expert capacity gather indices ---
    cap = _capacity(t, e, k, m.capacity_factor)
    counts = torch.zeros(e, dtype=torch.int64, device=x.device).scatter_add_(
        0, se, torch.ones_like(se))                              # (E,)
    if _LOG is not None:
        _LOG.append({"probs": probs, "ids": ids, "counts": counts,
                     "cap": cap})
    starts = torch.cumsum(counts, dim=0) - counts
    slots = torch.arange(cap, dtype=torch.int64, device=x.device)
    pos = starts[:, None] + slots[None, :]                       # (E,C)
    in_run = slots[None, :] < counts[:, None]
    pos_c = torch.clamp_max(pos, t * k - 1)
    tok_idx = torch.where(in_run, st[pos_c], 0)                  # (E,C)
    tok_w = torch.where(in_run, sw[pos_c], 0.0)

    # --- expert FFN over gathered tokens ---
    xe = xf[tok_idx]                                             # (E,C,D)
    gate = torch.bmm(xe, params["w_gate"].to(xe.dtype))
    up = torch.bmm(xe, params["w_up"].to(xe.dtype))
    h = F.silu(gate) * up
    ye = torch.bmm(h, params["w_down"].to(xe.dtype))
    ye = ye * tok_w[..., None].to(ye.dtype)

    # --- scatter back to token order ---
    # The reference adds every slot, the empty ones as zeros into token 0.
    # Adding a zero changes no sum, and on the card the accumulate
    # serialises equal indices, so each empty slot lands in a spare row of
    # its own (T + its slot number), dropped after
    spare = t + torch.arange(e * cap, device=x.device).reshape(e, cap)
    out = torch.zeros((t + e * cap, d), dtype=ye.dtype, device=x.device)
    out.index_put_((torch.where(in_run, tok_idx, spare).reshape(-1),),
                   ye.reshape(-1, d) * in_run.reshape(-1, 1).to(ye.dtype),
                   accumulate=True)
    out = out[:t].reshape(b, s, d)

    if m.num_shared:
        out = out + apply_mlp(params["shared"], x, cfg.mlp_kind)
    return out, aux
