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

A batch split over ranks (the rows of a sharded train step, or of a
serving step on split caches: ``parallel.fsdp.Layout.batch_axes``) is
routed as the reference's single-device call routes the whole batch,
which is what GSPMD preserves under any mesh: the capacity of every
token of the call, each expert's run in the batch's token order, and the
aux loss over every token (``_split_routing``: one all-gather of the
ranks' (E,) counts, one all-reduce of their probability sums). Each rank
then runs the expert FFN on its own kept pairs, in a buffer of
``min(capacity, local tokens)`` slots an expert (no pair of its rows can
need more: ``expert_buffer``). Without a layout, or on one batch rank,
nothing of this runs.

A step that splits its products over ``model`` (``fsdp.Layout.split``)
splits the experts over it as the reference's ``"experts": "model"``
does, where its act rules give ``experts`` and ``mlp`` that axis
(``moe_splits``): every rank of ``model`` holds the same tokens (the
gathered sequence), so it routes them whole and alike, then gathers,
runs and scatters back the pairs of its own E / n experts only, with
those experts' block of ``w_gate`` / ``w_up`` / ``w_down`` (its buffer:
``expert_buffer``); the shared experts run this rank's block of their
columns. The output is this rank's partial sum, which the segment
reduce-scatters or sums (``models.transformer``); the aux is whole on
every rank. Where ``model`` does not divide the experts (the reference's
divisibility fallback) the layer computes whole, as the unsplit step
does.

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
from repro_torch.parallel import fsdp

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


def expert_buffer(tokens: int, total: int, m: MoEConfig,
                  split: int = 1) -> Tuple[int, int]:
    """(the experts a rank runs, the slots of each): the dispatch's buffer
    (``_dispatch``) of an MoE call of ``total`` tokens, ``tokens`` of them
    on the rank (``tokens == total``: the batch is whole there), its
    experts split over ``split`` ranks. The slots are the capacity of
    every token of the call, and on a split batch at most the rank's own
    tokens (no pair of its rows can need more). The dry run counts the
    same buffer (``launch.dryrun.expert_slots``)."""
    cap = _capacity(total, m.num_experts, m.top_k, m.capacity_factor)
    return (m.num_experts // split,
            cap if tokens == total else min(cap, tokens))


def moe_splits(cfg: ModelConfig) -> bool:
    """Whether the current step splits the layer over its split axis: the
    routed experts, and the shared experts' columns with them, where the
    act rules give both ``experts`` and ``mlp`` the axis. Where either
    does not divide (6 experts on 4 ranks), the layer computes whole."""
    m: MoEConfig = cfg.moe
    return fsdp.splits("experts", m.num_experts) and (
        not m.num_shared or fsdp.splits("mlp", m.expert_ff * m.num_shared))


@contextlib.contextmanager
def routing_log():
    """Record every ``apply_moe`` call inside the block (a remat segment's
    recomputation records again): yields a list that gets one dict a call,
    ``{"probs": (T, E) router probabilities, "ids": (T, k) expert ids,
    "counts": (E,) pairs an expert, "cap": capacity}``, tensors left where
    they were computed (no host read). On a split batch the entry is this
    rank's: its tokens, its local runs, and as ``cap`` the (E,) pairs of
    each local run that the whole batch's capacity leaves to it.
    ``dropped_pairs`` reads the drops of an entry."""
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


def _first_choices(ids, e: int, t: int, dtype) -> torch.Tensor:
    """(E,) the count of each expert as a first choice: an exact sum of
    ones (``F.one_hot`` reads the ids' range to the host on the CPU)."""
    return torch.zeros(e, dtype=dtype, device=ids.device).scatter_add_(
        0, ids[:, 0], torch.ones((t,), dtype=dtype, device=ids.device))


def apply_moe(params, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B,S,D) -> (out (B,S,D), aux_loss float32 scalar). Under a layout
    whose batch is split over ranks (``parallel.fsdp``: a sharded train
    step, or a serving step on the caches' rows), ``x`` is this rank's rows
    and the routing is the whole batch's (``_split_routing``); the expert
    FFN runs on this rank's kept pairs. Under a step that splits the
    experts over ``model`` (``moe_splits``), ``params`` holds this rank's
    experts and shared columns and ``out`` is its partial sum."""
    m: MoEConfig = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = m.num_experts, m.top_k
    xf = x.reshape(t, d)
    # this rank's experts: all, or its E / n block of a split over n ranks
    run = params["w_gate"].shape[0]
    n, idx = (1, 0) if run == e else fsdp.split_rank()
    if run * n != e:
        raise ValueError(f"{run} of the {e} experts arrived on a rank of "
                         f"{n} that split them")

    # --- route ---
    probs, weights, ids = route(params["router"], xf, k)

    layout = fsdp.current_layout()
    if layout is not None and layout.batch_n > 1:
        order, counts = _sort_pairs(ids, e)
        kept, cap, aux = _split_routing(layout, probs, ids, counts, t, m)
        limit = torch.minimum(counts, kept)
        slots = expert_buffer(t, t * layout.batch_n, m, n)[1]
    else:
        # --- aux load-balance loss (switch-style) ---
        # mean(one_hot(ids[:, 0])): the count of each first choice over
        # T, divided as the reference divides
        first = _first_choices(ids, e, t, torch.float32)
        density = first / scalar(t, first)
        density_prob = torch.mean(probs, dim=0)
        aux = torch.sum(density * density_prob) * e * m.router_aux_weight
        order, counts = _sort_pairs(ids, e)
        kept = slots = expert_buffer(t, t, m, n)[1]
        limit = counts
    if _LOG is not None:
        _LOG.append({"probs": probs, "ids": ids, "counts": counts,
                     "cap": kept})
    out = _dispatch(params, xf, weights, ids, order, counts, limit, slots,
                    idx * run)
    out = out.reshape(b, s, d)
    if m.num_shared:
        out = out + apply_mlp(params["shared"], x, cfg.mlp_kind)
    return out, aux


def _sort_pairs(ids, e: int):
    """(the stable order of the (token, expert) pairs by expert, the (E,)
    pairs of each expert)."""
    flat_e = ids.reshape(-1)                                     # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    se = flat_e[order]
    counts = torch.zeros(e, dtype=torch.int64, device=ids.device
                         ).scatter_add_(0, se, torch.ones_like(se))
    return order, counts


def _dispatch(params, xf, weights, ids, order, counts, kept, slots: int,
              lo: int = 0):
    """The routed experts' output (T, D) of tokens ``xf``: each expert this
    rank runs (``params``' experts, from expert ``lo`` on) gathers the
    first ``kept`` (E,) pairs of its run into a buffer of ``slots``, runs
    its FFN on them, and the weighted outputs are scattered back to their
    tokens."""
    t, d = xf.shape
    k = ids.shape[1]
    e = params["w_gate"].shape[0]
    flat_t = torch.arange(t, dtype=torch.int64,
                          device=xf.device)[:, None].expand(t, k).reshape(-1)
    st, sw = flat_t[order], weights.reshape(-1)[order]

    # --- per-expert capacity gather indices (this rank's experts) ---
    starts = (torch.cumsum(counts, dim=0) - counts)[lo:lo + e]
    iota = torch.arange(slots, dtype=torch.int64, device=xf.device)
    pos = starts[:, None] + iota[None, :]                        # (E,C)
    in_run = iota[None, :] < kept[lo:lo + e, None]
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
    spare = t + torch.arange(e * slots, device=xf.device).reshape(e, slots)
    out = torch.zeros((t + e * slots, d), dtype=ye.dtype, device=xf.device)
    out.index_put_((torch.where(in_run, tok_idx, spare).reshape(-1),),
                   ye.reshape(-1, d) * in_run.reshape(-1, 1).to(ye.dtype),
                   accumulate=True)
    return out[:t]


def _split_routing(layout, probs, ids, counts, t: int, m: MoEConfig):
    """The whole batch's routing seen from one rank that holds ``t`` of its
    tokens: (the (E,) pairs of each expert's local run its share of the
    capacity keeps, the capacity, the aux loss).

    The batch's tokens are the ranks' rows in order (``layout.batch_rank``),
    so each expert's global run, sorted stably as the reference sorts it,
    is the ranks' local runs one after another. One all-gather of every
    rank's (E,) pair counts and first-choice counts gives this rank's
    offset into each run (the pairs of the ranks before it); the capacity
    of all ``t * batch_n`` tokens keeps a local pair where its offset plus
    its place in the local run is below it. The aux loss takes the first
    choices and the router's probabilities summed over the batch's ranks
    and divided by its tokens, the probabilities through
    ``layout.whole_batch`` (the step's gradient of the whole batch's
    term)."""
    e, k = m.num_experts, m.top_k
    total = t * layout.batch_n
    cap = _capacity(total, e, k, m.capacity_factor)
    first = _first_choices(ids, e, t, torch.int64)
    every = layout.batch_gather(torch.stack([counts, first]))    # (R,2,E)
    offset = torch.sum(every[:layout.batch_rank(), 0], dim=0)
    kept = torch.clamp_min(cap - offset, 0)
    n = scalar(total, probs)
    density = torch.sum(every[:, 1], dim=0).float() / n
    density_prob = layout.whole_batch(torch.sum(probs, dim=0)) / n
    aux = torch.sum(density * density_prob) * e * m.router_aux_weight
    return kept, cap, aux
