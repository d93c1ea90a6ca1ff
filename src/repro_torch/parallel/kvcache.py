"""Decode caches under a mesh: each rank stores only its blocks of the
caches (``launch.specs.cache_shardings`` under ``DECODE_RULES``) and the
serving steps compute on them. The reference lets GSPMD partition its
sharded serving steps; this is the port's own mechanism, the sibling of
``parallel.fsdp`` (which places the parameters and splits the products).

Placing. ``place`` cuts each leaf's block from a full tensor and marks it
with its spec (``fsdp.place``); ``init_blocks`` allocates only the
blocks, filled as ``init_caches`` fills each leaf; ``fsdp.full_value``
gathers a leaf back. A per-layer slice of a stacked leaf carries the spec
without its layer entry (``transformer.layer_slice``), so a layer finds
its cache's spec where it reads the cache.

Rows. A rank's caches hold the rows of the batch that their specs' batch
entry gives (``("pod", "data")``), and the serving steps compute those
rows: ``to_rows`` gathers an input's rows over the axes the caches do not
split (``DP_ACT_RULES`` split a prompt's batch over ``model`` too), and
``from_rows`` hands an output back as the rows of its input's split. The
rows' axes are the step's batch axes (``serving``), so an MoE FFN routes
over every rank's rows, the whole batch, as the reference does.

Products. The rows never take ``model`` under ``DECODE_RULES``, so on a
mesh whose ``model`` has more than one rank the serving layout splits the
products over it as the train step's does (``fsdp``): GQA and MLA heads,
MLP columns, an MoE layer's experts, SSD heads, RG-LRU channels, the
enc-dec's encoder and cross-attention heads, the embedding's vocab, and a
prompt's residual in sequence
blocks where ``model`` divides its length (else the residual is whole on
every rank: a decode step's one position). A prefill's logits then stay
in those sequence blocks (``from_rows(..., seq=)``); a decode step's are
computed a vocab block a rank and gathered.

Slots. A KV cache's ``kv_seq`` dim (GQA's k, v and pos; MLA's c_kv and
k_rope) splits over ``model``: the rank at index r along it holds slots
[r n, r n + n) of the S_max slots, in the single-device layout. The ring
(slot index % S_max), the clamped write at min(index % S_max, S_max - sq)
and the bulk prefill's last S_max positions all address global slots, and
``write_slots`` keeps the part of each write that falls in the rank's
block, so the gathered blocks are the single-device cache. Attention over
split slots is split-KV: each rank attends over its own slots
(``attention.attention_state``: the output normalised over them and its
log-sum-exp), and ``combine`` merges the partials over the axes that split
the slots by log-sum-exp, per query head: an all-reduce of the max, then
one of the rescaled outputs and weights. Where the heads split over the
same axis, every rank attends with every query head (q gathered, a few kB
a token) and ``combine_heads`` reduce-scatters the second sum by heads, so
each rank keeps its own heads. No block of a KV cache moves between
ranks: a split prefill projects the k and v of every kv head on the
positions of its own slots only, and a split decode step gathers the new
token's kv heads (``models.attention``).

Other split dims. Where a leaf splits a dim other than its rows and its
slots (the SSM state's heads, the conv windows' and the RG-LRU state's
channels over ``model``; a KV cache's kv heads where its slots do not
divide), ``read`` gathers the leaf where a layer reads it and
``write_block`` / ``write_slots`` write back this rank's block of the new
value. Where the step splits the SSD heads or the RG-LRU channels as the
leaf does, a layer reads and writes its own part only (``read_part`` /
``write_part``); the SSM conv window's ``model`` block cuts across its
x, B and C channels, so a split SSD layer reads it whole and gathers its
new x channels before it writes its block (``models.ssm``). MLA splits its
heads as GQA does: its cache has no head dim, so every rank computes the
new latent and rope key whole, writes the part that falls in its slots,
and attends with every gathered q head over its own slots
(``combine_heads``).

Collectives run only over axes of more than one rank, so on a mesh of size
1 every function here is the identity or the plain write, and a serving
step keeps the plain step's bits.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_map


class Split(NamedTuple):
    """This rank's block of a leaf along one dim: its first index in the
    full leaf, the dim's full size, and the axes (of more than one rank,
    most significant first) that split it (``()``: the block is the whole
    dim)."""

    lo: int
    full: int
    axes: Tuple[str, ...]


def split(t: torch.Tensor, dim: int) -> Split:
    """``t``'s block along ``dim`` under its spec on the current mesh."""
    mesh = S.current_mesh()
    spec = None if mesh is None else fsdp.spec_of(t)
    n = t.shape[dim]
    if spec is None or mesh is None or dim >= len(spec):
        return Split(0, n, ())
    sizes = S.mesh_shape(mesh)
    k, idx = S.block_index(spec[dim], mesh, sizes)
    if k == 1:
        return Split(0, n, ())
    return Split(idx * n, n * k,
                 tuple(a for a in S.spec_axes(spec[dim]) if sizes[a] > 1))


def _but(spec, dims: Sequence[int]):
    """``spec`` with the entries of ``dims`` left whole."""
    return tuple(None if d in dims else e for d, e in enumerate(spec))


def read(t: torch.Tensor, keep: Sequence[int] = (0,)) -> torch.Tensor:
    """``t`` gathered over every split dim but those in ``keep`` (by
    default its rows, dim 0 of a layer's leaf): ``t`` itself where no other
    dim is split."""
    mesh = S.current_mesh()
    spec = None if mesh is None else fsdp.spec_of(t)
    if spec is None or mesh is None:
        return t
    part = _but(spec, keep)
    sizes = S.mesh_shape(mesh)
    if all(sizes[a] == 1 for e in part for a in S.spec_axes(e)):
        return t
    return S.gather_shards(t, part, mesh)


def write_block(dst: torch.Tensor, full: torch.Tensor) -> None:
    """Write this rank's block of ``full`` (the new value of the whole
    leaf, on this rank's rows) into ``dst``."""
    mesh = S.current_mesh()
    spec = None if mesh is None else fsdp.spec_of(dst)
    if spec is not None and mesh is not None:
        full = S.shard_of(full, _but(spec, (0,)), mesh)
    dst.copy_(full)


def _check_part(t: torch.Tensor, dim: int) -> None:
    """Raise unless ``t``'s block along ``dim`` is this rank's part of the
    split axis (``fsdp.split_rank``): a cache placed by ``cache_shardings``
    splits the SSM state's heads and the RG-LRU channels over ``model``
    wherever the step's act rules split them."""
    n, idx = fsdp.split_rank()
    sp = split(t, dim)
    if sp.lo != idx * (sp.full // n) or t.shape[dim] != sp.full // n:
        raise ValueError(
            f"a cache leaf's block [{sp.lo}, {sp.lo + t.shape[dim]}) of "
            f"{sp.full} along dim {dim} is not this rank's part of the "
            f"{n} ranks that split it (place it by cache_shardings)")


def read_part(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This rank's part along ``dim`` of the split axis of a cache leaf
    (the SSM state's heads, an RG-LRU state's channels, under a step that
    splits them), on its rows: its block, which must be that part."""
    _check_part(t, dim)
    return read(t, (0, dim))


def write_part(dst: torch.Tensor, part: torch.Tensor, dim: int) -> None:
    """Write ``part``, the new value of this rank's part along ``dim`` of
    the split axis (``read_part``), into its block ``dst``."""
    _check_part(dst, dim)
    dst.copy_(part)


def write_slots(dst: torch.Tensor, src: torch.Tensor, start: int, dim: int,
                rows: bool = True) -> None:
    """Write ``src``, the values of global slots [start, start +
    src.shape[dim]) along ``dim``, into this rank's block ``dst``: the
    slots that fall in the block, and on every other split dim but the
    rows (dim 0 where ``rows``) this rank's block of them."""
    mesh = S.current_mesh()
    spec = None if mesh is None else fsdp.spec_of(dst)
    if spec is None or mesh is None:
        dst.narrow(dim, start, src.shape[dim]).copy_(src)
        return
    sp = split(dst, dim)
    a = max(start, sp.lo)
    b = min(start + src.shape[dim], sp.lo + dst.shape[dim])
    if a >= b:
        return
    src = S.shard_of(src, _but(spec, (0, dim) if rows else (dim,)), mesh)
    dst.narrow(dim, a - sp.lo, b - a).copy_(src.narrow(dim, a - start,
                                                       b - a))


def combine(out: torch.Tensor, lse: torch.Tensor, axes) -> torch.Tensor:
    """Split-KV: ``out`` (..., D) float32, each rank's attention output
    normalised over its own keys, and ``lse`` (...) the log-sum-exp of its
    scores -> the output over every rank's keys of ``axes``. A rank whose
    keys are all masked has an lse near the mask's -2e38 and weighs 0."""
    mesh = S.current_mesh()
    pack = _rescaled(out, lse, axes, mesh)
    for a in axes:
        dist.all_reduce(pack, group=mesh.get_group(a))
    return pack[..., :-1] / pack[..., -1:]


def _rescaled(out, lse, axes, mesh) -> torch.Tensor:
    """(..., D + 1): ``out`` and its weight exp(lse - the max of ``lse``
    over ``axes``) side by side, the output scaled by the weight, for a
    sum over the ranks of ``axes``."""
    top = lse.clone()
    for a in axes:
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    w = torch.exp(lse - top)
    return torch.cat([out * w[..., None], w[..., None]], dim=-1)


def combine_heads(out: torch.Tensor, lse: torch.Tensor,
                  axis: str) -> torch.Tensor:
    """``combine`` over the slots of ``axis`` (every rank's ``out``
    (B, Hkv, G, Sq, D) holds every query head), ending in this rank's
    block of the query heads (q head kv * G + g, the blocks in ``axis``'s
    order): (B, Sq, H / n, D) float32. The second sum is a reduce-scatter
    by heads, 1 / n of ``combine``'s all-reduce."""
    mesh = S.current_mesh()
    pack = _rescaled(out, lse, (axis,), mesh)
    b, hkv, g, sq, d = pack.shape
    pack = fsdp._reduce_scatter_dim(pack.reshape(b, hkv * g, sq, d), 1,
                                    mesh, axis)
    return (pack[..., :-1] / pack[..., -1:]).transpose(1, 2)


# ---------------------------------------------------------------------------
# Rows
# ---------------------------------------------------------------------------

def _rows_of(t):
    spec = fsdp.spec_of(t)
    return spec[0] if spec else None


def _rebatch(t: torch.Tensor, have, want, mesh) -> torch.Tensor:
    """``t``, the rows of the spec entry ``have``, as the rows of
    ``want``: an all-gather over the axes of ``have`` past their common
    prefix, then a slice over those of ``want``."""
    sizes = S.mesh_shape(mesh)
    h = [a for a in S.spec_axes(have) if sizes[a] > 1]
    w = [a for a in S.spec_axes(want) if sizes[a] > 1]
    c = 0
    while c < min(len(h), len(w)) and h[c] == w[c]:
        c += 1
    if len(h) > c:
        t = S.gather_shards(t, (tuple(h[c:]),), mesh)
    if len(w) > c:
        t = S.shard_of(t, (tuple(w[c:]),), mesh)
    return t


def to_rows(t: torch.Tensor, rows) -> torch.Tensor:
    """The caches' ``rows`` (a spec entry) of a step input ``t`` (marked
    with its spec, or whole)."""
    mesh = S.current_mesh()
    if mesh is None:
        return t
    return _rebatch(t, _rows_of(t), rows, mesh)


def from_rows(t: torch.Tensor, rows, like: torch.Tensor,
              seq=None) -> torch.Tensor:
    """A step output ``t`` computed on the caches' ``rows`` as the rows of
    ``like``'s split (the step input it answers), marked with that spec.
    ``seq``: ``t`` is this rank's block of the sequence (dim 1) over that
    axis; it keeps the caches' rows and is marked ``(rows, seq, ...)``,
    nothing moved."""
    mesh = S.current_mesh()
    if mesh is None:
        return t
    if seq is not None:
        return fsdp.mark(t, (rows, seq) + (None,) * (t.dim() - 2))
    want = _rows_of(like)
    out = _rebatch(t, rows, want, mesh)
    return fsdp.mark(out, (want,) + (None,) * (t.dim() - 1))


def serving_layout(mesh, rows) -> fsdp.Layout:
    """The layout of a serving step on ``mesh`` that computes the caches'
    ``rows`` (a spec entry): the rows' axes are its batch axes, and it
    splits the products over ``model`` wherever ``model`` has more than
    one rank and is not one of those axes, its residual whole where the
    positions do not split (``fsdp.make_layout``)."""
    return fsdp.make_layout(mesh, S.spec_axes(rows), True,
                            seq_fallback=True)


def prefill_seq_axis(mesh, rules, rows, seq: int):
    """The axis over which a ``seq``-position prefill under ``rules``
    leaves its residual, and so its logits, in sequence blocks, or None
    (``serving_layout`` and ``fsdp.residual``'s decision, made before the
    step)."""
    axis = serving_layout(mesh, rows).split
    spec = S.build_spec((seq,), ("seq",), mesh, rules)
    return axis if axis in S.spec_axes(spec[0]) else None


@contextlib.contextmanager
def serving(mesh, act_rules, rows=None):
    """Context of a serving step on ``mesh`` that computes the caches'
    ``rows`` (a spec entry): no gradient, the mesh and its activation rules
    current, the parameters gathered where the model reads them
    (``fsdp.gathered``), and ``serving_layout``: the rows' axes as the
    layout's batch axes, so that an MoE FFN routes over the whole batch
    (``models.moe``), and the products split over ``model``."""
    with torch.no_grad(), S.use_mesh(mesh, act_rules), \
            fsdp.use_layout(serving_layout(mesh, rows)):
        yield


# ---------------------------------------------------------------------------
# Placing
# ---------------------------------------------------------------------------

def place(tree, shardings):
    """Each tensor leaf of ``tree`` (caches, a batch, or a plain tuple such
    as ``enc_out``) as this rank's block under its sharding, marked
    (``fsdp.place``); host ints (a cache's ``index``) stay as they are."""
    if type(tree) is tuple:
        return tuple(place(t, sh) for t, sh in zip(tree, shardings))
    return fsdp.place(tree, shardings)


def init_blocks(cfg, batch: int, max_len: int, shardings, device):
    """This rank's blocks of ``init_caches(cfg, batch, max_len)`` under
    ``shardings`` (``cache_shardings``), each allocated at its local shape
    only and filled as ``init_caches`` fills its leaf (``pos`` -1, the rest
    0), marked."""
    from repro_torch.models.layers import dtype_of
    from repro_torch.models.transformer import init_caches

    dtype = dtype_of(cfg.dtype)
    meta = init_caches(cfg, batch, max_len, dtype, "meta")
    fills = init_caches(cfg, 1, 1, dtype, "cpu")

    def one(t, fill, sh):
        if not isinstance(t, torch.Tensor):
            return t
        out = torch.full(S.local_shape(t.shape, sh.spec, sh.mesh),
                         fill.reshape(-1)[0].item(), dtype=t.dtype,
                         device=device)
        return fsdp.mark(out, sh.spec)

    return tree_map(one, meta, fills, shardings)
