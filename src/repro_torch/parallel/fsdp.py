"""Sharded parameters for the train and serving steps: explicit local
blocks, gathered where the model reads them, gradients reduce-scattered
(FSDP); and the products split over ``model`` (tensor and sequence
parallelism).

The reference lets GSPMD partition its step from the parameters'
``NamedSharding``s. Here a sharded parameter is this rank's block of the
full tensor (``place``), marked with its spec (``spec_of``); optimizer
state is placed the same way, so a rank stores only its blocks. Every
place a parameter enters the computation (the embedding, each layer's
mixer / cross-attention / FFN segment, the norms, the loss's table) takes
it through ``gathered``, which under a ``Layout`` all-gathers each marked
leaf to its full shape and otherwise returns it unchanged. A stacked layer
tensor's per-layer slices carry the spec without its leading layer entry
(``mark_slices``), so a layer is gathered when it runs, and again when a
remat segment recomputes it.

The gather's backward turns the gradient of this rank's share of the
batch into this rank's block summed over the ranks that split the batch
(``Layout.batch_axes``): a reduce-scatter over each batch axis that splits
one of the leaf's dims, a slice for every other axis of its spec, and an
all-reduce of the block over the batch axes that split none of its dims
(under ZeRO-1 the parameters are whole over ``data``, so their gradients
take this all-reduce and the step then cuts the optimizer's block).

The split over ``model`` (``Layout.split``: wherever ``model`` has more
than one rank and splits no batch; a train step's layout,
``train.train_step``, and a serving step's, ``parallel.kvcache.serving``,
whose batch axes are the caches' rows). The residual stream between
segments, and so what remat keeps of it, is this rank's block of the
sequence (the reference's ``seq`` over ``model``). A segment normalises
its block, gathers the sequence (``seq_gather``) and ends in one of two
ways. A split segment (GQA and MLA heads, MLP columns, an MoE layer's
routed experts with its shared experts' columns, SSD heads, RG-LRU
channels, the enc-dec's encoder and cross-attention heads, where
``splits`` says the step's act rules give the dim ``model``) reads its
parameters' ``model`` blocks (``gathered(..., keep=True)``), computes its
heads, columns, channels or experts only, and reduce-scatters its partial
sums over the sequence (``seq_scatter``). Any other segment (one whose
dim the act rules leave whole: recurrentgemma-2b's 10 attention heads on
16 ranks) computes in full, as the unsplit step does, and keeps its own
block of the result (``seq_block``). Inside a split segment, a product
that contracts the split dim and is kept for the rank's own channels
(RG-LRU's gates) is reduce-scattered over that dim
(``channel_scatter``), and a sum over every channel that each rank
applies to its own (the SSD's gated RMSNorm) is all-reduced forward and
backward (``model_sum_shared``). The embedding is vocab-parallel (a
rank's vocab block, a reduce-scatter of one nonzero term a token) and so
is the loss (``model_sum``, ``model_max``).

A serving step's positions need not split: a decode step has one, and a
prompt may have a length ``model`` does not divide. The reference's
divisibility fallback then leaves ``seq`` whole, and so does a serving
layout (``Layout.seq_fallback``): ``residual`` gives such a forward a
layout whose residual is whole on every rank of ``model``
(``Layout.whole_seq``), where a split segment's partial sums are
all-reduced (``model_sum``) and any other segment keeps its whole
output. A train step's layout has no fallback: its sequence must split.

A kept block's gradient is exactly the block's, so it is summed over the
batch axes only; every other leaf's gradient on a rank is the part that
rank's sequence block, heads, columns or experts produced, so ``model``
joins the axes it is summed over. That holds for a leaf a split segment
reads whole: MLA's ``w_dkv``, ``kv_norm`` and ``w_kr`` reach the loss
through this rank's heads only, an MoE router through this rank's
experts' outputs (its routing weights) and the aux, and the SSD's fused
``w_in`` and ``conv_w`` through this rank's heads' columns and B and C,
so each rank's gradient of them is a partial sum. A scalar that every
``model`` rank computes whole (an MoE aux) passes through
``model_share``, so that sum counts it once.

A statistic of the whole batch (an MoE FFN's expert counts and aux, a
masked loss's mask sum) is read through the layout as well:
``Layout.batch_gather`` stacks every batch rank's value in the rows'
order, and ``Layout.whole_batch`` sums a rank's share over the batch
ranks with ``batch_n`` times the share's gradient, which the step's mean
over those ranks turns into the whole batch's gradient. The serving
steps' layout takes the caches' rows as its batch axes, so both paths
use these two.

Collectives run only over axes of more than one rank, and a leaf is
gathered only where its spec, the batch or the split has such an axis, so
on a mesh of size 1 every path here is the identity and the step keeps the
plain step's bits.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import scalar
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_leaves, tree_map

#: attribute under which a placed leaf carries its spec
_SPEC_ATTR = "_repro_shard_spec"


def mark(t: torch.Tensor, spec) -> torch.Tensor:
    setattr(t, _SPEC_ATTR, tuple(spec))
    return t


def spec_of(t) -> Optional[tuple]:
    return getattr(t, _SPEC_ATTR, None)


def mark_slices(slices, stacked: torch.Tensor):
    """Give each slice of a stacked leaf the leaf's spec without its first
    (layer) entry."""
    spec = spec_of(stacked)
    if spec is not None:
        for s in slices:
            mark(s, spec[1:])
    return slices


def mark_tree(tree, shardings):
    """Mark every leaf of ``tree`` (already blocks) with its sharding's
    spec."""
    return tree_map(lambda t, sh: t if sh is None else mark(t, sh.spec),
                    tree, shardings)


def place(tree, shardings):
    """The ``device_put`` counterpart: each leaf's block under its
    sharding, marked, with the leaf's ``requires_grad``. A block smaller
    than its leaf is copied (the full tensor can then be freed); a block
    that is the whole leaf shares its storage. Leaves without a sharding
    and host values (a cache's ``index``) stay as they are."""
    def one(t, sh):
        if sh is None or not isinstance(t, torch.Tensor):
            return t
        full = t.detach()
        local = sh.shard(full)
        if local.numel() != full.numel():
            local = local.clone()
        return mark(local.requires_grad_(t.requires_grad), sh.spec)

    return tree_map(one, tree, shardings)


def full_value(t, mesh=None) -> torch.Tensor:
    """The full tensor of a marked leaf (gathered from every rank), or the
    leaf itself."""
    spec = spec_of(t)
    mesh = mesh or S.current_mesh()
    if spec is None or mesh is None:
        return t
    return S.gather_shards(t.detach(), spec, mesh)


def extra_spec(param_spec, grad_spec, ndim: int) -> tuple:
    """The axes ``grad_spec`` adds to ``param_spec`` on each dim: the spec
    of a grad block within the parameter's block (ZeRO-1: the optimizer's
    ``embed`` over ``data`` under a parameter block with ``embed``
    whole)."""
    ps = tuple(param_spec or ()) + (None,) * ndim
    gs = tuple(grad_spec or ()) + (None,) * ndim
    out = []
    for d in range(ndim):
        p, g = S.spec_axes(ps[d]), S.spec_axes(gs[d])
        if g[:len(p)] != p:
            raise ValueError(f"grad spec {grad_spec} does not refine the "
                             f"parameter spec {param_spec} on dim {d}")
        rest = g[len(p):]
        out.append(None if not rest else rest[0] if len(rest) == 1
                   else rest)
    return tuple(out)


# ---------------------------------------------------------------------------
# The layout of a sharded step
# ---------------------------------------------------------------------------

class Layout(NamedTuple):
    """The mesh of a sharded step, its axis sizes, the axes (of more than
    one rank) that split its batch and their product, the axis that
    splits its products, if any, and how its residual stream meets a
    sequence that axis does not divide (``make_layout``)."""

    mesh: object
    sizes: Dict[str, int]
    batch_axes: Tuple[str, ...]
    batch_n: int
    #: ``gathered``'s decision for each spec met so far
    needs: Dict[tuple, bool]
    #: ``model`` where the step splits its products over it, else None
    split: Optional[str] = None
    #: a serving step's: a residual whose positions do not split over
    #: ``split`` stays whole (the reference's divisibility fallback); a
    #: train step's layout raises there instead (``residual``)
    seq_fallback: bool = False
    #: set by ``residual`` for one forward: the residual stream is whole on
    #: every rank of ``split`` (its positions did not split)
    whole_seq: bool = False

    def sum_over(self, t: torch.Tensor, axes) -> torch.Tensor:
        for a in axes:
            if self.sizes[a] > 1:
                dist.all_reduce(t, group=self.mesh.get_group(a))
        return t

    def batch_sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the ranks that split the batch (in place on a
        contiguous copy)."""
        if self.batch_n == 1:
            return t
        return self.sum_over(t.contiguous().clone(), self.batch_axes)

    def batch_mean(self, t: torch.Tensor) -> torch.Tensor:
        n = self.batch_n
        if n == 1:
            return t
        return self.batch_sum(t) / scalar(n, t)

    def batch_rank(self) -> int:
        """This rank's block of the batch's rows: its index along the batch
        axes, most significant first (pod-major), so the rows' order."""
        return S.block_index(self.batch_axes, self.mesh, self.sizes)[1]

    def batch_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(batch_n, *t.shape): ``t`` of every rank that splits the batch,
        stacked in the order of their rows (one all-gather a batch axis;
        no gradient)."""
        if self.batch_n == 1:
            return t[None]
        return S.gather_shards(t.detach()[None], (self.batch_axes,),
                               self.mesh)

    def whole_batch(self, t: torch.Tensor) -> torch.Tensor:
        """A whole-batch statistic from this rank's share ``t`` of it: the
        value is ``t`` summed over the ranks that split the batch, and the
        gradient with respect to this rank's ``t`` is ``batch_n``. The step
        sums each rank's gradients and divides them by ``batch_n`` (each
        rank's loss is the mean over its own rows), so a term a rank
        reads through ``whole_batch`` reaches the update with the whole
        batch's gradient, as the reference's single-device step takes
        it."""
        if self.batch_n == 1:
            return t
        share = t - t.detach()          # 0, carrying t's gradient
        return self.batch_sum(t.detach()) + share * scalar(self.batch_n,
                                                           share)

    def global_norm(self, tree, specs: List[tuple]) -> torch.Tensor:
        """The L2 norm of a tree of blocks under ``specs`` (one a leaf in
        tree order): each leaf's sum of squares summed over the axes that
        split it (one collective per distinct axis set), then the leaves
        summed in order, as ``optim.adamw.global_norm`` sums them."""
        leaves = tree_leaves(tree)
        sums = [torch.sum(torch.square(x.float())) for x in leaves]
        groups = {}
        for i, spec in enumerate(specs):
            axes = tuple(a for e in (spec or ()) for a in S.spec_axes(e)
                         if self.sizes[a] > 1)
            if axes:
                groups.setdefault(tuple(sorted(axes)), []).append(i)
        for axes, idx in groups.items():
            part = self.sum_over(torch.stack([sums[i] for i in idx]), axes)
            for j, i in enumerate(idx):
                sums[i] = part[j]
        return torch.sqrt(torch.sum(torch.stack(sums)))


# The layout is process-wide, not thread-local: on the card autograd runs a
# backward, and so a remat segment's recomputed forward, on its own device
# thread, which must gather as the forward did.
_layout: List[Optional[Layout]] = [None]


def current_layout() -> Optional[Layout]:
    return _layout[0]


class use_layout:
    """Context: ``gathered`` gathers under ``layout`` (None: it does
    nothing)."""

    def __init__(self, layout: Optional[Layout]):
        self.layout = layout

    def __enter__(self):
        self.prev, _layout[0] = _layout[0], self.layout
        return self.layout

    def __exit__(self, *exc):
        _layout[0] = self.prev


def layout_of(params, batch, split: bool = False) -> Optional[Layout]:
    """The layout of a step on ``params`` and ``batch``: None when no leaf
    of either is marked (the plain step); else the current mesh (which must
    be set), the batch's split axes and, with ``split``, the split of the
    products over ``model`` (``make_layout``)."""
    marked = any(spec_of(p) is not None for p in tree_leaves(params))
    bspec = spec_of(batch["tokens"])
    if not marked and bspec is None:
        return None
    mesh = S.current_mesh()
    if mesh is None:
        raise ValueError("sharded parameters or batch need a mesh: run the "
                         "step under parallel.sharding.use_mesh")
    return make_layout(mesh, S.spec_axes(bspec[0]) if bspec else (), split)


def make_layout(mesh, batch_axes, split: bool = False,
                seq_fallback: bool = False) -> Layout:
    """``split``: the products split over ``model`` wherever it has more
    than one rank and splits no batch (else the layout splits nothing).
    ``seq_fallback``: a serving step's layout, whose residual stays whole
    where its positions do not split (``residual``)."""
    sizes = S.mesh_shape(mesh)
    axes = tuple(a for a in batch_axes if sizes[a] > 1)
    tp = ("model" if split and sizes.get("model", 1) > 1
          and "model" not in axes else None)
    return Layout(mesh, sizes, axes, math.prod(sizes[a] for a in axes), {},
                  tp, seq_fallback)


def _reduce_scatter_dim(t: torch.Tensor, dim: int, mesh,
                       axis: str) -> torch.Tensor:
    """``t`` summed over the ranks of ``axis``, and this rank's block of
    the sum along ``dim``."""
    src = t.movedim(dim, 0).contiguous()
    n = S.mesh_shape(mesh)[axis]
    out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=mesh.get_group(axis))
    return out.movedim(0, dim).contiguous() if dim else out


def reduce_to_block(grad: torch.Tensor, spec, layout: Layout,
                    keep: bool = False) -> torch.Tensor:
    """This rank's block under ``spec`` of ``grad`` summed over the ranks
    that split the batch and, where the layout splits the products and the
    leaf's ``model`` block was not kept, over ``model`` too. Along each
    dim, the axes of its spec entry in order (most significant first): a
    reduce-scatter over a summed axis, a slice for any other (whose ranks
    hold the same sum), nothing for the kept ``model`` (``grad`` is
    already its block); then an all-reduce of the block over the summed
    axes that split none of the dims."""
    mesh, out, scattered = layout.mesh, grad, set()
    summed = layout.batch_axes
    if layout.split is not None and not keep:
        summed = summed + (layout.split,)
    for dim, entry in enumerate(spec):
        for a in S.spec_axes(entry):
            n = layout.sizes[a]
            if n == 1 or (keep and a == layout.split):
                continue
            if a in summed:
                out = _reduce_scatter_dim(out, dim, mesh, a)
                scattered.add(a)
            else:
                size = out.shape[dim] // n
                out = out.narrow(dim, mesh.get_local_rank(a) * size, size)
    rest = [a for a in summed if a not in scattered]
    if rest:
        if not scattered:   # still a view of autograd's gradient
            out = out.clone(memory_format=torch.contiguous_format)
        out = layout.sum_over(out.contiguous(), rest)
    return out


def _without(spec, axis) -> tuple:
    """``spec`` with ``axis`` taken out of every entry."""
    out = []
    for entry in spec:
        rest = tuple(a for a in S.spec_axes(entry) if a != axis)
        out.append(None if not rest else rest[0] if len(rest) == 1
                   else rest)
    return tuple(out)


class _Gather(torch.autograd.Function):
    """Forward: the full tensor of a block (with ``keep``, the ``model``
    block: every other axis gathered). Backward: this rank's block of the
    gradient, summed (``reduce_to_block``)."""

    @staticmethod
    def forward(ctx, local, spec, layout, keep):
        ctx.spec, ctx.layout, ctx.keep = spec, layout, keep
        full = S.gather_shards(local, _without(spec, layout.split) if keep
                               else spec, layout.mesh)
        return full if full is not local else local.view_as(local)

    @staticmethod
    def backward(ctx, grad):
        return (reduce_to_block(grad, ctx.spec, ctx.layout, ctx.keep), None,
                None, None)


def _needs_gather(spec, layout: Layout) -> bool:
    hit = layout.needs.get(spec)
    if hit is None:
        hit = layout.needs[spec] = (
            layout.batch_n > 1 or layout.split is not None or any(
                layout.sizes[a] > 1 for e in spec for a in S.spec_axes(e)))
    return hit


def gathered(tree, keep: bool = False):
    """``tree`` (a tree, a leaf, or a plain tuple of either) with every
    marked leaf at its full shape under the current layout (the identity
    without one, or where no axis of the leaf's spec, the batch or the
    split has more than one rank). ``keep``: a leaf whose spec splits a dim
    over the layout's split axis keeps its ``model`` block of that dim (a
    split segment's heads, columns or vocab rows). The caller passes
    ``keep`` where the act rules split the segment (``splits``), so its
    output is this rank's partial sum; a tree of which no leaf then keeps
    a block would give every rank the whole product, which the split would
    sum n times over: that raises."""
    layout = current_layout()
    if layout is None:
        return tree
    if type(tree) is tuple:
        return tuple(gathered(t, keep) for t in tree)
    keep = keep and layout.split is not None

    def kept(spec) -> bool:
        return keep and spec is not None and any(
            layout.split in S.spec_axes(e) for e in spec)

    if keep and not any(kept(spec_of(t)) for t in tree_leaves(tree)):
        raise ValueError(
            f"the act rules split this segment over {layout.split!r}, but "
            f"none of its parameters' specs holds a {layout.split!r} block "
            "(the parameter rules and the act rules disagree)")

    def one(t):
        spec = spec_of(t)
        if spec is None or not _needs_gather(spec, layout):
            return t
        return _Gather.apply(t, spec, layout, kept(spec))

    return tree_map(one, tree)


# ---------------------------------------------------------------------------
# The products split over ``model``: the residual's sequence blocks and the
# vocab-parallel sums
# ---------------------------------------------------------------------------

def split_axis() -> Optional[str]:
    """The axis the current step splits its products over, or None."""
    layout = current_layout()
    return None if layout is None else layout.split


def splits(name: str, dim: int) -> bool:
    """Whether the current step splits the activation dim ``name`` of size
    ``dim`` over its split axis: ``build_spec`` under the step's act rules
    gives it that axis (the divisibility fallback decides, as the
    reference's does)."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return False
    spec = S.build_spec((dim,), (name,), layout.mesh,
                        S.current_act_rules())
    return layout.split in S.spec_axes(spec[0])


def split_rank() -> Tuple[int, int]:
    """(the ranks of the split axis, this rank's index on it); (1, 0)
    without a split."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return 1, 0
    return (layout.sizes[layout.split],
            layout.mesh.get_local_rank(layout.split))


@contextlib.contextmanager
def residual(seq: int):
    """Context of a forward whose residual stream has ``seq`` positions;
    yields whether the stream is split over the sequence: wherever the step
    splits its products and the act rules split ``seq`` there. Where they
    do not, a serving layout (``Layout.seq_fallback``) leaves the stream
    whole on every rank of the split axis (``whole_seq`` inside the
    context), as the reference's divisibility fallback does; a train
    step's layout raises: it never falls back to whole products."""
    layout = current_layout()
    if layout is None or layout.split is None:
        yield False
    elif splits("seq", seq):
        yield True
    elif not layout.seq_fallback:
        raise ValueError(
            f"the step splits its products over "
            f"{layout.sizes[layout.split]} ranks of {layout.split!r}, but "
            f"its residual's {seq} positions do not split over them")
    else:
        with use_layout(layout._replace(whole_seq=True)):
            yield False


def whole_seq() -> bool:
    """Whether the current step splits its products over an axis on whose
    every rank the residual stream is whole (``residual``)."""
    layout = current_layout()
    return layout is not None and layout.split is not None and \
        layout.whole_seq


def split_gather(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` of the split axis, concatenated along ``dim`` in
    the axis's order (one all-gather; no gradient: serving's q heads, new
    kv heads and vocab columns)."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return t
    return S._gather_dim(t.detach(), dim, layout.mesh, layout.split)


class _SeqGather(torch.autograd.Function):
    """(B, S / n, ...) blocks -> (B, S, ...): forward all-gathers the
    sequence over the split axis, backward reduce-scatters the gradient
    (each rank's part of it) back to the blocks."""

    @staticmethod
    def forward(ctx, x, layout):
        ctx.layout = layout
        return S._gather_dim(x, 1, layout.mesh, layout.split)

    @staticmethod
    def backward(ctx, grad):
        return (_reduce_scatter_dim(grad, 1, ctx.layout.mesh,
                                    ctx.layout.split), None)


class _SplitScatter(torch.autograd.Function):
    """Partial sums -> this rank's block along ``dim`` of their sum over
    the split axis ((B, S, ...) -> (B, S / n, ...) at dim 1); backward
    all-gathers the blocks' gradients (each rank's partial sum takes the
    whole gradient)."""

    @staticmethod
    def forward(ctx, x, layout, dim):
        ctx.layout, ctx.dim = layout, dim
        return _reduce_scatter_dim(x, dim, layout.mesh, layout.split)

    @staticmethod
    def backward(ctx, grad):
        return (S._gather_dim(grad.contiguous(), ctx.dim, ctx.layout.mesh,
                              ctx.layout.split), None, None)


class _ModelSum(torch.autograd.Function):
    """Forward: ``t`` summed over the split axis. Backward: the gradient as
    it is (``shared`` False: every rank holds the whole sum's gradient,
    which is each term's), or summed over the axis too (``shared``: each
    rank's gradient of the sum is the part its own use of it gives)."""

    @staticmethod
    def forward(ctx, t, layout, shared):
        ctx.layout, ctx.shared = layout, shared
        return layout.sum_over(t.contiguous().clone(), (layout.split,))

    @staticmethod
    def backward(ctx, grad):
        if ctx.shared:
            grad = ctx.layout.sum_over(grad.contiguous().clone(),
                                       (ctx.layout.split,))
        return grad, None, None


def seq_gather(x: torch.Tensor) -> torch.Tensor:
    """The whole sequence of a residual block (the identity without a
    split)."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return x
    return _SeqGather.apply(x, layout)


def seq_scatter(x: torch.Tensor) -> torch.Tensor:
    """This rank's sequence block of the sum over the split axis of every
    rank's partial ``x`` (the identity without a split)."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return x
    return _SplitScatter.apply(x, layout, 1)


def channel_scatter(x: torch.Tensor) -> torch.Tensor:
    """This rank's block along the last dim of the sum over the split axis
    of every rank's partial ``x`` (the identity without a split): a
    product that contracts a split dim (RG-LRU's gates, ``w_a`` and
    ``w_i`` read as row blocks) kept for this rank's own channels; its
    backward all-gathers."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return x
    return _SplitScatter.apply(x, layout, x.dim() - 1)


def seq_block(x: torch.Tensor) -> torch.Tensor:
    """This rank's sequence block of a whole-sequence ``x`` that every rank
    of the split axis computed alike (the identity without a split)."""
    n, idx = split_rank()
    if n == 1:
        return x
    size = x.shape[1] // n
    return x.narrow(1, idx * size, size)


def model_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the split axis, each rank's gradient the sum's
    (the vocab-parallel loss's sums)."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return t
    return _ModelSum.apply(t, layout, False)


def model_sum_shared(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the split axis where each rank uses the sum for
    its own part only (the split gated RMSNorm's sum of squares, which a
    rank applies to its own channels): the backward sums the ranks'
    gradients over the axis too, so each term takes the whole sum's."""
    layout = current_layout()
    if layout is None or layout.split is None:
        return t
    return _ModelSum.apply(t, layout, True)


def model_max(t: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``t`` over the split axis, no gradient."""
    layout = current_layout()
    t = t.detach()
    if layout is None or layout.split is None:
        return t
    out = t.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX,
                    group=layout.mesh.get_group(layout.split))
    return out


def model_share(t: torch.Tensor) -> torch.Tensor:
    """A term every rank of the split axis computes whole (an MoE layer's
    aux on the whole sequence): its value, with 1 / n of its gradient, so
    the gradients' sum over the axis counts it once."""
    n, _ = split_rank()
    if n == 1:
        return t
    share = t - t.detach()
    return t.detach() + share / scalar(n, share)
