"""Logical-axis sharding rules -> concrete specs, as the reference's
``src/repro/parallel/sharding.py``.

Every tensor is described by *logical* dim names; the rules table maps
names to mesh axes (DP/FSDP/TP/EP/SP). ``build_spec`` drops any mapping
whose axis size does not divide the dim, so small models gracefully lose
TP on dims that do not split (8 kv heads on a 16-way model axis).

A spec is a tuple with one entry a tensor dim: None (replicated), a mesh
axis name, or a tuple of names (the dim split over those axes, the first
the most significant), the counterpart of ``PartitionSpec``; ``()`` is
``P()``. A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with
named dims, or anything with a ``.shape`` dict of axis sizes (the spec
tables need no devices): ``mesh_shape`` reads either.

``NamedSharding(mesh, spec)`` places a tensor: ``shard`` takes this rank's
block of a full tensor and ``gather`` assembles the full tensor from every
rank's block.

The reference's ``logical(x, names)`` (``with_sharding_constraint``) has
no counterpart here: the port's model computes on plain tensors, and a
train step decides each split where the reference places a constraint,
from ``build_spec`` under the step's act rules (``parallel.fsdp.splits``),
then moves the blocks itself (``fsdp.seq_gather`` / ``seq_scatter``).
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

AxisName = Union[str, Tuple[str, ...], None]
Spec = Tuple[AxisName, ...]

# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

#: parameter dims
PARAM_RULES: Dict[str, AxisName] = {
    "vocab": "model",
    "embed": "data",          # FSDP / ZeRO-3: shard the embed dim over data
    "heads": "model",         # TP: attention heads
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",           # TP: MLP hidden
    "experts": "model",       # EP: routed experts
    "expert_mlp": None,
    "kv_lora": None,
    "layers": None,           # the stacked-layer axis, never sharded
    "conv": None,
    "state": None,
}

#: activation dims
ACT_RULES: Dict[str, AxisName] = {
    "batch": ("pod", "data"),
    # Megatron-style sequence parallelism: the residual stream shards its
    # seq dim over `model`; the divisibility fallback handles seq=1 decode
    "seq": "model",
    "attn_seq": None,   # attention-internal q/k/v seq dim (never forced)
    "kv_seq": None,
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "capacity": None,
    "vocab": "model",
    "state": None,
    # LArTPC sim
    "depos": ("pod", "data", "model"),
    "events": ("pod", "data"),   # event axis of a multi-event batch (DP)
    "wires": "model",
    "ticks": None,
}

#: DP-heavy activation rules for small archs whose head count does not
#: divide the model axis (e.g. 14 heads on 16): the batch claims every
#: mesh axis (pure data parallelism); the per-tensor divisibility fallback
#: drops the `model` axis from any dim that cannot take it
DP_ACT_RULES: Dict[str, AxisName] = dict(
    ACT_RULES, batch=("pod", "data", "model"),
)


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (its named dims) or of a
    stand-in with a ``.shape`` dict; {} for None."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return {n: mesh.size(i) for i, n in enumerate(names)}
    return dict(mesh.shape)


def act_rules_for(cfg, mesh) -> Dict[str, AxisName]:
    """Pick TP (heads over model) or DP-heavy activation rules per arch."""
    shape = mesh_shape(mesh)
    if mesh is None or "model" not in shape:
        return ACT_RULES
    nh = getattr(cfg, "num_heads", 0)
    if nh and nh % shape["model"] != 0:
        return DP_ACT_RULES
    return ACT_RULES


def rules_without_fsdp(rules: Dict[str, AxisName]) -> Dict[str, AxisName]:
    out = dict(rules)
    out["embed"] = None
    return out


# ---------------------------------------------------------------------------
# Mesh context
# ---------------------------------------------------------------------------

# Process-wide where the reference's tracker is thread-local: on the card
# autograd runs a backward, and a remat segment's recomputed forward, on its
# own device thread, which must see the mesh the forward saw.
_state = SimpleNamespace(mesh=None, act_rules=None)


def current_mesh():
    return _state.mesh


def current_act_rules() -> Dict[str, AxisName]:
    return _state.act_rules or ACT_RULES


@contextlib.contextmanager
def use_mesh(mesh, act_rules: Optional[Dict] = None):
    prev, prev_rules = _state.mesh, _state.act_rules
    _state.mesh = mesh
    _state.act_rules = act_rules
    try:
        yield mesh
    finally:
        _state.mesh = prev
        _state.act_rules = prev_rules


# ---------------------------------------------------------------------------
# Spec construction
# ---------------------------------------------------------------------------

def build_spec(shape: Sequence[int], names: Sequence[Optional[str]],
               mesh, rules: Dict[str, AxisName]) -> Spec:
    """The spec of ``shape`` given logical ``names``, with divisibility
    fallback (drop axes that don't divide, trailing-first for tuples)."""
    if mesh is None:
        return ()
    sizes = mesh_shape(mesh)
    assert len(shape) == len(names), (shape, names)
    used: set = set()
    entries = []
    for dim, name in zip(shape, names):
        axis = rules.get(name) if name else None
        if axis is None:
            entries.append(None)
            continue
        axes = (axis,) if isinstance(axis, str) else tuple(axis)
        # keep only axes present in the mesh and unused so far
        axes = tuple(a for a in axes if a in sizes and a not in used)
        # drop axes (from the right) until the product divides the dim
        while axes:
            prod = 1
            for a in axes:
                prod *= sizes[a]
            if prod and dim % prod == 0:
                break
            axes = axes[:-1]
        if not axes:
            entries.append(None)
        else:
            used.update(axes)
            entries.append(axes if len(axes) > 1 else axes[0])
    return tuple(entries)


def spec_axes(entry: AxisName) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, most significant first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _gather_dim(t: torch.Tensor, dim: int, mesh, axis: str) -> torch.Tensor:
    """The blocks of ``t`` along ``dim`` from every rank of ``axis``,
    concatenated in the axis's order."""
    n = mesh_shape(mesh)[axis]
    if n == 1:
        return t
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t.contiguous(), group=mesh.get_group(axis))
    return torch.cat(parts, dim=dim)


def block_index(entry: AxisName, mesh, sizes: Dict[str, int]
                ) -> Tuple[int, int]:
    """(the blocks a dim splits into under the spec entry ``entry``, this
    rank's block among them); ``sizes`` is ``mesh_shape(mesh)``."""
    n, idx = 1, 0
    for a in spec_axes(entry):
        n, idx = n * sizes[a], idx * sizes[a] + mesh.get_local_rank(a)
    return n, idx


def shard_of(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (a view; ``t`` itself when
    every axis of the spec has size 1)."""
    sizes = mesh_shape(mesh)
    for dim, entry in enumerate(spec):
        n, idx = block_index(entry, mesh, sizes)
        if n > 1:
            size = t.shape[dim] // n
            t = t.narrow(dim, idx * size, size)
    return t


def gather_shards(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """The full tensor from this rank's block ``t`` under ``spec``: per
    dim an all-gather over each of its axes, least significant first."""
    for dim, entry in enumerate(spec):
        for a in reversed(spec_axes(entry)):
            t = _gather_dim(t, dim, mesh, a)
    return t


def local_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    sizes = mesh_shape(mesh)
    out = list(shape)
    for dim, entry in enumerate(spec):
        for a in spec_axes(entry):
            out[dim] //= sizes[a]
    return tuple(out)


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh: the counterpart of ``jax.sharding.NamedSharding``
    (a leaf of a sharding tree, not a node)."""

    mesh: object
    spec: Spec

    def shard(self, t: torch.Tensor) -> torch.Tensor:
        return shard_of(t, self.spec, self.mesh)

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_shards(t, self.spec, self.mesh)


def named_sharding(shape, names, rules=None, mesh=None
                   ) -> Optional[NamedSharding]:
    mesh = mesh or current_mesh()
    if mesh is None:
        return None
    spec = build_spec(shape, names, mesh, rules or ACT_RULES)
    return NamedSharding(mesh, spec)


def spec_tree(shapes, names_tree, rules=None, mesh=None):
    """Map a tree (nested dicts) whose leaves are (shape, names) pairs to
    their specs; ``names_tree`` is unused, as in the reference."""
    mesh = mesh or current_mesh()
    rules = rules or PARAM_RULES

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        shape, names = node
        return build_spec(shape, names, mesh, rules)

    return one(shapes)
