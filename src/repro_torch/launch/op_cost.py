"""Per-rank cost of one eager step, the port's counterpart of the
reference's trip-count-aware HLO cost model (``src/repro/launch/
hlo_cost.py``).

Eager torch has no HLO: the unit here is the aten op, as a
``TorchDispatchMode`` sees it below autograd (so a backward's ops and a
remat segment's recomputation count where they run). ``analyze(fn,
args)`` runs ``fn(*args)`` once and records, for the rank it runs as:

  flops            : matmul-family FLOPs at 2 M N K, exactly as
                     ``torch.utils.flop_counter.FlopCounterMode`` counts
                     them (one runs inside the mode)
  bytes_accessed   : input plus output bytes of every aten op that is not
                     a view, and the operand bytes of every collective.
                     This is eager's own traffic: every op reads its inputs
                     from memory and writes its output back. The
                     reference's estimate is taken after XLA's fusion (twice
                     the output bytes of each top-level fused instruction),
                     so the two differ by what fusion keeps on chip; compare
                     the port with itself
  collectives      : operand bytes and counts by kind, in the reference's
                     vocabulary (``all-gather``, ``all-reduce``,
                     ``reduce-scatter``, ``all-to-all``,
                     ``collective-permute``), from the c10d ops
  top_collectives  : [bytes, "kind site"] of the heaviest (kind, site)
                     pairs, a site as ``analysis.census`` names it but
                     past the parallel layer's own frames (its gathers,
                     reduce-scatters and combines) and the tree walk, so
                     the model or step code that asked
  memory           : argument_size_in_bytes, the rank's blocks of the
                     step's arguments; output_size_in_bytes, the new
                     storages the step returns (arguments updated in place
                     count 0, as the reference's donated buffers alias);
                     temp_size_in_bytes, the peak of the live bytes above
                     the arguments during the step (outputs included)

Storages are keyed by ``untyped_storage()._cdata`` (a ``meta`` tensor's
``data_ptr()`` is 0), counted once across their views, and freed when
their storage object dies, which is when the last tensor on it dies
(autograd's saved tensors included). A storage first seen as an op's
input that is not an argument existed before the step (a constant of the
model) and is not counted.

The step may run on ``meta`` tensors (``launch.dryrun``: no device, the
shapes and the control flow of the real step) or on real ones (the card's
check of the prediction). Ops issued inside a kernel wrapper's plain
version are seen like any other.
"""
from __future__ import annotations

import collections
import weakref
from pathlib import Path
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.analysis import census

#: the reference's collective kinds, in its order
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")
#: (kind, site) pairs kept in ``top_collectives``
TOP = 12

#: files a collective's site is named past: this one, the tree walk and
#: the parallel layer's
_SKIP = (Path(__file__).resolve(), census.PKG / "tree.py") + tuple(
    sorted((census.PKG / "parallel").glob("*.py")))


def _tensors(tree):
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _storage_key(t: torch.Tensor):
    st = t.untyped_storage()
    return st._cdata, st


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Memory:
    """Live storages created during the step, their peak, and the
    storages that were there before it."""

    def __init__(self):
        self.live = 0
        self.peak = 0
        self.sizes: Dict[int, int] = {}       # cdata -> bytes (0: earlier)

    def _free(self, key: int) -> None:
        self.live -= self.sizes.pop(key, 0)

    def seen(self, t: torch.Tensor, new: bool) -> None:
        key, st = _storage_key(t)
        if key in self.sizes:
            return
        size = st.nbytes() if new else 0
        self.sizes[key] = size
        weakref.finalize(st, self._free, key)
        if size:
            self.live += size
            self.peak = max(self.peak, self.live)


class _Mode(TorchDispatchMode):
    def __init__(self, cost: "_Cost"):
        super().__init__()
        self.cost = cost

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        mem = self.cost.memory
        inputs = _tensors((args, kwargs))
        for t in inputs:
            mem.seen(t, new=False)
        out = func(*args, **kwargs)
        self.cost.record(func, args, inputs, out)
        for t in _tensors(out):
            mem.seen(t, new=True)
        return out


class _Cost:
    def __init__(self):
        self.memory = _Memory()
        self.bytes_accessed = 0
        self.coll_bytes = collections.Counter()
        self.coll_counts = collections.Counter()
        self.by_site = collections.Counter()

    def record(self, func, args, inputs, out) -> None:
        packet = getattr(func, "_overloadpacket", None)
        if packet is None:      # a higher-order op: its body's ops count
            return
        name = packet.__name__
        if func.namespace == "c10d":
            kind = census.C10D_KINDS.get(name, f"c10d.{name}")
            if kind is None:
                return
            nbytes = census.operand_bytes(name, args)
            self.coll_counts[kind] += 1
            self.coll_bytes[kind] += nbytes
            self.bytes_accessed += nbytes
            self.by_site[f"{kind} {census.site(skip=_SKIP)}"] += nbytes
            return
        if func.is_view:
            return
        self.bytes_accessed += sum(map(tensor_bytes, inputs)) + sum(
            map(tensor_bytes, _tensors(out)))


def argument_bytes(args) -> int:
    """The bytes of the distinct storages of ``args``' tensors."""
    sizes = {}
    for t in _tensors(args):
        key, st = _storage_key(t)
        sizes[key] = st.nbytes()
    return sum(sizes.values())


def analyze(fn, args: Tuple) -> Tuple[Any, Dict[str, Any]]:
    """Run ``fn(*args)`` once; returns (its output, the cost: module
    docstring)."""
    cost = _Cost()
    arg_keys = set()
    for t in _tensors(args):
        key, st = _storage_key(t)
        arg_keys.add(key)
        cost.memory.seen(t, new=False)
    flops = FlopCounterMode(display=False)
    with flops, _Mode(cost):
        out = fn(*args)
    outputs = {}
    for t in _tensors(out):
        key, st = _storage_key(t)
        if key not in arg_keys and cost.memory.sizes.get(key):
            outputs[key] = st.nbytes()
    kinds = list(COLLECTIVES) + sorted(set(cost.coll_counts)
                                       - set(COLLECTIVES))
    top = sorted(((b, s) for s, b in cost.by_site.items()),
                 key=lambda x: (-x[0], x[1]))[:TOP]
    result = {
        "flops": int(flops.get_total_flops()),
        "bytes_accessed": int(cost.bytes_accessed),
        "collectives": {
            "bytes_by_kind": {k: int(cost.coll_bytes[k]) for k in kinds},
            "counts": {k: int(cost.coll_counts[k]) for k in kinds},
            "total_bytes": int(sum(cost.coll_bytes.values())),
        },
        "top_collectives": [[int(b), s] for b, s in top],
        "memory": {
            "argument_size_in_bytes": argument_bytes(args),
            "output_size_in_bytes": sum(outputs.values()),
            "temp_size_in_bytes": cost.memory.peak,
        },
    }
    return out, result
