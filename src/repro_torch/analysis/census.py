"""The op census of one eager program: the port's counterpart of the
reference's HLO inspection (``src/repro/analysis/hlo.py``).

An eager program has no compiled text, but it has an op stream. ``Census``
is a context manager that stacks a ``TorchDispatchMode`` (every aten and
c10d op) and a ``TorchFunctionMode`` (the Python-level calls the dispatcher
never sees: ``.tolist()``, ``.cpu()``, ``.numpy()``, ``int(t)``, and the
divisor of ``t / 2.5``) over the calls inside it, and records:

  dtypes          : output dtype tokens of every op, under the reference's
                    names (``f32``, ``c64``, ``pred``, ``s16``, ``s64``, ...)
  scatter_dtypes  : output dtypes of the accumulating writes
                    (``index_put_(accumulate=True)``, ``index_add_``,
                    ``scatter_add_``, ``scatter_reduce_``)
  host_syncs      : host reads and copies, ``{site: {"op@device": n}}``;
                    ``device`` is the device type of the tensor read (for a
                    host-to-card copy, of the copy's destination): ``cuda``
                    reads wait for the card, ``cpu`` ones do not on the card
  collectives     : c10d ops per kind, in the reference's vocabulary
  collective_bytes: their operand bytes per kind (``operand_bytes``)
  kernels         : launches of the eight kernel wrappers (PERF §6 rows
                    1-8): on the card the wrappers' ``LAUNCHES`` deltas, on
                    the CPU the plain-version runs that stand for them
  float_divisions : ``tensor / number`` with a Python divisor whose
                    reciprocal is inexact, by site (torch on the card
                    multiplies by the reciprocal: one ULP off a division)
  f64_bytes       : float64 bytes written, by site

A *site* is ``path:function:line`` of the innermost frame under
``src/repro_torch/`` outside ``analysis/``, the path relative to the
package (``core/prng.py:_words:66``); ops issued from elsewhere have the
site ``<outside>``.

While a kernel wrapper runs its plain version on CPU tensors
(``repro_torch.kernels.plain_version``), the census counts the launch the
card would make and records none of the plain version's ops: on the card
the kernel runs, not those ops.

The reference's ``donated_args`` and ``realized_aliases`` have no
counterpart (the port donates nothing, on purpose), nor does
``recompiles`` (no jit): ``repro_torch.analysis.audit`` asks instead that
a program's second call have the census of its first.
"""
from __future__ import annotations

import collections
import math
import sys
from contextlib import contextmanager
from pathlib import Path
from typing import Dict

import torch
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

PKG = Path(__file__).resolve().parent.parent
_ANALYSIS = Path(__file__).resolve().parent
OUTSIDE = "<outside>"

#: the reference's dtype tokens (``src/repro/analysis/hlo.py``)
DTYPE_TOKENS = {
    torch.bool: "pred", torch.int8: "s8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.uint8: "u8",
    torch.uint16: "u16", torch.uint32: "u32", torch.uint64: "u64",
    torch.float16: "f16", torch.bfloat16: "bf16", torch.float32: "f32",
    torch.float64: "f64", torch.complex64: "c64",  # repro-lint: disable=f64-literal — a dtype token, not a cast
    torch.complex128: "c128",
    torch.float8_e4m3fn: "f8e4m3fn", torch.float8_e5m2: "f8e5m2"}

#: the reference's collective kinds
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "all-to-all",
                    "collective-permute", "reduce-scatter")

#: c10d op -> collective kind; a ring exchange counts its sends (each pairs
#: with one receive), as the reference counts one collective-permute a
#: direction. Any other c10d op counts under its own name.
C10D_KINDS = {
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "send": "collective-permute", "recv_": None,
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather"}

#: the kernel wrappers' launch counters (PERF §6 rows 1-8)
LAUNCH_MODULES = ("repro_torch.kernels.fused_sim.kernel",
                  "repro_torch.kernels.scatter_add.kernel",
                  "repro_torch.kernels.hitfind.kernel",
                  "repro_torch.kernels.rasterize.kernel")

#: Tensor methods the function mode records as host reads
HOST_READS = ("tolist", "cpu", "numpy", "item", "__int__", "__float__",
              "__bool__", "__index__")
#: tensor factories that copy host data to the device they are given
_FACTORIES = ("tensor", "as_tensor")
#: ops whose output size depends on the data: the card waits for it
_DATA_SIZED = ("nonzero", "masked_select", "_unique", "_unique2",
               "unique_dim", "unique_consecutive")
_ACCUMULATING = ("index_add_", "index_add", "scatter_add_", "scatter_add",
                 "scatter_reduce_", "scatter_reduce")
_DIVISIONS = ("div", "div_", "__truediv__", "__itruediv__", "true_divide",
              "true_divide_")


def site(skip: tuple = ()) -> str:
    """``path:function:line`` of the innermost frame under the package
    outside ``analysis/`` and the files ``skip``, or ``<outside>``."""
    frame = sys._getframe(1)
    while frame is not None:
        path = Path(frame.f_code.co_filename)
        if path.is_relative_to(PKG) and not path.is_relative_to(_ANALYSIS) \
                and path not in skip:
            rel = path.relative_to(PKG).as_posix()
            return f"{rel}:{frame.f_code.co_name}:{frame.f_lineno}"
        frame = frame.f_back
    return OUTSIDE


#: c10d ops whose first argument is the operand (written in place); every
#: other op's operand is its second argument (the first is the output)
_OPERAND_FIRST = ("allreduce_", "allreduce_coalesced_", "send", "recv_",
                  "broadcast_")


def operand_bytes(name: str, args) -> int:
    """The bytes of a c10d op's operand tensors (the input of an
    all-gather, the full input of a reduce-scatter, the tensor of an
    all-reduce or a send), as the reference counts a collective."""
    operand = args[0 if name in _OPERAND_FIRST else 1]
    return sum(t.numel() * t.element_size() for t in tree_leaves(operand)
               if isinstance(t, torch.Tensor))


def inexact_divisor(value) -> bool:
    """True for a Python number whose reciprocal is not exact (anything
    but a power of two, zero or a non-finite value)."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return False
    if value == 0 or not math.isfinite(value):
        return False
    return math.frexp(abs(value))[0] != 0.5


def _masked_fill(args, kwargs, indices) -> bool:
    """Whether a masked write takes torch's ``masked_fill_`` path, which
    does not wait: one mask, no accumulation, one value on the host."""
    value = args[2] if len(args) > 2 else kwargs.get("values")
    accumulate = kwargs.get("accumulate") or (len(args) > 3 and args[3])
    return (len(indices) == 1 and not accumulate
            and isinstance(value, torch.Tensor) and value.numel() == 1
            and value.device.type == "cpu")


def _launches() -> Dict[str, int]:
    import importlib

    out: Dict[str, int] = {}
    for name in LAUNCH_MODULES:
        out.update(importlib.import_module(name).LAUNCHES)
    return out


class _Dispatch(TorchDispatchMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = self.census
        if not c._paused:
            c._record_op(func, args, kwargs, out)
        return out


class _Function(TorchFunctionMode):
    def __init__(self, census: "Census"):
        super().__init__()
        self.census = census

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        c = self.census
        name = getattr(func, "__name__", "")
        if c._paused:
            return func(*args, **kwargs)
        if name in HOST_READS and args and isinstance(args[0], torch.Tensor):
            c._host(name, args[0].device.type)
            c._in_read += 1
            try:
                return func(*args, **kwargs)
            finally:
                c._in_read -= 1
        if name in _DIVISIONS and len(args) > 1 \
                and isinstance(args[0], torch.Tensor) \
                and inexact_divisor(args[1]):
            c.float_divisions[site()] += 1
        elif name in _FACTORIES and getattr(func, "__module__", "") \
                == "torch":
            dev = kwargs.get("device")
            if dev is not None and torch.device(dev).type != "cpu":
                c._host("h2d", torch.device(dev).type)
        return func(*args, **kwargs)


class Census:
    """Record the op census of the calls inside ``with Census() as c:``
    (module docstring). ``contract()`` gives the fields as plain data;
    ``device_reads()`` the reads a site makes of card tensors."""

    def __init__(self):
        self.dtypes: collections.Counter = collections.Counter()
        self.scatter_dtypes: set = set()
        self.host_syncs: Dict[str, collections.Counter] = \
            collections.defaultdict(collections.Counter)
        self.collectives: collections.Counter = collections.Counter()
        self.collective_bytes: collections.Counter = collections.Counter()
        self.float_divisions: collections.Counter = collections.Counter()
        self.f64_bytes: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self._paused = 0
        self._in_read = 0
        self._modes = None
        self._before: Dict[str, int] = {}
        self._saved_watch = None

    # -- recording ---------------------------------------------------------

    def _host(self, op: str, device_type: str) -> None:
        self.host_syncs[site()][f"{op}@{device_type}"] += 1

    def _record_op(self, func, args, kwargs, out) -> None:
        name = func._overloadpacket.__name__
        if func.namespace == "c10d":
            kind = C10D_KINDS.get(name, f"c10d.{name}")
            if kind is not None:
                self.collectives[kind] += 1
                self.collective_bytes[kind] += operand_bytes(name, args)
            return
        for leaf in tree_leaves(out):
            if isinstance(leaf, torch.Tensor):
                token = DTYPE_TOKENS.get(leaf.dtype, str(leaf.dtype))
                self.dtypes[token] += 1
                if token == "f64":
                    self.f64_bytes[site()] += leaf.numel() * 8
        if name in _ACCUMULATING or (
                name in ("index_put_", "index_put", "_index_put_impl_")
                and (kwargs.get("accumulate")
                     or (len(args) > 3 and args[3] is True))):
            self.scatter_dtypes.add(DTYPE_TOKENS.get(args[0].dtype,
                                                     str(args[0].dtype)))
        if not self._in_read:
            op = self._wait_op(name, args, kwargs)
            if op is not None:
                self._host(*op)

    @staticmethod
    def _wait_op(name, args, kwargs):
        """(op, device type) when the op reads data sizes or values on the
        host, else None."""
        if name in _DATA_SIZED:
            return name, args[0].device.type
        if name == "_local_scalar_dense":
            return "item", args[0].device.type
        if name == "repeat_interleave" and isinstance(args[0], torch.Tensor) \
                and kwargs.get("output_size") is None \
                and (len(args) == 1 or isinstance(args[1], torch.Tensor)):
            return name, args[0].device.type
        if name in ("index", "index_put_", "index_put"):
            indices = [i for i in (args[1] if len(args) > 1
                                   else kwargs.get("indices", ()))
                       if i is not None]
            masks = [i for i in indices if isinstance(i, torch.Tensor)
                     and i.dtype in (torch.bool, torch.uint8)]
            if not masks or (name != "index" and _masked_fill(args, kwargs,
                                                              indices)):
                return None
            return name, args[0].device.type
        if name in ("_to_copy", "copy_"):
            if kwargs.get("non_blocking") or (name == "copy_"
                                              and len(args) > 2 and args[2]):
                return None
            src, dst_type = args[1 if name == "copy_" else 0], None
            if name == "copy_":
                dst_type = args[0].device.type
            elif kwargs.get("device") is not None:
                dst_type = torch.device(kwargs["device"]).type
            if dst_type is None or dst_type == src.device.type:
                return None
            if dst_type == "cpu":
                return "d2h", src.device.type
            return "h2d", dst_type
        return None

    @contextmanager
    def _plain(self, name: str):
        self.kernels[name] += 1
        self._paused += 1
        try:
            yield
        finally:
            self._paused -= 1

    # -- context -----------------------------------------------------------

    def __enter__(self) -> "Census":
        from repro_torch import kernels

        self._before = _launches()
        self._saved_watch = kernels.PLAIN_WATCH
        kernels.PLAIN_WATCH = self._plain
        self._modes = (_Function(self), _Dispatch(self))
        for mode in self._modes:
            mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        from repro_torch import kernels

        for mode in reversed(self._modes):
            mode.__exit__(*exc)
        kernels.PLAIN_WATCH = self._saved_watch
        for name, n in _launches().items():
            if n > self._before.get(name, 0):
                self.kernels[name] += n - self._before.get(name, 0)

    # -- results -----------------------------------------------------------

    def device_reads(self, device_type: str = "cuda") -> Dict[str, int]:
        """Reads and copies each site makes of ``device_type`` tensors."""
        out = {}
        for where, ops in self.host_syncs.items():
            n = sum(v for k, v in ops.items()
                    if k.rsplit("@", 1)[1] == device_type)
            if n:
                out[where] = n
        return out

    def contract(self) -> Dict:
        """The census as plain, JSON-ready data (sorted keys)."""

        def plain(counter) -> Dict:
            return {k: counter[k] for k in sorted(counter)}

        return {
            "collectives": plain(self.collectives),
            "dtypes": sorted(self.dtypes),
            "scatter_dtypes": sorted(self.scatter_dtypes),
            "host_syncs": {s: plain(ops)
                           for s, ops in sorted(self.host_syncs.items())},
            "kernels": plain(self.kernels),
            "float_divisions": plain(self.float_divisions),
            "f64_bytes": plain(self.f64_bytes),
        }
