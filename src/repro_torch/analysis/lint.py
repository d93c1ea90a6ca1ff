"""torch-lint: AST lint rules for the port's own torch hazards.

The counterpart of the reference's ``src/repro/analysis/lint.py``, for
torch code. Generic Python is ruff's; these rules encode the mistakes that
run fine on one device and quietly change bits, wait for the card or
break the calibration path on another:

  key-reuse        : a threefry key consumed by two sampler calls
                     (``prng.random_bits``/``uniform``/``normal``/
                     ``normal_bf16_wide``) without a ``split``/``fold_in``
                     between them: correlated noise
  mutable-default  : mutable default argument (state shared across calls)
  f64-literal      : ``torch.float64``/``torch.double``/``.double()``/
                     ``"float64"``: twice the bytes of every value it makes
  host-sync        : ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, or
                     ``float``/``int``/``bool`` of a tensor, inside a stage
                     function or a kernel wrapper: a wait for the card
  config-branch    : an ``if``, ``float()``, ``max`` or ``min`` on a field
                     of ``core/fit.py``'s ``FITTABLE_FIELDS``: the field
                     may be a 0-d tensor with autograd history
  tensor-fork      : ``isinstance(<config field>, torch.Tensor)`` outside
                     ``device.scalar``, the one place a config field forks
                     between a float and a tensor
  scalar-division  : ``tensor / number`` (a literal with an inexact
                     reciprocal, or a config field) in ``core/``,
                     ``kernels/``, ``models/``, ``serve/``, ``optim/``,
                     ``train/``, ``ckpt/``, ``data/`` and
                     ``launch/train.py``: torch on
                     the card multiplies by the
                     reciprocal, one ULP off the reference's division;
                     divide by ``device.scalar(value, like)``
  atomic-index-add : ``index_add_``: on the card it adds colliding indices
                     with atomics, so its bits differ run to run

The reference's ``traced-branch`` and ``config-replace-guard`` have no
counterpart: eager torch has no trace to concretise or retrace, and a
config field that holds a tensor is the calibration path's design (its
hazards are ``config-branch`` and ``tensor-fork``).

Run as ``python -m repro_torch.analysis.lint src/repro_torch`` (findings,
exit 1 when any) or with ``--json``. Suppress a deliberate exception on
its line with ``# torch-lint: disable=<rule>[,<rule>] — <reason>``, or
file-wide with ``# torch-lint: disable-file=<rule>``. The reference's
marker ``# repro-lint: disable=<rule>`` is honoured for the rule names the
two lints share (key-reuse, mutable-default, f64-literal, host-sync), so
one comment serves both (the reference's lint sweeps all of ``src/``).

Scope heuristics (deliberately simple, no cross-module analysis):

* a *stage function* is one passed to ``Stage(...)`` or as a keyword to
  ``<graph>.replace(...)``, or one with a parameter annotated ``SimState``
  (or a list of them) or returning ``SimState``; a *kernel wrapper* is any
  function of a module that defines a module-level ``LAUNCHES`` dict.
* In those scopes ``.item()``/``.tolist()``/``.cpu()``/``.numpy()`` always
  count; ``float``/``int``/``bool`` count when their argument reaches a
  likely tensor: a parameter (minus ``cfg``/``self``-like names and any
  annotated with a type that does not name ``Tensor``) or a local assigned
  from one, not through static metadata (``.shape``, ``.ndim``,
  ``.dtype``, ``.device``, ``.n_valid``, ``len()``).
* ``scalar-division``'s dividend counts as a tensor unless it is itself a
  Python number: a literal, a config field, an ALL_CAPS constant, a call
  of ``float``/``int``/``len``/``round``/``math.*``, or arithmetic of
  those. Powers of two divide exactly and never count.

Pure stdlib: the lint runs without torch.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import math
import os
import re
import sys
from functools import lru_cache
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

#: rule name -> one-line description (the docs/analysis_torch.md catalog)
RULES: Dict[str, str] = {
    "key-reuse": "threefry key consumed by more than one sampler call "
                 "without an intervening split/fold_in (correlated noise)",
    "mutable-default": "mutable default argument (state shared across "
                       "calls)",
    "f64-literal": "explicit float64 dtype (twice the bytes of every value)",
    "host-sync": ".item()/.tolist()/.cpu()/.numpy()/float()/int()/bool() "
                 "of a tensor inside a stage function or kernel wrapper "
                 "(a wait for the card)",
    "config-branch": "if/float()/max/min on a fittable config field (a 0-d "
                     "tensor with autograd history on the calibration path)",
    "tensor-fork": "isinstance(config field, torch.Tensor) outside "
                   "device.scalar",
    "scalar-division": "tensor / Python number in core/, kernels/, "
                       "models/, serve/, optim/, train/, ckpt/, data/ or "
                       "launch/train.py (the card multiplies by the "
                       "reciprocal: one ULP off)",
    "atomic-index-add": "index_add_ (atomic adds: run-to-run different "
                        "bits on the card)",
}

#: the rules the reference's lint has under the same names: its marker
#: ``# repro-lint: disable=`` suppresses them here too
SHARED_RULES = ("key-reuse", "mutable-default", "f64-literal", "host-sync")

_DISABLE_RE = re.compile(r"#\s*torch-lint:\s*disable=([\w\-,\s]+)")
_DISABLE_FILE_RE = re.compile(r"#\s*torch-lint:\s*disable-file=([\w\-,\s]+)")
_REF_DISABLE_RE = re.compile(r"#\s*repro-lint:\s*disable=([\w\-,\s]+)")
_REF_DISABLE_FILE_RE = re.compile(
    r"#\s*repro-lint:\s*disable-file=([\w\-,\s]+)")

#: the port's threefry samplers (``core/prng.py``) that CONSUME a key
SAMPLERS = {"random_bits", "uniform", "normal", "normal_bf16_wide"}

_PKG = Path(__file__).resolve().parent.parent
#: the file holding ``FITTABLE_FIELDS`` (read by AST: no torch import)
FIT_MODULE = _PKG / "core" / "fit.py"

#: params that are Python-static by the port's convention
_STATIC_PARAMS = {"cfg", "config", "self", "cls", "spec", "specs", "mesh",
                  "axes", "name", "names", "device", "dev"}
#: attribute reads that are static metadata, not tensor values
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "n_valid",
                 "name", "names", "stages", "stage_names", "type"}
_HOST_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
_HOST_SYNC_CALLS = {"float", "int", "bool"}
_SCALAR_CALLS = {"float", "int", "len", "round", "abs"}
#: scalar-division applies to files in (a package under) these folders,
#: and to these files
_DIVISION_DIRS = ("core", "kernels", "models", "serve", "optim", "train",
                  "ckpt", "data")
_DIVISION_FILES = (("launch", "train.py"),)


@dataclasses.dataclass(frozen=True)
class Finding:
    path: str
    line: int
    col: int
    rule: str
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: " \
               f"{self.message}"

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def _tail_name(func: ast.expr) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _dotted(node: ast.expr) -> str:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _functions(tree: ast.AST):
    return [n for n in ast.walk(tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]


def _own_nodes(fn: ast.AST):
    """The nodes of ``fn`` outside its nested function definitions."""
    nested = {id(sub) for n in ast.walk(fn)
              if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)) and n is not fn
              for sub in ast.walk(n)}
    return [n for n in ast.walk(fn) if id(n) not in nested]


@lru_cache(maxsize=None)
def fittable_fields(path: str = str(FIT_MODULE)) -> Tuple[str, ...]:
    """``FITTABLE_FIELDS`` of ``core/fit.py``, read from its source."""
    tree = ast.parse(Path(path).read_text(), filename=path)
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "FITTABLE_FIELDS"
               for t in targets):
            return tuple(ast.literal_eval(node.value))
    raise ValueError(f"no FITTABLE_FIELDS in {path}")


def _is_cfg_name(node: ast.expr) -> bool:
    return isinstance(node, ast.Name) and ("cfg" in node.id.lower()
                                           or "config" in node.id.lower())


def _fittable_attrs(node: ast.AST) -> List[ast.Attribute]:
    """Fittable-field reads in ``node`` that reach the value: not inside
    ``isinstance(...)`` (tensor-fork's business) or ``x is None``."""
    fields = set(fittable_fields())
    skip: Set[int] = set()
    for sub in ast.walk(node):
        if (isinstance(sub, ast.Call) and _tail_name(sub.func)
                == "isinstance") or (isinstance(sub, ast.Compare) and any(
                    isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops)):
            skip.update(id(inner) for inner in ast.walk(sub))
    return [n for n in ast.walk(node) if isinstance(n, ast.Attribute)
            and n.attr in fields and id(n) not in skip]


# ---------------------------------------------------------------------------
# Carried over from the reference: mutable-default, f64-literal, key-reuse
# ---------------------------------------------------------------------------


def _rule_mutable_default(tree: ast.Module, path: str) -> List[Finding]:
    out = []
    for fn in _functions(tree):
        for default in fn.args.defaults + [d for d in fn.args.kw_defaults
                                           if d is not None]:
            if isinstance(default, (ast.List, ast.Dict, ast.Set)) or (
                    isinstance(default, ast.Call)
                    and _tail_name(default.func) in ("list", "dict", "set",
                                                     "defaultdict")):
                out.append(Finding(
                    path, default.lineno, default.col_offset,
                    "mutable-default",
                    f"mutable default argument in {fn.name}() is shared "
                    "across calls; default to None and build inside"))
    return out


def _rule_f64_literal(tree: ast.Module, path: str) -> List[Finding]:
    """``torch``/``np`` ``float64``/``double`` attributes outside a
    comparison (``x.dtype in (f32, f64)`` checks a dtype, it makes none),
    ``.double()`` calls, and ``"float64"`` strings in dtype positions
    (``dtype=``, ``.to(...)``, ``.type(...)``, ``.astype(...)``)."""
    out = []
    compare_members: Set[int] = set()
    dtype_positions: List[ast.expr] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Compare):
            compare_members.update(id(sub) for sub in ast.walk(node))
        elif isinstance(node, ast.Call):
            dtype_positions += [kw.value for kw in node.keywords
                                if kw.arg == "dtype"]
            tail = _tail_name(node.func)
            if isinstance(node.func, ast.Attribute) \
                    and tail in ("to", "type", "astype"):
                dtype_positions += list(node.args)
            if isinstance(node.func, ast.Attribute) and tail == "double" \
                    and not node.args:
                out.append(Finding(path, node.lineno, node.col_offset,
                                   "f64-literal", ".double() makes float64"))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) \
                and node.attr in ("float64", "double") \
                and id(node) not in compare_members \
                and _dotted(node).split(".")[0] in ("torch", "np", "numpy"):
            out.append(Finding(
                path, node.lineno, node.col_offset, "f64-literal",
                f"explicit {_dotted(node)}: twice the bytes of every value "
                "it makes"))
    for pos in dtype_positions:
        for node in ast.walk(pos):
            if isinstance(node, ast.Constant) \
                    and node.value in ("float64", "f64", "double"):
                out.append(Finding(path, node.lineno, node.col_offset,
                                   "f64-literal",
                                   f"dtype literal {node.value!r}"))
    return out


def _assigned_names(target: ast.expr) -> Iterable[str]:
    for node in ast.walk(target):
        if isinstance(node, ast.Name):
            yield node.id


def _is_key_consumer(call: ast.Call) -> bool:
    """A call of one of the port's samplers, bare or through ``prng.``."""
    dotted = _dotted(call.func)
    parts = dotted.split(".")
    return parts[-1] in SAMPLERS and (len(parts) == 1
                                      or parts[-2] == "prng")


class _KeyReuseVisitor(ast.NodeVisitor):
    """Per-function key-consumption tracker (the reference's): two
    consumptions of one name conflict unless a reassignment sits between
    them or they live in exclusive branches."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.findings: List[Finding] = []
        self._uses: Dict[str, List[Tuple[Tuple, int, int]]] = {}
        self._branch: List[Tuple[int, str]] = []

    @staticmethod
    def _conflicts(a: Tuple, b: Tuple) -> bool:
        shorter, longer = sorted((a, b), key=len)
        return longer[:len(shorter)] == shorter

    def _consume(self, name: str, node: ast.AST) -> None:
        here = tuple(self._branch)
        for prev_path, line, _col in self._uses.get(name, []):
            if self._conflicts(prev_path, here):
                self.findings.append(Finding(
                    self.path, node.lineno, node.col_offset, "key-reuse",
                    f"key {name!r} already consumed at line {line}; "
                    "split/fold_in before sampling again"))
                break
        self._uses.setdefault(name, []).append(
            (here, node.lineno, node.col_offset))

    def visit_Call(self, node: ast.Call) -> None:
        if _is_key_consumer(node) and node.args \
                and isinstance(node.args[0], ast.Name):
            self._consume(node.args[0].id, node)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        self.generic_visit(node)
        for t in node.targets:
            for name in _assigned_names(t):
                self._uses.pop(name, None)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self.generic_visit(node)
        for name in _assigned_names(node.target):
            self._uses.pop(name, None)

    def visit_For(self, node: ast.For) -> None:
        for name in _assigned_names(node.target):
            self._uses.pop(name, None)
        self._branch.append((node.lineno, "for"))
        for stmt in node.body:
            self.visit(stmt)
        self._branch.pop()
        for stmt in node.orelse:
            self.visit(stmt)

    def _drop_prefix(self, prefix: Tuple) -> None:
        for name in list(self._uses):
            kept = [u for u in self._uses[name]
                    if u[0][:len(prefix)] != prefix]
            if kept:
                self._uses[name] = kept
            else:
                del self._uses[name]

    def visit_If(self, node: ast.If) -> None:
        self.visit(node.test)
        for arm, body in (("if", node.body), ("else", node.orelse)):
            self._branch.append((node.lineno, arm))
            prefix = tuple(self._branch)
            for stmt in body:
                self.visit(stmt)
            self._branch.pop()
            if body and isinstance(body[-1], (ast.Return, ast.Raise,
                                              ast.Continue, ast.Break)):
                self._drop_prefix(prefix)

    def _skip_nested(self, node) -> None:
        pass  # nested defs get their own pass

    visit_FunctionDef = _skip_nested
    visit_AsyncFunctionDef = _skip_nested
    visit_Lambda = _skip_nested


def _rule_key_reuse(tree: ast.Module, path: str) -> List[Finding]:
    out: List[Finding] = []
    for fn in _functions(tree):
        visitor = _KeyReuseVisitor(path)
        for stmt in fn.body:
            visitor.visit(stmt)
        out.extend(visitor.findings)
    return out


# ---------------------------------------------------------------------------
# Translated to torch: host-sync, config-branch, tensor-fork,
# scalar-division; new: atomic-index-add
# ---------------------------------------------------------------------------


def _annotation_text(node: Optional[ast.expr]) -> str:
    return ast.unparse(node) if node is not None else ""


def stage_function_names(tree: ast.Module) -> Set[str]:
    """Names of the module's stage functions (see the module docstring)."""
    names: Set[str] = set()

    def mark(node: ast.expr) -> None:
        if isinstance(node, ast.Name):
            names.add(node.id)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            tail = _tail_name(node.func)
            if tail == "Stage":
                for arg in node.args[1:]:
                    mark(arg)
                for kw in node.keywords:
                    mark(kw.value)
            elif tail == "replace" and isinstance(node.func, ast.Attribute) \
                    and "graph" in _dotted(node.func.value).lower():
                for kw in node.keywords:
                    mark(kw.value)
    for fn in _functions(tree):
        args = fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs
        if any("SimState" in _annotation_text(a.annotation) for a in args) \
                or "SimState" in _annotation_text(fn.returns):
            names.add(fn.name)
    return names


def _defines_launches(tree: ast.Module) -> bool:
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        if any(isinstance(t, ast.Name) and t.id == "LAUNCHES"
               for t in targets):
            return True
    return False


def tainted_names(fn: ast.AST) -> Set[str]:
    """Likely-tensor locals of ``fn``: its parameters (minus the static
    names and those annotated with a type that does not name ``Tensor``)
    and anything assigned from them, in one forward pass."""
    args = fn.args
    params = args.posonlyargs + args.args + args.kwonlyargs
    tainted = {a.arg for a in params
               if a.arg not in _STATIC_PARAMS and not a.arg.startswith("_")
               and (a.annotation is None
                    or "Tensor" in _annotation_text(a.annotation)
                    or "SimState" in _annotation_text(a.annotation))}
    for extra in (args.vararg, args.kwarg):
        if extra is not None:
            tainted.add(extra.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)) \
                and node.value is not None and _value_refs(node.value,
                                                           tainted):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                tainted.update(_assigned_names(t))
    return tainted


def _value_refs(node: ast.expr, tainted: Set[str]) -> List[ast.Name]:
    """Tainted names in ``node`` that reach a value, not static metadata
    (``x.shape``, ``len(x)``, ``isinstance(x, ...)``, ``x is None``)."""
    skip: Set[int] = set()
    for sub in ast.walk(node):
        if isinstance(sub, ast.Attribute) and sub.attr in _STATIC_ATTRS:
            skip.update(id(inner) for inner in ast.walk(sub.value))
        elif isinstance(sub, ast.Call) and _tail_name(sub.func) in (
                "len", "isinstance", "hasattr", "getattr", "type", "id",
                "repr"):
            for a in sub.args:
                skip.update(id(inner) for inner in ast.walk(a))
        elif isinstance(sub, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in sub.ops):
            skip.update(id(inner) for inner in ast.walk(sub))
    return [n for n in ast.walk(node)
            if isinstance(n, ast.Name) and n.id in tainted
            and id(n) not in skip]


def _rule_host_sync(tree: ast.Module, path: str) -> List[Finding]:
    stage_fns = stage_function_names(tree)
    wrapper_module = _defines_launches(tree)
    out = []
    for fn in _functions(tree):
        if fn.name not in stage_fns and not wrapper_module:
            continue
        scope = "stage function" if fn.name in stage_fns else \
            "kernel wrapper"
        tainted = tainted_names(fn)
        for node in _own_nodes(fn):
            if not isinstance(node, ast.Call):
                continue
            func = node.func
            hit = None
            if isinstance(func, ast.Attribute) \
                    and func.attr in _HOST_SYNC_METHODS and not node.args:
                hit = f".{func.attr}()"
            elif isinstance(func, ast.Name) and func.id in _HOST_SYNC_CALLS \
                    and node.args and _value_refs(node.args[0], tainted):
                hit = f"{func.id}()"
            if hit:
                out.append(Finding(
                    path, node.lineno, node.col_offset, "host-sync",
                    f"{hit} inside {scope} {fn.name}() reads the host: a "
                    "wait for the card on a card tensor"))
    return out


def _rule_config_branch(tree: ast.Module, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        tests = []
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            tests, what = [node.test], "a branch"
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id in ("float", "max", "min"):
            tests, what = list(node.args), f"{node.func.id}()"
        for test in tests:
            attrs = _fittable_attrs(test)
            if attrs:
                out.append(Finding(
                    path, node.lineno, node.col_offset, "config-branch",
                    f"{what} on fittable field {attrs[0].attr!r}: on the "
                    "calibration path it is a 0-d tensor; take it through "
                    "device.scalar"))
                break
    return out


def _rule_tensor_fork(tree: ast.Module, path: str) -> List[Finding]:
    fields = set(fittable_fields())
    allowed: Set[int] = set()
    if Path(path).name == "device.py":
        for fn in _functions(tree):
            if fn.name == "scalar":
                allowed.update(id(n) for n in ast.walk(fn))
    out = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and _tail_name(node.func)
                == "isinstance" and len(node.args) == 2) \
                or id(node) in allowed:
            continue
        obj, kind = node.args
        if not any(_dotted(k).endswith("Tensor") for k in ast.walk(kind)
                   if isinstance(k, (ast.Attribute, ast.Name))):
            continue
        if isinstance(obj, ast.Attribute) and (obj.attr in fields
                                               or _is_cfg_name(obj.value)):
            out.append(Finding(
                path, node.lineno, node.col_offset, "tensor-fork",
                f"isinstance({_dotted(obj) or obj.attr}, Tensor) forks a "
                "config field; device.scalar is the one fork"))
    return out


def _inexact_number(node: ast.expr) -> bool:
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.USub,
                                                              ast.UAdd)):
        node = node.operand
    if not (isinstance(node, ast.Constant)
            and isinstance(node.value, (int, float))
            and not isinstance(node.value, bool)):
        return False
    v = node.value
    return v != 0 and math.isfinite(v) and math.frexp(abs(v))[0] != 0.5


def _python_number(node: ast.expr, numbers: Set[str]) -> bool:
    """Whether ``node`` is, by the heuristic, a Python number; ``numbers``
    are the local names assigned one."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (int, float))
    if isinstance(node, ast.Attribute):
        return _is_cfg_name(node.value)
    if isinstance(node, ast.Name):
        return node.id.isupper() or node.id in numbers
    if isinstance(node, ast.Call):
        dotted = _dotted(node.func)
        return dotted in _SCALAR_CALLS or dotted.startswith("math.")
    if isinstance(node, ast.UnaryOp):
        return _python_number(node.operand, numbers)
    if isinstance(node, ast.BinOp):
        return _python_number(node.left, numbers) \
            and _python_number(node.right, numbers)
    return False


def _number_names(nodes) -> Set[str]:
    """Names ``nodes`` assign only Python numbers (``rw, rt = cfg.a,
    cfg.b``)."""
    numbers: Set[str] = set()
    others: Set[str] = set()
    for node in nodes:
        if not isinstance(node, ast.Assign):
            continue
        for target in node.targets:
            pairs = ([(target, node.value)] if isinstance(target, ast.Name)
                     else list(zip(target.elts, node.value.elts))
                     if isinstance(target, ast.Tuple)
                     and isinstance(node.value, ast.Tuple)
                     and len(target.elts) == len(node.value.elts)
                     else [(n, None) for n in getattr(target, "elts", ())])
            for name, value in pairs:
                if not isinstance(name, ast.Name):
                    continue
                if value is not None and _python_number(value, numbers):
                    numbers.add(name.id)
                else:
                    others.add(name.id)
    return numbers - others


def _rule_scalar_division(tree: ast.Module, path: str) -> List[Finding]:
    parts = Path(path).parts
    if not (any(part in _DIVISION_DIRS for part in parts[-3:-1])
            or parts[-2:] in _DIVISION_FILES):
        return []
    out = []
    for scope in [tree] + _functions(tree):
        nodes = _own_nodes(scope)
        numbers = _number_names(nodes)
        for node in nodes:
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                left, right = node.left, node.right
            elif isinstance(node, ast.AugAssign) \
                    and isinstance(node.op, ast.Div):
                left, right = node.target, node.value
            else:
                continue
            divisor = (_inexact_number(right)
                       or (isinstance(right, ast.Attribute)
                           and _is_cfg_name(right.value)))
            if divisor and not _python_number(left, numbers):
                out.append(Finding(
                    path, node.lineno, node.col_offset, "scalar-division",
                    f"division by the Python number {ast.unparse(right)}: "
                    "on the card torch multiplies by its reciprocal; "
                    "divide by device.scalar(value, like)"))
    return out


def _rule_atomic_index_add(tree: ast.Module, path: str) -> List[Finding]:
    return [Finding(path, node.lineno, node.col_offset, "atomic-index-add",
                    f"{_dotted(node.func) or node.func.attr}: atomic adds "
                    "on the card, run-to-run different bits; use "
                    "index_put_(accumulate=True), which sorts")
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and _tail_name(node.func) in ("index_add_", "index_add")]


# ---------------------------------------------------------------------------
# Driver
# ---------------------------------------------------------------------------

_RULE_FNS = (_rule_mutable_default, _rule_f64_literal, _rule_key_reuse,
             _rule_host_sync, _rule_config_branch, _rule_tensor_fork,
             _rule_scalar_division, _rule_atomic_index_add)


def lint_source(src: str, path: str) -> List[Finding]:
    """All findings for one file's source text (suppressions applied)."""
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as exc:
        return [Finding(path, exc.lineno or 0, exc.offset or 0,
                        "parse-error", str(exc))]
    findings: List[Finding] = []
    for rule in _RULE_FNS:
        findings += rule(tree, path)
    return _apply_suppressions(src, findings)


def _rules_of(match) -> Set[str]:
    return {r.strip() for r in match.group(1).split(",")}


def _apply_suppressions(src: str, findings: List[Finding]) -> List[Finding]:
    file_disabled: Set[str] = set()
    line_disabled: Dict[int, Set[str]] = {}
    for i, line in enumerate(src.splitlines(), start=1):
        rules: Set[str] = set()
        for regex, shared_only, target in (
                (_DISABLE_FILE_RE, False, file_disabled),
                (_REF_DISABLE_FILE_RE, True, file_disabled),
                (_DISABLE_RE, False, rules),
                (_REF_DISABLE_RE, True, rules)):
            m = regex.search(line)
            if m:
                found = _rules_of(m)
                target.update(found & set(SHARED_RULES) if shared_only
                              else found)
        if rules:
            line_disabled[i] = rules
    out = [f for f in findings
           if not ({f.rule, "all"} & file_disabled)
           and not ({f.rule, "all"} & line_disabled.get(f.line, set()))]
    return sorted(out, key=lambda f: (f.path, f.line, f.col, f.rule))


def lint_paths(paths: Sequence[str]) -> List[Finding]:
    findings: List[Finding] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = sorted(os.path.join(dirpath, name)
                           for dirpath, _dirs, names in os.walk(root)
                           for name in names if name.endswith(".py"))
        for fp in files:
            with open(fp, encoding="utf-8") as fh:
                findings.extend(lint_source(fh.read(), fp))
    return sorted(findings, key=lambda f: (f.path, f.line, f.col, f.rule))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.lint",
        description="the port's torch lint rules (docs/analysis_torch.md)")
    ap.add_argument("paths", nargs="*", help="files or directories to lint")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable findings on stdout")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)
    if args.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}: {RULES[rule]}")
        return 0
    if not args.paths:
        ap.error("give the files or directories to lint")
    findings = lint_paths(args.paths)
    if args.json:
        print(json.dumps([f.as_dict() for f in findings], indent=2))
    else:
        for f in findings:
            print(f.format())
        print(f"{len(findings)} finding(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
