"""Program contract auditor of the port: the counterpart of the reference's
``src/repro/analysis/audit.py``.

Every production entry point of the port is run twice on fresh inputs at
the audit config, each call under a ``repro_torch.analysis.census.Census``;
the first call's census is the program's *contract*, and it is diffed
against the committed ``AUDIT_torch_contracts.json``. Per-program fields:

  collectives     : c10d ops per kind, in the reference's vocabulary
  dtypes          : every dtype an op wrote (``f64`` only at ALLOWED_F64)
  scatter_dtypes  : dtypes of the accumulating writes (bf16/f16 = fail)
  host_syncs      : host reads and copies by site, ``{site: {"op@dev": n}}``
  kernels         : launches of the kernel wrappers (PERF §6 rows 1-9)
  float_divisions : ``tensor / number`` with an inexact reciprocal, by site
  f64_bytes       : float64 bytes written, by site
  repeat_drift    : the fields whose second-call census differs from the
                    first (the counterpart of the reference's
                    ``recompiles``: a per-call tuning lookup, a host cache
                    that misses); must be empty

Hard policy (baseline-independent): float64 only at ALLOWED_F64's sites,
no bf16/f16 scatter accumulation, host reads only at KNOWN_HOST_SYNCS's
sites (a new site fails even when the counts match), no float division
outside ALLOWED_FLOAT_DIVISIONS, collective kinds only from the declared
set (``repro_torch.tune.registry.declared_collectives()`` for local
programs, ``SCATTER_REDUCTION_COLLECTIVES`` for the distributed ones), and
an empty ``repeat_drift``. Anything else (a count drifting, a kernel no
longer launched, a new dtype) fails only against the baseline, and
``--update`` refreshes it when the change is intended.

The contracts are CPU censuses: the wrappers run their plain versions,
counted as the launches the card would make, and every tensor lives on
the host, so a read's device is ``cpu`` throughout; which reads wait for
the card shows on the card only (``chip_smoke.py``'s "audit" phase).

Usage:

    PYTHONPATH=src python -m repro_torch.analysis.audit --check     # gate
    PYTHONPATH=src python -m repro_torch.analysis.audit --update    # re-pin
    PYTHONPATH=src python -m repro_torch.analysis.audit --check --json out.json

``--inject`` seeds a deliberate regression so the gate's failure mode is
itself testable. The distributed programs run on ``--devices`` gloo ranks
(``repro_torch.testing.ranks``), all of them in one spawn; the contract is
rank 0's, and the audit fails if the ranks' contracts differ.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import fnmatch
import json
import os
import sys
import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.analysis.census import Census

#: default committed baseline, at the repository root
DEFAULT_BASELINE = "AUDIT_torch_contracts.json"
SCHEMA_VERSION = 1

#: seeded-regression modes (``--inject``): each perturbs the property the
#: auditor pins, so the tests can show that the gate trips
INJECT_MODES = ("f64_noise", "host_sync", "float_division",
                "extra_collective")

#: collective kinds each distributed scatter reduction may issue (the
#: reference's table): ``psum_scatter`` reduce-scatters the partial grids,
#: ``halo`` all-reduces the strips and ring-exchanges the margins; the
#: pencil FFT's all-to-all chains ride along in both
SCATTER_REDUCTION_COLLECTIVES = {
    "psum_scatter": ("reduce-scatter", "all-to-all", "all-reduce"),
    "halo": ("all-reduce", "collective-permute", "all-to-all"),
}

#: the sites allowed to write float64, each with its reason; each line
#: carries the lint suppression ``f64-literal``
ALLOWED_F64 = {
    "core/prng.py:uniform:150": (
        "float32 uniforms: the FMA of the reference's XLA emulated exactly "
        "in float64, rounded once to float32 on the next line"),
}

#: the sites allowed to read the host or wait for the card, each with its
#: reason (what the read is, and whether it waits on the card)
KNOWN_HOST_SYNCS = {
    "core/prng.py:_words:66": (
        "the two threefry key words of a host key, as Python ints"),
    "kernels/fused_sim/ops.py:_seeds:37": (
        "the fused kernels' seed words, read from host keys"),
    "kernels/scatter_add/ops.py:bin_depos_to_tiles:124": (
        "the dense tile binning's masked write: two boolean-mask reads"),
    "kernels/scatter_add/ops.py:bin_depos_to_tiles_compact:142": (
        "the compact tile binning's masked list write: two mask reads"),
    "kernels/scatter_add/ops.py:bin_depos_to_tiles_compact:146": (
        "the compact tile binning's masked slot write: two mask reads"),
    "kernels/scatter_add/ops.py:compact_n_cap:179": (
        "the compact layout's occupancy, one read for all rows"),
    "core/batch.py:simulate_events:256": (
        "the valid depo counts of a batch, a host tensor"),
}

#: the sites allowed to divide a tensor by a Python number whose
#: reciprocal is inexact, each with its reason (none: ``device.scalar``)
ALLOWED_FLOAT_DIVISIONS: Dict[str, str] = {}


@dataclasses.dataclass(frozen=True)
class AuditContext:
    """Everything a program's build function needs."""

    cfg: object               # the pinned audit LArTPCConfig
    planes: int
    inject: Optional[str] = None
    device: str = "cpu"
    mesh: object = None       # the DeviceMesh of a distributed program


@dataclasses.dataclass(frozen=True)
class AuditProgram:
    """One production entry point the auditor runs.

    build   : ``ctx -> (fn, make_args)``; ``make_args(i)`` builds FRESH
              inputs for call ``i``, outside the census.
    planes  : plane counts this program is audited at.
    overrides : config fields set for this program (on top of the audit
              config), per plane count.
    collective_source : the scatter reduction of a distributed program,
              which bounds its collective kinds and picks its mesh
              (``psum_scatter``: (n // 2, 2), the reference's convention;
              ``halo``: (n, 1), every rank on the halo axis); "none" for a
              local program (the collective-free policy).
    """

    name: str
    build: Callable[[AuditContext], Tuple[Callable, Callable[[int], tuple]]]
    planes: Tuple[int, ...] = (1, 3)
    overrides: Dict[int, Dict] = dataclasses.field(default_factory=dict)
    collective_source: str = "none"


def audit_config(planes: int = 1, smoke: bool = True, **overrides):
    """The pinned audit workload: the smoke config with ``hitfind_strategy
    = "scan"`` (every other field its default, none ``"auto"`` but
    ``plane_batching``, which the plane count decides), so contracts
    cannot drift with a tuning cache; ``smoke=False`` gives the same at
    full width (the card's audit phase)."""
    from repro_torch.config import get_config

    cfg = get_config("lartpc-uboone", smoke=smoke)
    repl = {"hitfind_strategy": "scan", **overrides}
    if planes > 1:
        repl["num_planes"] = planes
    return dataclasses.replace(cfg, **repl)


# ---------------------------------------------------------------------------
# The programs
# ---------------------------------------------------------------------------


def _fold_key(i: int) -> torch.Tensor:
    from repro_torch.core import prng

    return prng.fold_in(prng.key(0), i)


def _injected_noise(orig: Callable, inject: Optional[str]) -> Callable:
    """The noise stage with the seeded regression ``inject`` spliced in
    after it (each exists to show that the auditor catches it)."""

    def noise(state):
        state = orig(state)
        sig = state.signal
        if inject == "f64_noise":
            sig = (sig.to(torch.float64) * (1.0 + 1e-12)).to(torch.float32)  # repro-lint: disable=f64-literal — the injected float64 step
        elif inject == "host_sync":
            sig = sig + 0.0 * sig.sum().item()  # repro-lint: disable=host-sync — the injected host read
        elif inject == "float_division":
            sig = sig * 1.5 / 1.5  # torch-lint: disable=scalar-division — the injected division
        return state._replace(signal=sig)

    return noise


def _single_graph(ctx: AuditContext, recon: bool = False):
    from repro_torch.core.pipeline import make_sim_fn

    graph = make_sim_fn(ctx.cfg, device=ctx.device, recon=recon)
    if ctx.inject in ("f64_noise", "host_sync", "float_division") \
            and not recon:
        graph = graph.replace(noise=_injected_noise(
            graph.stages[graph.stage_names.index("noise")].fn, ctx.inject))
    return graph


def _single_args(ctx: AuditContext):
    from repro_torch.core.depo import generate_physical_depos

    def make_args(i):
        key = _fold_key(i)
        return key, generate_physical_depos(key, ctx.cfg, device=ctx.device)

    return make_args


def _build_single(ctx: AuditContext):
    return _single_graph(ctx).run, _single_args(ctx)


def _build_recon(ctx: AuditContext):
    return _single_graph(ctx, recon=True).run, _single_args(ctx)


def _batch_args(ctx: AuditContext, events: int = 2):
    from repro_torch.core.batch import event_keys, pack_events
    from repro_torch.core.depo import generate_depos, generate_plane_depos
    from repro_torch.core import prng

    gen = generate_plane_depos if ctx.planes > 1 else generate_depos

    def make_args(i):
        key = _fold_key(i)
        evs = [gen(prng.fold_in(key, e), ctx.cfg, device=ctx.device)
               for e in range(events)]
        return event_keys(key, range(events)), pack_events(evs)

    return make_args


def _build_batched(ctx: AuditContext):
    from repro_torch.core.batch import make_batched_sim_fn

    return (make_batched_sim_fn(ctx.cfg, device=ctx.device),
            _batch_args(ctx))


def _build_streaming(ctx: AuditContext):
    """The device program ``stream_simulate`` drives."""
    from repro_torch.launch.sim import make_streaming_sim_fn

    return (make_streaming_sim_fn(ctx.cfg, device=ctx.device),
            _batch_args(ctx))


def _dist_response(ctx: AuditContext, w_pad: int):
    from repro_torch.core.response import (make_distributed_plane_responses,
                                           make_distributed_response)

    if ctx.planes > 1:
        return make_distributed_plane_responses(ctx.cfg, w_pad,
                                                device=ctx.device)
    return make_distributed_response(ctx.cfg, w_pad, device=ctx.device)


def _build_distributed_psum(ctx: AuditContext):
    from repro_torch.core.depo import generate_depos, generate_physical_depos
    from repro_torch.core.distributed import (make_distributed_sim,
                                              num_shards, padded_grid_shape,
                                              shard_depos)

    cfg = ctx.cfg
    if ctx.inject == "extra_collective" and ctx.planes > 1:
        # the reference's regression: one collective chain a plane
        cfg = dataclasses.replace(cfg, plane_batching="loop")
    w_pad = padded_grid_shape(cfg, num_shards(ctx.mesh))[0]
    fn = make_distributed_sim(ctx.mesh, cfg, _dist_response(ctx, w_pad))
    gen = generate_physical_depos if ctx.planes > 1 else generate_depos

    def make_args(i):
        key = _fold_key(i)
        return key, shard_depos(gen(key, cfg, device=ctx.device), ctx.mesh)

    return fn, make_args


def _build_distributed_halo(ctx: AuditContext):
    from repro_torch.core.depo import generate_depos
    from repro_torch.core.distributed import (AXES, bin_depos_by_wire,
                                              make_distributed_sim,
                                              num_shards, padded_grid_shape,
                                              shard_depos)

    mesh = ctx.mesh
    n_strips = mesh.size(mesh.mesh_dim_names.index(AXES[0]))
    w_pad = padded_grid_shape(ctx.cfg, max(num_shards(mesh), n_strips))[0]
    fn = make_distributed_sim(mesh, ctx.cfg, _dist_response(ctx, w_pad),
                              scatter_reduction="halo")
    # one fixed event, as the reference's program: the strips' bucket size
    # depends on the event
    binned = bin_depos_by_wire(
        generate_depos(_fold_key(0), ctx.cfg, device=ctx.device),
        n_strips=n_strips, w_pad=w_pad)

    def make_args(i):
        return _fold_key(i), shard_depos(binned, mesh)

    return fn, make_args


def _fit_pieces(ctx: AuditContext):
    from repro_torch.core import prng
    from repro_torch.core.fit import (make_fit_loss, make_fit_targets,
                                      spec_from_names)

    spec = spec_from_names(("electron_lifetime_us", "recombination"),
                           ctx.cfg)
    targets = make_fit_targets(ctx.cfg, prng.key(7), num_events=2,
                               device=ctx.device)
    loss = make_fit_loss(ctx.cfg, spec, targets, device=ctx.device)
    theta0 = spec.init_theta(ctx.cfg, device=ctx.device)
    return loss, lambda i: (theta0.clone(),)


def _build_fit_loss(ctx: AuditContext):
    return _fit_pieces(ctx)


def _build_fit_grad(ctx: AuditContext):
    from repro_torch.core.fit import value_and_grad

    loss, make_args = _fit_pieces(ctx)
    return (lambda theta: value_and_grad(loss, theta)), make_args


#: the audited surface: the reference's programs under its names (the four
#: executors, recon, the distributed executor's two reductions, the fit),
#: then the port's programs on its kernel strategies
PROGRAMS: Tuple[AuditProgram, ...] = (
    AuditProgram("single", _build_single),
    AuditProgram("batched", _build_batched),
    AuditProgram("streaming", _build_streaming),
    AuditProgram("recon", _build_recon),
    AuditProgram("distributed_psum", _build_distributed_psum,
                 collective_source="psum_scatter"),
    AuditProgram("distributed_halo", _build_distributed_halo, planes=(1,),
                 collective_source="halo"),
    AuditProgram("fit_loss", _build_fit_loss, planes=(1,)),
    AuditProgram("fit_grad", _build_fit_grad, planes=(1,)),
    AuditProgram("single_fused", _build_single, overrides={
        1: {"charge_grid_strategy": "fused_pallas"},
        3: {"charge_grid_strategy": "fused_pallas_multiplane"}}),
    AuditProgram("unfused_pallas_compact", _build_single, planes=(1,),
                 overrides={1: {"scatter_strategy": "pallas_compact"}}),
    AuditProgram("recon_kernels", _build_recon, planes=(3,), overrides={
        3: {"charge_grid_strategy": "fused_pallas_multiplane",
            "hitfind_strategy": "pallas"}}),
)

def program_names(planes: Tuple[int, ...] = (1, 3),
                  programs: Tuple[AuditProgram, ...] = PROGRAMS) -> List[str]:
    """Every contract name ``collect_contracts`` emits for ``planes``."""
    return [f"p{p}/{prog.name}" for p in planes for prog in programs
            if p in prog.planes]


def program_named(name: str) -> Optional[AuditProgram]:
    base = name.split("/", 1)[-1]
    return next((p for p in PROGRAMS if p.name == base), None)


def context_for(prog: AuditProgram, planes: int,
                inject: Optional[str] = None, device: str = "cpu",
                mesh=None, smoke: bool = True) -> AuditContext:
    """The context program ``prog`` runs in at ``planes`` planes: the audit
    config (``smoke=False``: at full width) with the program's
    overrides."""
    cfg = audit_config(planes, smoke, **prog.overrides.get(planes, {}))
    return AuditContext(cfg=cfg, planes=planes, inject=inject,
                        device=device, mesh=mesh)


# ---------------------------------------------------------------------------
# Contract extraction
# ---------------------------------------------------------------------------


def extract_contract(fn: Callable, make_args: Callable[[int], tuple],
                     calls: int = 2) -> Dict:
    """Run ``fn`` on ``make_args(i)`` for ``i < calls``, each call under a
    census (inputs built outside it); the first census is the contract,
    and ``repeat_drift`` lists the fields a later call changed."""
    contracts = []
    for i in range(calls):
        args = make_args(i)
        with Census() as census:
            fn(*args)
        contracts.append(census.contract())
    first = contracts[0]
    drift = sorted({f for later in contracts[1:] for f in first
                    if later[f] != first[f]})
    return {**first, "repeat_drift": drift}


@contextlib.contextmanager
def hermetic_tune_cache():
    """Point the port's tuning cache at an empty file of the audit's own
    for the duration (every strategy is explicit; this makes sure)."""
    from repro_torch.tune.autotune import CACHE_ENV

    saved = os.environ.get(CACHE_ENV)
    with tempfile.TemporaryDirectory(prefix="audit_tune_") as tmp:
        os.environ[CACHE_ENV] = os.path.join(tmp, "tune_cache.json")
        try:
            yield
        finally:
            if saved is None:
                os.environ.pop(CACHE_ENV, None)
            else:
                os.environ[CACHE_ENV] = saved


def _selected(planes, patterns, want_distributed: bool):
    for p in planes:
        for prog in PROGRAMS:
            if p not in prog.planes or (prog.collective_source != "none") \
                    != want_distributed:
                continue
            name = f"p{p}/{prog.name}"
            if patterns and not any(fnmatch.fnmatch(name, pat)
                                    for pat in patterns):
                continue
            yield name, prog, p


def _rank_contracts(mesh, planes, patterns, inject) -> Dict:
    """The distributed programs on this rank (``testing.ranks`` calls it in
    every rank): ``{name: contract as a JSON string array}``."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import AXES

    meshes = {"psum_scatter": mesh,
              "halo": DeviceMesh(mesh.device_type,
                                 torch.arange(mesh.size()).reshape(-1, 1),
                                 mesh_dim_names=AXES)}
    out = {}
    for name, prog, p in _selected(planes, patterns, True):
        ctx = context_for(prog, p, inject,
                          mesh=meshes[prog.collective_source])
        out[name] = np.array(json.dumps(extract_contract(*prog.build(ctx))))
    return out


def collect_contracts(planes: Tuple[int, ...] = (1, 3), devices: int = 2,
                      patterns: Optional[List[str]] = None,
                      inject: Optional[str] = None,
                      log: Callable[[str], None] = lambda s: None) -> Dict:
    """Run every (selected) program and extract its contract.

    Returns ``{name: contract}`` with names ``p<planes>/<program>``; the
    distributed programs run on ``devices`` gloo ranks in one spawn and
    raise if the ranks' contracts differ. ``inject`` seeds a deliberate
    regression (``INJECT_MODES``)."""
    from repro_torch.testing.ranks import run_ranks

    if inject is not None and inject not in INJECT_MODES:
        raise ValueError(f"unknown inject mode {inject!r}; known: "
                         f"{INJECT_MODES}")
    out: Dict[str, Dict] = {}
    with hermetic_tune_cache():
        for name, prog, p in _selected(planes, patterns, False):
            log(f"run {name} ...")
            ctx = context_for(prog, p, inject)
            out[name] = extract_contract(*prog.build(ctx))
        dist_names = [n for n, _, _ in _selected(planes, patterns, True)]
        if dist_names and devices < 2:
            log(f"skip {dist_names}: need >= 2 ranks (have {devices})")
        elif dist_names:
            log(f"run {dist_names} on {devices} gloo ranks ...")
            # the reference's psum mesh: (n // 2, 2), or (n, 1) for odd n
            shape = (devices // 2, 2) if devices % 2 == 0 else (devices, 1)
            with tempfile.TemporaryDirectory(prefix="audit_ranks_") as tmp:
                ranks = run_ranks(_rank_contracts, devices, shape, "gloo",
                                  tmp, tuple(planes), patterns, inject)
            for name in dist_names:
                per_rank = [json.loads(str(r[name])) for r in ranks]
                differ = [i for i, c in enumerate(per_rank)
                          if c != per_rank[0]]
                if differ:
                    raise RuntimeError(
                        f"{name}: ranks {differ} have another contract "
                        f"than rank 0: {per_rank[differ[0]]} vs "
                        f"{per_rank[0]}")
                out[name] = per_rank[0]
    return {k: out[k] for k in sorted(out)}


# ---------------------------------------------------------------------------
# Policy (baseline-independent invariants)
# ---------------------------------------------------------------------------


def _declared_local_collectives() -> set:
    from repro_torch.tune import registry

    return set(registry.declared_collectives())


def policy_violations(name: str, contract: Dict) -> List[str]:
    """Hard invariants a contract must satisfy whatever the baseline."""
    v = []
    bad_f64 = sorted(set(contract["f64_bytes"]) - set(ALLOWED_F64))
    if bad_f64 or ("f64" in contract["dtypes"]
                   and not contract["f64_bytes"]):
        v.append(f"f64 written at {bad_f64 or 'an unknown site'}, outside "
                 "ALLOWED_F64 (every float64 value doubles the bytes it "
                 "moves)")
    bad_acc = set(contract["scatter_dtypes"]) & {"bf16", "f16"}
    if bad_acc:
        v.append(f"scatter accumulates in {sorted(bad_acc)}: bf16 paths "
                 "must accumulate in f32")
    new_syncs = sorted(set(contract["host_syncs"]) - set(KNOWN_HOST_SYNCS))
    if new_syncs:
        v.append(f"host_syncs at {new_syncs}, outside KNOWN_HOST_SYNCS (a "
                 "host read waits for the card)")
    bad_div = sorted(set(contract["float_divisions"])
                     - set(ALLOWED_FLOAT_DIVISIONS))
    if bad_div:
        v.append(f"float_divisions at {bad_div}: torch on the card "
                 "multiplies by the reciprocal; divide by device.scalar")
    if contract["repeat_drift"]:
        v.append(f"repeat_drift: the second call changed "
                 f"{contract['repeat_drift']}")
    prog = program_named(name)
    if prog is None or prog.collective_source == "none":
        allowed = _declared_local_collectives()
    else:
        allowed = set(SCATTER_REDUCTION_COLLECTIVES[prog.collective_source])
    extra = set(contract["collectives"]) - allowed
    if extra:
        v.append(f"collectives {sorted(extra)} outside the declared set "
                 f"{sorted(allowed)} for this program's data movement")
    return v


# ---------------------------------------------------------------------------
# Baseline diff (the reference's glob-gating rules)
# ---------------------------------------------------------------------------


def expand_contract_names(patterns: List[str], baseline: Dict,
                          fresh: Dict) -> List[str]:
    """Expand ``--programs`` globs against baseline + fresh names: a glob
    matching no *baseline* contract gates nothing and returns [] (the
    caller fails); plain names pass through, so a missing contract still
    reports as MISSING."""
    known = sorted(set(baseline) | set(fresh))
    names: List[str] = []
    for pat in patterns:
        if any(c in pat for c in "*?["):
            hits = [n for n in known if fnmatch.fnmatch(n, pat)]
            if not hits:
                print(f"error: --programs pattern {pat!r} matched no "
                      "contracts", file=sys.stderr)
                return []
            if not any(h in baseline for h in hits):
                print(f"error: --programs pattern {pat!r} matched no "
                      "BASELINE contracts; commit the baseline (--update) "
                      "or fix the pattern", file=sys.stderr)
                return []
            names.extend(h for h in hits if h not in names)
        elif pat not in names:
            names.append(pat)
    return names


def diff_contracts(baseline: Dict, fresh: Dict,
                   patterns: Optional[List[str]] = None) -> int:
    """Print a per-contract diff; 1 on drift or a policy violation, 0
    when every gated contract matches."""
    patterns = patterns or sorted({n.split("/", 1)[0] + "/*" for n in fresh})
    names = expand_contract_names(patterns, baseline, fresh)
    if not names:
        return 1
    failed = False
    for name in names:
        b, f = baseline.get(name), fresh.get(name)
        if f is None:
            print(f"{name}: MISSING from the fresh run (program vanished or "
                  "was skipped)  FAIL")
            failed = True
            continue
        problems = []
        if b is None:
            print(f"{name}: (new, not in the baseline; --update to pin)")
        else:
            problems += [f"  {field}: {b.get(field)!r} -> {f.get(field)!r}"
                         for field in sorted(set(b) | set(f))
                         if b.get(field) != f.get(field)]
        problems += [f"  policy: {v}" for v in policy_violations(name, f)]
        if problems:
            print(f"{name}: FAIL")
            print("\n".join(problems))
            failed = True
        elif b is not None:
            print(f"{name}: ok")
    print(f"gated {len(names)} contract(s)")
    if failed:
        print("\ncontract drift: a program contract changed; if intended, "
              "refresh with `python -m repro_torch.analysis.audit --update` "
              "(docs/analysis_torch.md)", file=sys.stderr)
    return 1 if failed else 0


def load_baseline(path: str) -> Dict:
    with open(path) as fh:
        data = json.load(fh)
    if data.get("schema") != SCHEMA_VERSION:
        raise ValueError(f"baseline {path!r} has schema "
                         f"{data.get('schema')!r}, expected {SCHEMA_VERSION}")
    return data["contracts"]


def write_baseline(path: str, contracts: Dict, devices: int,
                   merge_into: Optional[str] = None) -> None:
    merged: Dict[str, Dict] = {}
    if merge_into and os.path.exists(merge_into):
        try:
            merged = load_baseline(merge_into)
        except (ValueError, KeyError, json.JSONDecodeError):
            merged = {}
    merged.update(contracts)
    data = {
        "schema": SCHEMA_VERSION,
        "devices": devices,
        "backend": "cpu",
        "note": "op-census contracts of the port's programs; refresh with "
                "`python -m repro_torch.analysis.audit --update` (see "
                "docs/analysis_torch.md)",
        "contracts": {k: merged[k] for k in sorted(merged)},
    }
    with open(path, "w") as fh:
        json.dump(data, fh, indent=2)
        fh.write("\n")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------


def _parse_planes(text: str) -> Tuple[int, ...]:
    try:
        planes = tuple(int(p) for p in text.split(",") if p)
    except ValueError:
        raise SystemExit(f"--planes expects e.g. '1,3', got {text!r}")
    if not planes:
        raise SystemExit("--planes expects at least one plane count")
    return planes


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.analysis.audit",
        description="run every production entry point of the port under an "
                    "op census and check its contract against the committed "
                    "baseline")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--check", action="store_true",
                      help="diff fresh contracts against --baseline "
                           "(default mode)")
    mode.add_argument("--update", action="store_true",
                      help="regenerate and (re)write --baseline")
    ap.add_argument("--baseline", default=DEFAULT_BASELINE,
                    help=f"contract baseline path (default {DEFAULT_BASELINE})")
    ap.add_argument("--planes", default="1,3",
                    help="comma-separated plane counts to audit (default 1,3)")
    ap.add_argument("--devices", type=int, default=2,
                    help="gloo ranks of the distributed programs (default 2; "
                         "they need >= 2)")
    ap.add_argument("--programs", action="append", default=None,
                    help="contract name or fnmatch glob to gate (repeatable; "
                         "default: every program of the selected planes)")
    ap.add_argument("--json", default=None,
                    help="also write the fresh contracts to this path")
    ap.add_argument("--inject", default=None, choices=INJECT_MODES,
                    help="seed a deliberate contract regression (tests the "
                         "gate itself)")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-program progress")
    args = ap.parse_args(argv)

    torch.set_num_threads(1)
    planes = _parse_planes(args.planes)
    log = (lambda s: None) if args.quiet else (
        lambda s: print(f"[audit] {s}", file=sys.stderr))
    fresh = collect_contracts(planes=planes, devices=args.devices,
                              patterns=args.programs, inject=args.inject,
                              log=log)
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"schema": SCHEMA_VERSION, "contracts": fresh}, fh,
                      indent=2)
            fh.write("\n")
    if args.update:
        write_baseline(args.baseline, fresh, args.devices,
                       merge_into=args.baseline)
        print(f"wrote {len(fresh)} contract(s) to {args.baseline}")
        return 0
    if not os.path.exists(args.baseline):
        print(f"error: no contract baseline {args.baseline!r}; generate one "
              "with `python -m repro_torch.analysis.audit --update` and "
              "commit it", file=sys.stderr)
        return 1
    return diff_contracts(load_baseline(args.baseline), fresh,
                          patterns=args.programs)


if __name__ == "__main__":
    sys.exit(main())
