"""The dry run: every (arch x shape x mesh) cell's sharded step, traced on a
fake world, as the reference's ``src/repro/launch/dryrun.py`` lowers and
compiles each cell without hardware.

For the reference's production meshes, 16 x 16 (256 ranks) and 2 x 16 x 16
(512 ranks, ``launch.mesh``), and every assigned architecture and input
shape, a cell:

  * starts a fake process group of the mesh's size (``mesh.fake_world``:
    this process is rank 0, collectives move nothing) and builds the mesh;
  * builds the step with the port's own builder (``launch.specs``
    ``build_train`` / ``build_prefill`` / ``build_decode``) under the
    arch's activation rules (``act_rules_for``);
  * places each argument as rank 0's block on the ``meta`` device, marked
    with its spec (the parameters of a train step take a gradient);
  * runs the step once under ``launch.op_cost`` and writes one JSON: the
    FLOPs, the bytes accessed, the memory account and the collectives of
    rank 0, as the reference's keys name them (``status``, ``flops``,
    ``bytes_accessed``, ``memory``, ``collectives``, ``n_devices``), with
    ``trace_s`` (the step's wall time here) in place of ``lower_s`` /
    ``compile_s``, and ``replicated_compute``: n times rank 0's FLOPs over
    the FLOPs of the same step on one rank (``flops_one_rank``: the
    builder's step on a one-rank mesh, traced once for an arch and shape),
    to one decimal, so the factor by which the ranks repeat each other's
    products: 1 where every product splits (a train step's heads, MLP
    columns and vocab over ``model``, its batch over the batch axes), 16
    where the 16 ranks of ``model`` compute the same products, and between
    where only some split; an MoE arch's cell adds ``expert_slots``, a
    rank's expert-FFN slots a layer against the reference's share of them
    (``expert_slots``).

The dry run allocates nothing on any device: every tensor is ``meta``, so
it runs the same on a laptop and on the card's machine, as the reference's
compiles need no TPU. It is the one entry point of the port that touches no
device, by design.

A cell ends ``ok``; ``skipped`` (``long_500k`` for an arch outside
``LONG_OK``, as in the reference); or ``error`` (an exception, with its
traceback). Every arch builds on every mesh: an MoE FFN on a split batch
routes over the whole batch (``models.moe``), so its cells count the
all-gather of the experts' counts and each rank's expert FFN on its own
rows. ``main`` exits 1 on
any ``error``. Results are cached in ``--out`` (``dryrun_torch_out/`` at the
repository root unless given) and reused unless ``--force``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch ID]
      [--shape NAME] [--multi-pod | --single-pod] [--force] [--out DIR]
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config import SHAPES, get_config
from repro_torch.configs import ARCH_IDS
from repro_torch.launch import op_cost
from repro_torch.launch.mesh import (MULTI_POD, SINGLE_POD, fake_world,
                                     make_production_mesh)
from repro_torch.launch.specs import build_decode, build_prefill, build_train
from repro_torch.models.moe import _capacity, expert_buffer, moe_splits
from repro_torch.parallel import fsdp
from repro_torch.parallel.sharding import (ACT_RULES, act_rules_for,
                                           build_spec, local_shape,
                                           mesh_shape, spec_axes, use_mesh)
from repro_torch.tree import tree_map

RESULTS_DIR = Path(__file__).resolve().parents[3] / "dryrun_torch_out"

#: cells run by design (sub-quadratic requirement), as the reference's
LONG_OK = {"mamba2-780m", "recurrentgemma-2b"}

BUILDERS = {"train": build_train, "prefill": build_prefill,
            "decode": build_decode}


def meta_blocks(arg, sharding, grad: bool = False):
    """``arg`` (a tree, a plain tuple of trees, a tensor or a host value)
    as rank 0's blocks under ``sharding``: a fresh ``meta`` tensor of each
    leaf's local shape, marked with its spec, floating leaves taking a
    gradient where ``grad``. Every block has a storage of its own, as the
    step's real arguments do."""
    if type(arg) is tuple:
        return tuple(meta_blocks(a, s, grad) for a, s in
                     zip(arg, sharding or (None,) * len(arg)))

    def one(t, sh):
        if not isinstance(t, torch.Tensor):
            return t
        shape = t.shape if sh is None else local_shape(t.shape, sh.spec,
                                                       sh.mesh)
        block = torch.empty(shape, dtype=t.dtype, device="meta")
        if sh is not None:
            fsdp.mark(block, sh.spec)
        return block.requires_grad_(grad and block.is_floating_point())

    if sharding is None:
        return tree_map(lambda t: one(t, None), arg)
    return tree_map(one, arg, sharding)


def step_args(kind: str, args, shardings):
    """A builder's meta arguments as rank 0's blocks (train: the
    parameters take a gradient)."""
    return tuple(meta_blocks(a, s, grad=(kind == "train" and i == 0))
                 for i, (a, s) in enumerate(zip(args, shardings)))


def measure(cfg, shape, mesh, rules=None) -> Dict[str, Any]:
    """The cost of rank 0's step of ``cfg`` at ``shape`` on ``mesh`` (built
    and run under ``use_mesh`` with ``rules``, the arch's own unless
    given): ``op_cost.analyze``'s fields, ``n_devices``,
    ``replicated_compute``, ``trace_s`` and, for an MoE arch,
    ``expert_slots``."""
    rules = rules or act_rules_for(cfg, mesh)
    t0 = time.perf_counter()
    cost = _cost(cfg, shape, mesh, rules)
    n = math.prod(mesh_shape(mesh).values())
    one = (cost["flops"] if n == 1 else
           flops_one_rank(cfg, shape, mesh.device_type,
                          tuple(mesh.mesh_dim_names)))
    out = dict(cost, n_devices=n, flops_one_rank=one,
               replicated_compute=round(n * cost["flops"] / one, 1),
               trace_s=round(time.perf_counter() - t0, 3))
    if cfg.moe is not None:
        out["expert_slots"] = expert_slots(cfg, shape, mesh, rules)
    return out


def _cost(cfg, shape, mesh, rules) -> Dict[str, Any]:
    """``op_cost.analyze`` of rank 0's step of ``cfg`` at ``shape`` on
    ``mesh`` under ``rules``."""
    with use_mesh(mesh, rules):
        fn, args, shardings, _ = BUILDERS[shape.kind](cfg, shape, mesh)
        return op_cost.analyze(fn, step_args(shape.kind, args,
                                             shardings))[1]


@functools.lru_cache(maxsize=None)
def flops_one_rank(cfg, shape, device_type: str, names) -> int:
    """The FLOPs of the step of ``cfg`` at ``shape`` on a one-rank mesh of
    dim ``names`` (``one_rank``) under the arch's act rules. On one rank
    every spec is whole and no rule splits anything, so the count depends
    on the arch and the shape alone: a sweep traces it once for both
    production meshes."""
    mesh = one_rank(device_type, names)
    return _cost(cfg, shape, mesh, act_rules_for(cfg, mesh))["flops"]


def one_rank(device_type: str, names) -> DeviceMesh:
    """A mesh of dim ``names``, each of one rank (this one), in the current
    process group."""
    return DeviceMesh(device_type,
                      torch.zeros((1,) * len(names), dtype=torch.int64),
                      mesh_dim_names=names)


def expert_slots(cfg, shape, mesh, rules) -> Dict[str, Any]:
    """The expert-FFN slots (one token through one expert's three
    products) a rank computes in one MoE layer of ``cfg``'s step at
    ``shape`` on ``mesh`` under the act rules ``rules``: the port's, the
    dispatch's own buffer (``models.moe.expert_buffer``: the experts the
    rank runs, E / n where the step splits them over ``model``
    (``moe_splits``), times the slots of each, min(capacity, the rank's
    tokens) on a split batch and the capacity on a whole one), read under
    the step's layout (its batch axes as ``batch_ranks`` places the
    batch, the split over ``model``); the reference's share, E x capacity
    over the ranks that split its experts (``ACT_RULES["experts"]``); and
    the port's over the reference's."""
    m = cfg.moe
    e = m.num_experts
    tokens = shape.global_batch * (1 if shape.kind == "decode"
                                   else shape.seq_len)
    cap = _capacity(tokens, e, m.top_k, m.capacity_factor)
    batch = build_spec((shape.global_batch,), ("batch",), mesh,
                       rules if shape.kind == "train" else ACT_RULES)[0]
    layout = fsdp.make_layout(mesh, spec_axes(batch), split=True)
    with use_mesh(mesh, rules), fsdp.use_layout(layout):
        split = fsdp.split_rank()[0] if moe_splits(cfg) else 1
    run, slots = expert_buffer(tokens // layout.batch_n, tokens, m, split)
    sizes = mesh_shape(mesh)
    entry = build_spec((e,), ("experts",), mesh, ACT_RULES)[0]
    reference = e * cap / math.prod(sizes[a] for a in spec_axes(entry))
    return {"capacity": cap, "port": run * slots, "reference": reference,
            "ratio": round(run * slots / reference, 4)}


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             force: bool = False, out_dir: Path = RESULTS_DIR
             ) -> Dict[str, Any]:
    """One cell on its production mesh (module docstring); its JSON is
    written to ``out_dir`` and reused unless ``force``."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_tag = "pod2" if multi_pod else "pod1"
    cell = f"{arch_id}__{shape_name}__{mesh_tag}"
    path = out_dir / f"{cell}.json"
    if path.exists() and not force:
        return json.loads(path.read_text())

    result: Dict[str, Any] = {"cell": cell, "arch": arch_id,
                              "shape": shape_name, "mesh": mesh_tag}
    if shape_name == "long_500k" and arch_id not in LONG_OK:
        result["status"] = "skipped"
        result["reason"] = ("full-attention arch: 500k decode requires "
                            "sub-quadratic attention (DESIGN.md)")
        _save(path, result)
        return result
    cfg, shape = get_config(arch_id), SHAPES[shape_name]
    dims = (MULTI_POD if multi_pod else SINGLE_POD)[0]
    try:
        with fake_world(math.prod(dims)):
            mesh = make_production_mesh(multi_pod=multi_pod)
            result.update(measure(cfg, shape, mesh))
        result["status"] = "ok"
    except Exception as e:  # noqa: BLE001 — a failed cell is a bug report
        result["status"] = "error"
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
    _save(path, result)
    return result


def _save(path: Path, result) -> None:
    path.write_text(json.dumps(result, indent=1))


def summary(r: Dict[str, Any]) -> str:
    """One line of a cell's result."""
    status = r["status"]
    extra = ""
    if status == "ok":
        m = r["memory"]
        held = (m["argument_size_in_bytes"] + m["temp_size_in_bytes"])
        extra = (f"flops={r['flops']:.3g} "
                 f"coll={r['collectives']['total_bytes']:.3g}B "
                 f"args={m['argument_size_in_bytes'] / 2**30:.2f}GiB "
                 f"temp={m['temp_size_in_bytes'] / 2**30:.2f}GiB "
                 f"peak={held / 2**30:.2f}GiB "
                 f"x{r['replicated_compute']} [{r['trace_s']:.1f}s]")
        if "expert_slots" in r:
            extra += f" experts x{r['expert_slots']['ratio']:g}"
    elif status == "error":
        extra = r["error"][:120]
    return f"{r['cell']:<55} {status:<8} {extra}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None, choices=ARCH_IDS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", type=Path, default=RESULTS_DIR)
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = ([True] if args.multi_pod else
              [False] if args.single_pod else [False, True])

    failures = 0
    t0 = time.perf_counter()
    for multi_pod in meshes:
        for arch in archs:
            for shape in shapes:
                r = run_cell(arch, shape, multi_pod, force=args.force,
                             out_dir=args.out)
                failures += r["status"] == "error"
                print(summary(r), flush=True)
    print(f"dry run: {len(meshes) * len(archs) * len(shapes)} cells, "
          f"{failures} errors, {time.perf_counter() - t0:.1f} s; results "
          f"in {args.out}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
