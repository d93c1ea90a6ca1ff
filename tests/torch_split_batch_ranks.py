"""Rank functions of ``tests/test_torch_split_batch.py``, importable
without JAX (spawn imports a rank function's module anew in every child).

``moe_steps`` runs deepseek-moe-16b's smoke config in float32 at capacity
factor ``FACTOR`` through ``launch.specs.build_train`` in each of
``VARIANTS`` for ``STEPS`` steps, every batch placed for the step's
microbatches (``data.tokens.shard_batch``), and returns the losses, the
aux, every parameter's full value and (remat ``none``) each MoE call's
routing on this rank.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config import (OptimizerConfig, ParallelConfig, ShapeConfig,
                                get_config)
from repro_torch.data.tokens import make_batch, shard_batch
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.specs import build_train
from repro_torch.models import moe
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_items, tree_map

MOE_CFG = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              dtype="float32")
#: low enough that every microbatch drops pairs on both sides of the
#: ranks' boundaries
FACTOR = 0.5
SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=16)
STEPS = 2
#: AdamW's eps: 1, so that an update is linear in its gradient. At the
#: default 1e-8 an update is about lr times the gradient's sign, and a
#: leaf that starts at zero (a norm's scale) holds only such updates: an
#: element whose two steps' gradients nearly cancel turns a rounding of
#: its gradient into a visible share of the leaf's max (ROADMAP queue 3,
#: gap 12). The port's plain single-device step reads 1.25e-5 of such a
#: leaf's max from the reference's there, at eps 1 4.6e-7
OPT_EPS = 1.0
#: tag -> (mesh dims, mesh axes, zero1, microbatches, remat)
VARIANTS = {
    "micro1": ((4, 2), ("data", "model"), False, 1, "none"),
    "micro2": ((4, 2), ("data", "model"), False, 2, "none"),
    "zero1.micro2": ((2, 2, 2), ("pod", "data", "model"), True, 2,
                     "selective"),
}


def cfg(tag: str):
    return dataclasses.replace(
        MOE_CFG, remat=VARIANTS[tag][4],
        moe=dataclasses.replace(MOE_CFG.moe, capacity_factor=FACTOR))


def unflatten(flat):
    """{"a.b.c": array} -> nested dicts."""
    out = {}
    for key, v in flat.items():
        node = out
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = v
    return out


def _mesh(dims, axes, spawn_mesh):
    if tuple(dims) == tuple(spawn_mesh.mesh.shape):
        return spawn_mesh
    return DeviceMesh("cpu", torch.arange(8).reshape(dims),
                      mesh_dim_names=axes)


def moe_steps(mesh, params_np):
    """Every variant from ``params_np``: ``<tag>.losses``, ``<tag>.aux``,
    ``<tag>.param.<name>``, and for remat ``none`` ``<tag>.probs`` /
    ``<tag>.ids`` (one row a MoE call: step, microbatch, layer) with
    ``<tag>.batch_rank``."""
    out = {}
    for tag, (dims, axes, zero1, micro, _) in VARIANTS.items():
        c = cfg(tag)
        m = _mesh(dims, axes, mesh)
        with S.use_mesh(m, S.act_rules_for(c, m)):
            fn, _, (psh, osh, _), _ = build_train(
                c, SHAPE, m, OptimizerConfig(eps=OPT_EPS),
                ParallelConfig(microbatches=micro), zero1=zero1)
            full = tree_map(lambda t: t.requires_grad_(True),
                            model_params_from_numpy(unflatten(params_np),
                                                    "cpu"))
            params = fsdp.place(full, psh)
            opt = fsdp.place(init_opt_state(full), osh)
            losses, aux = [], []
            with moe.routing_log() as log:
                for i in range(STEPS):
                    batch = shard_batch(make_batch(c, SHAPE, 0, i), m,
                                        microbatches=micro)
                    layout = fsdp.layout_of(params, batch)
                    params, opt, metrics = fn(params, opt, batch)
                    losses.append(float(metrics["loss"]))
                    aux.append(float(metrics["aux"]))
            out[f"{tag}.losses"] = np.asarray(losses)
            out[f"{tag}.aux"] = np.asarray(aux)
            out[f"{tag}.batch_rank"] = np.int64(layout.batch_rank())
            out[f"{tag}.batch_n"] = np.int64(layout.batch_n)
            if c.remat == "none":
                out[f"{tag}.probs"] = np.stack([e["probs"].detach().numpy()
                                                for e in log])
                out[f"{tag}.ids"] = np.stack([e["ids"].numpy() for e in log])
            for key, leaf in tree_items(params):
                out[f"{tag}.param." + key.replace("/", ".")] = \
                    fsdp.full_value(leaf).detach().numpy()
    return out
