"""Rank functions of ``tests/test_torch_parallel.py``: each runs on every
rank of a ``testing.ranks.run_ranks`` spawn and returns a dict of numpy
arrays. They live here, importable without JAX, because spawn imports a
rank function's module anew in every child."""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.config import (ModelConfig, OptimizerConfig,
                                ParallelConfig, ShapeConfig, get_config)
from repro_torch.data.tokens import make_batch, shard_batch
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch.specs import build_train
from repro_torch.models.model import Model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.models import attention
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as S
from repro_torch.parallel.pipeline import pipeline_apply
from repro_torch.train.compressed_dp import (init_compressed_state,
                                             make_compressed_train_step)
from repro_torch.tree import tree_items, tree_leaves, tree_map

#: the reference's sharded-step test config (tests/test_distributed.py)
STEP_CFG = ModelConfig(num_layers=2, d_model=32, num_heads=4, num_kv_heads=2,
                       d_ff=64, vocab_size=256, remat="none",
                       dtype="float32")
STEP_SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=8)
STEP_STEPS = 2


def loss_mask(shape: ShapeConfig) -> np.ndarray:
    """A (B, S - 1) loss mask from a numpy seed whose rows keep between a
    fifth and all of their tokens, so the ranks' mask sums differ."""
    rng = np.random.default_rng(11)
    b, s = shape.global_batch, shape.seq_len - 1
    keep = rng.permutation(np.linspace(0.2, 1.0, b))
    return (rng.random((b, s)) < keep[:, None]).astype(np.float32)


#: the configs of the sharded step: the reference's sharded-step config,
#: and gemma2-2b's smoke config in float32 (softcaps, a local window,
#: gelu, the tied table, the embedding scale)
STEP_CFGS = {
    "step": STEP_CFG,
    "gemma2": dataclasses.replace(get_config("gemma2-2b", smoke=True),
                                  dtype="float32", remat="none"),
}

#: the meshes of the sharded step's spawns: (4, 2) splits the 4 heads and
#: 2 kv heads over 2 ranks of ``model``; on (2, 4) ``model`` does not
#: divide the kv heads, so they are repeated (``_maybe_repeat_kv``)
STEP_MESHES = ((4, 2), (2, 4))


def masked_batch(shape: ShapeConfig, cfg: ModelConfig = STEP_CFG) -> dict:
    """The batch of step ``STEP_STEPS`` with ``loss_mask``."""
    batch = make_batch(cfg, shape, 0, STEP_STEPS)
    batch["loss_mask"] = loss_mask(shape)
    return batch


#: the sharded step's variants: tag -> (zero1, microbatches, remat); the
#: ``micro2`` ones are the configuration the card runs (microbatches and
#: remat ``selective``), at the test's size
STEP_VARIANTS = {
    "plain": (False, 1, "none"),
    "zero1": (True, 1, "none"),
    "plain.micro2": (False, 2, "selective"),
    "zero1.micro2": (True, 2, "selective"),
}


def step_cfg(tag: str, name: str = "step") -> ModelConfig:
    return dataclasses.replace(STEP_CFGS[name], remat=STEP_VARIANTS[tag][2])

#: the reference's compressed-DP test config (tests/test_compressed_dp.py)
DP_CFG = ModelConfig(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                     d_ff=64, vocab_size=128, remat="none", dtype="float32")
DP_SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=4)
DP_OPT = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=50,
                         schedule="constant")
DP_STEPS = 10


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


def _trainable(params_np):
    return tree_map(lambda t: t.requires_grad_(True),
                    model_params_from_numpy(unflatten(params_np), "cpu"))


def _axes_product(spec, mesh) -> int:
    sizes = S.mesh_shape(mesh)
    return math.prod(sizes[a] for e in spec for a in S.spec_axes(e))


def sharded_steps(mesh, params_by_cfg, ckpt_dir, ckpt_step):
    """For each config of ``STEP_CFGS`` (its parameters in
    ``params_by_cfg``), the sharded step of ``build_train`` in each of
    ``STEP_VARIANTS`` for ``STEP_STEPS`` steps, then one step on
    ``masked_batch`` (its loss, aux and parameters under
    ``<cfg>.<tag>.masked``), and how often the attention repeated its kv
    heads (``_maybe_repeat_kv`` returning new tensors); every leaf's block
    size against its full size over its spec's axes; the checkpoint at
    ``ckpt_dir`` restored onto this mesh, every block against the same
    block cut from the saved arrays. Each batch is placed for the step's
    microbatches."""
    out = {}
    repeats = []
    plain_repeat = attention._maybe_repeat_kv

    def counted(k, v, *a, **kw):
        got = plain_repeat(k, v, *a, **kw)
        repeats.append(got[0] is not k)
        return got

    attention._maybe_repeat_kv = counted
    try:
        for name, params_np in params_by_cfg.items():
            out.update(_cfg_steps(mesh, name, params_np, repeats))
    finally:
        attention._maybe_repeat_kv = plain_repeat
    with S.use_mesh(mesh, S.act_rules_for(STEP_CFG, mesh)):
        # elastic restore of a whole-array checkpoint onto this mesh
        _, (pshape, oshape, _), (psh, osh, _), _ = build_train(
            STEP_CFG, STEP_SHAPE, mesh)
        restored, extra = CheckpointManager(ckpt_dir).restore(
            ckpt_step, {"params": pshape, "opt": oshape},
            shardings={"params": psh, "opt": osh})
        saved = np.load(f"{ckpt_dir}/blocks.npz")
        same = True
        for (key, blk), (_, sh) in zip(tree_items(restored),
                                       tree_items({"params": psh,
                                                   "opt": osh})):
            want = sh.shard(torch.from_numpy(saved[key]))
            same &= (fsdp.spec_of(blk) == sh.spec
                     and torch.equal(blk, want))
        out["restore.bitwise"] = np.bool_(same)
        out["restore.step"] = np.int64(extra["step"])
    return out


def _cfg_steps(mesh, name, params_np, repeats):
    cfg = STEP_CFGS[name]
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        for tag, (zero1, micro, _) in STEP_VARIANTS.items():
            key = f"{name}.{tag}"
            fn, _, (psh, osh, _), _ = build_train(
                step_cfg(tag, name), STEP_SHAPE, mesh, OptimizerConfig(),
                ParallelConfig(microbatches=micro), zero1=zero1)
            full = _trainable(params_np)
            params = fsdp.place(full, psh)
            opt = fsdp.place(init_opt_state(full), osh)
            sizes_ok = True
            for tree in (params, opt.m, opt.v):
                for (_, blk), (_, f) in zip(tree_items(tree),
                                            tree_items(full)):
                    want = f.numel() // _axes_product(fsdp.spec_of(blk),
                                                      mesh)
                    sizes_ok &= blk.numel() == want
            out[f"{key}.sizes_ok"] = np.bool_(sizes_ok)
            losses = []
            del repeats[:]
            for i in range(STEP_STEPS):
                batch = shard_batch(make_batch(cfg, STEP_SHAPE, 0, i),
                                    mesh, microbatches=micro)
                params, opt, m = fn(params, opt, batch)
                losses.append(float(m["loss"]))
            out[f"{key}.repeats"] = np.int64(sum(repeats))
            out[f"{key}.losses"] = np.asarray(losses)
            out[f"{key}.grad_norm"] = np.asarray(float(m["grad_norm"]))
            for k, leaf in tree_items(params):
                out[f"{key}.param.{k.replace('/', '.')}"] = fsdp.full_value(
                    leaf).detach().numpy().copy()  # the step updates leaves
            params, opt, m = fn(params, opt, shard_batch(
                masked_batch(STEP_SHAPE, cfg), mesh, microbatches=micro))
            out[f"{key}.masked.loss"] = np.asarray(float(m["loss"]))
            out[f"{key}.masked.grad_norm"] = np.asarray(
                float(m["grad_norm"]))
            for k, leaf in tree_items(params):
                out[f"{key}.masked.param.{k.replace('/', '.')}"] = (
                    fsdp.full_value(leaf).detach().numpy())
    return out


#: the one-rank cases: tag -> (config, zero1, microbatches); gemma2-2b's
#: smoke config as it ships (bfloat16, remat ``selective``)
ONE_RANK = {
    "step.plain": (STEP_CFG, False, 1),
    "step.zero1": (STEP_CFG, True, 1),
    "gemma2.bf16.micro2": (get_config("gemma2-2b", smoke=True), False, 2),
    "gemma2.bf16.zero1.micro2": (get_config("gemma2-2b", smoke=True), True,
                                 2),
}


def one_rank_steps(mesh, tag, params_np):
    """``STEP_STEPS`` steps of ``build_train``'s step on the one-rank
    ``mesh`` in case ``tag`` of ``ONE_RANK``: the losses, grad norms and
    every parameter after them."""
    cfg, zero1, micro = ONE_RANK[tag]
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, (psh, osh, _), _ = build_train(
            cfg, STEP_SHAPE, mesh, OptimizerConfig(),
            ParallelConfig(microbatches=micro), zero1=zero1)
        full = _trainable(params_np)
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        metrics = []
        for i in range(STEP_STEPS):
            batch = shard_batch(make_batch(cfg, STEP_SHAPE, 0, i), mesh,
                                microbatches=micro)
            params, opt, m = fn(params, opt, batch)
            metrics.append([float(m["loss"]), float(m["grad_norm"])])
        out["metrics"] = np.asarray(metrics)
        for k, leaf in tree_items(params):
            out["param." + k.replace("/", ".")] = leaf.detach().numpy()
    return out


#: an MoE config on a mesh that does not split the batch: (1, 2), the
#: experts' storage over ``model``
MOE_CFG = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              dtype="float32")
MOE_SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=4)


def moe_steps(mesh, params_np):
    """``STEP_STEPS`` steps of ``build_train``'s step on ``MOE_CFG`` from
    ``params_np``: the losses and every parameter's full value."""
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(MOE_CFG, mesh)):
        fn, _, (psh, osh, _), _ = build_train(
            MOE_CFG, MOE_SHAPE, mesh, OptimizerConfig(),
            ParallelConfig(microbatches=2))
        full = _trainable(params_np)
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        losses = []
        for i in range(STEP_STEPS):
            batch = shard_batch(make_batch(MOE_CFG, MOE_SHAPE, 0, i), mesh)
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
        out["losses"] = np.asarray(losses)
        out["experts_split"] = np.bool_(any(
            "model" in S.spec_axes(e) for sh in tree_leaves(psh)
            for e in sh.spec))
        for key, leaf in tree_items(params):
            out["param." + key.replace("/", ".")] = fsdp.full_value(
                leaf).detach().numpy()
    return out


def compressed_steps(mesh, params_np):
    """``DP_STEPS`` compressed steps on the ``("pod",)`` mesh from
    ``params_np``: the losses."""
    model = Model(DP_CFG, "cpu")
    params = _trainable(params_np)
    state = init_compressed_state(params, init_opt_state(params))
    step = make_compressed_train_step(model, DP_OPT, mesh)
    losses = []
    for t in range(DP_STEPS):
        batch = {k: torch.from_numpy(v)
                 for k, v in make_batch(DP_CFG, DP_SHAPE, 0, t).items()}
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses)}


def pipeline_stages(mesh, w, b, x):
    """``pipeline_apply`` of the reference test's tanh stages on the
    ``("stage",)`` mesh."""
    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    y = pipeline_apply(stage_fn, {"w": torch.from_numpy(w),
                                  "b": torch.from_numpy(b)},
                       torch.from_numpy(x), mesh, "stage")
    return {"y": y.numpy()}

