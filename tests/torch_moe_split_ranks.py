"""Rank functions of ``tests/test_torch_moe_split.py``: each runs on every
rank of a ``testing.ranks.run_ranks`` spawn and returns a dict of numpy
arrays. They live here, importable without JAX, because spawn imports a
rank function's module anew in every child.

``TRAIN`` and ``SERVE`` are shared with the test's reference subprocess:
the MoE family's smoke configs (deepseek-moe-16b: GQA and routed plus
shared experts; deepseek-v2-236b: MLA) on (4, 2) and (2, 4) meshes of the
8 ranks, where ``model`` splits the experts, the shared experts' columns
and the heads (``models.moe``, ``models.attention``); and a fallback
config of 6 experts, which ``model`` = 4 does not divide, so its MoE
layers compute whole.

A bfloat16 run or case replays one routing (``replayed``): a top-k choice
flips at a near-tie where two runs' bfloat16 roundings differ, and a
flipped token moves whole between experts (ROADMAP queue 3, gap 11), so
the port's split steps, and in the test's subprocess the reference's
steps, take the expert ids of the port's one-device run, which the test
records before the ranks start.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import OptimizerConfig, ShapeConfig, get_config
from repro_torch.data.tokens import make_batch, shard_batch
from repro_torch.interop import caches_to_numpy, model_params_from_numpy
from repro_torch.launch.specs import build_decode, build_prefill, build_train
from repro_torch.models import moe
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp, kvcache
from repro_torch.parallel import sharding as S
from repro_torch.testing import parity
from repro_torch.tree import tree_items, tree_map

import torch_serve_mesh_ranks as SR

#: the smoke configs, by name; "moe6" is deepseek-moe's with 6 experts
CFGS = {
    "moe": get_config("deepseek-moe-16b", smoke=True),
    "mla": get_config("deepseek-v2-236b", smoke=True),
}
CFGS["moe6"] = dataclasses.replace(
    CFGS["moe"], moe=dataclasses.replace(CFGS["moe"].moe, num_experts=6))

#: the train steps' shape: 8 rows of 16 positions, which split over 4
#: ranks of ``data`` or of ``model``
SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=8)
STEPS = 2
#: AdamW's eps: 1, so that an update is linear in its gradient (ROADMAP
#: queue 3, gap 12; ``torch_split_batch_ranks.OPT_EPS``)
OPT_EPS = 1.0
#: decode steps after each prefill: an append prefill of 12 tokens into
#: 32 slots then writes slots 12 to 17, across the slot blocks' boundary
#: at 16 of (4, 2) and (2, 4)
DECODE_STEPS = 6


class Run(NamedTuple):
    """A train run: config name, mesh, dtype, capacity factor (None: the
    config's), remat."""

    cfg: str
    mesh: Tuple[int, int]
    dtype: str = "float32"
    capacity: Optional[float] = None
    remat: str = "none"

    def config(self):
        return _config(self.cfg, self.dtype, self.capacity, self.remat)


def _config(name: str, dtype: str, capacity: Optional[float],
            remat: str = "none"):
    cfg = dataclasses.replace(CFGS[name], dtype=dtype, remat=remat)
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


#: tag -> train run. "moe.4x2" splits its 8 rows over the 4 ranks of
#: ``data`` at capacity factor 0.5, so the whole batch drops pairs that a
#: rank's own capacity would keep; the (2, 4) runs recompute their
#: segments (remat ``selective``), collectives included; "moe6.2x4" is
#: the fallback (6 experts on 4 ranks of ``model``)
TRAIN = {
    "moe.4x2": Run("moe", (4, 2), capacity=0.5),
    "moe.2x4": Run("moe", (2, 4), remat="selective"),
    "mla.4x2": Run("mla", (4, 2)),
    "mla.2x4": Run("mla", (2, 4), remat="selective"),
    "moe6.2x4": Run("moe6", (2, 4)),
    "moe.bf16.4x2": Run("moe", (4, 2), "bfloat16"),
}
#: the train runs the reference also takes on one device: the routing of
#: "moe.4x2" (recorded), and the bfloat16 run's single-device gap
TRAIN_SINGLE = ("moe.4x2", "moe.bf16.4x2")


class Serve(NamedTuple):
    """A serving case: config name, mesh, rows, prompt positions, cache
    slots, whether it is held against the reference's single-device steps
    (its sharded MLA decode drops the clamped write past the cache's end:
    reference caveat), dtype, capacity factor (None: the config's)."""

    cfg: str
    mesh: Tuple[int, int]
    batch: int
    prompt: int
    max_len: int
    single: bool = False
    dtype: str = "float32"
    capacity: Optional[float] = None

    def config(self):
        return _config(self.cfg, self.dtype, self.capacity)


#: name -> serving case: a bulk prefill (16 positions into 16 slots; the
#: MLA cache's decode steps write past its end, clamped) and an append
#: prefill (12 into 32) of each config, each config on each mesh;
#: "moe.rows.4x2" splits 8 rows over the 4 ranks of ``data`` at capacity
#: factor 0.5; the fallback; one bfloat16 case (seeded decode tokens)
SERVE = {
    "moe.bulk.2x4": Serve("moe", (2, 4), 4, 16, 16),
    "moe.append.4x2": Serve("moe", (4, 2), 4, 12, 32),
    "mla.bulk.4x2": Serve("mla", (4, 2), 4, 16, 16, single=True),
    "mla.append.2x4": Serve("mla", (2, 4), 4, 12, 32),
    "moe.rows.4x2": Serve("moe", (4, 2), 8, 12, 32, capacity=0.5),
    "moe6.append.2x4": Serve("moe6", (2, 4), 4, 12, 32),
    "mla.bf16.append.4x2": Serve("mla", (4, 2), 4, 12, 32,
                                 dtype="bfloat16"),
}


def serve_inputs(name: str, case: Serve) -> Dict[str, np.ndarray]:
    """The prompt tokens of ``case`` and, for a bfloat16 case, its
    (B, DECODE_STEPS) decode tokens, from a numpy seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    vocab = case.config().vocab_size
    out = {"tokens": rng.integers(0, vocab, (case.batch, case.prompt),
                                  dtype=np.int32)}
    if case.dtype != "float32":
        out["decode_tokens"] = rng.integers(
            0, vocab, (case.batch, DECODE_STEPS), dtype=np.int32)
    return out


def replay_calls(inputs, key: str):
    """The recorded (probs (T, E), ids (T, k)) of every MoE call of run or
    case ``key`` (``train.<tag>`` / ``serve.<name>``) in the inputs, in
    call order, or None where it replays none."""
    calls, i = [], 0
    while f"replay/{key}/ids/{i:03d}" in inputs:
        calls.append((inputs[f"replay/{key}/probs/{i:03d}"],
                      inputs[f"replay/{key}/ids/{i:03d}"]))
        i += 1
    return calls or None


@contextlib.contextmanager
def replayed(calls):
    """Inside the block ``moe.route`` takes each call's expert ids from
    ``calls`` (``replay_calls``: the whole batch's, in call order), those
    of this rank's rows where the batch splits, with the router's own
    probabilities at them, renormalised (as the reference renormalises its
    top k). Each of its own choices that differs must sit at a near-tie
    (``parity.moe_flips``). ``calls`` None: the plain route."""
    if calls is None:
        yield
        return
    plain, it = moe.route, iter(calls)

    def replay(router, xf, top_k):
        probs, _, own = plain(router, xf, top_k)
        rprobs, rids = next(it)
        t = xf.shape[0]
        layout = fsdp.current_layout()
        r = (layout.batch_rank() if layout is not None
             and layout.batch_n > 1 else 0)
        rprobs, rids = rprobs[r * t:(r + 1) * t], rids[r * t:(r + 1) * t]
        parity.moe_flips(own.numpy(), rids, probs.detach().float().numpy(),
                         rprobs)
        ids = torch.from_numpy(rids.astype(np.int64))
        w = torch.gather(probs, 1, ids)
        return probs, w / torch.sum(w, dim=-1, keepdim=True), ids

    moe.route = replay
    try:
        yield
    finally:
        moe.route = plain


def _routing(log) -> Dict[str, np.ndarray]:
    """Each MoE call's (E,) pair counts and dropped pairs on this rank, one
    row a call."""
    return {"counts": np.stack([e["counts"].numpy() for e in log]),
            "dropped": np.asarray([int(moe.dropped_pairs(e))
                                   for e in log])}


def _ranks(mesh) -> Dict[str, np.ndarray]:
    return {"data_rank": np.int64(mesh.get_local_rank("data")),
            "model_rank": np.int64(mesh.get_local_rank("model"))}


def train_run(mesh, inputs, tag: str) -> Dict[str, np.ndarray]:
    """``STEPS`` steps of ``build_train``'s step of run ``tag`` from the
    parameters under ``<cfg>/param/``: the losses, aux, last grad norm,
    every parameter's full value, this rank's routing and its place on the
    mesh."""
    run = TRAIN[tag]
    cfg = run.config()
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, (psh, osh, _), _ = build_train(cfg, SHAPE, mesh,
                                              OptimizerConfig(eps=OPT_EPS))
        full = tree_map(lambda t: t.requires_grad_(True),
                        model_params_from_numpy(
                            SR.unflatten(inputs, f"{run.cfg}/param/"),
                            "cpu"))
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        losses, aux = [], []
        with moe.routing_log() as log, \
                replayed(replay_calls(inputs, f"train.{tag}")):
            for i in range(STEPS):
                batch = shard_batch(make_batch(cfg, SHAPE, 0, i), mesh)
                params, opt, m = fn(params, opt, batch)
                losses.append(float(m["loss"]))
                aux.append(float(m["aux"]))
        out.update(_routing(log) if run.remat == "none" else {})
        out.update(_ranks(mesh))
        out["losses"] = np.asarray(losses)
        out["aux"] = np.asarray(aux)
        out["grad_norm"] = np.asarray(float(m["grad_norm"]))
        for key, leaf in tree_items(params):
            out["param." + key.replace("/", ".")] = fsdp.full_value(
                leaf).detach().float().numpy()
    return {f"train.{tag}.{k}": v for k, v in out.items()}


def serve_case(name: str, mesh, inputs) -> Dict[str, np.ndarray]:
    """Case ``name`` through ``build_prefill`` and ``build_decode`` on
    ``mesh``: the prefill's and every decode step's full logits, the
    decoded tokens (greedy, or a bfloat16 case's seeded ones), the caches
    gathered from the ranks, this rank's routing and its place on the
    mesh."""
    case = SERVE[name]
    cfg = case.config()
    forced = inputs.get(f"{name}/decode_tokens")
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        pre, _, (psh, bsh, _), pre_out = build_prefill(
            cfg, ShapeConfig("p", "prefill", case.prompt, case.batch), mesh)
        dec, _, dsh, dec_out = build_decode(
            cfg, ShapeConfig("d", "decode", case.max_len, case.batch), mesh)
        params = kvcache.place(model_params_from_numpy(
            SR.unflatten(inputs, f"{case.cfg}/param/"), "cpu"), psh)
        batch = kvcache.place({"tokens": torch.from_numpy(
            inputs[f"{name}/tokens"].copy())}, bsh)
        caches = kvcache.init_blocks(cfg, case.batch, case.max_len, dsh[2],
                                     "cpu")

        def next_token(full, i):
            if forced is not None:
                return torch.from_numpy(forced[:, i:i + 1].copy())
            return torch.argmax(full[:, -1], dim=-1).to(torch.int32)[:, None]

        with moe.routing_log() as log, \
                replayed(replay_calls(inputs, f"serve.{name}")):
            logits, caches = pre(params, batch, caches)
            full = pre_out["out_shardings"][0].gather(logits)
            out["prefill_logits"] = full.float().numpy()
            tok = next_token(full, 0)
            toks, steps = [tok], []
            for i in range(DECODE_STEPS):
                logits, caches = dec(params, kvcache.place(tok, dsh[1]),
                                     caches, case.prompt + i)
                full = dec_out["out_shardings"][0].gather(logits)
                steps.append(full.float().numpy())
                if i + 1 < DECODE_STEPS or forced is None:
                    tok = next_token(full, i + 1)
                    toks.append(tok)
        out.update(_routing(log))
        out.update(_ranks(mesh))
        out["decode_logits"] = np.stack(steps)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        for key, leaf in tree_items(caches_to_numpy(
                tree_map(fsdp.full_value, caches))):
            out["cache/" + key] = leaf
    return {f"serve.{name}.{k}": v for k, v in out.items()}


def run_all(mesh, inputs_path: str, train, serve) -> Dict[str, np.ndarray]:
    """The train runs ``train`` and the serving cases ``serve``, each on
    its mesh of the 8 ranks (the spawn's own (4, 2) mesh, or (2, 4) built
    here). Every rank returns its routing and place; rank 0 everything."""
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    meshes = {(4, 2): mesh}

    def on(dims):
        if dims not in meshes:
            meshes[dims] = SR._mesh(dims)
        return meshes[dims]

    out = {}
    for tag in train:
        out.update(train_run(on(TRAIN[tag].mesh), inputs, tag))
    for name in serve:
        out.update(serve_case(name, on(SERVE[name].mesh), inputs))
    if torch.distributed.get_rank() != 0:
        out = {k: v for k, v in out.items()
               if k.endswith((".counts", ".dropped", "_rank"))}
    return out


def one_rank(mesh, inputs_path: str, train, serve) -> Dict[str, np.ndarray]:
    """The train runs and serving cases on this spawn's one-rank (1, 1)
    mesh, whatever mesh they name."""
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    out = {}
    for tag in train:
        out.update(train_run(mesh, inputs, tag))
    for name in serve:
        out.update(serve_case(name, mesh, inputs))
    return out
