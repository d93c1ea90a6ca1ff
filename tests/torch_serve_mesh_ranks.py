"""Rank functions of ``tests/test_torch_serve_mesh.py``: each runs on every
rank of a ``testing.ranks.run_ranks`` spawn and returns a dict of numpy
arrays. They live here, importable without JAX, because spawn imports a
rank function's module anew in every child.

``CASES`` is shared with the test's reference subprocess: every case is a
smoke config (or the reference's sharded-step config, ``"step"``) in
float32 or bfloat16 served through ``build_prefill`` and ``build_decode``
on one mesh of the 8 ranks (the first prefill's caches sized by the decode
shape's ``seq_len``, ``max_len``), then ``DECODE_STEPS`` tokens: greedy in
float32, the seeded ``decode_tokens`` in bfloat16 (both packages then
decode the same tokens, so a near-tie that rounds apart moves no later
step). On a mesh whose ``model`` has more than one rank the steps split
their dense products over it (``parallel.kvcache``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.config import (OptimizerConfig, ShapeConfig, get_config)
from repro_torch.interop import caches_to_numpy, model_params_from_numpy
from repro_torch.launch.specs import build_decode, build_prefill, build_train
from repro_torch.models import attention
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp, kvcache
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_items, tree_leaves, tree_map

import torch_parallel_ranks as PR

DECODE_STEPS = 4

#: AdamW's eps in the bfloat16 runs: 1, so that an update is linear in its
#: gradient and a parameter's gap reads its gradient's (at the default an
#: element of a zero-init norm scale whose gradient nearly cancels moves
#: by lr times a sign that rounding picks: ROADMAP queue 3, gap 12;
#: ``torch_split_batch_ranks.OPT_EPS``)
BF16_EPS = 1.0
#: the sharded train step's runs: (the results' tag, config of
#: ``PR.STEP_CFGS``, mesh, dtype, AdamW's eps or None for the default).
#: (2, 4) repeats the 2 kv heads for its 4 ranks of ``model``; the bfloat16
#: runs reduce-scatter bfloat16 partial sums, and gemma2-2b's add the
#: softcaps, the window and the tied table
TRAIN_RUNS = (("train", "step", (4, 2), "float32", None),
              ("train.2x4", "step", (2, 4), "float32", None),
              ("train.bf16", "step", (4, 2), "bfloat16", BF16_EPS),
              ("train.bf16.2x4", "step", (2, 4), "bfloat16", BF16_EPS),
              ("train.gemma2.bf16", "gemma2", (4, 2), "bfloat16", BF16_EPS),
              ("train.gemma2.bf16.2x4", "gemma2", (2, 4), "bfloat16",
               BF16_EPS))
#: the reference's jitted single-device steps in bfloat16, by config: how
#: far its own sharded bfloat16 steps round apart from one device
BF16_SINGLE = {name: (f"train{'' if name == 'step' else '.' + name}"
                      ".bf16.single", name, None, "bfloat16", BF16_EPS)
               for name in ("step", "gemma2")}


class Case(NamedTuple):
    arch: str
    mesh: Tuple[int, int]
    batch: int
    prompt: int       # positions of the prefill (frontend tokens included)
    max_len: int      # cache slots
    dp_rules: bool    # the prompt's batch under DP_ACT_RULES
    #: held against the reference's single-device steps (its sharded
    #: decode past an MLA cache's end departs from them)
    single: bool = False
    #: an MoE config's capacity factor, where not the config's
    capacity: Optional[float] = None
    #: the activations' dtype; a bfloat16 case decodes ``decode_tokens``
    dtype: str = "float32"

    def cfg(self):
        base = (PR.STEP_CFG if self.arch == "step"
                else get_config(self.arch, smoke=True))
        cfg = dataclasses.replace(base, dtype=self.dtype)
        if self.capacity is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=self.capacity))
        return cfg

    def rules(self, mesh):
        return S.DP_ACT_RULES if self.dp_rules else S.act_rules_for(
            self.cfg(), mesh)


#: name -> case. gemma2's window (8) and recurrentgemma's local attention
#: wrap their rings on split slots from the first decode step (the caches
#: hold the prompt's positions only); "dense.append" fills 32 slots with a
#: 12-token prompt (the engine's prefill, split-KV over the blockwise
#: form); "dense.heads" has 15 slots, which `model` does not divide, so
#: the KV caches split their kv heads instead (gathered where read), and a
#: 15-token prompt, so the residual stays whole and the prefill's logits
#: are gathered from vocab blocks; "dense.2x4" is a bulk prefill on 4 ranks
#: of ``model``, which do not divide the 2 kv heads (``_maybe_repeat_kv``);
#: "dense.dp" splits the prompt's batch over ("data", "model") and
#: the caches' over "data" only. The bfloat16 cases ("*.bf16.*") run the
#: sharded-step config and gemma2-2b's on (4, 2) and (2, 4). "mla" fills
#: its 16 slots with the prompt, so each decode step writes past the
#: cache's end, where the write's start is clamped to the last slot
#: (``dynamic_update_slice``); the reference's partitioned write drops it
#: instead, so that case is held
#: against the reference's single-device steps, and "mla.append" (a
#: 12-token prompt into 32 slots) against its sharded ones. "moe.rows" and
#: "mla.rows" split their 32 rows over the 4 ranks of ``data`` at capacity
#: factor 0.5, so the prefill and the decode steps drop pairs of the whole
#: batch that each rank's own capacity would keep: held against the
#: reference's single-device steps, which route the whole batch
CASES: Dict[str, Case] = {
    "dense": Case("gemma2-2b", (4, 2), 4, 16, 16, False),
    "dense.append": Case("gemma2-2b", (2, 4), 4, 12, 32, False),
    "dense.heads": Case("gemma2-2b", (4, 2), 4, 15, 15, False),
    "dense.2x4": Case("gemma2-2b", (2, 4), 4, 16, 16, False),
    "dense.dp": Case("gemma2-2b", (4, 2), 8, 16, 16, True),
    "vlm": Case("internvl2-1b", (4, 2), 4, 16, 16, False),
    "ssm.4x2": Case("mamba2-780m", (4, 2), 4, 16, 16, False),
    "ssm.2x4": Case("mamba2-780m", (2, 4), 4, 16, 16, False),
    "hybrid.4x2": Case("recurrentgemma-2b", (4, 2), 4, 16, 16, False),
    "hybrid.2x4": Case("recurrentgemma-2b", (2, 4), 4, 16, 16, False),
    "moe": Case("deepseek-moe-16b", (1, 8), 2, 16, 16, False),
    "mla": Case("deepseek-v2-236b", (1, 8), 2, 16, 16, False, True),
    "mla.append": Case("deepseek-v2-236b", (1, 8), 2, 12, 32, False),
    "moe.rows": Case("deepseek-moe-16b", (4, 2), 32, 16, 24, False, True,
                     0.5),
    "mla.rows": Case("deepseek-v2-236b", (4, 2), 32, 12, 24, False, True,
                     0.5),
    "encdec": Case("seamless-m4t-large-v2", (4, 2), 4, 16, 16, False),
    "step.bf16.4x2": Case("step", (4, 2), 4, 16, 16, False,
                          dtype="bfloat16"),
    "step.bf16.2x4": Case("step", (2, 4), 4, 16, 16, False,
                          dtype="bfloat16"),
    "gemma2.bf16.4x2": Case("gemma2-2b", (4, 2), 4, 16, 16, False,
                            dtype="bfloat16"),
    "gemma2.bf16.2x4": Case("gemma2-2b", (2, 4), 4, 16, 16, False,
                            dtype="bfloat16"),
}


def case_inputs(name: str, case: Case) -> Dict[str, np.ndarray]:
    """The prompt batch of ``case`` from a numpy seed: ``tokens`` and, for
    the vlm and enc-dec configs, ``frontend_embeds`` / ``enc_embeds``."""
    cfg = case.cfg()
    rng = np.random.default_rng(sum(map(ord, name)))
    b, s = case.batch, case.prompt
    out = {}
    if cfg.frontend == "vision" and cfg.frontend_tokens:
        f = cfg.frontend_tokens
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s - f),
                                     dtype=np.int32)
        out["frontend_embeds"] = rng.standard_normal(
            (b, f, cfg.d_model)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab_size, (b, s),
                                     dtype=np.int32)
        if cfg.is_encoder_decoder:
            out["enc_embeds"] = (rng.standard_normal(
                (b, s, cfg.d_model)) * 0.02).astype(np.float32)
    return out


def decode_tokens(name: str, case: Case) -> Optional[np.ndarray]:
    """(B, DECODE_STEPS) int32 tokens a bfloat16 case decodes, from a numpy
    seed; None for a float32 case (greedy)."""
    if case.dtype == "float32":
        return None
    rng = np.random.default_rng(sum(map(ord, name)) + 1)
    return rng.integers(0, case.cfg().vocab_size,
                        (case.batch, DECODE_STEPS), dtype=np.int32)


def unflatten(flat, prefix: str):
    """{"<prefix>a.b": array} -> nested dicts of the keys under prefix."""
    return PR.unflatten({k[len(prefix):]: v for k, v in flat.items()
                         if k.startswith(prefix)})


def opt_config(eps: Optional[float]) -> OptimizerConfig:
    return OptimizerConfig() if eps is None else OptimizerConfig(eps=eps)


def _mesh(dims) -> DeviceMesh:
    return DeviceMesh("cpu", torch.arange(8).reshape(dims),
                      mesh_dim_names=("data", "model"))


def _shapes_ok(tree, meta, shardings) -> bool:
    """Every leaf of ``tree`` holds exactly the local shape of its full
    (``meta``) shape under its spec, and is marked with that spec."""
    ok = []

    def one(t, m, sh):
        if isinstance(t, torch.Tensor):
            ok.append(fsdp.spec_of(t) == sh.spec and tuple(t.shape)
                      == S.local_shape(m.shape, sh.spec, sh.mesh))

    tree_map(one, tree, meta, shardings)
    return all(ok)


def _counting_repeats(count):
    """``attention._maybe_repeat_kv``, counting in ``count[0]`` the calls
    that repeated the kv heads."""
    inner = attention._maybe_repeat_kv

    def counted(k, v, *args, **kw):
        out = inner(k, v, *args, **kw)
        count[0] += out[0] is not k
        return out

    return counted


def serve_case(name: str, case: Case, mesh, inputs) -> Dict[str, np.ndarray]:
    """``case`` through the port's sharded steps on ``mesh``: the prefill's
    and every decode step's full logits, the decoded tokens, the caches
    gathered from the ranks, whether every block holds its local shape,
    the shape of the rank's own block of the prefill's logits and how many
    of the prefill's calls repeated the kv heads."""
    cfg = case.cfg()
    out = {}
    forced = inputs.get(f"{name}/decode_tokens")
    with S.use_mesh(mesh, case.rules(mesh)):
        pre, (pmeta, _, _), (psh, bsh, _), pre_out = build_prefill(
            cfg, ShapeConfig("p", "prefill", case.prompt, case.batch), mesh)
        dec, dmeta, dsh, dec_out = build_decode(
            cfg, ShapeConfig("d", "decode", case.max_len, case.batch), mesh)
        csh = dsh[2]
        params = kvcache.place(model_params_from_numpy(
            unflatten(inputs, f"{name}/param/"), "cpu"), psh)
        batch = kvcache.place(
            {k: torch.from_numpy(inputs[f"{name}/batch/{k}"].copy())
             for k in bsh}, bsh)
        caches = kvcache.init_blocks(cfg, case.batch, case.max_len, csh,
                                     "cpu")
        ok = (_shapes_ok(params, pmeta, psh)
              and _shapes_ok(caches, dmeta[2], csh))

        repeats = [0]
        plain_repeat = attention._maybe_repeat_kv
        attention._maybe_repeat_kv = _counting_repeats(repeats)
        try:
            logits, caches = pre(params, batch, caches)
        finally:
            attention._maybe_repeat_kv = plain_repeat
        out["prefill_repeats"] = np.int64(repeats[0])
        out["prefill_block_shape"] = np.asarray(logits.shape)
        ok &= fsdp.spec_of(logits) == pre_out["out_shardings"][0].spec
        full = pre_out["out_shardings"][0].gather(logits)
        out["prefill_logits"] = full.float().numpy()

        def next_token(full, i):
            if forced is not None:
                return torch.from_numpy(forced[:, i:i + 1].copy())
            return torch.argmax(full[:, -1], dim=-1).to(torch.int32)[:, None]

        tok = next_token(full, 0)
        toks, steps = [tok], []
        extra = ()
        if cfg.is_encoder_decoder:
            extra = (kvcache.place(
                (torch.from_numpy(inputs[f"{name}/enc_states"].copy()),
                 torch.from_numpy(inputs[f"{name}/enc_positions"].copy())),
                dsh[4]),)
        for i in range(DECODE_STEPS):
            logits, caches = dec(params, kvcache.place(tok, dsh[1]), caches,
                                 case.prompt + i, *extra)
            full = dec_out["out_shardings"][0].gather(logits)
            steps.append(full.float().numpy())
            if i + 1 < DECODE_STEPS or forced is None:
                tok = next_token(full, i + 1)
                toks.append(tok)
        ok &= _shapes_ok(caches, dmeta[2], csh)
        out["decode_logits"] = np.stack(steps)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        out["cache_bytes"] = np.int64(sum(
            t.numel() * t.element_size() for t in tree_leaves(caches)
            if isinstance(t, torch.Tensor)))
        for key, leaf in tree_items(caches_to_numpy(
                tree_map(fsdp.full_value, caches))):
            out["cache/" + key] = leaf
    out["shapes_ok"] = np.bool_(ok)
    return {f"{name}.{k}": v for k, v in out.items()}


def serve_one_rank(mesh, inputs_path: str, names) -> Dict[str, np.ndarray]:
    """Every case of ``names`` on this spawn's mesh (one rank: (1, 1)),
    whatever mesh the case names."""
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    out = {}
    for name in names:
        out.update(serve_case(name, CASES[name], mesh, inputs))
    return out


def sharded_train(mesh, inputs, tag: str, name: str, dtype: str,
                  eps: Optional[float]) -> Dict[str, np.ndarray]:
    """``PR.STEP_STEPS`` steps of ``build_train``'s plain sharded step on
    ``PR.STEP_CFGS[name]`` in ``dtype``, AdamW's eps ``eps`` (None: the
    default), from the parameters under
    ``train/<name>/param/``: the losses, the last grad norm and every
    parameter's full value, under ``tag``."""
    from repro_torch.data.tokens import make_batch, shard_batch

    out = {}
    cfg = dataclasses.replace(PR.STEP_CFGS[name], dtype=dtype)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, (psh, osh, _), _ = build_train(cfg, PR.STEP_SHAPE, mesh,
                                              opt_config(eps))
        full = tree_map(lambda t: t.requires_grad_(True),
                        model_params_from_numpy(
                            unflatten(inputs, f"train/{name}/param/"), "cpu"))
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        losses = []
        for i in range(PR.STEP_STEPS):
            batch = shard_batch(make_batch(cfg, PR.STEP_SHAPE, 0, i), mesh)
            params, opt, m = fn(params, opt, batch)
            losses.append(float(m["loss"]))
        out[f"{tag}.losses"] = np.asarray(losses)
        out[f"{tag}.grad_norm"] = np.asarray(float(m["grad_norm"]))
        for key, leaf in tree_items(params):
            out[f"{tag}.param." + key.replace("/", ".")] = fsdp.full_value(
                leaf).detach().numpy()
    return out


def serve_all(mesh, inputs_path: str, names) -> Dict[str, np.ndarray]:
    """Every case of ``names`` on its mesh (built from the 8 ranks; the
    spawn's own (4, 2) mesh serves its cases), then the sharded train step
    of each run of ``TRAIN_RUNS``.
    Rank 0 returns the values; every rank returns whether its blocks held
    their local shapes."""
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    meshes = {(4, 2): mesh}
    out = {}
    for name in names:
        case = CASES[name]
        if case.mesh not in meshes:
            meshes[case.mesh] = _mesh(case.mesh)
        out.update(serve_case(name, case, meshes[case.mesh], inputs))
    if any(k.startswith("train/") for k in inputs):
        for tag, name, dims, dtype, eps in TRAIN_RUNS:
            if dims not in meshes:
                meshes[dims] = _mesh(dims)
            out.update(sharded_train(meshes[dims], inputs, tag, name, dtype,
                                     eps))
    if torch.distributed.get_rank() != 0:
        out = {k: v for k, v in out.items()
               if k.endswith((".shapes_ok", ".cache_bytes",
                              ".prefill_block_shape"))}
    return out
