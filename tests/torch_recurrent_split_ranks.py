"""Rank functions of ``tests/test_torch_recurrent_split.py``: each runs on
every rank of a ``testing.ranks.run_ranks`` spawn and returns a dict of
numpy arrays. They live here, importable without JAX, because spawn
imports a rank function's module anew in every child.

``CFGS``, ``TRAIN`` and ``SERVE`` are shared with the test's reference
subprocess: the smoke configs of mamba2-780m (SSD heads), recurrentgemma-2b
(RG-LRU channels and local MQA) and seamless-m4t-large-v2 (the audio
enc-dec) on (4, 2) and (2, 4) meshes of the 8 ranks, where ``model``
splits the SSD heads, the LRU width, the encoder's and the decoder's
heads and MLP columns (``models.ssm``, ``models.rglru``, ``models.encdec``);
and two fallbacks. "ssm_h2" has SSD heads of 64 channels, so 2 heads,
which ``model`` = 4 does not divide: its SSD segments compute whole.
"hybrid_dp" has 3 attention heads, which send recurrentgemma to
``DP_ACT_RULES``: its batch of 8 rows takes ("data", "model") there, so
its train step splits nothing over ``model``, as the reference's does,
and in serving (whose caches' rows never take ``model``) its attention
stays whole while its RG-LRU channels and MLP columns split.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.config import OptimizerConfig, ShapeConfig, get_config
from repro_torch.data.tokens import make_batch
from repro_torch.interop import caches_to_numpy, model_params_from_numpy
from repro_torch.launch.specs import build_decode, build_prefill, build_train
from repro_torch.models import attention, rglru, ssm
from repro_torch.models.encdec import encode
from repro_torch.models.layers import rmsnorm
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp, kvcache
from repro_torch.parallel import sharding as S
from repro_torch.tree import tree_items, tree_map

import torch_serve_mesh_ranks as SR

#: name -> (arch, overrides of its smoke config: a field's value, or a dict
#: of a nested config's fields)
CFG_SPECS = {
    "ssm": ("mamba2-780m", {}),
    "hybrid": ("recurrentgemma-2b", {}),
    "encdec": ("seamless-m4t-large-v2", {}),
    "ssm_h2": ("mamba2-780m", {"ssm": {"head_dim": 64}}),
    "hybrid_dp": ("recurrentgemma-2b", {"num_heads": 3}),
}


def make_config(arch: str, overrides, **fields):
    """``arch``'s smoke config with ``overrides`` (``CFG_SPECS``) and
    ``fields``."""
    cfg = get_config(arch, smoke=True)
    for key, value in overrides.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, key), **value)
        cfg = dataclasses.replace(cfg, **{key: value})
    return dataclasses.replace(cfg, **fields)


CFGS = {name: make_config(*spec) for name, spec in CFG_SPECS.items()}

#: the train steps' shape: 8 rows of 32 positions (two SSD chunks of 16,
#: four of recurrentgemma's windows), which split over 4 ranks of ``data``
#: or of ``model``
SHAPE = ShapeConfig("t", "train", seq_len=32, global_batch=8)
STEPS = 2
#: AdamW's eps: 1, so that an update is linear in its gradient (ROADMAP
#: queue 3, gap 12; ``torch_split_batch_ranks.OPT_EPS``)
OPT_EPS = 1.0
DECODE_STEPS = 4


class Run(NamedTuple):
    """A train run: config name, mesh, dtype, remat."""

    cfg: str
    mesh: Tuple[int, int]
    dtype: str = "float32"
    remat: str = "none"

    def config(self):
        return dataclasses.replace(CFGS[self.cfg], dtype=self.dtype,
                                   remat=self.remat)


#: tag -> train run; the (2, 4) runs of the three families recompute their
#: segments (remat ``selective``; the enc-dec's encoder layers whole),
#: collectives included
TRAIN = {
    "ssm.4x2": Run("ssm", (4, 2)),
    "ssm.2x4": Run("ssm", (2, 4), remat="selective"),
    "hybrid.4x2": Run("hybrid", (4, 2)),
    "hybrid.2x4": Run("hybrid", (2, 4), remat="selective"),
    "encdec.4x2": Run("encdec", (4, 2)),
    "encdec.2x4": Run("encdec", (2, 4), remat="selective"),
    "ssm_h2.2x4": Run("ssm_h2", (2, 4)),
    "hybrid_dp.4x2": Run("hybrid_dp", (4, 2)),
    "ssm.bf16.2x4": Run("ssm", (2, 4), "bfloat16"),
}
#: the train runs the reference also takes on one device: the bfloat16
#: run's single-device gap
TRAIN_SINGLE = ("ssm.bf16.2x4",)


class Serve(NamedTuple):
    """A serving case (float32): config name, mesh, rows, prompt
    positions, cache slots."""

    cfg: str
    mesh: Tuple[int, int]
    batch: int
    prompt: int
    max_len: int

    def config(self):
        return dataclasses.replace(CFGS[self.cfg], dtype="float32")


#: name -> serving case: an append prefill (12 positions into 32 slots)
#: and decode steps; recurrentgemma's window of 8 slots wraps its ring
SERVE = {
    "ssm.append.4x2": Serve("ssm", (4, 2), 4, 12, 32),
    "hybrid.append.2x4": Serve("hybrid", (2, 4), 4, 12, 32),
    "encdec.append.2x4": Serve("encdec", (2, 4), 4, 12, 32),
    "hybrid_dp.append.4x2": Serve("hybrid_dp", (4, 2), 4, 12, 32),
}


def serve_inputs(name: str, case: Serve, params=None):
    """The prompt tokens of ``case`` and, for the enc-dec, its frames and
    the encoder's states over them (the port's ``encode`` of ``params`` on
    one device, which every decode step takes), from a numpy seed."""
    cfg = case.config()
    rng = np.random.default_rng(sum(map(ord, name)))
    out = {"tokens": rng.integers(0, cfg.vocab_size,
                                  (case.batch, case.prompt), dtype=np.int32)}
    if cfg.is_encoder_decoder:
        out["enc_embeds"] = (rng.standard_normal(
            (case.batch, case.prompt, cfg.d_model)) * 0.02).astype(
                np.float32)
        with torch.no_grad():
            states, positions = encode(params, torch.from_numpy(
                out["enc_embeds"]), cfg)
        out["enc_states"] = states.numpy()
        out["enc_positions"] = positions.contiguous().numpy()
    return out


@contextlib.contextmanager
def probed():
    """Inside the block, the widths of the products each call computes:
    the SSD scan's heads (``ssm.ssd_chunked``, decode steps' included),
    the RG-LRU scan's channels (``rglru._lru_scan``) and the attention's q
    heads (``attention.flash_attention`` and ``attention_state``), each a
    list in call order."""
    seen = {"ssd": [], "lru": [], "attn": []}
    plain = (ssm.ssd_chunked, ssm.ssd_decode_step, rglru._lru_scan,
             attention.flash_attention, attention.attention_state)

    def probe(kind, fn, dim):
        def wrapped(*args, **kw):
            seen[kind].append(args[0].shape[dim])
            return fn(*args, **kw)
        return wrapped

    ssm.ssd_chunked = probe("ssd", plain[0], 2)
    ssm.ssd_decode_step = probe("ssd", plain[1], 2)
    rglru._lru_scan = probe("lru", plain[2], -1)
    attention.flash_attention = probe("attn", plain[3], 2)
    attention.attention_state = probe("attn", plain[4], 2)
    try:
        yield seen
    finally:
        (ssm.ssd_chunked, ssm.ssd_decode_step, rglru._lru_scan,
         attention.flash_attention, attention.attention_state) = plain


def _widths(seen) -> Dict[str, np.ndarray]:
    return {f"widths.{k}": np.asarray(v, dtype=np.int64)
            for k, v in seen.items()}


def _ranks(mesh) -> Dict[str, np.ndarray]:
    return {"data_rank": np.int64(mesh.get_local_rank("data")),
            "model_rank": np.int64(mesh.get_local_rank("model"))}


def train_run(mesh, inputs, tag: str) -> Dict[str, np.ndarray]:
    """``STEPS`` steps of ``build_train``'s step of run ``tag`` from the
    parameters under ``<cfg>/param/``, each batch placed by the builder's
    shardings: the losses, the last grad norm,
    every parameter's full value, the widths this rank computed and its
    place on the mesh."""
    run = TRAIN[tag]
    cfg = run.config()
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, (psh, osh, bsh), _ = build_train(
            cfg, SHAPE, mesh, OptimizerConfig(eps=OPT_EPS))
        full = tree_map(lambda t: t.requires_grad_(True),
                        model_params_from_numpy(
                            SR.unflatten(inputs, f"{run.cfg}/param/"),
                            "cpu"))
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        losses = []
        with probed() as seen:
            for i in range(STEPS):
                # placed as the builder places it (under the arch's act
                # rules, as the reference's step takes it)
                batch = fsdp.place({k: torch.from_numpy(v) for k, v in
                                    make_batch(cfg, SHAPE, 0, i).items()},
                                   bsh)
                params, opt, m = fn(params, opt, batch)
                losses.append(float(m["loss"]))
        out.update(_widths(seen))
        out.update(_ranks(mesh))
        out["losses"] = np.asarray(losses)
        out["grad_norm"] = np.asarray(float(m["grad_norm"]))
        for key, leaf in tree_items(params):
            out["param." + key.replace("/", ".")] = fsdp.full_value(
                leaf).detach().float().numpy()
    return {f"train.{tag}.{k}": v for k, v in out.items()}


def serve_case(name: str, mesh, inputs) -> Dict[str, np.ndarray]:
    """Case ``name`` through ``build_prefill`` and ``build_decode`` on
    ``mesh``: the prefill's and every decode step's full logits, the
    greedy tokens, the caches gathered from the ranks, the widths this
    rank computed and its place on the mesh."""
    case = SERVE[name]
    cfg = case.config()
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        pre, _, (psh, bsh, _), pre_out = build_prefill(
            cfg, ShapeConfig("p", "prefill", case.prompt, case.batch), mesh)
        dec, _, dsh, dec_out = build_decode(
            cfg, ShapeConfig("d", "decode", case.max_len, case.batch), mesh)
        params = kvcache.place(model_params_from_numpy(
            SR.unflatten(inputs, f"{case.cfg}/param/"), "cpu"), psh)
        batch = kvcache.place({k: torch.from_numpy(
            inputs[f"{name}/{k}"].copy()) for k in bsh}, bsh)
        caches = kvcache.init_blocks(cfg, case.batch, case.max_len, dsh[2],
                                     "cpu")
        extra = ()
        if cfg.is_encoder_decoder:
            extra = (kvcache.place(
                (torch.from_numpy(inputs[f"{name}/enc_states"].copy()),
                 torch.from_numpy(inputs[f"{name}/enc_positions"].copy())),
                dsh[4]),)

        def next_token(full):
            return torch.argmax(full[:, -1], dim=-1).to(torch.int32)[:, None]

        with probed() as seen:
            logits, caches = pre(params, batch, caches)
            full = pre_out["out_shardings"][0].gather(logits)
            out["prefill_logits"] = full.float().numpy()
            tok = next_token(full)
            toks, steps = [tok], []
            for i in range(DECODE_STEPS):
                logits, caches = dec(params, kvcache.place(tok, dsh[1]),
                                     caches, case.prompt + i, *extra)
                full = dec_out["out_shardings"][0].gather(logits)
                steps.append(full.float().numpy())
                tok = next_token(full)
                toks.append(tok)
        out.update(_widths(seen))
        out.update(_ranks(mesh))
        out["decode_logits"] = np.stack(steps)
        out["tokens"] = torch.cat(toks, dim=1).numpy()
        for key, leaf in tree_items(caches_to_numpy(
                tree_map(fsdp.full_value, caches))):
            out["cache/" + key] = leaf
    return {f"serve.{name}.{k}": v for k, v in out.items()}


#: the gated RMSNorm's width in ``norm_grads``, and its rows
NORM_WIDTH = 24
NORM_ROWS = (3, 5)


def norm_grads(mesh) -> Dict[str, np.ndarray]:
    """The split gated RMSNorm (``ssm.split_rmsnorm``) on this rank's
    channels of a ``NORM_WIDTH``-channel input under a layout that splits
    over ``model``, and the whole one (``layers.rmsnorm``) on every
    channel: each one's output and the gradients of the input and the
    scale for the loss sum(out * w), the split one's loss summed over the
    ranks of ``model``; and the split one's input gradient where the sum
    of squares is taken by ``fsdp.model_sum`` (whose backward leaves each
    rank's gradient of the sum as it is), to show that rule is wrong
    here. Inputs from a numpy seed, the same on every rank."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal(NORM_ROWS + (NORM_WIDTH,)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(NORM_WIDTH)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)

    def grads(fn, xs, ss, ws):
        xt = torch.from_numpy(xs.copy()).requires_grad_(True)
        st = torch.from_numpy(ss.copy()).requires_grad_(True)
        out = fn(xt, st)
        gx, gs = torch.autograd.grad(torch.sum(out * torch.from_numpy(
            ws.copy())), (xt, st))
        return out.detach().numpy(), gx.numpy(), gs.numpy()

    whole = grads(rmsnorm, x, scale, w)
    layout = fsdp.make_layout(mesh, ("data",), split=True)
    with S.use_mesh(mesh), fsdp.use_layout(layout):
        n, idx = fsdp.split_rank()
        c = NORM_WIDTH // n
        part = slice(idx * c, (idx + 1) * c)
        split = grads(lambda a, b: ssm.split_rmsnorm(a, b, NORM_WIDTH),
                      x[..., part], scale[part], w[..., part])
        plain_sum = fsdp.model_sum_shared
        fsdp.model_sum_shared = fsdp.model_sum
        try:
            identity = grads(lambda a, b: ssm.split_rmsnorm(a, b, NORM_WIDTH),
                             x[..., part], scale[part], w[..., part])
        finally:
            fsdp.model_sum_shared = plain_sum
    return {"norm.whole.out": whole[0][..., part],
            "norm.whole.dx": whole[1][..., part],
            "norm.whole.dscale": whole[2][part],
            "norm.split.out": split[0], "norm.split.dx": split[1],
            "norm.split.dscale": split[2],
            "norm.identity.dx": identity[1]}


def run_all(mesh, inputs_path: str, train, serve) -> Dict[str, np.ndarray]:
    """The train runs ``train``, the serving cases ``serve`` (each on its
    mesh of the 8 ranks: the spawn's own (4, 2) mesh, or (2, 4) built
    here) and the norm's gradients on (4, 2). Every rank returns its
    widths, place and norm gradients; rank 0 everything."""
    with np.load(inputs_path) as f:
        inputs = {k: f[k] for k in f.files}
    meshes = {(4, 2): mesh}

    def on(dims):
        if dims not in meshes:
            meshes[dims] = SR._mesh(dims)
        return meshes[dims]

    out = norm_grads(mesh)
    for tag in train:
        out.update(train_run(on(TRAIN[tag].mesh), inputs, tag))
    for name in serve:
        out.update(serve_case(name, on(SERVE[name].mesh), inputs))
    if torch.distributed.get_rank() != 0:
        out = {k: v for k, v in out.items()
               if ".widths." in k or k.endswith("_rank")
               or k.startswith("norm.")}
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
