"""The port's parallel layer on gloo ranks against the live reference.

* The sharded train step (``launch.specs.build_train``, plain and
  ``zero1=True``, each with one microbatch and remat ``none`` and with two
  microbatches and remat ``selective``) on 8 ranks, mesh (4, 2), at the
  reference's sharded-step config (``tests/test_distributed.py``), against
  the reference's jitted single-device step with the same microbatches
  (the reference's own sharded step raises ``DuplicateSpecError`` on
  ``jax.make_mesh``'s Explicit axes and runs on Auto axes, where
  ``tests/test_torch_serve_mesh.py`` holds the plain (4, 2) step against
  it; ROADMAP queue 3). Each rank's block of every parameter and moment
  holds its full size over its spec's axes, a step on a batch with a loss
  mask divides by the whole batch's mask sum as the reference's does, and
  a whole-array checkpoint restores onto the mesh bit for bit.
* Compressed DP on 2 ranks against the reference's run on 2 forced host
  devices, and its own drift against the exact step (the reference
  test's bounds); ``pipeline_apply`` on 4 ranks against the reference's
  on 4 forced devices and against the sequential loop.
* ``_maybe_repeat_kv`` and ``launch.train --mesh`` (an MoE config too,
  on a mesh that splits the batch and on one that does not).

One spawn per mesh shape (module-scoped fixtures); the reference runs
its multi-device parts in one subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.data.tokens import make_batch as jmake_batch
from repro.models import attention as jattention
from repro.models.model import Model as JModel
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.parallel import sharding as jsharding
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import config as tconfig
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.core import prng
from repro_torch.data.tokens import make_batch, to_device
from repro_torch.interop import model_params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.specs import batch_ranks
from repro_torch.models import attention as tattention
from repro_torch.models.model import Model as TModel
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as tsharding
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_items

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_ranks as R  # noqa: E402

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(v)
    return out


def jax_cfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    return jconfig.ModelConfig(**{f.name: getattr(cfg, f.name)
                                  for f in dataclasses.fields(cfg)})


# ---------------------------------------------------------------------------
# The sharded train step, 8 ranks on (4, 2)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """({(config, microbatches): the reference's losses, grad norm and
    parameters of its jitted single-device steps}, {mesh: the ranks'
    results}): one spawn of 8 ranks per mesh of ``R.STEP_MESHES``."""
    ref, params_by_cfg = {}, {}
    for name, cfg in R.STEP_CFGS.items():
        jp = JModel(jax_cfg(cfg)).init(jax.random.key(0))
        params_by_cfg[name] = flatten(jax.tree.map(np.asarray, jp))
        for tag in ("plain", "plain.micro2"):
            _, micro, _ = R.STEP_VARIANTS[tag]
            jm = JModel(jax_cfg(R.step_cfg(tag, name)))
            step = jax.jit(jmake_train_step(
                jm, jconfig.OptimizerConfig(),
                jconfig.ParallelConfig(microbatches=micro)))
            p, s = jp, jinit_opt_state(jp)
            losses = []
            for i in range(R.STEP_STEPS):
                batch = jmake_batch(jm.cfg, R.STEP_SHAPE, 0, i)
                p, s, m = step(p, s, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
                losses.append(float(m["loss"]))
            one = {"losses": losses, "grad_norm": float(m["grad_norm"]),
                   "params": flatten(jax.tree.map(np.asarray, p))}
            masked = {k: jnp.asarray(v) for k, v in
                      R.masked_batch(R.STEP_SHAPE, cfg).items()}
            one["per_rank_loss"] = {
                dims[0]: _per_rank_masked_loss(jm, p, masked, micro, dims[0])
                for dims in R.STEP_MESHES}
            p, s, m = step(p, s, masked)
            one["masked"] = {
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "params": flatten(jax.tree.map(np.asarray, p))}
            ref[name, micro] = one

    # a whole-array checkpoint of the port's plain step, to restore
    tmp = tmp_path_factory.mktemp("parallel")
    tm = TModel(R.STEP_CFG, "cpu")
    tp = tm.load_params(model_params_from_numpy(
        R.unflatten(params_by_cfg["step"]), "cpu"), trainable=True)
    ts = init_opt_state(tp)
    tp, ts, _ = make_train_step(tm, tconfig.OptimizerConfig())(
        tp, ts, to_device(make_batch(R.STEP_CFG, R.STEP_SHAPE, 0, 0), "cpu"))
    ckpt = tmp / "ckpt"
    CheckpointManager(str(ckpt), async_save=False).save(
        1, {"params": tp, "opt": ts}, extra={"step": 1})
    np.savez(ckpt / "blocks.npz", **{
        k: v.detach().numpy() for k, v in tree_items({"params": tp,
                                                      "opt": ts})})
    ranks = {dims: run_ranks(R.sharded_steps, 8, dims, "gloo", tmp,
                             params_by_cfg, str(ckpt), 1)
             for dims in R.STEP_MESHES}
    return ref, ranks


def _per_rank_masked_loss(jm, params, batch, micro: int, ranks: int):
    """The masked loss of ``batch`` as ``ranks`` ranks would take it if each
    divided by its own mask sum: per microbatch the mean over the ranks'
    row blocks of each block's masked mean NLL (the reference's logits),
    averaged over the microbatches."""
    logits, _ = jm.forward(params, batch)
    logits = np.asarray(logits[:, :-1], np.float64)
    labels = np.asarray(batch["tokens"][:, 1:])
    logz = np.log(np.sum(np.exp(logits - logits.max(-1, keepdims=True)),
                         -1)) + logits.max(-1)
    nll = logz - np.take_along_axis(logits, labels[..., None], -1)[..., 0]
    mask = np.asarray(batch["loss_mask"], np.float64)
    b = nll.shape[0]
    means = [[np.sum((nll * mask)[rows]) / np.sum(mask[rows])
              for rows in np.array_split(np.arange(i * b // micro,
                                                   (i + 1) * b // micro),
                                         ranks)]
             for i in range(micro)]
    return float(np.mean(means))


TAGS = list(R.STEP_VARIANTS)

#: (mesh, config, variant) of the sharded-step tests: the variants of the
#: reference's sharded-step config on (4, 2) keep their tags as ids; the
#: others read "<mesh>-<config>-<tag>"
CASES = {tag: ((4, 2), "step", tag) for tag in TAGS}
CASES.update({f"{d[0]}x{d[1]}-{name}-{tag}": (d, name, tag)
              for d in R.STEP_MESHES for name in R.STEP_CFGS for tag in TAGS
              if (d, name) != ((4, 2), "step")})


def _case(refs, ranks, case):
    """(the reference's run, the mesh's ranks, the results' key prefix, the
    mesh) of a case."""
    dims, name, tag = CASES[case]
    return (refs[name, R.STEP_VARIANTS[tag][1]], ranks[dims],
            f"{name}.{tag}", dims)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_loss_matches_reference(sharded, tag):
    refs, ranks = sharded
    ref, ranks, key, _ = _case(refs, ranks, tag)
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r[f"{key}.losses"], ref["losses"]))
    print(f"sharded {tag}: losses within {rel:.3e} relative")
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}.losses"], ref["losses"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(r[f"{key}.grad_norm"], ref["grad_norm"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_step_params_match_reference(sharded, tag):
    refs, ranks = sharded
    ref, ranks, key, _ = _case(refs, ranks, tag)
    worst = 0.0
    for name, want in ref["params"].items():
        for r in ranks:
            err = parity.assert_close(r[f"{key}.param.{name}"], want,
                                      rtol=0.0,
                                      atol_frac=parity.LM_GRAD_ATOL_FRAC,
                                      what=f"{tag} {name}")
            worst = max(worst, err / max(float(np.max(np.abs(want))),
                                         1e-30))
    print(f"sharded {tag}: parameters within {worst:.3e} of a leaf's max")


@pytest.mark.parametrize("tag", list(CASES))
def test_sharded_blocks_hold_their_share(sharded, tag):
    """Each rank's block of every parameter, m and v == full size / the
    product of the mesh axes in its spec."""
    refs, ranks = sharded
    _, ranks, key, _ = _case(refs, ranks, tag)
    assert all(bool(r[f"{key}.sizes_ok"]) for r in ranks)


@pytest.mark.parametrize("tag", list(CASES))
def test_split_batch_refuses_a_loss_mask(sharded, tag):
    """A loss mask on the batch split over the ranks of ``data``: one
    step on ``R.masked_batch`` after the ``R.STEP_STEPS`` steps. The
    reference divides by the whole microbatch's mask sum, so each rank
    does too: the loss, the grad norm and every parameter within
    ``parity.LM_GRAD_ATOL_FRAC`` of the reference's. The mask sums differ
    between the ranks, and dividing by each rank's own would give another
    loss."""
    refs, ranks = sharded
    ref, ranks, key, dims = _case(refs, ranks, tag)
    micro = R.STEP_VARIANTS[CASES[tag][2]][1]
    mask = R.loss_mask(R.STEP_SHAPE)
    sums = [float(blk.sum()) for mb in np.split(mask, micro)
            for blk in np.split(mb, dims[0])]
    assert len(set(sums)) > 1, sums
    want = ref["masked"]
    own = ref["per_rank_loss"][dims[0]]
    gap = abs(own - want["loss"]) / want["loss"]
    assert gap > 10 * parity.LM_GRAD_ATOL_FRAC, gap
    worst = (0.0, "")
    for r in ranks:
        np.testing.assert_allclose(r[f"{key}.masked.loss"], want["loss"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(r[f"{key}.masked.grad_norm"],
                                   want["grad_norm"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        for name, value in want["params"].items():
            err = parity.assert_close(r[f"{key}.masked.param.{name}"], value,
                                      rtol=0.0,
                                      atol_frac=parity.LM_GRAD_ATOL_FRAC,
                                      what=f"{tag} masked {name}")
            worst = max(worst, (err / max(float(np.max(np.abs(value))),
                                          1e-30), name))
    print(f"sharded {tag}: masked loss {want['loss']:.6f}; each rank's own "
          f"denominator would give {own:.6f} ({gap:.2e} "
          f"relative); parameters within {worst[0]:.3e} of a leaf's max "
          f"({worst[1]})")


@pytest.mark.parametrize("dims", R.STEP_MESHES)
def test_kv_heads_repeat_where_model_does_not_divide_them(sharded, dims):
    """On (2, 4) the 4 ranks of ``model`` split the 4 heads, not the 2 kv
    heads: every attention call of every variant goes through
    ``_maybe_repeat_kv``, which repeats this rank's kv heads, as the
    reference's GSPMD step does; on (4, 2) the kv heads split and nothing
    repeats."""
    _, ranks = sharded
    for r in ranks[dims]:
        for name, cfg in R.STEP_CFGS.items():
            for tag in TAGS:
                n = int(r[f"{name}.{tag}.repeats"])
                if dims == (2, 4):
                    # a call a layer a microbatch a step, and one more a
                    # layer for each segment remat recomputes
                    assert n >= cfg.num_layers * R.STEP_STEPS, (name, tag)
                else:
                    assert n == 0, (name, tag)


@pytest.mark.parametrize("dims, split", [((4, 2), True), ((1, 2), False)])
def test_split_batch_refuses_moe(tmp_path, dims, split):
    """``launch.train --mesh`` trains deepseek-moe's smoke config (float32)
    on a mesh that splits the batch over 4 ranks and on one that splits
    none: the MoE FFN routes over the whole batch either way, and both
    runs' losses match the one-rank run's within
    ``parity.LM_GRAD_ATOL_FRAC``."""
    mesh = _StandIn(**dict(zip(("data", "model"), dims)))
    shape = tconfig.ShapeConfig("cli", "train", 32, 8)
    assert (batch_ranks(shape, mesh) > 1) == split
    common = ["--arch", "deepseek-moe-16b", "--smoke", "--device", "cpu",
              "--steps", "2", "--batch", "8", "--seq", "32", "--set",
              "dtype=float32"]
    one = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    ranks = launch_train.main(common + ["--mesh", "x".join(map(str, dims)),
                                        "--ckpt-dir", str(tmp_path / "mesh")])
    assert ranks.steps_run == one.steps_run == 2
    np.testing.assert_allclose(ranks.losses, one.losses,
                               rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)


@pytest.mark.parametrize("arch, dims, split", [
    ("qwen3-32b", (16, 16), {"heads": True, "kv_heads": False, "mlp": True,
                             "vocab": True, "seq": True}),
    ("nemotron-4-15b", (2, 16, 16), {"heads": True, "kv_heads": False,
                                     "mlp": True, "vocab": True,
                                     "seq": True}),
    ("gemma2-2b", (16, 16), {"heads": False, "kv_heads": False,
                             "mlp": False, "vocab": False, "seq": False}),
    ("gemma2-2b", (2, 16, 16), {"heads": False, "kv_heads": False,
                                "mlp": True, "vocab": True, "seq": True}),
])
def test_split_decisions_follow_build_spec(arch, dims, split):
    """The split over ``model`` of each activation dim of a ``train_4k``
    step on a production mesh (``fsdp.splits``, under ``act_rules_for``)
    == the reference's ``build_spec`` giving that dim ``model`` under the
    same rules, after the batch took its axes: 8 kv heads on 16 ranks do
    not split (they are repeated); gemma2-2b's 8 heads on 16 take
    ``DP_ACT_RULES``, whose batch takes ``model`` at 256 ranks (nothing
    splits) but not at 512, where its MLP columns, vocab and sequence split
    and its heads do not."""
    cfg = tconfig.get_config(arch)
    shape = tconfig.SHAPES["train_4k"]
    axes = ("pod", "data", "model")[-len(dims):]
    mesh = _StandIn(**dict(zip(axes, dims)))
    rules = tsharding.act_rules_for(cfg, mesh)
    jmesh = _StandIn(**dict(zip(axes, dims)))
    jrules = jsharding.act_rules_for(jax_cfg(cfg), jmesh)
    sizes = {"heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
             "mlp": cfg.d_ff, "vocab": cfg.padded_vocab,
             "seq": shape.seq_len}
    bspec = jsharding.build_spec((shape.global_batch,), ("batch",), jmesh,
                                 jrules)
    layout = fsdp.make_layout(mesh, tsharding.spec_axes(bspec[0]),
                              split=True)
    with tsharding.use_mesh(mesh, rules), fsdp.use_layout(layout):
        for name, dim in sizes.items():
            spec = jsharding.build_spec((shape.global_batch, dim),
                                        ("batch", name), jmesh, jrules)
            want = "model" in tsharding.spec_axes(spec[1])
            assert fsdp.splits(name, dim) == want == split[name], name


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-32b", "nemotron-4-15b",
                                  "stablelm-12b", "gemma2-2b"])
def test_rank_computes_its_share(arch, m):
    """Rank 0 of a (1, m) mesh on a fake world: ``build_train``'s step on
    a dense smoke config computes its share of the one-rank step's FLOPs
    (``launch.dryrun.measure``, op_cost on meta tensors): at least 1 / m
    of them and at most 1.25 / m. On 4 ranks the 2 kv heads are repeated,
    so a rank projects a whole kv head for its one q head."""
    cfg = tconfig.get_config(arch, smoke=True)
    shape = tconfig.ShapeConfig("t", "train", 32, 2)
    with fake_world(m):
        got = dryrun.measure(cfg, shape, make_mesh((1, m),
                                                   ("data", "model")))
    share = got["flops"] / got["flops_one_rank"]
    print(f"{arch} smoke on (1, {m}): rank 0 computes {share:.4f} of the "
          f"one-rank step's {got['flops_one_rank']} FLOPs (x{m}: "
          f"{share * m:.4f})")
    assert 1 / m <= share <= 1.25 / m
    assert got["replicated_compute"] <= 1.25


@pytest.mark.parametrize("specs, raises", [
    # the parameter rules left ``model`` off the MLP's columns
    ({"w_up": (None, None), "w_down": (None, None)}, True),
    ({"w_up": (None, "model"), "w_down": ("model", None)}, False),
])
def test_split_segment_needs_a_model_block(specs, raises):
    """Under a layout that splits over ``model`` (rank 0 of (1, 2) on a
    fake world), ``gathered(..., keep=True)`` of a segment the act rules
    split raises where none of its leaves' specs holds a ``model`` block:
    every rank would compute the whole product and the reduce-scatter
    would sum it twice. Where the blocks are there it keeps them."""
    with fake_world(2):
        mesh = make_mesh((1, 2), ("data", "model"))
        tree = {k: fsdp.mark(torch.zeros(4 if spec[0] is None else 2,
                                         4 if spec[1] is None else 2), spec)
                for k, spec in specs.items()}
        with fsdp.use_layout(fsdp.make_layout(mesh, (), split=True)):
            if raises:
                with pytest.raises(ValueError, match="disagree"):
                    fsdp.gathered(tree, keep=True)
            else:
                out = fsdp.gathered(tree, keep=True)
                assert {k: tuple(v.shape) for k, v in out.items()} == {
                    "w_up": (4, 2), "w_down": (2, 4)}


@pytest.mark.parametrize("tag", list(R.ONE_RANK))
def test_one_rank_mesh_gives_the_plain_bits(tmp_path, tag):
    """On a (1, 1) mesh every collective and slice of the sharded step is
    skipped, the split over ``model`` included: ``build_train``'s step
    (plain or ZeRO-1) gives the plain ``make_train_step``'s losses, grad
    norms and parameters bit for bit, in float32 and in bfloat16 with two
    microbatches and remat ``selective``."""
    cfg, _, micro = R.ONE_RANK[tag]
    tm = TModel(cfg, "cpu")
    drawn = tm.init(prng.key(0))
    params_np = {k.replace("/", "."): v.numpy()
                 for k, v in tree_items(drawn)}
    tp = tm.load_params(model_params_from_numpy(R.unflatten(params_np),
                                                "cpu"), trainable=True)
    ts = init_opt_state(tp)
    step = make_train_step(tm, tconfig.OptimizerConfig(),
                           tconfig.ParallelConfig(microbatches=micro))
    metrics = []
    for i in range(R.STEP_STEPS):
        tp, ts, m = step(tp, ts, to_device(
            make_batch(cfg, R.STEP_SHAPE, 0, i), "cpu"))
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
    (got,) = run_ranks(R.one_rank_steps, 1, (1, 1), "gloo", tmp_path, tag,
                       params_np)
    np.testing.assert_array_equal(got["metrics"], np.asarray(metrics))
    for key, want in tree_items(tp):
        np.testing.assert_array_equal(
            got["param." + key.replace("/", ".")], want.detach().numpy(),
            err_msg=key)


def test_elastic_restore_onto_mesh_is_bitwise(sharded):
    """A whole-array checkpoint restores onto (4, 2) and (2, 4), every
    block the saved array's block under its spec, bit for bit."""
    _, meshes = sharded
    for ranks in meshes.values():
        assert all(bool(r["restore.bitwise"]) for r in ranks)
        assert all(int(r["restore.step"]) == 1 for r in ranks)


def test_moe_on_an_unsplit_batch_matches_one_device(tmp_path):
    """deepseek-moe's smoke config on a (1, 2) mesh (the batch whole on
    every rank, parameters split over ``model``), two microbatches:
    every rank's losses and parameters against the port's single-device
    step from the same parameters."""
    cfg = R.MOE_CFG
    tm = TModel(cfg, "cpu")
    drawn = tm.init(prng.key(0))
    params_np = {k.replace("/", "."): v.numpy()
                 for k, v in tree_items(drawn)}
    tp = tm.load_params(model_params_from_numpy(R.unflatten(params_np),
                                                "cpu"), trainable=True)
    ts = init_opt_state(tp)
    step = make_train_step(tm, tconfig.OptimizerConfig(),
                           tconfig.ParallelConfig(microbatches=2))
    losses = []
    for i in range(R.STEP_STEPS):
        tp, ts, m = step(tp, ts, to_device(
            make_batch(cfg, R.MOE_SHAPE, 0, i), "cpu"))
        losses.append(float(m["loss"]))
    ranks = run_ranks(R.moe_steps, 2, (1, 2), "gloo", tmp_path, params_np)
    worst = 0.0
    for r in ranks:
        assert bool(r["experts_split"])
        np.testing.assert_allclose(r["losses"], losses,
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        for key, want in tree_items(tp):
            want = want.detach().numpy()
            err = parity.assert_close(
                r["param." + key.replace("/", ".")], want, rtol=0.0,
                atol_frac=parity.LM_GRAD_ATOL_FRAC, what=f"moe {key}")
            worst = max(worst, err / max(float(np.max(np.abs(want))),
                                         1e-30))
    print(f"moe (1, 2): parameters within {worst:.3e} of a leaf's max")


# ---------------------------------------------------------------------------
# Compressed DP (2 ranks) and GPipe (4 ranks) against the reference
# ---------------------------------------------------------------------------

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from repro.config import ModelConfig, OptimizerConfig, ShapeConfig
from repro.data.tokens import make_batch
from repro.models.model import Model
from repro.optim.adamw import init_opt_state
from repro.parallel.pipeline import pipeline_apply
from repro.train.compressed_dp import (init_compressed_state,
                                       make_compressed_train_step)

out = sys.argv[1]
inputs = np.load(out + "/pipe_in.npz")
mesh = jax.make_mesh((4,), ("stage",))
params = {"w": jnp.asarray(inputs["w"]), "b": jnp.asarray(inputs["b"])}
y = pipeline_apply(lambda p, h: jnp.tanh(h @ p["w"] + p["b"]), params,
                   jnp.asarray(inputs["x"]), mesh, "stage")

cfg = ModelConfig(**json.loads(sys.argv[2]))
shape = ShapeConfig("t", "train", seq_len=32, global_batch=4)
opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=0, total_steps=50,
                          schedule="constant")
model = Model(cfg)
p = model.init(jax.random.key(0))
flat = {"/".join(str(k.key) for k in path): np.asarray(v)
        for path, v in jax.tree_util.tree_flatten_with_path(p)[0]}
pod = jax.make_mesh((2,), ("pod",), devices=jax.devices()[:2])
s = init_compressed_state(p, init_opt_state(p))
step = jax.jit(make_compressed_train_step(model, opt_cfg, pod))
losses = []
for t in range(10):
    batch = {k: jnp.asarray(v) for k, v in make_batch(cfg, shape, 0, t).items()}
    p, s, m = step(p, s, batch)
    losses.append(float(m["loss"]))
np.savez(out + "/ref.npz", y=np.asarray(y), losses=np.asarray(losses),
         **{"param." + k: v for k, v in flat.items()})
"""


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    """The reference's GPipe on 4 forced devices and its compressed DP on
    2, in one subprocess; the pipeline's inputs drawn here from a numpy
    seed."""
    tmp = tmp_path_factory.mktemp("parallel_ref")
    rng = np.random.default_rng(0)
    n_stages, n_micro, mb, d = 4, 8, 2, 16
    pipe = {"w": (rng.standard_normal((n_stages, d, d)) * 0.3
                  ).astype(np.float32),
            "b": (rng.standard_normal((n_stages, d)) * 0.1
                  ).astype(np.float32),
            "x": rng.standard_normal((n_micro, mb, d)).astype(np.float32)}
    np.savez(tmp / "pipe_in.npz", **pipe)
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    cfg = {f.name: getattr(R.DP_CFG, f.name)
           for f in dataclasses.fields(R.DP_CFG)
           if f.name in ("num_layers", "d_model", "num_heads",
                         "num_kv_heads", "d_ff", "vocab_size", "remat",
                         "dtype")}
    proc = subprocess.run([sys.executable, "-c", REF_SCRIPT, str(tmp),
                           json.dumps(cfg)], env=env, capture_output=True,
                          text=True, timeout=600, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(tmp / "ref.npz") as f:
        ref = {k: f[k] for k in f.files}
    return pipe, ref, tmp


def test_compressed_dp_matches_reference_and_tracks_exact(reference_runs):
    pipe, ref, tmp = reference_runs
    params_np = {k[len("param."):].replace("/", "."): v
                 for k, v in ref.items() if k.startswith("param.")}
    ranks = run_ranks(R.compressed_steps, 2, (2,), "gloo", tmp, params_np,
                      axes=("pod",))
    # the exact step on one rank, from the same parameters
    tm = TModel(R.DP_CFG, "cpu")
    tp = tm.load_params(model_params_from_numpy(R.unflatten(params_np),
                                                "cpu"), trainable=True)
    ts = init_opt_state(tp)
    step = make_train_step(tm, R.DP_OPT)
    exact = []
    for t in range(R.DP_STEPS):
        tp, ts, m = step(tp, ts, to_device(
            make_batch(R.DP_CFG, R.DP_SHAPE, 0, t), "cpu"))
        exact.append(float(m["loss"]))
    for r in ranks:
        rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                       ref["losses"]))
        print(f"compressed: losses within {rel:.3e} relative of the "
              f"reference's")
        np.testing.assert_allclose(r["losses"], ref["losses"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        drift = max(abs(a - b) for a, b in zip(exact, r["losses"]))
        print(f"compressed: drift {drift:.4e}, final gap "
              f"{abs(exact[-1] - r['losses'][-1]):.4e} against the exact "
              "step")
        assert exact[-1] < exact[0]
        assert drift < 0.08, (drift, exact, r["losses"])
        assert abs(exact[-1] - r["losses"][-1]) < 0.05


def test_pipeline_matches_reference_and_sequential(reference_runs):
    pipe, ref, tmp = reference_runs
    ranks = run_ranks(R.pipeline_stages, 4, (4,), "gloo", tmp, pipe["w"],
                      pipe["b"], pipe["x"], axes=("stage",))
    seq = torch.from_numpy(pipe["x"])
    for s in range(4):
        seq = torch.tanh(seq @ torch.from_numpy(pipe["w"][s])
                         + torch.from_numpy(pipe["b"][s]))
    for r in ranks:
        d_seq = float(np.max(np.abs(r["y"] - seq.numpy())))
        d_ref = float(np.max(np.abs(r["y"] - ref["y"])))
        print(f"pipeline: {d_seq:.3e} from the sequential loop, {d_ref:.3e} "
              "from the reference's")
        assert d_seq < 1e-5
        assert d_ref < 1e-5


# ---------------------------------------------------------------------------
# _maybe_repeat_kv, launch.train --mesh
# ---------------------------------------------------------------------------

class _StandIn:
    """A mesh stand-in: both packages read only its ``.shape``."""

    def __init__(self, **shape):
        self.shape = shape


def test_repeat_kv_decision_and_values(monkeypatch):
    """Heads 8 and kv heads 2 on a model axis of 4: both packages repeat
    the kv heads, and the attention over the repeated heads equals the
    attention over the grouped ones."""
    mesh = _StandIn(data=1, model=4)
    rng = np.random.default_rng(3)
    k = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 16, 2, 8)).astype(np.float32)
    monkeypatch.setattr(jattention, "logical", lambda x, names: x)
    monkeypatch.setattr(jsharding._state, "mesh", mesh, raising=False)
    monkeypatch.setattr(jsharding._state, "act_rules", None, raising=False)
    jk, _ = jattention._maybe_repeat_kv(jnp.asarray(k), jnp.asarray(v), 8)
    monkeypatch.undo()
    with tsharding.use_mesh(mesh):
        tk, tv = tattention._maybe_repeat_kv(torch.from_numpy(k),
                                             torch.from_numpy(v), 8)
    assert tk.shape[2] == jk.shape[2] == 8
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))

    q = torch.from_numpy(rng.standard_normal((2, 16, 8, 8)).astype(
        np.float32))
    pos = torch.arange(16, dtype=torch.int32)[None].expand(2, 16)
    plain = tattention.flash_attention(q, torch.from_numpy(k),
                                       torch.from_numpy(v), pos, pos,
                                       causal=True)
    repeated = tattention.flash_attention(q, tk, tv, pos, pos, causal=True)
    np.testing.assert_allclose(repeated.numpy(), plain.numpy(), rtol=0,
                               atol=1e-6 * float(plain.abs().max()))


def test_launch_train_mesh_matches_one_rank(tmp_path):
    """``launch.train --mesh 2x2`` on gemma2-2b's smoke config in float32
    against the one-rank run, held to ``parity.LM_GRAD_ATOL_FRAC``. The
    mesh splits the products over the 2 ranks of ``model``; in bfloat16
    its partial sums round apart from the one rank's whole products
    (``test_launch_train_mesh_bf16_matches_one_rank``)."""
    common = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "32", "--set",
              "dtype=float32"]
    one = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    four = launch_train.main(common + ["--mesh", "2x2", "--ckpt-dir",
                                       str(tmp_path / "four")])
    assert four.steps_run == one.steps_run == 3
    np.testing.assert_allclose(four.losses, one.losses,
                               rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
    assert os.path.isdir(tmp_path / "four")


def test_launch_train_mesh_bf16_matches_one_rank(tmp_path):
    """The same runs in gemma2-2b's own bfloat16: the mesh's bfloat16
    partial sums over ``model`` round apart from the one rank's whole
    products, as the reference's sharded bfloat16 step rounds apart from
    its single-device step; the losses are held to
    ``parity.LM_BF16_SPLIT_RTOL``, the rule the reference's sharded step
    meets (``test_torch_serve_mesh.py``,
    ``test_bf16_sharded_train_step_matches_reference_sharded_step``)."""
    common = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "32"]
    one = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    four = launch_train.main(common + ["--mesh", "2x2", "--ckpt-dir",
                                       str(tmp_path / "four")])
    assert four.steps_run == one.steps_run == 3
    rel = np.max(np.abs(np.asarray(four.losses) - np.asarray(one.losses))
                 / np.abs(np.asarray(one.losses)))
    print(f"launch.train --mesh 2x2 bfloat16: losses within {rel:.3e} "
          f"relative of one rank's")
    np.testing.assert_allclose(four.losses, one.losses,
                               rtol=parity.LM_BF16_SPLIT_RTOL, atol=0)


def test_launch_train_mesh_needs_a_card_a_rank(monkeypatch):
    """On the card, more ranks than cards raise (no fallback to gloo)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def refuse(*a, **k):
        raise AssertionError("ranks were started")

    monkeypatch.setattr(launch_train, "run_ranks", refuse)
    with pytest.raises(RuntimeError, match="CUDA devices"):
        launch_train.main(["--arch", "gemma2-2b", "--smoke", "--mesh", "2x1",
                           "--device", "cuda"])
