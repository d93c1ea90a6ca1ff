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
from repro_torch.launch import train as launch_train
from repro_torch.launch.specs import batch_ranks
from repro_torch.models import attention as tattention
from repro_torch.models.model import Model as TModel
from repro_torch.optim.adamw import init_opt_state
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
    """({microbatches: the reference's losses, grad norm and parameters of
    its jitted single-device steps}, the ranks' results)."""
    jp = JModel(jax_cfg(R.STEP_CFG)).init(jax.random.key(0))
    params_np = flatten(jax.tree.map(np.asarray, jp))
    ref = {}
    for tag in ("plain", "plain.micro2"):
        _, micro, _ = R.STEP_VARIANTS[tag]
        jm = JModel(jax_cfg(R.step_cfg(tag)))
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
        ref[micro] = {"losses": losses, "grad_norm": float(m["grad_norm"]),
                      "params": flatten(jax.tree.map(np.asarray, p))}
        masked = {k: jnp.asarray(v) for k, v in
                  R.masked_batch(R.STEP_SHAPE).items()}
        ref[micro]["per_rank_loss"] = _per_rank_masked_loss(
            jm, p, masked, micro, 4)
        p, s, m = step(p, s, masked)
        ref[micro]["masked"] = {
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "params": flatten(jax.tree.map(np.asarray, p))}

    # a whole-array checkpoint of the port's plain step, to restore
    tmp = tmp_path_factory.mktemp("parallel")
    tm = TModel(R.STEP_CFG, "cpu")
    tp = tm.load_params(model_params_from_numpy(
        R.unflatten(params_np), "cpu"), trainable=True)
    ts = init_opt_state(tp)
    tp, ts, _ = make_train_step(tm, tconfig.OptimizerConfig())(
        tp, ts, to_device(make_batch(R.STEP_CFG, R.STEP_SHAPE, 0, 0), "cpu"))
    ckpt = tmp / "ckpt"
    CheckpointManager(str(ckpt), async_save=False).save(
        1, {"params": tp, "opt": ts}, extra={"step": 1})
    np.savez(ckpt / "blocks.npz", **{
        k: v.detach().numpy() for k, v in tree_items({"params": tp,
                                                      "opt": ts})})
    ranks = run_ranks(R.sharded_steps, 8, (4, 2), "gloo", tmp, params_np,
                      str(ckpt), 1)
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


def _ref(refs, tag):
    return refs[R.STEP_VARIANTS[tag][1]]


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_step_loss_matches_reference(sharded, tag):
    refs, ranks = sharded
    ref = _ref(refs, tag)
    rel = max(abs(a - b) / abs(b) for r in ranks
              for a, b in zip(r[f"{tag}.losses"], ref["losses"]))
    print(f"sharded {tag}: losses within {rel:.3e} relative")
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}.losses"], ref["losses"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(r[f"{tag}.grad_norm"], ref["grad_norm"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_step_params_match_reference(sharded, tag):
    refs, ranks = sharded
    ref = _ref(refs, tag)
    worst = 0.0
    for name, want in ref["params"].items():
        for r in ranks:
            err = parity.assert_close(r[f"{tag}.param.{name}"], want,
                                      rtol=0.0,
                                      atol_frac=parity.LM_GRAD_ATOL_FRAC,
                                      what=f"{tag} {name}")
            worst = max(worst, err / max(float(np.max(np.abs(want))),
                                         1e-30))
    print(f"sharded {tag}: parameters within {worst:.3e} of a leaf's max")


@pytest.mark.parametrize("tag", TAGS)
def test_sharded_blocks_hold_their_share(sharded, tag):
    """Each rank's block of every parameter, m and v == full size / the
    product of the mesh axes in its spec."""
    _, ranks = sharded
    assert all(bool(r[f"{tag}.sizes_ok"]) for r in ranks)


@pytest.mark.parametrize("tag", TAGS)
def test_split_batch_refuses_a_loss_mask(sharded, tag):
    """A loss mask on the batch split over the 4 ranks of ``data``: one
    step on ``R.masked_batch`` after the ``R.STEP_STEPS`` steps. The
    reference divides by the whole microbatch's mask sum, so each rank
    does too: the loss, the grad norm and every parameter within
    ``parity.LM_GRAD_ATOL_FRAC`` of the reference's. The mask sums differ
    between the ranks, and dividing by each rank's own would give another
    loss."""
    refs, ranks = sharded
    ref = _ref(refs, tag)
    micro = R.STEP_VARIANTS[tag][1]
    mask = R.loss_mask(R.STEP_SHAPE)
    sums = [float(blk.sum()) for mb in np.split(mask, micro)
            for blk in np.split(mb, 4)]
    assert len(set(sums)) > 1, sums
    want = ref["masked"]
    gap = abs(ref["per_rank_loss"] - want["loss"]) / want["loss"]
    assert gap > 10 * parity.LM_GRAD_ATOL_FRAC, gap
    worst = (0.0, "")
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}.masked.loss"], want["loss"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(r[f"{tag}.masked.grad_norm"],
                                   want["grad_norm"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        for name, value in want["params"].items():
            err = parity.assert_close(r[f"{tag}.masked.param.{name}"], value,
                                      rtol=0.0,
                                      atol_frac=parity.LM_GRAD_ATOL_FRAC,
                                      what=f"{tag} masked {name}")
            worst = max(worst, (err / max(float(np.max(np.abs(value))),
                                          1e-30), name))
    print(f"sharded {tag}: masked loss {want['loss']:.6f}; each rank's own "
          f"denominator would give {ref['per_rank_loss']:.6f} ({gap:.2e} "
          f"relative); parameters within {worst[0]:.3e} of a leaf's max "
          f"({worst[1]})")


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


def test_logical_redistributes_a_dtensor(sharded):
    """``logical`` on a DTensor under the (4, 2) mesh: the spec's
    placements, whose local blocks are ``NamedSharding``'s (one dim over
    ``("data", "model")`` under ``DP_ACT_RULES``)."""
    _, ranks = sharded
    assert all(bool(r["dtensor.logical"]) for r in ranks)


def test_elastic_restore_onto_mesh_is_bitwise(sharded):
    _, ranks = sharded
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
    common = ["--arch", "gemma2-2b", "--smoke", "--device", "cpu",
              "--steps", "3", "--batch", "4", "--seq", "32"]
    one = launch_train.main(common + ["--ckpt-dir", str(tmp_path / "one")])
    four = launch_train.main(common + ["--mesh", "2x2", "--ckpt-dir",
                                       str(tmp_path / "four")])
    assert four.steps_run == one.steps_run == 3
    np.testing.assert_allclose(four.losses, one.losses,
                               rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
    assert os.path.isdir(tmp_path / "four")


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
