"""SSD heads, RG-LRU channels and the audio enc-dec split over ``model`` on
gloo ranks, against the reference's sharded steps (``models.ssm``,
``models.rglru``, ``models.encdec``, ``models.transformer``).

The reference runs in four subprocesses (its train runs dealt over
three, its serving cases) with 8 forced host devices, on Auto-axes meshes (``jax.make_mesh``'s
default Explicit axes refuse the steps' sharding constraints): its own
``build_train`` step and its ``build_prefill`` / ``build_decode`` steps
jitted with their shardings, and the bfloat16 run's jitted single-device
step. The port runs the same runs and cases on one spawn of 8 gloo ranks
(``torch_recurrent_split_ranks``; the (2, 4) mesh is built inside it),
from the parameters it draws from ``prng.key(0)``:

* train steps of mamba2-780m's, recurrentgemma-2b's and seamless's smoke
  configs on (4, 2) and (2, 4) in float32, within
  ``parity.LM_GRAD_ATOL_FRAC``; one in bfloat16 within
  ``parity.LM_BF16_SPLIT_RTOL`` / ``LM_BF16_SPLIT_ATOL_FRAC`` (the
  reference's sharded-vs-single gap and the port's one-device gap meet it
  too);
* serving: an append prefill of 12 tokens into 32 slots and decode steps
  of each family, in float32 within ``parity.LM_ATOL_FRAC``;
* which products split: each rank's SSD scan runs its heads, its RG-LRU
  scan its channels and its attention its q heads, 1 / ``model`` of them;
* the split gated RMSNorm's gradient against the whole norm's;
* the fallbacks: SSD heads that ``model`` does not divide, and 3
  attention heads that send recurrentgemma to ``DP_ACT_RULES``, compute
  whole and still match;
* a (1, 1) mesh gives the plain steps' bits, and rank 0 of a (1, m) mesh
  on a fake world computes its share of the one-rank step's FLOPs.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import config as tconfig
from repro_torch.core import prng
from repro_torch.data.tokens import make_batch, to_device
from repro_torch.interop import caches_to_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.model import Model as TModel
from repro_torch.models.rglru import rglru_splits
from repro_torch.models.ssm import ssm_splits
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as tsharding
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_items, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_recurrent_split_ranks as R  # noqa: E402

pytestmark = pytest.mark.subprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
#: the reference subprocesses the train runs are dealt over (each compiles
#: its runs' sharded steps in turn, the file's longest part)
TRAIN_PARTS = 3
F32_TRAIN = [t for t, r in R.TRAIN.items() if r.dtype == "float32"]
BF16_TRAIN = [t for t, r in R.TRAIN.items() if r.dtype == "bfloat16"]

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import config as C
from repro.data.tokens import make_batch
from repro.launch.specs import build_decode, build_prefill, build_train
from repro.models.model import Model
from repro.optim.adamw import init_opt_state
from repro.parallel import sharding as S
from repro.train.train_step import make_train_step

# part: "train<k>" (the train runs k, k + TRAIN_PARTS, ...) or "serve"
# (the serving cases)
out_dir, spec, part = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
with np.load(out_dir + "/inputs.npz") as f:
    inputs = {k: f[k] for k in f.files}
res = {}


def config(name, **fields):
    arch, overrides = spec["cfgs"][name]
    cfg = C.get_config(arch, smoke=True)
    for key, value in overrides.items():
        if isinstance(value, dict):
            value = dataclasses.replace(getattr(cfg, key), **value)
        cfg = dataclasses.replace(cfg, **{key: value})
    return dataclasses.replace(cfg, **fields)


def tree_of(prefix):
    out = {}
    for key, v in inputs.items():
        if key.startswith(prefix):
            node = out
            *path, last = key[len(prefix):].split(".")
            for p in path:
                node = node.setdefault(p, {})
            node[last] = jnp.asarray(v)
    return out


def f32(a):
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def flat(tree, prefix):
    out = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "name", getattr(p, "key", p)))
                       for p in path)
        out[prefix + key] = f32(v)
    return out


def auto_mesh(dims):
    return jax.make_mesh(tuple(dims), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


shape = C.ShapeConfig("t", "train", *spec["shape"])
opt = C.OptimizerConfig(eps=spec["eps"])


def train(tag, cfg, step, shs):
    put = (lambda t, sh: t) if shs is None else jax.device_put
    p = put(tree_of(spec["train"][tag][0] + "/param/"), shs and shs[0])
    s = put(init_opt_state(p), shs and shs[1])
    losses = []
    for i in range(spec["steps"]):
        batch = put({k: jnp.asarray(v) for k, v in
                     make_batch(cfg, shape, 0, i).items()}, shs and shs[2])
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
    return {"losses": np.asarray(losses),
            "grad_norm": np.asarray(float(m["grad_norm"])),
            **{k.replace("/", "."): v for k, v in flat(p, "param/").items()}}


for tag, (name, dims, dtype, remat) in (
        list(spec["train"].items())[int(part[5:])::spec["train_parts"]]
        if part.startswith("train") else ()):
    cfg = config(name, dtype=dtype, remat=remat)
    if tag in spec["train_single"]:
        got = train(tag, cfg, jax.jit(make_train_step(Model(cfg), opt)),
                    None)
        res.update({f"train.{tag}.single.{k}": v for k, v in got.items()})
    mesh = auto_mesh(dims)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, shs, kw = build_train(cfg, shape, mesh, opt)
        got = train(tag, cfg, jax.jit(fn, in_shardings=shs,
                                      out_shardings=kw["out_shardings"],
                                      donate_argnums=kw["donate_argnums"]),
                    shs)
    res.update({f"train.{tag}.{k}": v for k, v in got.items()})


for name, c in spec["serve"].items() if part == "serve" else ():
    cfg_name, dims, b, prompt, max_len = c
    cfg = config(cfg_name, dtype="float32")
    mesh = auto_mesh(dims)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        pre, _, psh, _ = build_prefill(
            cfg, C.ShapeConfig("p", "prefill", prompt, b), mesh)
        dec, _, dsh, dkw = build_decode(
            cfg, C.ShapeConfig("d", "decode", max_len, b), mesh)
        params = jax.device_put(tree_of(cfg_name + "/param/"), psh[0])
        batch = jax.device_put({k: jnp.asarray(inputs[f"{name}/{k}"])
                                for k in psh[1]}, psh[1])
        caches = jax.device_put(Model(cfg).init_caches(b, max_len), dsh[2])
        pstep = jax.jit(pre, in_shardings=(psh[0], psh[1], dsh[2]),
                        out_shardings=(None, dsh[2]))
        dstep = jax.jit(dec, in_shardings=dsh,
                        out_shardings=dkw["out_shardings"])
        extra = ()
        if cfg.is_encoder_decoder:
            extra = (jax.device_put(
                (jnp.asarray(inputs[name + "/enc_states"]),
                 jnp.asarray(inputs[name + "/enc_positions"])), dsh[4]),)
        logits, caches = pstep(params, batch, caches)
        res[f"serve.{name}.prefill_logits"] = f32(logits)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        toks, steps = [np.asarray(tok)], []
        for i in range(spec["decode_steps"]):
            logits, caches = dstep(params, jax.device_put(tok, dsh[1]),
                                   caches, jnp.int32(prompt + i), *extra)
            steps.append(f32(logits))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(
                jnp.int32)[:, None]
            toks.append(np.asarray(tok))
        res[f"serve.{name}.decode_logits"] = np.stack(steps)
        res[f"serve.{name}.tokens"] = np.concatenate(toks, axis=1)
        res.update(flat(caches, f"serve.{name}.cache/"))
np.savez(f"{out_dir}/ref_{part}.npz", **res)
"""


def _inputs():
    """Each config's parameters (the port's draw from ``prng.key(0)``) and
    each serving case's inputs (``R.serve_inputs``), by their keys in the
    inputs file."""
    out, params = {}, {}
    for name, cfg in R.CFGS.items():
        params[name] = TModel(cfg, "cpu").init(prng.key(0))
        out.update({f"{name}/param/{key.replace('/', '.')}": leaf.numpy()
                    for key, leaf in tree_items(params[name])})
    for name, case in R.SERVE.items():
        for key, value in R.serve_inputs(name, case,
                                         params[case.cfg]).items():
            out[f"{name}/{key}"] = value
    return out


def _spec():
    """The runs and cases for the reference's subprocesses."""
    return {"cfgs": R.CFG_SPECS,
            "train": {t: [r.cfg, list(r.mesh), r.dtype, r.remat]
                      for t, r in R.TRAIN.items()},
            "train_single": list(R.TRAIN_SINGLE),
            "serve": {n: [c.cfg, list(c.mesh), c.batch, c.prompt, c.max_len]
                      for n, c in R.SERVE.items()},
            "train_parts": TRAIN_PARTS,
            "shape": [R.SHAPE.seq_len, R.SHAPE.global_batch],
            "steps": R.STEPS, "eps": R.OPT_EPS,
            "decode_steps": R.DECODE_STEPS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the ranks' outputs): the reference's
    subprocesses (its train runs, its serving cases) run while the port's
    ranks do."""
    tmp = tmp_path_factory.mktemp("recurrent_split")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = tuple(f"train{k}" for k in range(TRAIN_PARTS)) + ("serve",)
    procs = [subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), json.dumps(_spec()),
         part], env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for part in parts]
    try:
        ranks = run_ranks(R.run_all, 8, (4, 2), "gloo", tmp,
                          str(tmp / "inputs.npz"), list(R.TRAIN),
                          list(R.SERVE))
        errs = [proc.communicate(timeout=600)[1] for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    ref = {}
    for part, proc, err in zip(parts, procs, errs):
        assert proc.returncode == 0, (part, err[-3000:])
        with np.load(tmp / f"ref_{part}.npz") as f:
            ref.update({k: f[k] for k in f.files})
    return ref, ranks


def _part(results, prefix):
    """The entries of ``results`` under ``prefix`` + ".", by key suffix."""
    n = len(prefix) + 1
    return {k[n:]: v for k, v in results.items()
            if k.startswith(prefix + ".")}


def _gap(a, b):
    """(the worst relative gap of the losses and the grad norm, the worst
    gap of a parameter as a fraction of its leaf's max|b|) between the
    train results ``a`` and ``b``."""
    scal = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
               for k in ("losses", "grad_norm"))
    keys = sorted(k for k in b if k.startswith("param."))
    assert keys and keys == sorted(k for k in a if k.startswith("param."))
    par = max(float(np.max(np.abs(a[k] - b[k]))) /
              max(float(np.max(np.abs(b[k]))), 1e-30) for k in keys)
    return scal, par


@pytest.mark.parametrize("tag", F32_TRAIN)
def test_train_step_matches_reference_sharded_step(runs, tag):
    """The split train step of run ``tag`` against the reference's sharded
    ``build_train`` step on the Auto-axes mesh of the same shape: losses
    and grad norm within ``parity.LM_GRAD_ATOL_FRAC`` (relative), every
    parameter within it of its leaf's max."""
    ref, ranks = runs
    want, got = _part(ref, f"train.{tag}"), _part(ranks[0], f"train.{tag}")
    for key in ("losses", "grad_norm"):
        np.testing.assert_allclose(got[key], want[key],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0,
                                   err_msg=key)
    scal, par = _gap(got, want)
    print(f"{tag}: losses and grad norm within {scal:.3e}, parameters "
          f"within {par:.3e} of a leaf's max")
    for key in sorted(k for k in want if k.startswith("param.")):
        parity.assert_close(got[key], want[key], rtol=0.0,
                            atol_frac=parity.LM_GRAD_ATOL_FRAC,
                            what=f"{tag} {key}")


@functools.lru_cache(maxsize=None)
def _plain_train(tag):
    """Run ``tag`` through the port's plain ``make_train_step`` on one
    device: results by key suffix, as ``R.train_run`` gives them."""
    cfg = R.TRAIN[tag].config()
    model = TModel(cfg, "cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(prng.key(0)))
    opt = init_opt_state(params)
    step = make_train_step(model, tconfig.OptimizerConfig(eps=R.OPT_EPS))
    losses = []
    for i in range(R.STEPS):
        params, opt, m = step(params, opt, to_device(
            make_batch(cfg, R.SHAPE, 0, i), "cpu"))
        losses.append(float(m["loss"]))
    out = {"losses": np.asarray(losses),
           "grad_norm": np.asarray(float(m["grad_norm"]))}
    out.update({"param." + k.replace("/", "."): v.detach().float().numpy()
                for k, v in tree_items(params)})
    return out


@pytest.mark.parametrize("tag", BF16_TRAIN)
def test_bf16_train_step_matches_reference_sharded_step(runs, tag):
    """The split train step in bfloat16 against the reference's sharded
    bfloat16 step: losses and grad norm within
    ``parity.LM_BF16_SPLIT_RTOL``, every parameter within
    ``parity.LM_BF16_SPLIT_ATOL_FRAC`` of its leaf's max. The reference's
    sharded step meets the same rule against its single-device step. The
    port's one-device step meets the one-device rule against that
    (``parity.lm_bf16_grad_atol_frac``): Mamba-2's ``a_log``, zero at the
    draw, is a small leaf whose gradient cancels, and after two steps its
    one-device gap (2.3e-2 of its max) is above the split rule, which the
    port's split step meets against the reference's sharded one."""
    ref, ranks = runs
    want, got = _part(ref, f"train.{tag}"), _part(ranks[0], f"train.{tag}")
    want = {k: v for k, v in want.items() if not k.startswith("single.")}
    single = _part(ref, f"train.{tag}.single")
    one = _plain_train(tag)
    gaps = {"port split - ref sharded": _gap(got, want),
            "ref sharded - ref single": _gap(want, single),
            "port one rank - ref single": _gap(one, single),
            "port split - port one rank": _gap(got, one)}
    for what, (scal, par) in gaps.items():
        print(f"{tag}: {what}: {scal:.3e} (losses, grad norm, relative), "
              f"{par:.3e} (parameters, of a leaf's max)")
    one_device = parity.lm_bf16_grad_atol_frac(R.TRAIN[tag].config()
                                               .num_layers)
    for what, atol in (
            ("port split - ref sharded", parity.LM_BF16_SPLIT_ATOL_FRAC),
            ("ref sharded - ref single", parity.LM_BF16_SPLIT_ATOL_FRAC),
            ("port one rank - ref single", one_device)):
        scal, par = gaps[what]
        assert scal <= parity.LM_BF16_SPLIT_RTOL, (what, scal)
        assert par <= atol, (what, par)


@pytest.mark.parametrize("name", list(R.SERVE))
def test_serving_matches_reference_sharded_steps(runs, name):
    """The prefill's and every decode step's logits within
    ``parity.LM_ATOL_FRAC`` of max|logit| (the vocabulary's), the greedy
    tokens equal, and the caches gathered from the ranks within the same
    rule of each leaf's max."""
    ref, ranks = runs
    want, got = _part(ref, f"serve.{name}"), _part(ranks[0], f"serve.{name}")
    vocab = R.SERVE[name].config().vocab_size
    worst = 0.0
    for key in ("prefill_logits", "decode_logits"):
        err = parity.assert_close(got[key][..., :vocab],
                                  want[key][..., :vocab], rtol=0.0,
                                  atol_frac=parity.LM_ATOL_FRAC,
                                  what=f"{name} {key}")
        worst = max(worst, err / float(np.max(np.abs(want[key][
            ..., :vocab]))))
    print(f"{name}: logits within {worst:.3e} of max|logit|")
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    keys = sorted(k for k in want if k.startswith("cache/"))
    assert keys and keys == sorted(k for k in got if k.startswith("cache/"))
    for key in keys:
        parity.assert_close(got[key], want[key], rtol=0.0,
                            atol_frac=parity.LM_ATOL_FRAC, what=key)


#: run or case -> (SSD heads, RG-LRU channels, attention q heads) each rank
#: computes, where the family has them: 1 / ``model`` of the config's where
#: the step splits them; whole in the fallbacks' segments (the SSD heads of
#: "ssm_h2" on 4 ranks of ``model``; "hybrid_dp"'s train step, whose batch
#: takes ``model``, and its serving attention's 3 heads). A split decode
#: step attends with every q head over its own cache slots
#: (``kvcache.combine_heads``), so the serving cases' attention widths are
#: not listed
WIDTHS = {
    "train.ssm.4x2": {"ssd": 2}, "train.ssm.2x4": {"ssd": 1},
    "train.ssm.bf16.2x4": {"ssd": 1}, "train.ssm_h2.2x4": {"ssd": 2},
    "train.hybrid.4x2": {"lru": 32, "attn": 2},
    "train.hybrid.2x4": {"lru": 16, "attn": 1},
    "train.hybrid_dp.4x2": {"lru": 64, "attn": 3},
    "train.encdec.4x2": {"attn": 2}, "train.encdec.2x4": {"attn": 1},
    "serve.ssm.append.4x2": {"ssd": 2},
    "serve.hybrid.append.2x4": {"lru": 16},
    "serve.hybrid_dp.append.4x2": {"lru": 32},
}


@pytest.mark.parametrize("key", list(WIDTHS))
def test_each_rank_computes_its_own_heads_and_channels(runs, key):
    """On every rank, every call of the SSD scan, the RG-LRU scan and the
    attention computes the widths ``WIDTHS`` gives, and no call of a
    family the config lacks runs."""
    _, ranks = runs
    for r in ranks:
        for kind in ("ssd", "lru", "attn"):
            seen = set(r[f"{key}.widths.{kind}"].tolist())
            if kind in WIDTHS[key]:
                assert seen == {WIDTHS[key][kind]}, (key, kind, seen)
            elif kind != "attn" or not key.startswith("serve."):
                assert not seen, (key, kind, seen)


def test_split_norm_gradient_is_the_whole_norms(runs):
    """The split gated RMSNorm on each rank's channels gives the whole
    norm's output and gradients of its input and scale on those channels
    (float32 sums in another order: within ``parity.LM_ATOL_FRAC`` of
    max|value|); with the
    sum of squares through ``fsdp.model_sum``, whose backward leaves each
    rank's gradient of the sum as it is, the input's gradient is wrong."""
    _, ranks = runs
    for r in ranks:
        for key in ("out", "dx", "dscale"):
            want = r[f"norm.whole.{key}"]
            parity.assert_close(r[f"norm.split.{key}"], want, rtol=0.0,
                                atol_frac=parity.LM_ATOL_FRAC, what=key)
        gap = np.max(np.abs(r["norm.identity.dx"] - r["norm.whole.dx"]))
        assert gap > 1e-2 * np.max(np.abs(r["norm.whole.dx"]))


@pytest.mark.parametrize("dims", [(4, 2), (2, 4)])
@pytest.mark.parametrize("name", list(R.CFGS))
def test_which_products_split(name, dims):
    """Under each mesh's act rules and a layout whose batch leaves
    ``model`` free (a serving step's): the SSD heads split where ``model``
    divides them (not "ssm_h2"'s 2 on 4 ranks), the LRU width always, the
    attention heads but for "hybrid_dp"'s 3, which also send it to
    ``DP_ACT_RULES``."""
    cfg = R.CFGS[name]
    with fake_world(8):
        mesh = make_mesh(dims, ("data", "model"))
        rules = tsharding.act_rules_for(cfg, mesh)
        with tsharding.use_mesh(mesh, rules), \
                fsdp.use_layout(fsdp.make_layout(mesh, ("data",), True)):
            got = {"ssd": cfg.ssm is not None and ssm_splits(cfg),
                   "lru": cfg.rglru is not None and rglru_splits(cfg),
                   "heads": fsdp.splits("heads", cfg.num_heads)}
    assert (rules is tsharding.DP_ACT_RULES) == (name == "hybrid_dp")
    assert got == {"ssd": name == "ssm" or (name == "ssm_h2"
                                            and dims[1] == 2),
                   "lru": name.startswith("hybrid"),
                   "heads": name != "hybrid_dp"}


ONE_RANK_TRAIN = ["ssm.2x4", "hybrid.2x4", "encdec.2x4"]
ONE_RANK_SERVE = ["ssm.append.4x2", "hybrid.append.2x4",
                  "encdec.append.2x4"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """``ONE_RANK_TRAIN`` and ``ONE_RANK_SERVE`` through the builders on one
    gloo rank, a (1, 1) mesh."""
    tmp = tmp_path_factory.mktemp("recurrent_split_one_rank")
    np.savez(tmp / "inputs.npz", **_inputs())
    (got,) = run_ranks(R.one_rank, 1, (1, 1), "gloo", tmp,
                       str(tmp / "inputs.npz"), ONE_RANK_TRAIN,
                       ONE_RANK_SERVE)
    return got


@functools.lru_cache(maxsize=None)
def _plain_serve(name):
    """Case ``name`` through the port's plain ``Model.prefill`` /
    ``decode_step`` on one device: results by key suffix, as
    ``R.serve_case`` gives them."""
    case = R.SERVE[name]
    model = TModel(case.config(), "cpu")
    params = model.init(prng.key(0))
    inputs = R.serve_inputs(name, case, params)
    batch = {k: torch.from_numpy(inputs[k]) for k in ("tokens", "enc_embeds")
             if k in inputs}
    caches = model.init_caches(case.batch, case.max_len)
    with torch.no_grad():
        logits, caches, extras = model.prefill(params, batch, caches)
        out = {"prefill_logits": logits.float().numpy()}
        tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
        toks, steps = [tok], []
        for i in range(R.DECODE_STEPS):
            logits, caches = model.decode_step(
                params, {"tokens": tok}, caches, case.prompt + i, extras)
            steps.append(logits.float().numpy())
            tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
            toks.append(tok)
    out["decode_logits"] = np.stack(steps)
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    out.update({"cache/" + k: v for k, v in
                tree_items(caches_to_numpy(caches))})
    return out


@pytest.mark.parametrize("key", [f"train.{t}" for t in ONE_RANK_TRAIN]
                         + [f"serve.{n}" for n in ONE_RANK_SERVE])
def test_one_rank_mesh_gives_the_plain_bits(one_rank, key):
    """On a (1, 1) mesh no product splits and no collective runs: the
    builders' steps give the plain path's losses, parameters, logits,
    tokens and caches bit for bit."""
    kind, name = key.split(".", 1)
    want = _plain_train(name) if kind == "train" else _plain_serve(name)
    got = _part(one_rank, key)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


#: arch -> (layers of the cut, the largest share of the one-rank step's
#: FLOPs rank 0 of (1, 4) may compute, over 1 / 4). What a rank computes
#: whole at these cuts: mamba2-780m's B and C projection (256 of the 1 804
#: columns of ``w_in`` a rank reads, against 1 612 for a quarter) and the
#: scan's C.B, under 1 % of a 2-layer step, whose unembedding (50 304 x
#: 1 536 a position) splits; recurrentgemma-2b's local MQA attention, whose
#: 10 heads 4 ranks do not divide, about 1.8 % of a (recurrent, recurrent,
#: attention) group's step at 256 positions (its 256 000-row unembedding
#: splits); seamless's bulk prefill projects every kv head on the
#: positions of its own quarter of the cache slots (a quarter of the self
#: attention's kv projection more). Measured (op_cost on meta tensors):
#: x4 1.0219-1.0240, 1.0506-1.0552, 1.0000-1.0117
SHARE_BOUNDS = {"mamba2-780m": (2, 1.05), "recurrentgemma-2b": (3, 1.10),
                "seamless-m4t-large-v2": (2, 1.05)}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(SHARE_BOUNDS))
def test_rank_computes_its_share(arch, kind):
    """Rank 0 of a (1, 4) mesh on a fake world: a step of ``arch`` at full
    width cut in depth (``SHARE_BOUNDS``; the enc-dec's encoder too),
    batch 1, 256 positions or cache slots, computes between 1 / 4 and the
    arch's bound over 4 of the one-rank step's FLOPs
    (``launch.dryrun.measure``)."""
    layers, bound = SHARE_BOUNDS[arch]
    cfg = dataclasses.replace(tconfig.get_config(arch), num_layers=layers)
    if cfg.is_encoder_decoder:
        cfg = dataclasses.replace(cfg, num_encoder_layers=layers)
    shape = tconfig.ShapeConfig(kind[0], kind, 256, 1)
    with fake_world(4):
        got = dryrun.measure(cfg, shape, make_mesh((1, 4),
                                                   ("data", "model")))
    share = got["flops"] / got["flops_one_rank"]
    print(f"{arch} cut to {layers} layers, {kind} on (1, 4): rank 0 "
          f"computes {share:.4f} of the one-rank step's "
          f"{got['flops_one_rank']} FLOPs (x4: {share * 4:.4f})")
    assert 1 / 4 <= share <= bound / 4
