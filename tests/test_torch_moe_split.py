"""The MoE family's products split over ``model`` on gloo ranks, against the
reference's sharded steps: the routed experts, the shared experts' columns
and MLA's heads (``models.moe``, ``models.attention``, ``models.transformer``
``_moe_segment``).

The reference runs in one subprocess with 8 forced host devices, on
Auto-axes meshes (``jax.make_mesh``'s default Explicit axes refuse the
steps' sharding constraints): its own ``build_train`` step and its
``build_prefill`` / ``build_decode`` steps jitted with their shardings,
and, where a case needs them, its jitted single-device steps with each
MoE call's top-k ids recorded (``jax.debug.callback``). The port runs the
same runs and cases on one spawn of 8 gloo ranks
(``torch_moe_split_ranks``; the (2, 4) mesh is built inside it), from the
parameters it draws from ``prng.key(0)``:

* train steps of deepseek-moe-16b's and deepseek-v2-236b's smoke configs
  on (4, 2) and (2, 4) in float32, within ``parity.LM_GRAD_ATOL_FRAC``;
  one in bfloat16 within ``parity.LM_BF16_SPLIT_RTOL`` /
  ``LM_BF16_SPLIT_ATOL_FRAC`` (the reference's sharded-vs-single gap and
  the port's one-device gap meet it too);
* serving: a bulk prefill, an append prefill of 12 tokens into 32 slots
  and decode steps across a split slot boundary, in float32 within
  ``parity.LM_ATOL_FRAC`` (the MLA bulk cases against the reference's
  single-device steps, whose clamped write its sharded decode drops:
  reference caveat), one in bfloat16 within
  ``parity.LM_BF16_SERVE_SPLIT_ATOL_FRAC``;
* the routing is whole on every rank: each rank of ``model`` records the
  same pair counts and drops, and the ranks of ``data`` together the
  reference's (capacity factor 0.5 on split rows);
* the fallback: 6 experts on 4 ranks of ``model`` do not split, and the
  results still hold;
* a bfloat16 run or case takes one routing everywhere: a top-k choice
  flips at a near-tie where two runs round apart, and moves a token whole
  between experts (ROADMAP queue 3, gap 11; the reference's own sharded
  steps flip against its single-device ones). The port's one-device run
  is recorded first; the port's split steps replay it
  (``R.replayed``, each own choice that differs a near-tie by
  ``parity.moe_flips``), and so do the reference's steps in the
  subprocess, whose ``jax.lax.top_k`` returns the recorded ids of the
  layer its MoE stack's scan runs;
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
from repro_torch.interop import caches_to_numpy, model_params_from_numpy
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.models.model import Model as TModel
from repro_torch.models import moe
from repro_torch.models.moe import moe_splits
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as tsharding
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_items, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_moe_split_ranks as R  # noqa: E402

pytestmark = pytest.mark.subprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
F32_TRAIN = [t for t, r in R.TRAIN.items() if r.dtype == "float32"]
BF16_TRAIN = [t for t, r in R.TRAIN.items() if r.dtype == "bfloat16"]
F32_SERVE = [n for n, c in R.SERVE.items() if c.dtype == "float32"]
BF16_SERVE = [n for n, c in R.SERVE.items() if c.dtype == "bfloat16"]

REF_SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro import config as C
from repro.data.tokens import make_batch
from repro.launch.specs import build_decode, build_prefill, build_train
from repro.models import moe as M
from repro.models.model import Model
from repro.optim.adamw import init_opt_state
from repro.parallel import sharding as S
from repro.train.train_step import make_train_step

# part: "train" (the train runs) or "serve" (the serving cases)
out_dir, spec, part = sys.argv[1], json.loads(sys.argv[2]), sys.argv[3]
with np.load(out_dir + "/inputs.npz") as f:
    inputs = {k: f[k] for k in f.files}
res = {}


def config(name, dtype, capacity, remat="none"):
    arch, experts = spec["cfgs"][name]
    cfg = C.get_config(arch, smoke=True)
    cfg = dataclasses.replace(cfg, dtype=dtype, remat=remat,
                              moe=dataclasses.replace(
                                  cfg.moe, num_experts=experts))
    if capacity is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=capacity))
    return cfg


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


class recorded:
    # repro.models.moe.apply_moe recording each call's top-k ids in ``log``
    def __init__(self):
        self.log, self.apply_moe = [], M.apply_moe

    def __enter__(self):
        def rec(params, x, cfg):
            probs = jax.nn.softmax(jnp.einsum(
                "td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
                params["router"]), axis=-1)
            _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
            jax.debug.callback(lambda i: self.log.append(np.asarray(i)), ids)
            return self.apply_moe(params, x, cfg)
        M.apply_moe = rec
        return self.log

    def __exit__(self, *exc):
        M.apply_moe = self.apply_moe


def replaying(fn):
    # fn(*args) traced with jax.lax.top_k returning the expert ids of the
    # step's last argument (layers, T, k) for the layer the MoE stack's scan
    # runs (jax.lax.scan numbers the layers of each scan it traces): the
    # port's one-device routing (ROADMAP queue 3, gap 11), its
    # probabilities at them as the weights, which apply_moe renormalises
    def step(*args):
        *args, ids = args
        top_k, scan, layer = jax.lax.top_k, jax.lax.scan, [None]

        def numbered(f, init, xs=None, length=None, **kw):
            n = (length if xs is None
                 else jax.tree_util.tree_leaves(xs)[0].shape[0])

            def body(c, pair):
                x, i = pair
                saved, layer[0] = layer[0], i
                try:
                    return f(c, x)
                finally:
                    layer[0] = saved
            return scan(body, init, (xs, jnp.arange(n)), **kw)

        def replay(probs, k):
            i = jax.lax.dynamic_index_in_dim(ids, layer[0], keepdims=False)
            return jnp.take_along_axis(probs, i, axis=-1), i
        jax.lax.top_k, jax.lax.scan = replay, numbered
        try:
            return fn(*args)
        finally:
            jax.lax.top_k, jax.lax.scan = top_k, scan
    return step


def replay_ids(key):
    # the recorded ids of run or case ``key``, one (T, k) array a call
    out, i = [], 0
    while f"replay/{key}/ids/{i:03d}" in inputs:
        out.append(inputs[f"replay/{key}/ids/{i:03d}"].astype(np.int32))
        i += 1
    return out


def repl(mesh):
    return NamedSharding(mesh, PartitionSpec())


shape = C.ShapeConfig("t", "train", *spec["shape"])
opt = C.OptimizerConfig(eps=spec["eps"])


def train(tag, cfg, step, shs, ids):
    # ids: the replayed ids of each step's calls, or None
    put = (lambda t, sh: t) if shs is None else jax.device_put
    p = put(tree_of(spec["train"][tag][0] + "/param/"), shs and shs[0])
    s = put(init_opt_state(p), shs and shs[1])
    losses, aux = [], []
    for i in range(spec["steps"]):
        batch = put({k: jnp.asarray(v) for k, v in
                     make_batch(cfg, shape, 0, i).items()}, shs and shs[2])
        p, s, m = step(p, s, batch, *([] if ids is None else [ids[i]]))
        losses.append(float(m["loss"]))
        aux.append(float(m["aux"]))
    return {"losses": np.asarray(losses), "aux": np.asarray(aux),
            "grad_norm": np.asarray(float(m["grad_norm"])),
            **{k.replace("/", "."): v for k, v in flat(p, "param/").items()}}


def moe_calls(cfg):
    return cfg.num_layers - cfg.moe.first_moe_layer


for tag, (name, dims, dtype, capacity, remat) in (
        spec["train"].items() if part == "train" else ()):
    cfg = config(name, dtype, capacity, remat)
    ids = replay_ids("train." + tag)
    n = moe_calls(cfg)
    ids = [np.stack(ids[i * n:(i + 1) * n]) for i in range(spec["steps"])
           ] if ids else None
    plain = make_train_step(Model(cfg), opt)
    if ids is not None:
        got = train(tag, cfg, jax.jit(replaying(plain)), None, ids)
        res.update({f"train.{tag}.single.{k}": v for k, v in got.items()})
    elif tag in spec["train_single"]:
        with recorded() as log:
            got = train(tag, cfg, jax.jit(plain), None, None)
        res.update({f"train.{tag}.single.{k}": v for k, v in got.items()})
        for i, a in enumerate(log):
            res[f"train.{tag}.single.ids/{i:03d}"] = a
    mesh = auto_mesh(dims)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, shs, kw = build_train(cfg, shape, mesh, opt)
        if ids is not None:
            fn, shs = replaying(fn), tuple(shs) + (repl(mesh),)
        got = train(tag, cfg, jax.jit(fn, in_shardings=shs,
                                      out_shardings=kw["out_shardings"],
                                      donate_argnums=kw["donate_argnums"]),
                    shs[:3], ids)
    res.update({f"train.{tag}.{k}": v for k, v in got.items()})


def serve(name, c, pre, dec, params, batch, caches, ids):
    # ids: the replayed ids of the prefill's and each decode step's calls
    forced = inputs.get(name + "/decode_tokens")

    def next_token(logits, i):
        if forced is not None:
            return jnp.asarray(forced[:, i:i + 1])
        return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]

    logits, caches = pre(params, batch, caches, *ids[:1])
    out = {"prefill_logits": f32(logits)}
    tok = next_token(logits, 0)
    toks, steps = [np.asarray(tok)], []
    for i in range(spec["decode_steps"]):
        logits, caches = dec(params, tok, caches, jnp.int32(c[3] + i),
                             *ids[i + 1:i + 2])
        steps.append(f32(logits))
        if i + 1 < spec["decode_steps"] or forced is None:
            tok = next_token(logits, i + 1)
            toks.append(np.asarray(tok))
    out["decode_logits"] = np.stack(steps)
    out["tokens"] = np.concatenate(toks, axis=1)
    out.update(flat(caches, "cache/"))
    return out


for name, c in spec["serve"].items() if part == "serve" else ():
    cfg_name, dims, b, prompt, max_len, single, dtype, capacity = c
    cfg = config(cfg_name, dtype, capacity)
    params = tree_of(cfg_name + "/param/")
    batch = {"tokens": jnp.asarray(inputs[name + "/tokens"])}
    ids = replay_ids("serve." + name)
    n = moe_calls(cfg)
    ids = [np.stack(ids[i * n:(i + 1) * n])
           for i in range(len(ids) // n)]
    wrap = replaying if ids else (lambda f: f)
    if single or ids:
        model = Model(cfg)
        with recorded() as log:
            got = serve(name, c, jax.jit(wrap(
                lambda p, bt, ca: model.prefill(p, bt, ca)[:2])),
                jax.jit(wrap(lambda p, t, ca, i: model.decode_step(
                    p, {"tokens": t}, ca, i))),
                params, batch, model.init_caches(b, max_len), ids)
        res.update({f"serve.{name}.single.{k}": v for k, v in got.items()})
        for i, a in enumerate(log if not ids else ()):
            res[f"serve.{name}.single.ids/{i:03d}"] = a
    mesh = auto_mesh(dims)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        pre, _, psh, _ = build_prefill(
            cfg, C.ShapeConfig("p", "prefill", prompt, b), mesh)
        dec, _, dsh, dkw = build_decode(
            cfg, C.ShapeConfig("d", "decode", max_len, b), mesh)
        more = (repl(mesh),) if ids else ()
        caches = jax.device_put(Model(cfg).init_caches(b, max_len), dsh[2])
        pstep = jax.jit(wrap(pre),
                        in_shardings=(psh[0], psh[1], dsh[2]) + more,
                        out_shardings=(None, dsh[2]))
        dstep = jax.jit(wrap(dec), in_shardings=tuple(dsh) + more,
                        out_shardings=dkw["out_shardings"])
        got = serve(name, c, pstep,
                    lambda p, t, ca, *a: dstep(p, jax.device_put(t, dsh[1]),
                                               ca, *a),
                    jax.device_put(params, psh[0]),
                    jax.device_put(batch, psh[1]), caches, ids)
    res.update({f"serve.{name}.{k}": v for k, v in got.items()})
np.savez(f"{out_dir}/ref_{part}.npz", **res)
"""


def _inputs():
    """Each config's parameters (the port's draw from ``prng.key(0)``), each
    serving case's tokens, and the routing a bfloat16 run or case replays
    (its one-device run's, ``R.replayed``), by their keys in the inputs
    file."""
    out = {}
    for name, cfg in R.CFGS.items():
        params = TModel(cfg, "cpu").init(prng.key(0))
        out.update({f"{name}/param/{key.replace('/', '.')}": leaf.numpy()
                    for key, leaf in tree_items(params)})
    for name, case in R.SERVE.items():
        for key, value in R.serve_inputs(name, case).items():
            out[f"{name}/{key}"] = value
    replays = ([(f"train.{t}", _plain_train(t)[1]) for t in BF16_TRAIN]
               + [(f"serve.{n}", _plain_serve(n)[1]) for n in BF16_SERVE])
    for key, calls in replays:
        for i, (probs, ids) in enumerate(calls):
            out[f"replay/{key}/probs/{i:03d}"] = probs
            out[f"replay/{key}/ids/{i:03d}"] = ids
    return out


def _spec():
    """The runs and cases for the reference's subprocesses."""
    return {"cfgs": {name: [{"moe": "deepseek-moe-16b",
                             "moe6": "deepseek-moe-16b",
                             "mla": "deepseek-v2-236b"}[name],
                            cfg.moe.num_experts]
                     for name, cfg in R.CFGS.items()},
            "train": {t: list(r) for t, r in R.TRAIN.items()},
            "train_single": list(R.TRAIN_SINGLE),
            "serve": {n: list(c) for n, c in R.SERVE.items()},
            "shape": [R.SHAPE.seq_len, R.SHAPE.global_batch],
            "steps": R.STEPS, "eps": R.OPT_EPS,
            "decode_steps": R.DECODE_STEPS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the ranks' outputs): the reference's two
    subprocesses (its train runs, its serving cases) run while the port's
    ranks do."""
    tmp = tmp_path_factory.mktemp("moe_split")
    np.savez(tmp / "inputs.npz", **_inputs())
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    parts = ("train", "serve")
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
    ``build_train`` step on the Auto-axes mesh of the same shape: losses,
    aux and grad norm within ``parity.LM_GRAD_ATOL_FRAC`` (relative), every
    parameter within it of its leaf's max."""
    ref, ranks = runs
    want, got = _part(ref, f"train.{tag}"), _part(ranks[0], f"train.{tag}")
    for key in ("losses", "aux", "grad_norm"):
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


def _calls(log):
    """A ``routing_log``'s (probs, ids) of every call, as numpy."""
    return [(e["probs"].detach().float().numpy(), e["ids"].numpy())
            for e in log]


@functools.lru_cache(maxsize=None)
def _plain_train(tag):
    """Run ``tag`` through the port's plain ``make_train_step`` on one
    device: (results by key suffix, as ``R.train_run`` gives them, its
    routing: each MoE call's (probs, ids))."""
    run = R.TRAIN[tag]
    cfg = run.config()
    model = TModel(cfg, "cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(prng.key(0)))
    opt = init_opt_state(params)
    step = make_train_step(model, tconfig.OptimizerConfig(eps=R.OPT_EPS))
    losses, aux = [], []
    with moe.routing_log() as log:
        for i in range(R.STEPS):
            params, opt, m = step(params, opt, to_device(
                make_batch(cfg, R.SHAPE, 0, i), "cpu"))
            losses.append(float(m["loss"]))
            aux.append(float(m["aux"]))
    out = {"losses": np.asarray(losses), "aux": np.asarray(aux),
           "grad_norm": np.asarray(float(m["grad_norm"]))}
    out.update({"param." + k.replace("/", "."): v.detach().float().numpy()
                for k, v in tree_items(params)})
    return out, _calls(log)


@pytest.mark.parametrize("tag", BF16_TRAIN)
def test_bf16_train_step_matches_reference_sharded_step(runs, tag):
    """The split train step in bfloat16 against the reference's sharded
    bfloat16 step, both on the port's one-device routing (module
    docstring): losses and grad norm within ``parity.LM_BF16_SPLIT_RTOL``,
    every parameter within ``parity.LM_BF16_SPLIT_ATOL_FRAC`` of its leaf's
    max. The reference's sharded step meets the same rule against its
    single-device step, and the port's one-device step against that."""
    ref, ranks = runs
    want, got = _part(ref, f"train.{tag}"), _part(ranks[0], f"train.{tag}")
    single = _part(ref, f"train.{tag}.single")
    one = _plain_train(tag)[0]
    gaps = {"port split - ref sharded": _gap(got, want),
            "ref sharded - ref single": _gap(want, single),
            "port one rank - ref single": _gap(one, single),
            "port split - port one rank": _gap(got, one)}
    for what, (scal, par) in gaps.items():
        print(f"{tag}: {what}: {scal:.3e} (losses, grad norm, relative), "
              f"{par:.3e} (parameters, of a leaf's max)")
    for what in ("port split - ref sharded", "ref sharded - ref single",
                 "port one rank - ref single"):
        scal, par = gaps[what]
        assert scal <= parity.LM_BF16_SPLIT_RTOL, (what, scal)
        assert par <= parity.LM_BF16_SPLIT_ATOL_FRAC, (what, par)


def _serve_ref(ref, name):
    """The reference's outputs case ``name`` is held to: its sharded
    steps', or for a ``single`` case its single-device steps'."""
    single = R.SERVE[name].single
    return _part(ref, f"serve.{name}.single" if single else
                 f"serve.{name}")


@pytest.mark.parametrize("name", F32_SERVE)
def test_serving_matches_reference(runs, name):
    """The prefill's and every decode step's logits within
    ``parity.LM_ATOL_FRAC`` of max|logit| (the vocabulary's), the greedy
    tokens equal, and the caches gathered from the ranks within the same
    rule."""
    ref, ranks = runs
    want, got = _serve_ref(ref, name), _part(ranks[0], f"serve.{name}")
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


@functools.lru_cache(maxsize=None)
def _plain_serve(name):
    """Case ``name`` through the port's plain ``Model.prefill`` /
    ``decode_step`` on one device: (results by key suffix, as
    ``R.serve_case`` gives them, its routing: each MoE call's (probs,
    ids))."""
    case = R.SERVE[name]
    model = TModel(case.config(), "cpu")
    params = model.init(prng.key(0))
    inputs = R.serve_inputs(name, case)
    forced = inputs.get("decode_tokens")

    def next_token(logits, i):
        if forced is not None:
            return torch.from_numpy(forced[:, i:i + 1].copy())
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    caches = model.init_caches(case.batch, case.max_len)
    with torch.no_grad(), moe.routing_log() as log:
        logits, caches, extras = model.prefill(
            params, {"tokens": torch.from_numpy(inputs["tokens"])}, caches)
        out = {"prefill_logits": logits.float().numpy()}
        tok = next_token(logits, 0)
        toks, steps = [tok], []
        for i in range(R.DECODE_STEPS):
            logits, caches = model.decode_step(
                params, {"tokens": tok}, caches, case.prompt + i, extras)
            steps.append(logits.float().numpy())
            if i + 1 < R.DECODE_STEPS or forced is None:
                tok = next_token(logits, i + 1)
                toks.append(tok)
    out["decode_logits"] = np.stack(steps)
    out["tokens"] = torch.cat(toks, dim=1).numpy()
    out.update({"cache/" + k: v for k, v in
                tree_items(caches_to_numpy(caches))})
    return out, _calls(log)


def _serve_gap(got, want, vocab):
    """The worst gap between two serving runs (dicts by key suffix): the
    logits' as a fraction of max|want| over the vocabulary, each float
    cache leaf's as a fraction of its max|want|."""
    gaps = [float(np.max(np.abs(got[k][..., :vocab] - want[k][..., :vocab])))
            / float(np.max(np.abs(want[k][..., :vocab])))
            for k in ("prefill_logits", "decode_logits")]
    for k in want:
        if k.startswith("cache/") and not k.endswith(("/pos", "/index")):
            gaps.append(float(np.max(np.abs(got[k] - want[k])))
                        / max(float(np.max(np.abs(want[k]))), 1e-30))
    return max(gaps)


@pytest.mark.parametrize("name", BF16_SERVE)
def test_bf16_serving_matches_reference_sharded_steps(runs, name):
    """A bfloat16 case (seeded decode tokens) against the reference's
    sharded bfloat16 serving steps, both on the port's one-device routing
    (module docstring): logits and gathered caches within
    ``parity.LM_BF16_SERVE_SPLIT_ATOL_FRAC``. The reference's own sharded
    steps meet the rule against its single-device steps, and the port's
    one-device steps against those."""
    ref, ranks = runs
    vocab = R.SERVE[name].config().vocab_size
    got = _part(ranks[0], f"serve.{name}")
    want = {k: v for k, v in _part(ref, f"serve.{name}").items()
            if not k.startswith("single.")}
    single = _part(ref, f"serve.{name}.single")
    one = _plain_serve(name)[0]
    gaps = {"port split - ref sharded": _serve_gap(got, want, vocab),
            "ref sharded - ref single": _serve_gap(want, single, vocab),
            "port one rank - ref single": _serve_gap(one, single, vocab),
            "port split - port one rank": _serve_gap(got, one, vocab)}
    for what, gap in gaps.items():
        print(f"{name}: {what}: {gap:.3e} of max|value|")
    for what in ("port split - ref sharded", "ref sharded - ref single",
                 "port one rank - ref single"):
        assert gaps[what] <= parity.LM_BF16_SERVE_SPLIT_ATOL_FRAC, (
            what, gaps[what])


ROUTED = ([f"train.{t}" for t, r in R.TRAIN.items() if r.remat == "none"]
          + [f"serve.{n}" for n in R.SERVE])


@pytest.mark.parametrize("key", ROUTED)
def test_every_rank_of_model_routes_alike(runs, key):
    """Every MoE call's pair counts and dropped pairs (``routing_log``) are
    the same on every rank of ``model``: the ranks that hold the same rows
    route them alike, whatever experts they run."""
    _, ranks = runs
    groups = {}
    for r in ranks:
        groups.setdefault(int(r[f"{key}.data_rank"]), []).append(r)
    assert len(groups) * len(groups[0]) == len(ranks)
    for rows in groups.values():
        for r in rows[1:]:
            np.testing.assert_array_equal(r[f"{key}.counts"],
                                          rows[0][f"{key}.counts"])
            np.testing.assert_array_equal(r[f"{key}.dropped"],
                                          rows[0][f"{key}.dropped"])


@pytest.mark.parametrize("key", ["train.moe.4x2", "serve.mla.bulk.4x2"])
def test_routing_is_the_reference_whole_batch(runs, key):
    """The ranks of ``data`` together route as the reference's
    single-device steps: each call's pair counts summed over them equal
    the reference's, and so do its dropped pairs (at capacity factor 0.5
    in "train.moe.4x2": the whole batch drops pairs in every call)."""
    ref, ranks = runs
    kind, name = key.split(".", 1)
    cfg = (R.TRAIN[name] if kind == "train" else R.SERVE[name]).config()
    m = cfg.moe
    ids = [ref[k] for k in sorted(k for k in ref
                                  if k.startswith(f"{key}.single.ids/"))]
    firsts = {int(r[f"{key}.data_rank"]): r for r in ranks
              if int(r[f"{key}.model_rank"]) == 0}
    counts = sum(r[f"{key}.counts"] for r in firsts.values())
    dropped = sum(r[f"{key}.dropped"] for r in firsts.values())
    assert len(ids) == len(counts)
    for i, a in enumerate(ids):
        want = np.bincount(a.reshape(-1), minlength=m.num_experts)
        np.testing.assert_array_equal(counts[i], want, err_msg=str(i))
        cap = moe._capacity(a.shape[0], m.num_experts, m.top_k,
                            m.capacity_factor)
        assert dropped[i] == np.maximum(want - cap, 0).sum(), i
    if kind == "train":
        assert all(dropped > 0), dropped


@pytest.mark.parametrize("dims", [(4, 2), (2, 4)])
@pytest.mark.parametrize("name", list(R.CFGS))
def test_which_products_split(name, dims):
    """Under each mesh's act rules, the MoE layers split their experts and
    shared columns where ``model`` divides them, and MLA its heads: on
    (2, 4) the fallback config's 6 experts do not split, so its MoE layers
    compute whole."""
    cfg = R.CFGS[name]
    with fake_world(8):
        mesh = make_mesh(dims, ("data", "model"))
        with tsharding.use_mesh(mesh, tsharding.act_rules_for(cfg, mesh)), \
                fsdp.use_layout(fsdp.make_layout(mesh, ("data",), True)):
            got = (moe_splits(cfg), fsdp.splits("heads", cfg.num_heads))
    assert got == (not (name == "moe6" and dims[1] == 4), True)


ONE_RANK_TRAIN = ["moe.4x2", "mla.4x2"]
ONE_RANK_SERVE = ["moe.append.4x2", "mla.bulk.4x2"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """``ONE_RANK_TRAIN`` and ``ONE_RANK_SERVE`` through the builders on one
    gloo rank, a (1, 1) mesh."""
    tmp = tmp_path_factory.mktemp("moe_split_one_rank")
    np.savez(tmp / "inputs.npz", **_inputs())
    (got,) = run_ranks(R.one_rank, 1, (1, 1), "gloo", tmp,
                       str(tmp / "inputs.npz"), ONE_RANK_TRAIN,
                       ONE_RANK_SERVE)
    return got


@pytest.mark.parametrize("key", [f"train.{t}" for t in ONE_RANK_TRAIN]
                         + [f"serve.{n}" for n in ONE_RANK_SERVE])
def test_one_rank_mesh_gives_the_plain_bits(one_rank, key):
    """On a (1, 1) mesh no product splits and no collective runs: the
    builders' steps give the plain path's losses, parameters, logits,
    tokens and caches bit for bit."""
    kind, name = key.split(".", 1)
    want = (_plain_train(name) if kind == "train" else
            _plain_serve(name))[0]
    got = _part(one_rank, key)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "deepseek-v2-236b"])
def test_rank_computes_its_share(arch, kind):
    """Rank 0 of a (1, 4) mesh on a fake world: a step of the MoE smoke
    config (batch 2, 32 positions or cache slots) computes between 1 / 4
    and 1.25 / 4 of the one-rank step's FLOPs (``launch.dryrun.measure``):
    every product splits but the router, MLA's latent and rope-key
    projections and, in a bulk prefill, every kv head's projection on
    the rank's own slots."""
    cfg = tconfig.get_config(arch, smoke=True)
    shape = tconfig.ShapeConfig(kind[0], kind, 32, 2)
    with fake_world(4):
        got = dryrun.measure(cfg, shape, make_mesh((1, 4),
                                                   ("data", "model")))
    share = got["flops"] / got["flops_one_rank"]
    print(f"{arch} smoke {kind} on (1, 4): rank 0 computes {share:.4f} of "
          f"the one-rank step's {got['flops_one_rank']} FLOPs (x4: "
          f"{share * 4:.4f})")
    assert 1 / 4 <= share <= 1.25 / 4
