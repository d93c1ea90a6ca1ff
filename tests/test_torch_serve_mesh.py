"""The port's serving steps under a mesh on gloo ranks against the
reference's sharded serving steps.

The reference runs in one subprocess with 8 forced host devices: its own
``build_prefill`` / ``build_decode`` jitted with their ``in_shardings`` on
an Auto-axes mesh (``jax.make_mesh``'s default Explicit axes refuse the
steps' sharding constraints), then ``DECODE_STEPS`` greedy decode steps,
every sharded output taken through ``np.asarray``. The port runs the same
cases on one spawn of 8 gloo ranks (``testing.ranks.run_ranks``; the
(2, 4) and (1, 8) meshes are built inside it), each rank holding only its
blocks of the caches (``parallel.kvcache``). Both take the parameters the
port draws from ``prng.key(0)`` and the same numpy prompts
(``torch_serve_mesh_ranks.CASES``: every family at smoke size in
float32, the enc-dec decode through ``build_decode``'s ``enc_out``
branch on the reference's encoder states). Held to: logits within
``parity.LM_ATOL_FRAC`` of max|logit|, greedy tokens equal, the caches
gathered from the ranks within the same rule (``pos`` and ``index``
exactly), and each rank's leaves exactly their spec's local shape. Two
MoE cases split their rows over ranks at a capacity factor at which the
whole batch drops pairs that each rank's own capacity would keep; they are
held against the reference's single-device steps, whose expert choices
the subprocess records.

The same subprocess runs the reference's sharded ``build_train`` step on
the Auto-axes (4, 2) and (2, 4) meshes (``R.TRAIN_RUNS``), which the
port's plain sharded step on the same mesh is held against: in float32
within ``parity.LM_GRAD_ATOL_FRAC``, in bfloat16 within
``parity.LM_BF16_SPLIT_RTOL`` / ``LM_BF16_SPLIT_ATOL_FRAC``, beside the
reference's jitted single-device bfloat16 step.
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
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_mesh
from repro_torch.launch.specs import build_decode, build_prefill
from repro_torch.models.encdec import encode
from repro_torch.models.model import Model as TModel
from repro_torch.models.moe import _capacity
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp
from repro_torch.parallel import sharding as tsharding
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks
from repro_torch.train.train_step import make_train_step
from repro_torch.tree import tree_items, tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_parallel_ranks as PR  # noqa: E402
import torch_serve_mesh_ranks as R  # noqa: E402

pytestmark = pytest.mark.subprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NAMES = list(R.CASES)
#: the float32 cases (greedy tokens, ``parity.LM_ATOL_FRAC``) and the
#: bfloat16 ones (seeded tokens, ``parity.LM_BF16_SERVE_SPLIT_ATOL_FRAC``)
F32 = [n for n in NAMES if R.CASES[n].dtype == "float32"]
BF16 = [n for n in NAMES if R.CASES[n].dtype == "bfloat16"]

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

out_dir, cases, step_cfg, steps = sys.argv[1], json.loads(sys.argv[2]), \
    json.loads(sys.argv[3]), int(sys.argv[4])
with np.load(out_dir + "/inputs.npz") as f:
    inputs = {k: f[k] for k in f.files}


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
    # a bfloat16 array widened (exactly) to float32, any other as it is
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype.name == "bfloat16" else a


def flat(tree, prefix):
    res = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "name", getattr(p, "key", p)))
                       for p in path)
        res[prefix + key] = f32(v)
    return res


def next_token(name, logits, i):
    # the seeded token of a bfloat16 case, else the greedy one
    forced = inputs.get(name + "/decode_tokens")
    if forced is not None:
        return jnp.asarray(forced[:, i:i + 1])
    return jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]


def auto_mesh(dims):
    return jax.make_mesh(tuple(dims), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def recorded_ids(log):
    # repro.models.moe.apply_moe recording each call's top-k expert ids
    from repro.models import moe as M
    apply_moe = M.apply_moe

    def recorded(params, x, cfg):
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", x.reshape(-1, x.shape[-1]).astype(jnp.float32),
            params["router"]), axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda i: log.append(np.asarray(i)), ids)
        return apply_moe(params, x, cfg)

    return M, apply_moe, recorded


def single_device(name, c, cfg):
    # the case through Model.prefill / decode_step on one device, an MoE
    # config's expert ids recorded call by call
    ids = []
    if cfg.moe is not None:
        M, apply_moe, M.apply_moe = recorded_ids(ids)
    model = Model(cfg)
    params = tree_of(name + "/param/")
    batch = {k[len(name + "/batch/"):]: jnp.asarray(v)
             for k, v in inputs.items() if k.startswith(name + "/batch/")}
    caches = model.init_caches(c["batch"], c["max_len"])
    logits, caches, extras = jax.jit(model.prefill)(params, batch, caches)
    res[name + ".single.prefill_logits"] = f32(logits)
    tok = next_token(name, logits, 0)
    toks, outs = [np.asarray(tok)], []
    dec = jax.jit(model.decode_step)
    for i in range(steps):
        logits, caches = dec(params, {"tokens": tok}, caches,
                             jnp.int32(c["prompt"] + i), extras)
        outs.append(f32(logits))
        if i + 1 < steps or c["dtype"] == "float32":
            tok = next_token(name, logits, i + 1)
            toks.append(np.asarray(tok))
    res[name + ".single.decode_logits"] = np.stack(outs)
    res[name + ".single.tokens"] = np.concatenate(toks, axis=1)
    res.update(flat(caches, name + ".single.cache/"))
    for i, a in enumerate(ids):
        res[f"{name}.single.ids/{i:03d}"] = a
    if cfg.moe is not None:
        M.apply_moe = apply_moe


res = {}
for name, c in cases.items():
    base = (C.ModelConfig(**step_cfg["cfgs"]["step"]) if c["arch"] == "step"
            else C.get_config(c["arch"], smoke=True))
    cfg = dataclasses.replace(base, dtype=c["dtype"])
    if c["capacity"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=c["capacity"]))
    if c["single"] or c["dtype"] != "float32":
        single_device(name, c, cfg)
    mesh = auto_mesh(c["mesh"])
    rules = S.DP_ACT_RULES if c["dp"] else S.act_rules_for(cfg, mesh)
    b = c["batch"]
    with S.use_mesh(mesh, rules):
        pre, _, psh, pkw = build_prefill(
            cfg, C.ShapeConfig("p", "prefill", c["prompt"], b), mesh)
        dec, _, dsh, dkw = build_decode(
            cfg, C.ShapeConfig("d", "decode", c["max_len"], b), mesh)
        params = jax.device_put(tree_of(name + "/param/"), psh[0])
        batch = jax.device_put({k: jnp.asarray(inputs[name + "/batch/" + k])
                                for k in psh[1]}, psh[1])
        caches = jax.device_put(Model(cfg).init_caches(b, c["max_len"]),
                                dsh[2])
        pstep = jax.jit(pre, in_shardings=(psh[0], psh[1], dsh[2]),
                        out_shardings=(None, dsh[2]))
        logits, caches = pstep(params, batch, caches)
        res[name + ".prefill_logits"] = f32(logits)
        tok = next_token(name, logits, 0)
        toks, outs = [np.asarray(tok)], []
        extra = ()
        if cfg.is_encoder_decoder:
            extra = (jax.device_put(
                (jnp.asarray(inputs[name + "/enc_states"]),
                 jnp.asarray(inputs[name + "/enc_positions"])), dsh[4]),)
        dstep = jax.jit(dec, in_shardings=dsh,
                        out_shardings=dkw["out_shardings"])
        for i in range(steps):
            logits, caches = dstep(params, jax.device_put(tok, dsh[1]),
                                   caches, jnp.int32(c["prompt"] + i),
                                   *extra)
            outs.append(f32(logits))
            if i + 1 < steps or c["dtype"] == "float32":
                tok = next_token(name, logits, i + 1)
                toks.append(np.asarray(tok))
        res[name + ".decode_logits"] = np.stack(outs)
        res[name + ".tokens"] = np.concatenate(toks, axis=1)
        res.update(flat(caches, name + ".cache/"))

# the sharded train step on the Auto-axes mesh of each run of
# step_cfg["runs"], in its dtype; a run without a mesh is the jitted
# single-device step
from repro.train.train_step import make_train_step
shape = C.ShapeConfig("t", "train", *step_cfg["shape"])


def train(tag, name, step, shs):
    put = (lambda t, sh: t) if shs is None else jax.device_put
    p = put(tree_of(f"train/{name}/param/"), shs and shs[0])
    s = put(init_opt_state(p), shs and shs[1])
    losses = []
    for i in range(step_cfg["steps"]):
        batch = put({k: jnp.asarray(v) for k, v in
                     make_batch(cfg, shape, 0, i).items()}, shs and shs[2])
        p, s, m = step(p, s, batch)
        losses.append(float(m["loss"]))
    res[tag + ".losses"] = np.asarray(losses)
    res[tag + ".grad_norm"] = np.asarray(float(m["grad_norm"]))
    res.update({k.replace("/", "."): v
                for k, v in flat(p, tag + ".param/").items()})


for tag, name, dims, dtype, eps in step_cfg["runs"]:
    cfg = dataclasses.replace(C.ModelConfig(**step_cfg["cfgs"][name]),
                              dtype=dtype)
    opt = C.OptimizerConfig() if eps is None else C.OptimizerConfig(eps=eps)
    if dims is None:
        train(tag, name, jax.jit(make_train_step(Model(cfg), opt)), None)
        continue
    mesh = auto_mesh(dims)
    with S.use_mesh(mesh, S.act_rules_for(cfg, mesh)):
        fn, _, shs, kw = build_train(cfg, shape, mesh, opt)
        train(tag, name, jax.jit(fn, in_shardings=shs,
                           out_shardings=kw["out_shardings"],
                           donate_argnums=kw["donate_argnums"]), shs)
np.savez(out_dir + "/ref.npz", **res)
"""


def _case_inputs(name):
    """Case ``name``'s parameters (the port's draw from ``prng.key(0)``),
    prompt, a bfloat16 case's decode tokens and, for the enc-dec case, the
    encoder's states over its ``enc_embeds``, by their keys in the inputs
    file."""
    case = R.CASES[name]
    cfg = case.cfg()
    params = TModel(cfg, "cpu").init(prng.key(0))
    out = {f"{name}/param/{key.replace('/', '.')}": leaf.numpy()
           for key, leaf in tree_items(params)}
    for key, value in R.case_inputs(name, case).items():
        out[f"{name}/batch/{key}"] = value
    forced = R.decode_tokens(name, case)
    if forced is not None:
        out[f"{name}/decode_tokens"] = forced
    if cfg.is_encoder_decoder:
        with torch.no_grad():
            states, positions = encode(params, torch.from_numpy(
                out[f"{name}/batch/enc_embeds"]), cfg)
        out[f"{name}/enc_states"] = states.numpy()
        out[f"{name}/enc_positions"] = positions.contiguous().numpy()
    return out


def _inputs():
    """Every case's inputs (``_case_inputs``), and ``PR.STEP_CFG``'s
    parameters for the train step."""
    out = {}
    for name in R.CASES:
        out.update(_case_inputs(name))
    for name, cfg in PR.STEP_CFGS.items():
        train = TModel(cfg, "cpu").init(prng.key(0))
        for key, leaf in tree_items(train):
            out[f"train/{name}/param/{key.replace('/', '.')}"] = leaf.numpy()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the reference's outputs, the ranks' outputs): the reference's
    subprocess runs while the port's ranks do."""
    tmp = tmp_path_factory.mktemp("serve_mesh")
    np.savez(tmp / "inputs.npz", **_inputs())
    cases = {name: {"arch": c.arch, "mesh": list(c.mesh), "batch": c.batch,
                    "prompt": c.prompt, "max_len": c.max_len,
                    "dp": c.dp_rules, "single": c.single,
                    "capacity": c.capacity, "dtype": c.dtype}
             for name, c in R.CASES.items()}
    step_cfg = {"cfgs": {name: {f.name: getattr(cfg, f.name)
                                for f in dataclasses.fields(cfg)}
                         for name, cfg in PR.STEP_CFGS.items()},
                "shape": [PR.STEP_SHAPE.seq_len, PR.STEP_SHAPE.global_batch],
                "steps": PR.STEP_STEPS,
                "runs": list(R.TRAIN_RUNS) + list(R.BF16_SINGLE.values())}
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(
        [sys.executable, "-c", REF_SCRIPT, str(tmp), json.dumps(cases),
         json.dumps(step_cfg), str(R.DECODE_STEPS)], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = run_ranks(R.serve_all, 8, (4, 2), "gloo", tmp,
                          str(tmp / "inputs.npz"), NAMES)
        _, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-3000:]
    with np.load(tmp / "ref.npz") as f:
        ref = {k: f[k] for k in f.files}
    return ref, ranks


def _ref_of(ref, name):
    """The reference's outputs the case is held to: its sharded steps', or
    for a ``single`` case its single-device steps'."""
    tag = f"{name}.single." if R.CASES[name].single else f"{name}."
    return {k[len(tag):]: v for k, v in ref.items() if k.startswith(tag)}


def _close(got, want, what):
    err = parity.assert_close(got, want, rtol=0.0,
                              atol_frac=parity.LM_ATOL_FRAC, what=what)
    return err / max(float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("name", F32)
def test_logits_and_tokens_match_reference(runs, name):
    """The prefill's and every decode step's logits within
    ``parity.LM_ATOL_FRAC`` of max|logit| (the vocabulary's, not the
    padding's), and the greedy tokens equal."""
    refs, ranks = runs
    ref, got = _ref_of(refs, name), ranks[0]
    vocab = R.CASES[name].cfg().vocab_size   # the padded entries are -1e9
    worst = max(_close(got[f"{name}.{k}"][..., :vocab], ref[k][..., :vocab],
                       f"{name} {k}")
                for k in ("prefill_logits", "decode_logits"))
    print(f"{name}: logits within {worst:.3e} of max|logit|")
    if R.CASES[name].single:
        sharded = refs[f"{name}.decode_logits"][..., :vocab]
        gap = float(np.max(np.abs(sharded - ref["decode_logits"][
            ..., :vocab]))) / float(np.max(np.abs(sharded)))
        print(f"{name}: the reference's sharded decode departs from its "
              f"single-device decode by {gap:.3e} of max|logit|")
    np.testing.assert_array_equal(got[f"{name}.tokens"], ref["tokens"])


@pytest.mark.parametrize("name", F32)
def test_gathered_caches_match_reference(runs, name):
    """The caches gathered from the ranks after the last step equal the
    reference's: floats within the logits' rule, ``pos`` and ``index``
    exactly."""
    refs, ranks = runs
    ref, got = _ref_of(refs, name), ranks[0]
    keys = sorted(k for k in ref if k.startswith("cache/"))
    assert keys and keys == sorted(k[len(name) + 1:] for k in got
                                   if k.startswith(f"{name}.cache/"))
    for key in keys:
        if key.endswith(("/pos", "/index")):
            np.testing.assert_array_equal(got[f"{name}.{key}"], ref[key],
                                          err_msg=key)
        else:
            _close(got[f"{name}.{key}"], ref[key], key)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_blocks(runs, name):
    """Every rank's parameter and cache leaves are exactly their spec's
    local shape, the prefill's logits carry the tokens' spec, and the
    caches of a rank hold their share of the whole caches' bytes."""
    ref, ranks = runs
    assert all(bool(r[f"{name}.shapes_ok"]) for r in ranks)
    whole = sum(v.nbytes for k, v in ref.items()
                if k.startswith(f"{name}.cache/")
                and not k.endswith("/index"))
    held = [int(r[f"{name}.cache_bytes"]) for r in ranks]
    print(f"{name}: each rank holds {held[0]} of {whole} cache bytes")
    assert all(h == held[0] for h in held) and held[0] < whole


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_stay_in_sequence_blocks(runs, name):
    """Where the step splits its products over ``model`` and ``model``
    divides the prompt's positions, each rank's prefill logits are its
    block of the sequence, 1 / ``model`` of them, on the caches' rows,
    never gathered in the step, the enc-dec model's too; elsewhere (a
    prompt of 15 positions on 2 ranks) they come back whole on the tokens'
    rows."""
    _, ranks = runs
    case = R.CASES[name]
    data, model = case.mesh
    vocab = case.cfg().padded_vocab
    splits = model > 1 and case.prompt % model == 0
    rows = case.batch // data
    if case.dp_rules and not splits:
        rows = case.batch // (data * model)
    want = ((rows, case.prompt // model, vocab) if splits
            else (rows, case.prompt, vocab))
    for r in ranks:
        assert tuple(r[f"{name}.prefill_block_shape"]) == want


@pytest.mark.parametrize("name", ["dense.2x4", "step.bf16.2x4",
                                  "gemma2.bf16.2x4"])
def test_bulk_prefill_repeats_the_kv_heads(runs, name):
    """On (2, 4) ``model`` does not divide the 2 kv heads: the bulk
    prefill of every layer repeats them (``_maybe_repeat_kv``), as the
    reference's bulk prefill does."""
    _, ranks = runs
    assert R.CASES[name].mesh == (2, 4)
    layers = R.CASES[name].cfg().num_layers
    assert int(ranks[0][f"{name}.prefill_repeats"]) == layers


@functools.lru_cache(maxsize=None)
def _plain_serve(name):
    """Case ``name`` through the port's plain ``Model.prefill`` /
    ``decode_step`` on one device (no mesh), from the case's parameters,
    prompt and tokens (greedy, or a bfloat16 case's seeded ones): results
    by key suffix, as ``R.serve_case`` gives them."""
    from repro_torch.interop import caches_to_numpy, model_params_from_numpy

    case = R.CASES[name]
    inputs = _case_inputs(name)
    model = TModel(case.cfg(), "cpu")
    params = model.load_params(model_params_from_numpy(
        R.unflatten(inputs, f"{name}/param/"), "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in
             R.case_inputs(name, case).items()}
    forced = R.decode_tokens(name, case)

    def next_token(logits, i):
        if forced is not None:
            return torch.from_numpy(forced[:, i:i + 1].copy())
        return torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]

    caches = model.init_caches(case.batch, case.max_len)
    with torch.no_grad():
        logits, caches, extras = model.prefill(params, batch, caches)
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
    return out


def _serve_gap(got, want, vocab):
    """The worst gap between two bfloat16 runs of a case (dicts by key
    suffix): the logits' as a fraction of max|want| over the vocabulary,
    each float cache leaf's as a fraction of its max|want|."""
    gaps = [float(np.max(np.abs(got[k][..., :vocab] - want[k][..., :vocab])))
            / float(np.max(np.abs(want[k][..., :vocab])))
            for k in ("prefill_logits", "decode_logits")]
    for k in want:
        if k.startswith("cache/") and not k.endswith(("/pos", "/index")):
            gaps.append(float(np.max(np.abs(got[k] - want[k])))
                        / max(float(np.max(np.abs(want[k]))), 1e-30))
    return max(gaps)


@pytest.mark.parametrize("name", BF16)
def test_bf16_serving_matches_reference_sharded_steps(runs, name):
    """A bfloat16 case (the sharded-step config and gemma2-2b smoke on
    (4, 2) and (2, 4), seeded decode tokens) through the split serving
    steps against the reference's sharded bfloat16 serving steps: the
    prefill's and every decode step's logits and the gathered caches
    within ``parity.LM_BF16_SERVE_SPLIT_ATOL_FRAC``, ``pos`` and
    ``index`` exactly. The reference's own sharded steps meet the rule
    against its single-device steps, and the port's one-device steps
    against those (the readings the rule was set from)."""
    refs, ranks = runs
    vocab = R.CASES[name].cfg().vocab_size
    got = {k[len(name) + 1:]: v for k, v in ranks[0].items()
           if k.startswith(name + ".")}
    want = {k[len(name) + 1:]: v for k, v in refs.items()
            if k.startswith(name + ".")
            and not k.startswith(name + ".single.")}
    single = {k[len(name) + 8:]: v for k, v in refs.items()
              if k.startswith(name + ".single.")}
    for key in want:
        if key.endswith(("/pos", "/index")):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    one = _plain_serve(name)
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


#: cases served on a (1, 1) mesh beside the plain path: a bulk prefill,
#: a prompt of 15 positions, and bfloat16
ONE_RANK = ["dense", "dense.heads", "gemma2.bf16.4x2"]


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """The ``ONE_RANK`` cases through the serving builders on one gloo
    rank, a (1, 1) mesh."""
    tmp = tmp_path_factory.mktemp("serve_one_rank")
    inputs = {}
    for name in ONE_RANK:
        inputs.update(_case_inputs(name))
    np.savez(tmp / "inputs.npz", **inputs)
    (got,) = run_ranks(R.serve_one_rank, 1, (1, 1), "gloo", tmp,
                       str(tmp / "inputs.npz"), ONE_RANK)
    return got


@pytest.mark.parametrize("name", ONE_RANK)
def test_one_rank_mesh_gives_the_plain_bits(one_rank, name):
    """On a (1, 1) mesh every split, collective and slice of the serving
    steps is skipped: ``build_prefill`` / ``build_decode`` give the plain
    path's logits, tokens and caches bit for bit."""
    want = _plain_serve(name)
    for key, value in want.items():
        np.testing.assert_array_equal(one_rank[f"{name}.{key}"], value,
                                      err_msg=key)


def test_sharded_train_step_matches_reference_sharded_step(runs):
    """``PR.STEP_CFG``'s plain sharded step on (4, 2) and on (2, 4) (its
    products split over ``model``; on (2, 4) the 2 kv heads repeated for
    the 4 ranks of ``model``) against the reference's sharded
    ``build_train`` step on the Auto-axes mesh of the same shape, from the
    same parameters and batches."""
    ref, ranks = runs
    got = ranks[0]
    for tag in ("train", "train.2x4"):
        np.testing.assert_allclose(got[f"{tag}.losses"], ref[f"{tag}.losses"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(got[f"{tag}.grad_norm"],
                                   ref[f"{tag}.grad_norm"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        keys = sorted(k for k in ref if k.startswith(f"{tag}.param."))
        assert keys and keys == sorted(k for k in got
                                       if k.startswith(f"{tag}.param."))
        for key in keys:
            parity.assert_close(got[key], ref[key], rtol=0.0,
                                atol_frac=parity.LM_GRAD_ATOL_FRAC, what=key)


def _gap(a, b):
    """(the worst relative gap of the losses and the grad norm, the worst
    gap of a parameter as a fraction of its leaf's max|b|) between the
    train runs ``a`` and ``b`` (two dicts of results by key suffix)."""
    scal = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k])))
               for k in ("losses", "grad_norm"))
    keys = sorted(k for k in b if k.startswith("param."))
    assert keys and keys == sorted(k for k in a if k.startswith("param."))
    par = max(float(np.max(np.abs(a[k] - b[k]))) /
              max(float(np.max(np.abs(b[k]))), 1e-30) for k in keys)
    return scal, par


def _train_run(results, tag):
    return {k[len(tag) + 1:]: v for k, v in results.items()
            if k.startswith(tag + ".")}


@functools.lru_cache(maxsize=None)
def _one_rank_bf16(name):
    """The port's plain ``make_train_step`` in bfloat16 on one device from
    the parameters the train runs of ``name`` start from: results by key
    suffix, as ``_train_run`` gives them."""
    cfg = dataclasses.replace(PR.STEP_CFGS[name], dtype="bfloat16")
    model = TModel(cfg, "cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      model.init(prng.key(0)))
    opt = init_opt_state(params)
    step = make_train_step(model, R.opt_config(R.BF16_EPS))
    losses = []
    for i in range(PR.STEP_STEPS):
        params, opt, m = step(params, opt, to_device(
            make_batch(cfg, PR.STEP_SHAPE, 0, i), "cpu"))
        losses.append(float(m["loss"]))
    out = {"losses": np.asarray(losses),
           "grad_norm": np.asarray(float(m["grad_norm"]))}
    out.update({"param." + k.replace("/", "."): v.detach().numpy()
                for k, v in tree_items(params)})
    return out


@pytest.mark.parametrize("tag, name", [(t, n) for t, n, _, d, _ in
                                       R.TRAIN_RUNS if d == "bfloat16"])
def test_bf16_sharded_train_step_matches_reference_sharded_step(runs, tag,
                                                                name):
    """``PR.STEP_CFGS[name]``'s sharded step in bfloat16 on (4, 2) and
    (2, 4) (bfloat16 partial sums reduce-scattered over ``model``) against
    the reference's sharded bfloat16 step on the Auto-axes mesh of the
    same shape, both at AdamW eps ``R.BF16_EPS``: losses and grad norm
    within ``parity.LM_BF16_SPLIT_RTOL``, every parameter within
    ``parity.LM_BF16_SPLIT_ATOL_FRAC`` of its leaf's max. The reference's
    own sharded step meets the same rule against its single-device step,
    and the port's one-device step against that step (the readings the
    rule was set from)."""
    ref, ranks = runs
    want, got = _train_run(ref, tag), _train_run(ranks[0], tag)
    single, one = _train_run(ref, R.BF16_SINGLE[name][0]), _one_rank_bf16(name)
    gaps = {"port split - ref sharded": _gap(got, want),
            "ref sharded - ref single": _gap(want, single),
            "port split - port one rank": _gap(got, one),
            "port one rank - ref single": _gap(one, single)}
    for what, (scal, par) in gaps.items():
        print(f"{tag}: {what}: {scal:.3e} (losses, grad norm, relative), "
              f"{par:.3e} (parameters, of a leaf's max)")
    for what in ("port split - ref sharded", "ref sharded - ref single",
                 "port one rank - ref single"):
        scal, par = gaps[what]
        assert scal <= parity.LM_BF16_SPLIT_RTOL, (what, scal)
        assert par <= parity.LM_BF16_SPLIT_ATOL_FRAC, (what, par)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("arch", ["qwen3-32b", "nemotron-4-15b",
                                  "stablelm-12b", "gemma2-2b"])
def test_serving_rank_computes_its_share(arch, m, kind):
    """Rank 0 of a (1, m) mesh on a fake world: ``build_prefill``'s and
    ``build_decode``'s steps on a dense smoke config (batch 2, 32 positions
    or cache slots) compute their share of the one-rank step's FLOPs
    (``launch.dryrun.measure``, op_cost on meta tensors). The reckoning:
    every product splits over ``model`` but two. A bulk prefill also
    projects every kv head on the positions of its own 1 / m of the slots
    (1 / m of the kv projection more), and where ``model`` does not divide
    the 2 kv heads (m = 4) a rank projects a whole kv head for its one q
    head, in both steps. At smoke widths the kv projection is 10 % of a
    layer's FLOPs (8 192 of 81 920 a position for swiglu, 8 192 of 65 536
    for gelu and squared-relu), so the rank's share is at most 1.25 / m;
    at full width it is 1-2 % of a decode layer (ROADMAP item 22(b))."""
    cfg = tconfig.get_config(arch, smoke=True)
    shape = tconfig.ShapeConfig(kind[0], kind, 32, 2)
    with fake_world(m):
        got = dryrun.measure(cfg, shape, make_mesh((1, m),
                                                   ("data", "model")))
    share = got["flops"] / got["flops_one_rank"]
    print(f"{arch} smoke {kind} on (1, {m}): rank 0 computes {share:.4f} "
          f"of the one-rank step's {got['flops_one_rank']} FLOPs (x{m}: "
          f"{share * m:.4f})")
    assert 1 / m <= share <= 1.25 / m
    assert got["replicated_compute"] <= 1.25


@pytest.mark.parametrize("fallback", [False, True],
                         ids=["train layout", "serving layout"])
def test_a_residual_that_does_not_split(fallback):
    """A forward of 15 positions on 2 ranks of ``model`` (``fsdp.residual``):
    a serving layout (``seq_fallback``) leaves its residual whole on both
    ranks (``whole_seq`` inside the forward, and only there), as the
    reference's divisibility fallback does; a train layout raises rather
    than fall back to whole products. 16 positions split under both."""
    with fake_world(2):
        mesh = make_mesh((1, 2), ("data", "model"))
        layout = fsdp.make_layout(mesh, (), split=True,
                                  seq_fallback=fallback)
        with tsharding.use_mesh(mesh), fsdp.use_layout(layout):
            if fallback:
                with fsdp.residual(15) as split:
                    assert not split and fsdp.whole_seq()
                assert not fsdp.whole_seq()
            else:
                with pytest.raises(ValueError, match="do not split"):
                    with fsdp.residual(15):
                        pass
            with fsdp.residual(16) as split:
                assert split and not fsdp.whole_seq()


class _StandIn:
    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}


ROWS = ("moe.rows", "mla.rows")


@pytest.mark.parametrize("build", [build_prefill, build_decode])
def test_moe_on_a_split_batch_raises(runs, build):
    """An MoE FFN on caches whose rows split the batch ("moe.rows" and
    "mla.rows": 32 rows over the 4 ranks of ``data``): ``build`` takes a
    mesh that splits the batch as well as one that does not, and in the
    reference's single-device steps of its kind (the prefill, or the
    decode steps) the whole batch's capacity keeps other pairs than each
    rank's own capacity would: it drops pairs in every prefill call and
    in some decode step. The ranks' logits and caches match those steps
    (``test_logits_and_tokens_match_reference``), so they routed over the
    whole batch."""
    refs, _ = runs
    prefill = build is build_prefill
    for name in ROWS:
        case = R.CASES[name]
        cfg, m = case.cfg(), case.cfg().moe
        shape = tconfig.ShapeConfig("s", "prefill" if prefill else "decode",
                                    case.prompt if prefill else case.max_len,
                                    case.batch)
        build(cfg, shape, _StandIn(*case.mesh))
        build(cfg, shape, _StandIn(1, 8))
        tag = f"{name}.single.ids/"
        ids = [refs[k] for k in sorted(k for k in refs if k.startswith(tag))]
        layers = cfg.num_layers - m.first_moe_layer
        assert len(ids) == layers * (1 + R.DECODE_STEPS)
        n = case.mesh[0]
        differ = []
        for a in (ids[:layers] if prefill else ids[layers:]):
            t = a.shape[0]
            whole = parity.moe_kept_pairs(a, _capacity(
                t, m.num_experts, m.top_k, m.capacity_factor),
                m.num_experts)
            own = set().union(*(parity.moe_kept_pairs(
                a[r * t // n:(r + 1) * t // n], _capacity(
                    t // n, m.num_experts, m.top_k, m.capacity_factor),
                m.num_experts, r * t // n) for r in range(n)))
            differ.append(own != whole)
        print(f"{name} {shape.kind}: per-rank capacity differs in "
              f"{sum(differ)} of {len(differ)} calls")
        assert all(differ) if prefill else any(differ), differ
