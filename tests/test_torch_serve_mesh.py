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
from repro_torch.launch.specs import build_decode, build_prefill
from repro_torch.models.encdec import encode
from repro_torch.models.model import Model as TModel
from repro_torch.models.moe import _capacity
from repro_torch.optim.adamw import init_opt_state
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


def flat(tree, prefix):
    res = {}
    for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "name", getattr(p, "key", p)))
                       for p in path)
        res[prefix + key] = np.asarray(v)
    return res


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
    res[name + ".single.prefill_logits"] = np.asarray(logits)
    tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
    toks, outs = [np.asarray(tok)], []
    dec = jax.jit(model.decode_step)
    for i in range(steps):
        logits, caches = dec(params, {"tokens": tok}, caches,
                             jnp.int32(c["prompt"] + i), extras)
        outs.append(np.asarray(logits))
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
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
    cfg = dataclasses.replace(C.get_config(c["arch"], smoke=True),
                              dtype="float32")
    if c["capacity"] is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=c["capacity"]))
    if c["single"]:
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
        res[name + ".prefill_logits"] = np.asarray(logits)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
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
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits[:, -1], axis=-1).astype(
                jnp.int32)[:, None]
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


def _inputs():
    """Every case's parameters (the port's draw from ``prng.key(0)``),
    prompt and, for the enc-dec case, the encoder's states over its
    ``enc_embeds``; and ``PR.STEP_CFG``'s parameters for the train
    step."""
    out = {}
    for name, case in R.CASES.items():
        cfg = case.cfg()
        model = TModel(cfg, "cpu")
        params = model.init(prng.key(0))
        for key, leaf in tree_items(params):
            out[f"{name}/param/{key.replace('/', '.')}"] = leaf.numpy()
        for key, value in R.case_inputs(name, case).items():
            out[f"{name}/batch/{key}"] = value
        if cfg.is_encoder_decoder:
            with torch.no_grad():
                states, positions = encode(params, torch.from_numpy(
                    out[f"{name}/batch/enc_embeds"]), cfg)
            out[f"{name}/enc_states"] = states.numpy()
            out[f"{name}/enc_positions"] = positions.contiguous().numpy()
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
                    "capacity": c.capacity}
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


@pytest.mark.parametrize("name", NAMES)
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


@pytest.mark.parametrize("name", NAMES)
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
