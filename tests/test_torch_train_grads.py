"""The training loss and the gradient of every parameter against the live
reference, on the CPU at smoke size: the port's ``make_loss_fn`` under
``torch.autograd.grad`` against ``jax.jit(jax.value_and_grad(
make_loss_fn(model), has_aux=True))`` on the same parameters (drawn by
the port, handed to the reference bit for bit) and the same batch (the
reference's ``make_batch``). This file holds the dense, vlm, MLA and
enc-dec configs, the bfloat16 parameters' master-copy step, the remat
policies and the microbatches; ``tests/test_torch_train_families.py`` the
MoE, SSM and hybrid ones.

Tolerances (``repro_torch.testing.parity``): per parameter leaf,
``LM_GRAD_ATOL_FRAC`` of its max|reference gradient| in float32 (the
loss to it relatively) and ``lm_bf16_grad_atol_frac(L)`` in bfloat16
(the loss to ``lm_bf16_atol_frac(L)``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.data.tokens import make_batch as jmake_batch
from repro.models.model import Model as JModel
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.train.train_step import make_loss_fn as jmake_loss_fn
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch import config as tconfig
from repro_torch.core import prng
from repro_torch.data.tokens import make_batch
from repro_torch.models.model import Model as TModel
from repro_torch.optim.adamw import init_opt_state
from repro_torch.tree import tree_leaves
from repro_torch.train.train_step import (make_eval_step, make_loss_fn,
                                          make_train_step)
from repro_torch.testing import parity

torch.set_num_threads(1)

SEQ, BATCH = 32, 2


def to_np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def configs(arch, dtype="float32", param_dtype="float32", **over):
    kw = dict(dtype=dtype, param_dtype=param_dtype, **over)
    return (dataclasses.replace(jconfig.get_config(arch, smoke=True), **kw),
            dataclasses.replace(tconfig.get_config(arch, smoke=True), **kw))


def to_ref(tree):
    """The port's parameter tree as the reference's, bit for bit
    (bfloat16 through float32, exact)."""
    return jax.tree.map(lambda t: jnp.asarray(to_np(t)).astype(
        jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32), tree)


def setup(arch, dtype="float32", param_dtype="float32", seed=0, **over):
    """(reference model, its params, port model, its trainable params,
    the numpy batch)."""
    jcfg, tcfg = configs(arch, dtype, param_dtype, **over)
    tm = TModel(tcfg, "cpu")
    tp = tm.init(prng.key(seed), trainable=True)
    jm = JModel(jcfg)
    shape = jconfig.ShapeConfig("t", "train", SEQ, BATCH)
    batch = jmake_batch(jcfg, shape, seed, 0)
    return jm, to_ref(tp), tm, tp, batch


def port_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def port_value_and_grad(tm, tp, batch):
    leaves = flatten(tp)
    total, metrics = make_loss_fn(tm)(tp, port_batch(batch))
    grads = torch.autograd.grad(total, list(leaves.values()),
                                allow_unused=True)
    return ({k: float(v.detach()) for k, v in metrics.items()},
            dict(zip(leaves, grads)))


def ref_value_and_grad(jm, jp, batch):
    fn = jax.jit(jax.value_and_grad(jmake_loss_fn(jm), has_aux=True))
    (_, metrics), grads = fn(jp, {k: jnp.asarray(v) for k, v in
                                  batch.items()})
    return ({k: float(v) for k, v in metrics.items()},
            flatten(jax.tree.map(np.asarray, grads)))


def check_grads(tgrads, jgrads, cfg):
    """Every leaf's gradient within the dtype's rule; returns the worst
    fraction of a leaf's max|reference| (for the record)."""
    assert set(tgrads) == set(jgrads)
    frac = (parity.LM_GRAD_ATOL_FRAC if cfg.dtype == "float32"
            else parity.lm_bf16_grad_atol_frac(cfg.num_layers))
    worst = 0.0
    for name, ref in jgrads.items():
        ref = to_np(ref)
        g = tgrads[name]
        port = np.zeros_like(ref) if g is None else to_np(g)
        err = parity.assert_close(port, ref, rtol=0.0, atol_frac=frac,
                                  what=name)
        worst = max(worst, err / max(float(np.max(np.abs(ref))), 1e-30))
    return worst


def check_loss(tm, jm, tmetrics, jmetrics):
    cfg = tm.cfg
    rtol = (parity.LM_GRAD_ATOL_FRAC if cfg.dtype == "float32"
            else parity.lm_bf16_atol_frac(cfg.num_layers))
    for k in ("loss", "aux"):
        np.testing.assert_allclose(tmetrics[k], jmetrics[k], rtol=rtol,
                                   atol=1e-30, err_msg=k)


CASES = [("gemma2-2b", "float32"), ("gemma2-2b", "bfloat16"),
         ("internvl2-1b", "float32"), ("internvl2-1b", "bfloat16"),
         ("deepseek-v2-236b", "float32"),
         ("seamless-m4t-large-v2", "float32")]


@pytest.mark.parametrize("arch,dtype", CASES,
                         ids=[f"{a}-{d}" for a, d in CASES])
def test_loss_and_grads_match_reference(arch, dtype):
    jm, jp, tm, tp, batch = setup(arch, dtype)
    tmet, tgrads = port_value_and_grad(tm, tp, batch)
    jmet, jgrads = ref_value_and_grad(jm, jp, batch)
    check_loss(tm, jm, tmet, jmet)
    check_grads(tgrads, jgrads, tm.cfg)


def test_tokens_equal_reference():
    """The port's ``make_batch`` gives the reference's batches bit for bit
    (tokens and the frontend's embeddings)."""
    for arch in ("gemma2-2b", "internvl2-1b", "seamless-m4t-large-v2"):
        jcfg, tcfg = configs(arch)
        shape = tconfig.ShapeConfig("t", "train", SEQ, BATCH)
        for step in (0, 3):
            ours = make_batch(tcfg, shape, 5, step)
            ref = jmake_batch(jcfg, shape, 5, step)
            assert ours.keys() == ref.keys()
            for k in ref:
                assert ours[k].dtype == ref[k].dtype, k
                np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_bf16_params_master_step_matches_reference():
    """``param_dtype="bfloat16"``: the loss and gradients, then one train
    step of 2 microbatches through the float32 master copy, against the
    reference's jitted ``make_train_step``: the first moment (the summed
    microbatch gradients, times 1 - b1) within the bfloat16 gradient rule;
    the master copy within 2 lr of the reference's (a first AdamW step
    moves a weight by lr times about the sign of its gradient, which a
    near-zero component may flip) and the parameters its bfloat16
    rounding."""
    jm, jp, tm, tp, batch = setup("gemma2-2b", "bfloat16", "bfloat16")
    assert all(p.dtype == torch.bfloat16 for p in tree_leaves(tp))
    tmet, tgrads = port_value_and_grad(tm, tp, batch)
    jmet, jgrads = ref_value_and_grad(jm, jp, batch)
    check_loss(tm, jm, tmet, jmet)
    check_grads(tgrads, jgrads, tm.cfg)

    opt = tconfig.OptimizerConfig(lr=1e-3, warmup_steps=0)
    par = tconfig.ParallelConfig(microbatches=2)
    jopt = jconfig.OptimizerConfig(**dataclasses.asdict(opt))
    jpar = jconfig.ParallelConfig(**dataclasses.asdict(par))
    jstate = jinit_opt_state(jp)
    assert jstate.master is not None
    jnew, jstate, jm_ = jax.jit(jmake_train_step(jm, jopt, jpar))(
        jp, jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    state = init_opt_state(tp)
    assert state.master is not None
    tp, state, met = make_train_step(tm, opt, par)(tp, state,
                                                   port_batch(batch))
    rtol = parity.lm_bf16_atol_frac(tm.cfg.num_layers)
    np.testing.assert_allclose(float(met["loss"]), float(jm_["loss"]),
                               rtol=rtol)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jm_["grad_norm"]), rtol=rtol)
    assert int(state.step) == int(jstate.step) == 1
    ref_m = flatten(jax.tree.map(np.asarray, jstate.m))
    frac = parity.lm_bf16_grad_atol_frac(tm.cfg.num_layers)
    for name, m in flatten(state.m).items():
        parity.assert_close(to_np(m), ref_m[name], rtol=0.0,
                            atol_frac=frac, what=name)
    ref_master = flatten(jax.tree.map(np.asarray, jstate.master))
    ref_params = flatten(jax.tree.map(np.asarray, jnew))
    for name, p in flatten(state.master).items():
        # one step moves each weight by about lr: the update's error is a
        # fraction of lr, not of the weight
        np.testing.assert_allclose(to_np(p), ref_master[name], rtol=0.0,
                                   atol=2 * opt.lr, err_msg=name)
    for name, p in flatten(tp).items():
        assert p.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            to_np(p), to_np(flatten(state.master)[name].to(torch.bfloat16)),
            err_msg=name)
        np.testing.assert_allclose(
            to_np(p), to_np(ref_params[name]), rtol=2.0 ** -7,
            atol=2 * opt.lr, err_msg=name)


@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-moe-16b",
                                  "recurrentgemma-2b",
                                  "seamless-m4t-large-v2"])
def test_remat_policies_give_the_same_bits(arch):
    """``remat`` none, full and selective: the same loss and the same
    gradient of every leaf, bit for bit."""
    out = []
    for remat in ("none", "full", "selective"):
        _, _, tm, tp, batch = setup(arch, "float32", remat=remat)
        out.append(port_value_and_grad(tm, tp, batch))
    (met0, g0) = out[0]
    for met, g in out[1:]:
        assert met == met0
        for name in g0:
            assert torch.equal(g[name], g0[name]), name


def test_microbatches_one_and_two():
    """2 microbatches of 1 against one batch of 2: the same loss (the mean
    of two equal-count means) and the same gradients within the float32
    rule."""
    results = []
    for micro in (1, 2):
        _, _, tm, params, batch = setup("gemma2-2b", "float32")
        opt = tconfig.OptimizerConfig(lr=0.0, weight_decay=0.0,
                                      grad_clip=0.0)
        par = tconfig.ParallelConfig(microbatches=micro)
        state = init_opt_state(params)
        _, state, met = make_train_step(tm, opt, par)(params, state,
                                                      port_batch(batch))
        results.append((float(met["loss"]), float(met["grad_norm"]),
                        state.m))
    (l1, n1, m1), (l2, n2, m2) = results
    np.testing.assert_allclose(l2, l1, rtol=parity.LM_GRAD_ATOL_FRAC)
    np.testing.assert_allclose(n2, n1, rtol=parity.LM_GRAD_ATOL_FRAC)
    # m = (1 - b1) g after one step: the gradients themselves
    for name, a in flatten(m1).items():
        parity.assert_close(to_np(flatten(m2)[name]), to_np(a), rtol=0.0,
                            atol_frac=parity.LM_GRAD_ATOL_FRAC, what=name)


def test_eval_step_is_the_loss_without_a_graph():
    """``make_eval_step``: the loss function's metrics, bit for bit, with
    no autograd graph."""
    _, _, tm, tp, batch = setup("gemma2-2b", "float32")
    metrics = make_eval_step(tm)(tp, port_batch(batch))
    assert all(not v.requires_grad for v in metrics.values())
    ours, _ = port_value_and_grad(tm, tp, batch)
    assert {k: float(v) for k, v in metrics.items()} == ours
