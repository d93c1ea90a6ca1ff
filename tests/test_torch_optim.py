"""The port's AdamW (``repro_torch.optim.adamw``) against the live
reference's ``repro.optim.adamw``, on the CPU: the iterates over 5 steps
for each schedule, with clipping on and off and with a float32 master copy
of bfloat16 parameters; the schedules, the clip and the global norm; the
optimizer state carried both ways (``interop``); and the counterparts of
``tests/test_substrates.py``'s ``TestAdamW``.

The update's float stages are the reference's, but ``lr_at``'s cosine, the
bias corrections' powers and the norm's sum differ from XLA's by ULPs: the
iterates are held within ``parity.RTOL`` (relative) plus
``LM_GRAD_ATOL_FRAC`` of each leaf's max|reference|, the bfloat16
parameters within one bfloat16 ulp of the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.optim import adamw as JA
from repro_torch import config as tconfig
from repro_torch import interop
from repro_torch.optim import adamw as TA
from repro_torch.testing import parity
from repro_torch.tree import (tree_items, tree_leaves, tree_map,
                              tree_unflatten)

torch.set_num_threads(1)

SHAPES = {"a": (4, 3), "b": {"c": (5,), "w": (2, 3, 2)}}


def draw(rng, shapes, scale=1.0):
    if isinstance(shapes, dict):
        return {k: draw(rng, v, scale) for k, v in shapes.items()}
    return (rng.standard_normal(shapes) * scale).astype(np.float32)


def to_torch(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.from_numpy(x.copy()).to(dtype), tree)


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    x = np.asarray(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def close(port, ref, what, rtol=parity.RTOL):
    for (path, r), p in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                            jax.tree.leaves(jax.tree.map(
                                to_np, port,
                                is_leaf=lambda x: isinstance(x,
                                                             torch.Tensor)))):
        parity.assert_close(p, to_np(r), rtol=rtol,
                            atol_frac=parity.LM_GRAD_ATOL_FRAC,
                            what=f"{what} {jax.tree_util.keystr(path)}")


def opt_cfgs(**kw):
    return jconfig.OptimizerConfig(**kw), tconfig.OptimizerConfig(**kw)


@functools.lru_cache(maxsize=None)
def ref_update(cfg):
    return jax.jit(functools.partial(JA.adamw_update, cfg))


CASES = [("cosine", 1.0, "float32"), ("linear", 0.0, "float32"),
         ("constant", 1.0, "float32"), ("cosine", 0.5, "bfloat16"),
         ("linear", 1.0, "bfloat16")]


@pytest.mark.parametrize("schedule,clip,dtype", CASES,
                         ids=[f"{s}-clip{c:g}-{d}" for s, c, d in CASES])
def test_adamw_iterates_match_reference(schedule, clip, dtype):
    """5 steps from the same parameters and gradients: parameters, moments,
    master copy, step, lr and grad norm against the reference's."""
    jcfg, tcfg = opt_cfgs(lr=0.05, warmup_steps=2, total_steps=6,
                          schedule=schedule, grad_clip=clip,
                          weight_decay=0.1)
    rng = np.random.default_rng(len(schedule) + int(clip * 10))
    p0 = draw(rng, SHAPES)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    tp = to_torch(p0, getattr(torch, dtype))
    jstate, tstate = JA.init_opt_state(jp), TA.init_opt_state(tp)
    assert (jstate.master is None) == (tstate.master is None) \
        == (dtype == "float32")
    for step in range(5):
        g = draw(rng, SHAPES, scale=3.0)
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        jp, jstate, jmet = ref_update(jcfg)(jp, jg, jstate)
        tp, tstate, tmet = TA.adamw_update(
            tcfg, tp, to_torch(g, getattr(torch, dtype)), tstate)
        what = f"step {step + 1}"
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       rtol=parity.RTOL, err_msg=k)
        close(tstate.m, jstate.m, f"{what} m")
        close(tstate.v, jstate.v, f"{what} v")
        if dtype == "float32":
            close(tp, jp, f"{what} params")
        else:
            close(tstate.master, jstate.master, f"{what} master")
            close(tp, jp, f"{what} params", rtol=2.0 ** -8)
            for p, m in zip(tree_leaves(tp),
                            tree_leaves(tstate.master)):
                assert p.dtype == torch.bfloat16
                assert torch.equal(p, m.to(torch.bfloat16))


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_schedule_matches_reference(schedule):
    jcfg, tcfg = opt_cfgs(lr=3e-4, warmup_steps=10, total_steps=100,
                          schedule=schedule)
    for s in (0, 1, 5, 10, 11, 37, 99, 100, 150):
        ref = float(JA.lr_at(jcfg, jnp.asarray(s, jnp.int32)))
        ours = float(TA.lr_at(tcfg, torch.tensor(s, dtype=torch.int32)))
        np.testing.assert_allclose(ours, ref, rtol=parity.RTOL, err_msg=s)


def test_global_norm_and_clip_match_reference():
    rng = np.random.default_rng(3)
    g = draw(rng, SHAPES, scale=10.0)
    jclipped, jnorm = JA.clip_by_global_norm(
        jax.tree.map(jnp.asarray, g), 1.0)
    tclipped, tnorm = TA.clip_by_global_norm(to_torch(g), 1.0)
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=parity.RTOL)
    np.testing.assert_allclose(float(TA.global_norm(to_torch(g))),
                               float(JA.global_norm(g)), rtol=parity.RTOL)
    close(tclipped, jclipped, "clipped")


def test_opt_state_interop_round_trip():
    """The reference's state (with a master copy) into the port and back,
    bit for bit; a state without one keeps ``master`` None."""
    rng = np.random.default_rng(4)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                      draw(rng, SHAPES))
    jstate = JA.init_opt_state(jp)
    g = jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16),
                     draw(rng, SHAPES))
    jp, jstate, _ = ref_update(jconfig.OptimizerConfig())(jp, g, jstate)
    tstate = interop.opt_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                          "cpu")
    assert isinstance(tstate, TA.OptState)
    assert tstate.step.dtype == torch.int32 and int(tstate.step) == 1
    back = interop.opt_state_to_numpy(tstate)
    ref = jax.tree.map(np.asarray, jstate)._asdict()
    for field in ("step", "m", "v", "master"):
        for a, b in zip(jax.tree.leaves(back[field]),
                        jax.tree.leaves(ref[field])):
            np.testing.assert_array_equal(a, b, err_msg=field)
    plain = JA.init_opt_state(jax.tree.map(jnp.asarray, draw(rng, SHAPES)))
    assert interop.opt_state_from_numpy(
        jax.tree.map(np.asarray, plain), "cpu").master is None
    assert interop.opt_state_to_numpy(
        TA.init_opt_state(to_torch(draw(rng, SHAPES))))["master"] is None


def test_tree_walk_is_jax_flattening_order():
    """``repro_torch.tree`` walks dicts (keys out of order), NamedTuples
    and None as ``jax.tree_util`` flattens them, and ``tree_unflatten``
    puts the leaves back."""
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal(3).astype(np.float32)
              for k in ("a", "b", "c", "d")}
    jtree = JA.OptState(step=np.int32(0),
                        m={"z": arrays["a"], "b": {"y": arrays["b"],
                                                   "x": arrays["c"]}},
                        v={"k": arrays["d"]}, master=None)
    ttree = TA.OptState(step=torch.tensor(0, dtype=torch.int32),
                        m={"z": torch.from_numpy(arrays["a"]),
                           "b": {"y": torch.from_numpy(arrays["b"]),
                                 "x": torch.from_numpy(arrays["c"])}},
                        v={"k": torch.from_numpy(arrays["d"])}, master=None)
    jpaths, _ = jax.tree_util.tree_flatten_with_path(jtree)
    want = ["/".join(getattr(k, "name", None) or str(k.key) for k in path)
            for path, _ in jpaths]
    got = tree_items(ttree)
    assert [p for p, _ in got] == want
    for (_, t), (_, j) in zip(got, jpaths):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    doubled = tree_unflatten(ttree, [2 * x for x in tree_leaves(ttree)])
    assert doubled.master is None
    assert torch.equal(doubled.m["b"]["x"], 2 * ttree.m["b"]["x"])
    halved = tree_map(lambda x: x / 2, doubled)
    for x, y in zip(tree_leaves(halved), tree_leaves(ttree)):
        assert torch.equal(x, y)


class TestAdamW:
    """``tests/test_substrates.py::TestAdamW`` on the port."""

    def test_quadratic_convergence(self):
        cfg = tconfig.OptimizerConfig(lr=0.1, warmup_steps=0,
                                      total_steps=200, schedule="constant",
                                      weight_decay=0.0, grad_clip=0.0)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = TA.init_opt_state(params)
        target = torch.tensor([1.0, 2.0])
        for _ in range(200):
            grads = {"w": 2 * (params["w"] - target)}
            params, state, _ = TA.adamw_update(cfg, params, grads, state)
        np.testing.assert_allclose(params["w"].numpy(), target.numpy(),
                                   atol=1e-2)

    def test_grad_clip(self):
        g = {"a": torch.full((10,), 100.0)}
        clipped, norm = TA.clip_by_global_norm(g, 1.0)
        assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
        assert float(norm) > 100.0

    def test_schedule_shapes(self):
        cfg = tconfig.OptimizerConfig(lr=1.0, warmup_steps=10,
                                      total_steps=100, schedule="cosine")
        lrs = [float(TA.lr_at(cfg, torch.tensor(s)))
               for s in range(0, 101, 10)]
        assert lrs[0] == 0.0
        assert abs(lrs[1] - 1.0) < 1e-6          # end of warmup
        assert lrs[-1] < 1e-6                    # cosine floor
        assert all(a >= b - 1e-9 for a, b in zip(lrs[1:], lrs[2:]))
