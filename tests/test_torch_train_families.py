"""The training loss and gradients of the MoE, SSM and hybrid families
against the live reference, on the CPU at smoke size (the method and the
tolerances of ``tests/test_torch_train_grads.py``, whose helpers this file
uses): deepseek-moe-16b at capacity factor 1.25, where pairs drop, and at
E / k, where none can, with the aux load-balance loss's own gradient;
mamba2-780m; recurrentgemma-2b; each in float32 and bfloat16.

In bfloat16 an MoE top-k choice may flip at a near-tie between the
packages (``parity.moe_flips``): a discontinuity, not a tolerance. There
the port takes the experts the reference chose (recorded through a
``jax.debug.callback`` inside the reference's jitted gradient), and every
one of its own choices that differs must sit at a near-tie.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMOE
from repro.train.train_step import make_loss_fn as jmake_loss_fn
from repro_torch.models import moe as TMOE
from repro_torch.testing import parity
from repro_torch.train.train_step import make_loss_fn

from test_torch_train_grads import (check_grads, check_loss, flatten,
                                    port_batch, port_value_and_grad,
                                    ref_value_and_grad, setup, to_np)

torch.set_num_threads(1)


def moe_no_drop(arch="deepseek-moe-16b"):
    """The capacity factor E / k, at which no expert can overflow."""
    from repro_torch.config import get_config
    m = get_config(arch, smoke=True).moe
    return dataclasses.replace(m, capacity_factor=m.num_experts / m.top_k)


@pytest.mark.parametrize("capacity", ["1.25", "E/k"])
def test_moe_loss_grads_and_drops(capacity):
    """float32: equal routing and drops in every MoE call, the loss and
    every gradient within the float32 rule; drops happen at 1.25 and never
    at E / k."""
    over = {} if capacity == "1.25" else {"moe": moe_no_drop()}
    jm, jp, tm, tp, batch = setup("deepseek-moe-16b", "float32", **over)
    with TMOE.routing_log() as log:
        tmet, tgrads = port_value_and_grad(tm, tp, batch)
    drops = sum(int(TMOE.dropped_pairs(e)) for e in log)
    assert (drops > 0) if capacity == "1.25" else drops == 0, drops
    jmet, jgrads = ref_value_and_grad(jm, jp, batch)
    check_loss(tm, jm, tmet, jmet)
    check_grads(tgrads, jgrads, tm.cfg)


def test_moe_aux_loss_gradient():
    """The aux load-balance loss's own gradient (router and the layers
    below it) at capacity factor 1.25, float32."""
    jm, jp, tm, tp, batch = setup("deepseek-moe-16b", "float32")
    leaves = flatten(tp)
    _, metrics = make_loss_fn(tm)(tp, port_batch(batch))
    grads = torch.autograd.grad(metrics["aux"], list(leaves.values()),
                                allow_unused=True)
    jgrads = jax.jit(jax.grad(lambda p, b: jmake_loss_fn(jm)(p, b)[1]["aux"]))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = flatten(jax.tree.map(np.asarray, jgrads))
    assert np.max(np.abs(jgrads["moe_layers.ffn.router"])) > 0
    check_grads(dict(zip(leaves, grads)), jgrads, tm.cfg)


@contextlib.contextmanager
def replayed_reference_routing():
    """Inside the block the reference records (probs, ids) of every
    ``apply_moe`` call of its jitted gradient, and the port's ``route``
    takes those ids in call order, asserting that each of its own choices
    that differs sits at a near-tie. Yields (reference log, flip count)."""
    log, flips = [], [0]
    apply_moe, route = JMOE.apply_moe, TMOE.route

    def recorded(params, x, cfg):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", xf.astype(jnp.float32), params["router"]), axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda p, i: log.append((np.asarray(p),
                                                    np.asarray(i))),
                           probs, ids)
        return apply_moe(params, x, cfg)

    calls = iter(range(1 << 30))

    def replay(router, xf, top_k):
        probs, _, own = route(router, xf, top_k)
        jprobs, jids = log[next(calls)]
        ids = torch.from_numpy(jids.astype(np.int64))
        flips[0] += int(parity.moe_flips(own.numpy(), jids,
                                         to_np(probs), jprobs).sum())
        weights = torch.gather(probs, 1, ids)
        return probs, weights / torch.sum(weights, dim=-1, keepdim=True), ids

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JMOE, "apply_moe", recorded)
        mp.setattr(TMOE, "route", replay)
        yield log, flips


def test_moe_bf16_grads_with_the_reference_routing():
    """bfloat16 at capacity factor 1.25 (remat off: the replay is consumed
    once a call), the port on the reference's experts."""
    jm, jp, tm, tp, batch = setup("deepseek-moe-16b", "bfloat16",
                                  remat="none")
    with replayed_reference_routing() as (log, flips):
        jmet, jgrads = ref_value_and_grad(jm, jp, batch)
        assert len(log) == tm.cfg.num_layers - tm.cfg.moe.first_moe_layer
        tmet, tgrads = port_value_and_grad(tm, tp, batch)
    check_loss(tm, jm, tmet, jmet)
    check_grads(tgrads, jgrads, tm.cfg)


CASES = [("mamba2-780m", "float32"), ("mamba2-780m", "bfloat16"),
         ("recurrentgemma-2b", "float32"), ("recurrentgemma-2b", "bfloat16")]


@pytest.mark.parametrize("arch,dtype", CASES,
                         ids=[f"{a}-{d}" for a, d in CASES])
def test_recurrent_loss_and_grads_match_reference(arch, dtype):
    jm, jp, tm, tp, batch = setup(arch, dtype)
    tmet, tgrads = port_value_and_grad(tm, tp, batch)
    jmet, jgrads = ref_value_and_grad(jm, jp, batch)
    check_loss(tm, jm, tmet, jmet)
    check_grads(tgrads, jgrads, tm.cfg)
