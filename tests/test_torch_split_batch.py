"""Whole-batch statistics on a batch split over ranks: the MoE routing
(capacity, drops, aux) and the loss mask's denominator, held against the
reference's single-device step, which GSPMD preserves under any mesh.

* (d) one process: ``models.moe.apply_moe`` on row blocks cut from one
  batch, each block under a stand-in layout that hands it the other
  blocks' counts and sums, keeps exactly the pairs of the whole batch's
  call; its outputs, aux and (through ``fsdp.Layout.whole_batch``'s
  gradient) the step's gradient equal the whole batch's.
* (a) 8 gloo ranks: deepseek-moe-16b's smoke config in float32 at
  capacity factor 0.5 through ``launch.specs.build_train``, one and two
  microbatches on (4, 2) and ZeRO-1 with two microbatches and remat on a
  (2, 2, 2) ``("pod", "data", "model")`` mesh, against the reference's
  jitted single-device step (AdamW's eps ``R.OPT_EPS``, which says why):
  loss, aux and every parameter after ``STEPS`` steps within
  ``parity.LM_GRAD_ATOL_FRAC``, every top-k choice the reference's
  (``parity.moe_flips``). Each case asserts that the
  reference drops pairs and that each rank's own capacity would keep
  other pairs than the whole batch's.
"""
import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro.data.tokens import make_batch as jmake_batch
from repro.models import moe as JMOE
from repro.models.model import Model as JModel
from repro.optim.adamw import init_opt_state as jinit_opt_state
from repro.train.train_step import make_train_step as jmake_train_step
from repro_torch.core import prng
from repro_torch.models import moe as TMOE
from repro_torch.models.model import Model as TModel
from repro_torch.parallel import fsdp
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks
from repro_torch.tree import tree_map

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_split_batch_ranks as R  # noqa: E402

torch.set_num_threads(1)


def kept_pairs(ids, limit, first_token: int = 0):
    return parity.moe_kept_pairs(ids, limit, R.MOE_CFG.moe.num_experts,
                                 first_token)


# ---------------------------------------------------------------------------
# (d) one process: row blocks under a stand-in layout
# ---------------------------------------------------------------------------

class _Blocks:
    """A layout for row block ``rank`` of ``n`` run one after another in
    this process. Recording (``seen`` None), it keeps what the block hands
    to the collectives; replaying, it hands back every block's record, as
    the all-gather and the all-reduce would."""

    def __init__(self, n, rank, seen=None):
        self.batch_n, self.rank, self.seen = n, rank, seen
        self.calls = []

    def batch_rank(self):
        return self.rank

    def batch_gather(self, t):
        self.calls.append(t.detach().clone())
        if self.seen is None:
            return torch.stack([t.detach()] * self.batch_n)
        return torch.stack([s[len(self.calls) - 1] for s in self.seen])

    def whole_batch(self, t):
        self.calls.append(t.detach().clone())
        if self.seen is None:
            return t
        total = sum(s[len(self.calls) - 1] for s in self.seen)
        return total + (t - t.detach()) * self.batch_n


def _moe_inputs(rows: int, seq: int, factor: float):
    cfg = dataclasses.replace(R.MOE_CFG, moe=dataclasses.replace(
        R.MOE_CFG.moe, capacity_factor=factor))
    layer = TModel(cfg, "cpu").init(prng.key(3))["moe_layers"]["ffn"]
    ffn = tree_map(lambda t: t[0].detach().clone().requires_grad_(True),
                   layer)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal(
        (rows, seq, cfg.d_model)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    return cfg, ffn, x, w


@pytest.mark.parametrize("blocks, factor", [(4, 0.5), (2, 0.5), (4, 1.25)])
def test_split_routing_keeps_the_whole_batch_pairs(blocks, factor):
    cfg, ffn, x, w = _moe_inputs(8, 16, factor)
    leaves = [ffn["router"], ffn["w_gate"], ffn["w_down"]]
    with TMOE.routing_log() as log:
        out, aux = TMOE.apply_moe(ffn, x, cfg)
    whole = log[0]
    want = kept_pairs(whole["ids"], whole["cap"])
    objective = torch.sum(out * w) / x.shape[0] + aux
    want_grads = torch.autograd.grad(objective, leaves)

    rows = x.shape[0] // blocks
    seen = []
    for r in range(blocks):     # the blocks' collectives' operands
        stub = _Blocks(blocks, r)
        with fsdp.use_layout(stub):
            TMOE.apply_moe(ffn, x[r * rows:(r + 1) * rows], cfg)
        seen.append(stub.calls)
    got, outs, grads, own = set(), [], None, []
    tokens = rows * x.shape[1]
    for r in range(blocks):
        sl = slice(r * rows, (r + 1) * rows)
        with fsdp.use_layout(_Blocks(blocks, r, seen)), \
                TMOE.routing_log() as blog:
            o, a = TMOE.apply_moe(ffn, x[sl], cfg)
        entry = blog[0]
        got |= kept_pairs(entry["ids"], entry["cap"], r * tokens)
        own.append(kept_pairs(entry["ids"], TMOE._capacity(
            tokens, cfg.moe.num_experts, cfg.moe.top_k, factor),
            r * tokens))
        outs.append(o.detach())
        np.testing.assert_allclose(float(a.detach()), float(aux.detach()),
                                   rtol=parity.LM_GRAD_ATOL_FRAC)
        g = torch.autograd.grad(torch.sum(o * w[sl]) / rows + a, leaves)
        grads = g if grads is None else [u + v for u, v in zip(grads, g)]
    assert got == want
    drops = int(TMOE.dropped_pairs(whole))
    if factor < 1:
        # the whole batch drops pairs, and each block's own capacity would
        # keep others than the whole batch's
        assert drops > 0 and set().union(*own) != want, drops
    for u, v in zip(grads, want_grads):
        parity.assert_close((u / blocks).numpy(), v.numpy(), rtol=0.0,
                            atol_frac=parity.LM_GRAD_ATOL_FRAC, what="grad")
    parity.assert_close(torch.cat(outs).numpy(), out.detach().numpy(),
                        rtol=0.0, atol_frac=parity.LM_ATOL_FRAC, what="out")


# ---------------------------------------------------------------------------
# (a) the sharded MoE step on 8 gloo ranks
# ---------------------------------------------------------------------------

def jax_cfg(cfg):
    """The reference's ModelConfig with the port config's fields."""
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(cfg)}
    fields["moe"] = jconfig.MoEConfig(**dataclasses.asdict(cfg.moe))
    return jconfig.ModelConfig(**fields)


def flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.array(v)
    return out


def _recorded(log):
    """The reference's ``apply_moe`` recording (probs, ids) of every call
    of its jitted step, in call order."""
    apply_moe = JMOE.apply_moe

    def recorded(params, x, cfg):
        xf = x.reshape(-1, x.shape[-1])
        probs = jax.nn.softmax(jnp.einsum(
            "td,de->te", xf.astype(jnp.float32), params["router"]), axis=-1)
        _, ids = jax.lax.top_k(probs, cfg.moe.top_k)
        jax.debug.callback(lambda p, i: log.append((np.asarray(p),
                                                    np.asarray(i))),
                           probs, ids)
        return apply_moe(params, x, cfg)

    return recorded


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    """({microbatches: the reference's losses, aux, parameters and routing
    log of its jitted single-device steps (remat none)}, the ranks'
    results)."""
    base = jax_cfg(R.cfg("micro1"))
    jp = JModel(base).init(jax.random.key(0))
    params_np = flatten(jax.tree.map(np.asarray, jp))
    ref = {}
    for micro in (1, 2):
        log = []
        jm = JModel(base)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JMOE, "apply_moe", _recorded(log))
            step = jax.jit(jmake_train_step(
                jm, jconfig.OptimizerConfig(eps=R.OPT_EPS),
                jconfig.ParallelConfig(microbatches=micro)))
            p, s = jp, jinit_opt_state(jp)
            losses, aux = [], []
            for i in range(R.STEPS):
                batch = jmake_batch(base, R.SHAPE, 0, i)
                p, s, m = step(p, s, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
                losses.append(float(m["loss"]))
                aux.append(float(m["aux"]))
        ref[micro] = {"losses": losses, "aux": aux, "log": log,
                      "params": flatten(jax.tree.map(np.asarray, p))}
    tmp = tmp_path_factory.mktemp("split_batch")
    ranks = run_ranks(R.moe_steps, 8, (4, 2), "gloo", tmp, params_np)
    return ref, ranks


TAGS = list(R.VARIANTS)


def _micro(tag):
    return R.VARIANTS[tag][3]


@pytest.mark.parametrize("tag", TAGS)
def test_moe_step_matches_reference(moe_runs, tag):
    refs, ranks = moe_runs
    ref = refs[_micro(tag)]
    worst = (0.0, "")
    for r in ranks:
        np.testing.assert_allclose(r[f"{tag}.losses"], ref["losses"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        np.testing.assert_allclose(r[f"{tag}.aux"], ref["aux"],
                                   rtol=parity.LM_GRAD_ATOL_FRAC, atol=0)
        for name, want in ref["params"].items():
            err = parity.assert_close(r[f"{tag}.param.{name}"], want,
                                      rtol=0.0,
                                      atol_frac=parity.LM_GRAD_ATOL_FRAC,
                                      what=f"{tag} {name}")
            worst = max(worst, (err / max(float(np.max(np.abs(want))),
                                          1e-30), name))
    print(f"moe {tag}: parameters within {worst[0]:.3e} of a leaf's max "
          f"({worst[1]})")


@pytest.mark.parametrize("tag", TAGS)
def test_moe_routing_is_the_whole_batch(moe_runs, tag):
    """The reference drops pairs in every step, each rank's own capacity
    would keep other pairs than the whole batch's (so per-rank routing
    would give other values), and (remat none) the ranks' top-k choices,
    joined in the batch's row order, are the reference's."""
    refs, ranks = moe_runs
    ref = refs[_micro(tag)]
    m = R.MOE_CFG.moe
    n = int(ranks[0][f"{tag}.batch_n"])
    calls = R.STEPS * _micro(tag) * (R.MOE_CFG.num_layers
                                     - m.first_moe_layer)
    assert n > 1 and len(ref["log"]) == calls
    for i, (probs, ids) in enumerate(ref["log"]):
        t = ids.shape[0]
        cap = JMOE._capacity(t, m.num_experts, m.top_k, R.FACTOR)
        counts = np.bincount(ids.reshape(-1), minlength=m.num_experts)
        assert np.maximum(counts - cap, 0).sum() > 0, (i, counts, cap)
        whole = kept_pairs(ids, cap)
        own = set().union(*(kept_pairs(
            ids[b * t // n:(b + 1) * t // n],
            JMOE._capacity(t // n, m.num_experts, m.top_k, R.FACTOR),
            b * t // n) for b in range(n)))
        assert own != whole, i
    if R.VARIANTS[tag][4] != "none":
        return
    by_rank = {int(r[f"{tag}.batch_rank"]): r for r in ranks}
    assert sorted(by_rank) == list(range(n))
    probs = np.concatenate([by_rank[b][f"{tag}.probs"] for b in range(n)],
                           axis=1)
    ids = np.concatenate([by_rank[b][f"{tag}.ids"] for b in range(n)],
                         axis=1)
    flips = sum(int(parity.moe_flips(ids[i], rids, probs[i], rprobs).sum())
                for i, (rprobs, rids) in enumerate(ref["log"]))
    assert flips == 0
