"""Port hit finding against the reference, on the CPU.

The port's plain run scanner (what the ``scan`` strategy runs, and what the
``pallas`` strategy's kernel wrapper runs on CPU tensors) equals the
reference's ``hit_find_scan`` and its Pallas kernel in interpret mode bit
for bit, on the same (W, T) grids made with numpy: both sum float32 values
one operation at a time in tick order. ``compact_hits`` equals the
reference's bit for bit, with global truncation and a wire offset. The CUDA
kernel itself is held against the plain version on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core import hitfind as jhit
from repro.kernels.hitfind.ops import find_wire_hits_pallas as j_pallas
from repro_torch import interop
from repro_torch.core import hitfind as thit
from repro_torch.kernels.hitfind import kernel as tkernel
from repro_torch.kernels.hitfind.ops import find_wire_hits_pallas
from repro_torch.tune import registry

torch.set_num_threads(1)

CFG = JaxConfig(num_wires=24, num_ticks=96, hit_threshold=500.0,
                max_hits_per_wire=4, max_hits=64)
THR = CFG.hit_threshold


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _grid(name: str, seed: int = 0, w: int = 24, t: int = 96) -> np.ndarray:
    """(W, T) float32 deconvolved-like grids with the scanner's edge cases."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0.0, 200.0, (w, t)).astype(np.float32)
    if name == "noise":           # runs of every length at random
        return (base * 3.0).astype(np.float32)
    if name == "edges":
        g = np.zeros((w, t), np.float32)
        g[0, 0] = 700.0                          # one-tick run at tick 0
        g[1, :5] = [600, 900, 1200, 800, 510]    # run starting at tick 0
        g[2, -3:] = [550, 2000, 900]             # run open at the last tick
        g[3, :] = 1000.0 + np.arange(t)          # all above: one run
        g[4, ::2] = 800.0                        # t/2 runs > cap
        g[5, 10:20] = THR                        # == threshold: no run
        g[6, 10:20] = np.nextafter(np.float32(THR), np.float32(1e9))
        g[7, 30:40] = THR
        g[7, 33] = 501.0                         # one-tick run inside
        g[8] = base[8] * 0.01                    # all below
        g[9, 5:9] = [600, -50, 700, 650]         # two runs split by one tick
        g[10, ::3] = 2e6                         # large values, many runs
        g[11, 1:-1] = 5e3 * rng.random(t - 2) + 501.0
        return g
    raise KeyError(name)


GRIDS = ["noise", "edges"]


def _ref_scan(grid, cfg):
    return [np.array(x) for x in jhit.hit_find_scan(jnp.asarray(grid), cfg)]


def _assert_equal(port, ref):
    names = ("counts", "charge", "tick", "peak")
    for name, a, b in zip(names, port, ref):
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("name", GRIDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_scan_equals_reference_scan(name, seed):
    g = _grid(name, seed)
    port = thit.hit_find_scan(torch.from_numpy(g), _tcfg(CFG))
    _assert_equal(port, _ref_scan(g, CFG))


@pytest.mark.parametrize("name", GRIDS)
def test_kernel_wrapper_equals_interpret_mode_pallas(name):
    g = _grid(name, 3)
    port = find_wire_hits_pallas(torch.from_numpy(g), threshold=THR,
                                 cap=CFG.max_hits_per_wire)
    ref = [np.asarray(x) for x in j_pallas(jnp.asarray(g), threshold=THR,
                                           cap=CFG.max_hits_per_wire,
                                           interpret=True)]
    _assert_equal(port, ref)


def test_kernel_wrapper_layout_and_counter():
    """The wrapper returns the reference kernel's (W, 1) counts; a CPU call
    runs the plain version and is not counted as a launch."""
    g = torch.from_numpy(_grid("edges"))
    tkernel.reset_launches()
    counts, charge, tick, peak = tkernel.hitfind_pallas(g, threshold=THR,
                                                        cap=3)
    assert counts.shape == (24, 1) and counts.dtype == torch.int32
    assert charge.shape == tick.shape == peak.shape == (24, 3)
    assert tkernel.LAUNCHES == {"hitfind_pallas": 0}


def test_edge_cases_by_hand():
    """The edge-case grid's runs, counted by hand."""
    g = _grid("edges")
    counts, charge, tick, peak = thit.wire_scan(torch.from_numpy(g), THR, 4)
    c = counts.tolist()
    assert c[:12] == [1, 1, 1, 1, 48, 0, 1, 1, 0, 2, 32, 1]
    assert charge[0, 0] == 700.0 and tick[0, 0] == 0.0
    assert peak[2, 0] == 2000.0 and charge[2, 1] == 0.0
    assert tick[3, 0] == pytest.approx(
        float((np.arange(96) * (1000 + np.arange(96))).sum()
              / (1000 + np.arange(96)).sum()), rel=1e-5)
    assert (charge[4] == 800.0).all()        # first cap of 48 runs stored
    assert tick[4].tolist() == [0.0, 2.0, 4.0, 6.0]
    assert charge[7, 0] == 501.0 and tick[7, 0] == 33.0


@pytest.mark.parametrize("bad", ["dtype", "ndim", "cap"])
def test_kernel_wrapper_rejects(bad):
    g = torch.zeros((4, 8))
    kwargs = dict(threshold=1.0, cap=2)
    if bad == "dtype":
        g = g.double()
    elif bad == "ndim":
        g = g[None]
    else:
        kwargs["cap"] = 0
    with pytest.raises(ValueError):
        tkernel.hitfind_pallas(g, **kwargs)


@pytest.mark.parametrize("max_hits,wire_offset", [(64, 0), (7, 0), (64, 100),
                                                  (1, 5)])
def test_compact_hits_equals_reference(max_hits, wire_offset):
    g = _grid("edges")
    cfg = dataclasses.replace(CFG, max_hits=max_hits)
    cand = _ref_scan(g, cfg)
    ref = jhit.compact_hits(*(jnp.asarray(x) for x in cand), cfg,
                            wire_offset=wire_offset)
    port = thit.compact_hits(*(torch.from_numpy(x) for x in cand),
                             _tcfg(cfg), wire_offset=wire_offset)
    for f in jhit.HitSet._fields:
        a, b = getattr(port, f).numpy(), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    assert int(port.n_hits) >= int(port.mask.sum())


@pytest.mark.parametrize("strategy", ["scan", "pallas", "auto", None])
def test_find_hits_equals_reference(strategy):
    g = _grid("noise", 5)
    ref = jhit.find_hits(jnp.asarray(g), CFG, "scan", wire_offset=3,
                         max_hits=40)
    port = thit.find_hits(torch.from_numpy(g), _tcfg(CFG), strategy,
                          wire_offset=3, max_hits=40)
    for f in jhit.HitSet._fields:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)),
                                      err_msg=f)
    assert thit.hits_to_tuples(port) == jhit.hits_to_tuples(ref)


def test_strategy_defaults_per_backend():
    """``auto`` runs the kernel on the card and the plain scan elsewhere."""
    assert registry.default_strategy("hit_find", "cuda") == "pallas"
    assert registry.default_strategy("hit_find", "cpu") == "scan"
    assert set(registry.strategies("hit_find")) == set(
        jhit_strategies()) == {"scan", "pallas"}


def jhit_strategies():
    from repro.tune import registry as jregistry

    return jregistry.strategies("hit_find")


def test_unknown_strategy_lists_valid_ones():
    with pytest.raises(ValueError, match="valid.*auto"):
        thit.find_hits(torch.zeros((2, 4)), _tcfg(CFG), "nope")


def test_stack_hits_adds_plane_axis():
    g = torch.from_numpy(_grid("edges"))
    hits = [thit.find_hits(g * s, _tcfg(CFG)) for s in (1.0, 0.5, 2.0)]
    stacked = thit.stack_hits(hits)
    assert stacked.wire.shape == (3, CFG.max_hits)
    assert stacked.n_hits.shape == (3,)
    for p, h in enumerate(hits):
        for f in thit.HitSet._fields:
            assert torch.equal(getattr(stacked, f)[p], getattr(h, f))
