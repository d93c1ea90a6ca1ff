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


# ---------------------------------------------------------------------------
# The run decomposition the CUDA kernel relies on (csrc/hitfind.cu): runs
# found from shifted masks (the kernel: one 32-bit ballot per 32 ticks, the
# previous tick's flag carried in), ranked by a cumulative count of starts
# (the kernel: popcounts), and the first ``cap`` runs summed one tick after
# another from their first sample. A numpy model of that decomposition
# must give the reference scan's bits.
# ---------------------------------------------------------------------------

#: the kernel's load width and tick step
LOAD, STEP = 32, tkernel.STEP


def _kernel_grid(name: str, w: int = 70, t: int = 1001) -> np.ndarray:
    """(W, T) grids of the kernel's edge cases: W no multiple of its 4
    wires per CTA, T no multiple of 4, of a 32-tick load or of its step."""
    rng = np.random.default_rng(t)
    noise = (rng.standard_normal((w, t)) * 600.0).astype(np.float32)
    if name == "noise":
        return noise
    g = np.zeros((w, t), np.float32)
    g[0, 0] = 700.0
    g[1, -3:] = [550.0, 2000.0, 900.0]                # open at the last tick
    g[2, :] = 1000.0 + np.arange(t)                   # one run, the whole wire
    g[3, ::2] = 800.0                                 # more runs than any cap
    for lo, hi in ((LOAD - 2, LOAD + 3), (STEP // 2 - 1, STEP // 2 + 1),
                   (STEP - 5, STEP + 7)):
        g[4, lo:hi] = 900.0 + np.arange(hi - lo)      # across load/step edges
    g[5, LOAD - 1] = 650.0                            # last tick of a load
    g[5, STEP - 40:STEP] = 650.0                      # ends on a step's first
    g[5, STEP + 1] = 660.0                            # tick; one tick after
    last_step = (t - 1) // STEP * STEP
    g[6, 5:40:5] = 720.0                              # 7 runs, then the 8th
    g[6, last_step + 17:] = 1500.0                    # in the last step
    g[7, 10:20] = 500.0                               # == threshold 500
    g[8, 1:-1] = 0.37 * noise[8, 1:-1] + 333.3        # around 333.3
    g[9:40] = noise[9:40]
    g[40:] = np.abs(noise[40:]) * 0.5 + 450.0
    return g


def _word_masks(above: np.ndarray):
    """Run starts and closes (the first tick below after a run) of one
    wire's flags, one 32-tick word at a time with the previous tick's flag
    carried in, as the kernel's ballots find them; ticks past T are below."""
    t = above.shape[0]
    words = -(-(t + 1) // LOAD)
    flags = np.zeros(words * LOAD, bool)
    flags[:t] = above
    starts = np.zeros_like(flags)
    closes = np.zeros_like(flags)
    carry = 0
    for k in range(words):
        m = int(np.sum(flags[k * LOAD:(k + 1) * LOAD].astype(np.uint64)
                       << np.arange(LOAD, dtype=np.uint64)))
        prev = ((m << 1) | carry) & 0xFFFFFFFF
        carry = m >> 31
        for bit, mask in ((m & ~prev, starts), (~m & prev & 0xFFFFFFFF,
                                                closes)):
            mask[k * LOAD:(k + 1) * LOAD] = (bit >> np.arange(LOAD)) & 1
    return starts, closes


def _model_scan(grid: np.ndarray, threshold: float, cap: int):
    """The kernel's decomposition in numpy: (counts (W,), charge, tick,
    peak (W, cap))."""
    w, t = grid.shape
    above = grid > np.float32(threshold)
    prev = np.zeros_like(above)
    prev[:, 1:] = above[:, :-1]
    starts = above & ~prev
    after = np.zeros((w, t + 1), bool)
    after[:, :t] = above
    closes = np.zeros((w, t + 1), bool)
    closes[:, 1:] = after[:, :-1] & ~after[:, 1:]   # a close at T flushes
    rank = np.cumsum(starts, axis=1) - 1
    counts = starts.sum(axis=1).astype(np.int32)
    out = np.zeros((3, w, cap), np.float32)
    for i in range(w):
        s_word, c_word = _word_masks(above[i])
        assert np.array_equal(s_word[:t], starts[i]) and not s_word[t:].any()
        assert np.array_equal(c_word[:t + 1], closes[i])
        assert not c_word[t + 1:].any()
        lo = np.flatnonzero(starts[i] & (rank[i] < cap))
        hi = np.flatnonzero(closes[i])[:len(lo)]
        for k, (a, b) in enumerate(zip(lo, hi)):
            v = grid[i, a]
            csum, tsum, pk = v, v * np.float32(a), v
            for tick in range(a + 1, b):
                v = grid[i, tick]
                csum = np.float32(csum + v)
                tsum = np.float32(tsum + np.float32(v * np.float32(tick)))
                pk = max(pk, v)
            out[:, i, k] = (csum, np.float32(tsum / max(csum,
                                                         np.float32(1e-30))),
                            pk)
    return counts, out[0], out[1], out[2]


@pytest.mark.parametrize("threshold", [500.0, 333.3])
@pytest.mark.parametrize("cap", [1, 8, 40])
@pytest.mark.parametrize("name", ["edges", "noise"])
def test_run_decomposition_model_equals_reference_scan(name, cap, threshold):
    """The numpy model of the kernel's decomposition == the reference's
    find_wire_hits_ref == the port's plain version, bit for bit, at 70 x
    1001 (T no multiple of 4, 32 or 256; W no multiple of 4). Cap 40 stores
    more runs than a warp has lanes (lane l walks runs l, l + 32, ...)."""
    from repro.kernels.hitfind.ref import find_wire_hits_ref
    from repro_torch.kernels.hitfind.ref import hitfind_ref

    g = _kernel_grid(name)
    model = _model_scan(g, threshold, cap)
    ref = [np.asarray(x) for x in find_wire_hits_ref(
        jnp.asarray(g), threshold=threshold, cap=cap)]
    port = hitfind_ref(torch.from_numpy(g), threshold=threshold, cap=cap)
    _assert_equal(model, ref)
    _assert_equal((port[0][:, 0],) + tuple(port[1:]), ref)
    assert int(model[0].sum()) > int(np.minimum(model[0], cap).sum()) > 0


def test_run_decomposition_edge_cases_by_hand():
    """The kernel edge grid's runs at threshold 500, cap 8, by hand."""
    g = _kernel_grid("edges")
    counts, charge, tick, peak = _model_scan(g, 500.0, 8)
    last_step = 1000 // STEP * STEP
    assert counts[:8].tolist() == [1, 1, 1, 501, 3, 3, 8, 0]
    assert charge[2, 0] == np.float32(np.float32(1000.0 + np.arange(1001))
                                      .cumsum(dtype=np.float32)[-1])
    assert peak[4].tolist()[:3] == [904.0, 901.0, 911.0]
    assert charge[5].tolist()[:3] == [650.0, np.float32(650.0 * 40), 660.0]
    assert tick[5, 2] == float(STEP + 1)
    assert charge[6, 7] == np.float32(1500.0 * (1001 - last_step - 17))
    assert (charge[6, :7] == 720.0).all() and (charge[7] == 0.0).all()


def test_c_entry_point_signature_matches_the_binding():
    """ctypes passes what ``SIGNATURES`` declares: c_void_p for each pointer
    of the C function, c_float for a float, c_int for an int."""
    import ctypes
    import re

    from repro_torch import kernels

    src = (kernels.CSRC / kernels.SOURCES["hitfind"]).read_text()
    for name, argtypes in tkernel.SIGNATURES.items():
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1).split(",")
        want = [ctypes.c_void_p if "*" in p else
                ctypes.c_float if "float" in p else ctypes.c_int
                for p in params]
        assert argtypes == want, name
