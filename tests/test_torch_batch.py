"""The port's batched executor (``repro_torch.core.batch``) on the CPU.

Packing equals the reference's arrays and ``event_keys`` its key data, bit
for bit. Every row of ``simulate_events`` equals the port's per-event run
(``SimGraph.run``) on the same padded row, bit for bit (ADC, grid, signal,
dropped, and decon and hits with recon), for ragged events and a padding
row, one plane (fused, fused compact, unfused with the pallas and
pallas_compact scatters) and three planes (the multi-plane fused kernels,
with and without recon, and the unfused chain with recon), and for a
batch of 18 rows, which the fused wrapper splits into launches of at most
16. Such batches match the reference's jitted ``make_batched_sim_fn``
under ``parity``'s rules, the 18-row batch included.
Padding never counts as a dropped entry; a real overflow still does.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core import batch as jbatch
from repro.core.depo import generate_depos as j_generate
from repro.core.depo import generate_plane_depos as j_generate_planes
from repro.core.drift import PhysicalDepoSet as JPhysical
from repro.core.stages import SimState as JSimState
from repro.core.stages import build_sim_graph as j_build_sim_graph
from repro_torch import interop
from repro_torch.core import batch as tbatch
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet, generate_depos, \
    generate_plane_depos
from repro_torch.core.drift import PhysicalDepoSet
from repro_torch.core.stages import build_sim_graph
from repro_torch.kernels.fused_sim import kernel as fused_kernel
from repro_torch.kernels.scatter_add import ops as binning
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield

#: ``tests/test_event_batch.py``'s config
CFG = JaxConfig(num_wires=64, num_ticks=256, num_depos=48,
                response_wires=11, response_ticks=48)
CFG3 = dataclasses.replace(CFG, num_planes=3)
RAGGED = [7, 16, 3, 12]
#: 8 x 8 tiles of 64 x 256: k_max = 32 for 64 depos, so the padding of an
#: empty or short row (all in the corner tile) overflows it
PAD_CFG = JaxConfig(num_wires=512, num_ticks=2048, num_depos=64,
                    response_wires=11, response_ticks=48)
#: (planes, charge_grid_strategy, scatter_strategy, recon)
CASES = {"fused_pallas": (1, "fused_pallas", "xla", False),
         "fused_pallas_compact": (1, "fused_pallas_compact", "xla", False),
         "unfused_pallas": (1, "unfused", "pallas", False),
         "unfused_pallas_compact": (1, "unfused", "pallas_compact", False),
         "multiplane": (3, "fused_pallas_multiplane", "xla", False),
         "multiplane_compact": (3, "fused_pallas_multiplane_compact", "xla",
                                False),
         "multiplane_recon": (3, "fused_pallas_multiplane", "xla", True),
         "multiplane_compact_recon": (3, "fused_pallas_multiplane_compact",
                                      "xla", True),
         "unfused3_recon": (3, "unfused", "pallas", True)}


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _case_cfg(case, base=CFG):
    planes, strategy, scatter, recon = CASES[case]
    cfg = dataclasses.replace(base, num_planes=planes,
                              charge_grid_strategy=strategy,
                              scatter_strategy=scatter)
    return cfg, recon


def _port_events(cfg, sizes, seed=100):
    gen = generate_plane_depos if cfg.num_planes > 1 else generate_depos
    key = prng.key(0)
    return [gen(prng.fold_in(key, seed + i), _tcfg(cfg), n, device="cpu")
            for i, n in enumerate(sizes)]


def _ref_events(cfg, sizes, seed=100):
    gen = j_generate_planes if cfg.num_planes > 1 else j_generate
    key = jax.random.key(0)
    return [gen(jax.random.fold_in(key, seed + i), cfg, n)
            for i, n in enumerate(sizes)]


def _to_port(ev):
    return interop.depos_from_numpy(*(np.asarray(x) for x in ev),
                                    device="cpu")


def _leaves(out):
    """Every tensor of a SimOutput by name (HitSet leaves as hits.<f>)."""
    named = {}
    for name, value in out._asdict().items():
        if name == "hits" and value is not None:
            named.update({f"hits.{f}": v for f, v in value._asdict().items()})
        elif value is not None:
            named[name] = value
    return named


def _assert_rows_equal_loop(graph, keys, batch, out):
    """Each batched row == ``graph.run`` on the same padded row."""
    batched = _leaves(out)
    for e in range(batch.num_events):
        one = _leaves(graph.run(keys[e], batch.event(e),
                                int(batch.n_depos[e])))
        assert set(one) == set(batched)
        for name, value in one.items():
            assert torch.equal(batched[name][e], value), (e, name)


def test_pack_events_matches_reference():
    events = _ref_events(CFG, RAGGED)
    for kw in ({}, {"pad_to": 20}, {"pad_multiple": 8}):
        ref = jbatch.pack_events(events, **kw)
        out = tbatch.pack_events([_to_port(e) for e in events], **kw)
        assert out.max_depos == ref.max_depos
        for f in jbatch.EventBatch._fields:
            np.testing.assert_array_equal(getattr(out, f).numpy(),
                                          np.asarray(getattr(ref, f)), f)
    assert out.n_depos.device.type == "cpu"
    assert out.total_depos == sum(RAGGED)


def test_pad_depos_empty_event_and_oversize():
    ev = _ref_events(CFG3, [5])[0]
    ref = jbatch.pad_depos(ev, 9)
    out = tbatch.pad_depos(_to_port(ev), 9)
    for r, o in zip(ref, out):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    for planes in (1, 3):
        want = jbatch.empty_event(planes)
        got = tbatch.empty_event(planes, device="cpu")
        assert [tuple(x.shape) for x in got] == [x.shape for x in want]
    with pytest.raises(ValueError):
        tbatch.pad_depos(_to_port(ev), 4)
    with pytest.raises(ValueError):
        tbatch.pack_events([])


def test_pack_physical_events_matches_reference():
    rng = np.random.default_rng(3)
    events = [[rng.random(n).astype(np.float32) for _ in range(5)]
              for n in (4, 9, 2)]
    ref = jbatch.pack_physical_events([JPhysical(*e) for e in events],
                                      pad_multiple=4)
    out = tbatch.pack_physical_events(
        [PhysicalDepoSet(*(torch.from_numpy(x) for x in e)) for e in events],
        pad_multiple=4)
    for f in jbatch.PhysicalEventBatch._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(out.event(1).q.numpy(),
                                  np.asarray(ref.event(1).q))


def test_event_keys_match_reference_bitwise():
    ids = [0, 3, 7, 123456, 2**31 + 5]
    for seed in (0, 42):
        ref = np.asarray(jax.random.key_data(
            jbatch.event_keys(jax.random.key(seed), ids)))
        out = tbatch.event_keys(prng.key(seed), ids)
        assert out.shape == (len(ids), 2) and out.device.type == "cpu"
        np.testing.assert_array_equal(out.numpy(), ref.astype(np.int64))
        np.testing.assert_array_equal(
            interop.keys_from_data(ref).numpy(), out.numpy())


@pytest.mark.parametrize("case", sorted(CASES))
def test_batch_rows_equal_per_event_loop(case):
    """Ragged events and one padding row: every row bit for bit the
    per-event run on the same padded row."""
    cfg, recon = _case_cfg(case)
    events = _port_events(cfg, [5, 48, 17]) + [
        tbatch.empty_event(cfg.num_planes, device="cpu")]
    batch = tbatch.pack_events(events, pad_to=cfg.num_depos)
    keys = tbatch.event_keys(prng.key(0), [0, 1, 2, 9])
    graph = build_sim_graph(_tcfg(cfg), device="cpu", recon=recon)
    out = tbatch.simulate_events(keys, batch, graph=graph)
    lead = (4,) + ((3,) if cfg.num_planes > 1 else ())
    assert tuple(out.adc.shape) == lead + (cfg.num_wires, cfg.num_ticks)
    assert tuple(out.dropped.shape) == (4,) and not out.dropped.any()
    if recon:
        assert tuple(out.hits.mask.shape) == lead + (cfg.max_hits,)
    _assert_rows_equal_loop(graph, keys, batch, out)


def test_batch_of_18_rows_splits_into_two_launches(monkeypatch):
    """6 events x 3 planes: the fused wrapper takes 16 rows, then 2 (the
    split runs on every device), and every row equals the loop."""
    cfg, _ = _case_cfg("multiplane")
    calls = []
    wrapper = fused_kernel.fused_rasterize_scatter_multiplane

    def counted(*args, num_planes, **kw):
        calls.append(num_planes)
        return wrapper(*args, num_planes=num_planes, **kw)

    monkeypatch.setattr(fused_kernel, "fused_rasterize_scatter_multiplane",
                        counted)
    batch = tbatch.pack_events(_port_events(cfg, [48] * 6),
                               pad_to=cfg.num_depos)
    keys = tbatch.event_keys(prng.key(1), range(6))
    graph = build_sim_graph(_tcfg(cfg), device="cpu")
    out = tbatch.simulate_events(keys, batch, graph=graph)
    assert calls == [16, 2]
    _assert_rows_equal_loop(graph, keys, batch, out)
    with pytest.raises(ValueError, match="at most|1 to 16"):
        fused_kernel._check_rows(17)


def _hits_by_wire(hits, sel):
    wire, tick, charge, peak, mask = (np.asarray(getattr(hits, f))[sel]
                                      for f in ("wire", "tick", "charge",
                                                "peak", "mask"))
    rows = {}
    for w, t, q, p in zip(wire[mask], tick[mask], charge[mask], peak[mask]):
        rows.setdefault(int(w), []).append((t, q, p))
    return rows


def _ref_recon(cfg, adc):
    """The reference's jitted deconvolve and hit_find stages on ``adc``."""
    g = j_build_sim_graph(cfg, recon=True)

    @jax.jit
    def recon(adc):
        s = JSimState(key=None, kf=None, kn=None, depos=None, adc=adc)
        s = g.stage("hit_find").fn(g.stage("deconvolve").fn(s))
        return s.decon, s.hits

    return recon(jnp.asarray(adc))


def _assert_same_hits(out, ref, cfg, e):
    """Event e's hits equal the reference's, within ``HIT_RTOL``; a wire
    may differ only where a deconvolved sample lies within the decon
    tolerance of the threshold. ``HIT_RTOL`` holds for hits of one ADC:
    where the ADC differs by parity's rounding-tie flips, the reference's
    hits are its recon stages run on the port's ADC."""
    port_adc = out.adc[e].numpy()
    if np.array_equal(port_adc, np.asarray(ref.adc[e])):
        decon, hits, sel = np.asarray(ref.decon), ref.hits, (e,)
    else:
        decon, hits = _ref_recon(cfg, port_adc)
        decon, sel = np.asarray(decon)[None], (0,)
        hits = type(hits)(*(np.asarray(x)[None] for x in hits))
    for p in range(cfg.num_planes):
        at = (sel + (p,)) if cfg.num_planes > 1 else sel
        port = _hits_by_wire(out.hits, (e,) + at[1:])
        want = _hits_by_wire(hits, at)
        plane_decon = decon[at]
        atol = parity.ATOL_FRAC * float(np.abs(plane_decon).max())
        for w in sorted(set(port) | set(want)):
            a, b = port.get(w, []), want.get(w, [])
            if len(a) == len(b):
                for x, y in zip(a, b):
                    np.testing.assert_allclose(x, y, rtol=parity.HIT_RTOL)
            else:
                near = np.abs(plane_decon[w] - cfg.hit_threshold) <= (
                    atol + parity.RTOL * cfg.hit_threshold)
                assert near.any(), f"event {e} wire {w}: hits differ"


@pytest.mark.parametrize("case,sizes", [
    ("fused_pallas", [48, 9, 30]), ("unfused_pallas", [48, 9, 30]),
    ("multiplane_recon", [48, 9, 30]), ("unfused3_recon", [48, 9]),
    ("multiplane", [48, 9, 30, 48, 17, 5])])  # 18 rows: two launches
def test_batch_matches_reference_batched(case, sizes):
    """The reference's jitted vmap and the port's batched executor on the
    same packed batch and keys: ADC within parity, the same hits."""
    cfg, recon = _case_cfg(case)
    events = _ref_events(cfg, sizes)
    ref_batch = jbatch.pack_events(events, pad_to=cfg.num_depos)
    ref_keys = jbatch.event_keys(jax.random.key(0), range(len(sizes)))
    ref = jbatch.make_batched_sim_fn(cfg, recon=recon)(ref_keys, ref_batch)
    batch = interop.event_batch_from_numpy(
        *(np.asarray(getattr(ref_batch, f))
          for f in jbatch.EventBatch._fields), device="cpu")
    keys = interop.keys_from_data(np.asarray(jax.random.key_data(ref_keys)))
    out = tbatch.make_batched_sim_fn(_tcfg(cfg), device="cpu",
                                     recon=recon)(keys, batch)
    assert tuple(out.adc.shape) == tuple(ref.adc.shape)
    for e in range(len(sizes)):
        parity.assert_adc_close(out.adc[e].numpy(), np.asarray(ref.adc[e]),
                                what=f"event {e}")
        parity.assert_close(out.charge_grid[e].numpy(),
                            np.asarray(ref.charge_grid[e]),
                            atol_frac=parity.GRID_ATOL_FRAC, what="grid")
        if recon:
            _assert_same_hits(out, ref, cfg, e)


@pytest.mark.parametrize("strategy,scatter", [
    ("fused_pallas", "xla"), ("fused_pallas_compact", "xla"),
    ("unfused", "pallas"), ("unfused", "pallas_compact")])
def test_padding_never_counts_as_a_drop(strategy, scatter):
    """A short row and an empty row pad into the corner tile past k_max:
    the batch reports no drop, while the same rows run without their
    valid counts would report the padding's overflow; the ADC is the same
    either way."""
    cfg = _tcfg(dataclasses.replace(PAD_CFG, charge_grid_strategy=strategy,
                                    scatter_strategy=scatter))
    events = _port_events(cfg, [10]) + [tbatch.empty_event(device="cpu")]
    batch = tbatch.pack_events(events, pad_to=cfg.num_depos)
    keys = tbatch.event_keys(prng.key(0), [0, 5])
    graph = build_sim_graph(cfg, device="cpu")
    out = tbatch.simulate_events(keys, batch, graph=graph)
    assert out.dropped.tolist() == [0, 0]
    for e in range(2):
        blind = graph.run(keys[e], batch.event(e))
        assert int(blind.dropped) > 0
        assert torch.equal(blind.adc, out.adc[e])


def test_binning_counts_only_valid_depos():
    """Directly on the binning: n entries at one tile, k_max = 4."""
    w0 = torch.zeros(10, dtype=torch.int32)
    t0 = torch.zeros(10, dtype=torch.int32)
    args = (w0, t0, 20, 20, 512, 2048, 64, 256, 4)
    assert int(binning.bin_depos_to_tiles(*args)[2]) == 6
    assert int(binning.bin_depos_to_tiles(*args, n_valid=3)[2]) == 0
    assert int(binning.bin_depos_to_tiles(*args, n_valid=7)[2]) == 3
    assert int(binning.bin_depos_to_tiles_compact(*args, 8, n_valid=0)[2]) \
        == 0
    ids = binning.bin_depos_to_tiles(*args, n_valid=3)[0]
    assert ids[:4].tolist() == [0, 1, 2, 3]


@pytest.mark.parametrize("strategy", ["fused_pallas", "unfused"])
def test_real_overflow_still_counts_and_raises(strategy):
    """64 valid depos on one spot overflow k_max = 32: the batch reports
    the drop on that event (and none on a short event beside it), and the
    stream raises naming it."""
    cfg = _tcfg(dataclasses.replace(PAD_CFG, charge_grid_strategy=strategy,
                                    scatter_strategy="pallas"))
    n = cfg.num_depos
    crowd = DepoSet(torch.full((n,), 3.0), torch.full((n,), 9.0),
                    torch.ones(n), torch.ones(n), torch.full((n,), 100.0))
    batch = tbatch.pack_events(_port_events(cfg, [10]) + [crowd])
    keys = tbatch.event_keys(prng.key(0), [0, 1])
    out = tbatch.make_batched_sim_fn(cfg, device="cpu")(keys, batch)
    assert int(out.dropped[0]) == 0 and int(out.dropped[1]) == 32

    def dropping(keys, batch):
        return out._replace(dropped=torch.tensor([0, 32]))

    with pytest.raises(launcher.SimBatchError, match="event 1: the tile "
                       "binning dropped 32"):
        launcher.stream_simulate(cfg, 2, 2, sim=dropping, device="cpu")
