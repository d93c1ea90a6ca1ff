"""The fig3 per-depo baseline and the pool RNG of the port, against the
reference, on the CPU.

``rasterize_one`` against the reference's jitted one; ``make_pool`` (the
threefry bits exact, the normals within ``parity.NORMAL_ATOL``);
``fluctuate_pool`` on the reference's own pool (``interop.pool_from_numpy``):
bit for bit on bfloat16 patches, where both packages take one fused
multiply-add, within ``parity.GRID_ATOL_FRAC`` on float32 ones, where the
jitted reference contracts the last step into an FMA and the port rounds it
twice. ``simulate_fig3`` against the reference's on the default pool, with
all 256 smoke depos (depo 163 is the first whose normals take the
reference's ``np.resize`` branch), with ``max_depos`` and with and without
noise; fig3 against fig4 without fluctuation at the reference's own
tolerance. The pool through fig4's unfused chains at one plane and at three,
with and without recon; batched rows equal to the per-event runs bit for
bit and to the reference's batch under ``parity``; the launcher's
``--pipeline fig3`` line and refusals; the tuner's refusal of the pool
config, which the reference refuses too.
"""
import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core import batch as jbatch
from repro.core import fluctuate as jfl
from repro.core.depo import depo_patch_origin as j_origin
from repro.core.depo import generate_depos as j_generate
from repro.core.depo import generate_physical_depos as j_generate_physical
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.core.pipeline import simulate as j_simulate
from repro.core.pipeline import simulate_fig4 as j_simulate_fig4
from repro.core.rasterize import rasterize as j_rasterize
from repro.core.stages import SimState as JSimState
from repro.core.stages import build_sim_graph as j_build_sim_graph
from repro.core.rasterize import rasterize_one as j_rasterize_one
from repro.core.response import make_response as j_make_response
from repro.launch import sim as j_launcher
from repro.tune import autotune as jtune
from repro_torch import interop
from repro_torch.core import batch as tbatch
from repro_torch.core import fluctuate as tfl
from repro_torch.core import prng
from repro_torch.core.depo import generate_depos, generate_plane_depos
from repro_torch.core.pipeline import (_fig3_normals, make_sim_fn, simulate,
                                       simulate_fig3, simulate_fig4)
from repro_torch.core.rasterize import rasterize_one
from repro_torch.core.response import make_response
from repro_torch.core.stages import build_sim_graph
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity
from repro_torch.tune import autotune as ttune

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through empty tuning caches of
    this module's own, never the default paths."""
    tmp = tmp_path_factory.mktemp("tune")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp / "tune_cache.json"))
        mp.setenv("REPRO_TUNE_CACHE", str(tmp / "ref_tune_cache.json"))
        yield


SMOKE = jax_get_config("lartpc-uboone", smoke=True)
POOL = dataclasses.replace(SMOKE, rng_strategy="pool")
FIG3 = dataclasses.replace(SMOKE, pipeline="fig3")
#: ``tests/test_event_batch.py``'s config
BATCH_CFG = JaxConfig(num_wires=64, num_ticks=256, num_depos=48,
                      response_wires=11, response_ticks=48,
                      rng_strategy="pool")
#: the first depo whose 20 x 20 normals would run past a 2**16 pool
RESIZE_DEPO = 163


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tkey(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)))


def _depos(cfg, seed, physical=False):
    """(reference key, reference depos, the same depos in the port)."""
    k = jax.random.fold_in(jax.random.key(0), seed)
    if physical:
        d = j_generate_physical(k, cfg)
        return k, d, interop.physical_depos_from_numpy(
            *(np.asarray(x) for x in d), device="cpu")
    d = j_generate(k, cfg)
    return k, d, interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                          device="cpu")


def _compare(out, ref, adc=True):
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_close(out["signal"], np.asarray(ref.signal),
                        atol_frac=parity.SIGNAL_ATOL_FRAC, what="signal")
    if adc:
        parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")


# ---------------------------------------------------------------------------
# The per-depo patch and the pool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", [0, 7, 200])
def test_rasterize_one_matches_reference(i):
    _, d, td = _depos(SMOKE, 1)
    w0, t0 = (np.asarray(x) for x in j_origin(d, SMOKE))
    args = [np.asarray(x)[i] for x in d] + [np.float32(w0[i]),
                                            np.float32(t0[i])]
    pw, pt = SMOKE.patch_wires, SMOKE.patch_ticks
    ref = jax.jit(j_rasterize_one, static_argnums=(7, 8))(*args, pw, pt)
    out = rasterize_one(*(x[i] for x in td), torch.tensor(args[5]),
                        torch.tensor(args[6]), pw, pt)
    assert out.shape == (pw, pt) and out.dtype == torch.float32
    parity.assert_close(out.numpy(), np.asarray(ref), what="patch")


@pytest.mark.parametrize("seed,size", [(1234, 1 << 20), (5, 1 << 16)])
def test_make_pool_matches_reference(seed, size):
    """The graph's standard pool and a fig3-sized one: threefry bits
    exact, normals within ``NORMAL_ATOL``."""
    bits = prng.random_bits(prng.key(seed), (size,), "cpu").numpy()
    np.testing.assert_array_equal(
        bits, np.asarray(jax.random.bits(jax.random.key(seed), (size,))))
    out = tfl.make_pool(prng.key(seed), size, device="cpu")
    ref = np.asarray(jfl.make_pool(jax.random.key(seed), size))
    assert out.shape == (size,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=parity.NORMAL_ATOL)


@pytest.mark.parametrize("dtype,offset", [("float32", 0), ("float32", 1000),
                                          ("bfloat16", 0),
                                          ("bfloat16", 1000)])
def test_fluctuate_pool_matches_reference(dtype, offset):
    """A 2**10 pool under the smoke patches' 102 400 pixels wraps 100
    times. bfloat16 patches take the FMA in both packages: bit for bit."""
    _, d, td = _depos(SMOKE, 2)
    cfg = dataclasses.replace(SMOKE, patch_dtype=dtype)
    patches, _, _ = j_rasterize(d, cfg)
    pool = jfl.make_pool(jax.random.key(3), 1 << 10)
    ref = np.asarray(jax.jit(jfl.fluctuate_pool, static_argnames="offset")(
        pool, patches, d.charge, offset=offset))
    tpatches = (interop.bf16_from_numpy(np.asarray(patches), device="cpu")
                if dtype == "bfloat16" else torch.from_numpy(
                    np.array(patches)))
    out = tfl.fluctuate_pool(interop.pool_from_numpy(pool, device="cpu"),
                             tpatches, td.charge, offset=offset).numpy()
    assert out.dtype == np.float32 and out.shape == ref.shape
    if dtype == "bfloat16":
        np.testing.assert_array_equal(out, ref)
    else:
        parity.assert_close(out, ref, atol_frac=parity.GRID_ATOL_FRAC,
                            what="fluctuated patches")


def test_fig3_normals_take_the_resize_branch():
    """Depo i's normals start at (i * 400) % 65536; depo 163's would run
    past the end, and the reference takes the pool's first 400 instead of
    wrapping."""
    pool = np.arange(1 << 16, dtype=np.float32)
    pw = pt = 20
    np.testing.assert_array_equal(_fig3_normals(pool, RESIZE_DEPO - 1, pw, pt),
                                  pool[64800:65200].reshape(pw, pt))
    assert RESIZE_DEPO * pw * pt + pw * pt > pool.size
    np.testing.assert_array_equal(_fig3_normals(pool, RESIZE_DEPO, pw, pt),
                                  pool[:pw * pt].reshape(pw, pt))
    np.testing.assert_array_equal(_fig3_normals(pool, 164, pw, pt),
                                  pool[65600 - 65536:66000 - 65536].reshape(
                                      pw, pt))


# ---------------------------------------------------------------------------
# fig3
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("max_depos,noise", [(None, True), (None, False),
                                             (100, True)])
def test_fig3_matches_reference(max_depos, noise):
    """The default pool, all 256 depos (past depo 163's resize branch) or
    the first 100; the ADC under parity's rule."""
    k, d, td = _depos(FIG3, 3)
    ref = j_simulate(k, d, FIG3, add_noise=noise, max_depos=max_depos)
    out = simulate(_tkey(k), td, _tcfg(FIG3), add_noise=noise,
                   device="cpu", max_depos=max_depos)
    assert out.adc.dtype == torch.int16 and out.adc.shape == (128, 512)
    _compare(interop.to_numpy(out), ref)


def test_fig3_given_pool_and_without_fluctuation():
    """A pool handed across gives the reference's grid; with
    ``rng_strategy="none"`` no pool is read and the grid is the mean."""
    k, d, td = _depos(FIG3, 4)
    pool = jfl.make_pool(jax.random.key(6), 1 << 12)
    resp = make_response(_tcfg(FIG3), device="cpu")
    ref = j_simulate(k, d, FIG3, resp=j_make_response(FIG3), pool=pool)
    out = simulate_fig3(_tkey(k), td, resp, _tcfg(FIG3),
                        pool=interop.pool_from_numpy(pool, device="cpu"),
                        device="cpu")
    _compare(interop.to_numpy(out), ref)
    quiet = dataclasses.replace(_tcfg(FIG3), rng_strategy="none")
    mean = simulate_fig3(_tkey(k), td, resp, quiet, add_noise=False,
                         device="cpu")
    nofl = simulate_fig3(_tkey(k), td, resp, dataclasses.replace(
        quiet, rng_strategy="counter", fluctuate=False), add_noise=False,
        device="cpu")
    assert torch.equal(mean.charge_grid, nofl.charge_grid)


@pytest.mark.parametrize("scatter", ["xla", "pallas"])
def test_fig3_equals_fig4_without_fluctuation(scatter):
    """The reference's own fig3/fig4 rule (``tests/test_core_sim.py``):
    grids within rtol 1e-4, atol 1e-2; ADC equal on > 99.9 % of pixels."""
    cfg = dataclasses.replace(_tcfg(FIG3), fluctuate=False,
                              scatter_strategy=scatter)
    k = prng.key(5)
    depos = generate_depos(k, cfg, device="cpu")
    out3 = simulate(k, depos, cfg, add_noise=False, device="cpu")
    out4 = simulate_fig4(k, depos, cfg=cfg, add_noise=False, device="cpu")
    np.testing.assert_allclose(out3.charge_grid.numpy(),
                               out4.charge_grid.numpy(), rtol=1e-4, atol=1e-2)
    assert (out3.adc == out4.adc).float().mean() > 0.999


# ---------------------------------------------------------------------------
# The pool through fig4
# ---------------------------------------------------------------------------


def _wire_hits(hits, plane):
    fields = [np.asarray(getattr(hits, f)) for f in ("wire", "tick",
                                                     "charge", "peak",
                                                     "mask")]
    if plane is not None:
        fields = [x[plane] for x in fields]
    wire, tick, charge, peak, mask = fields
    rows = {}
    for w, t, q, p in zip(wire[mask], tick[mask], charge[mask], peak[mask]):
        rows.setdefault(int(w), []).append((t, q, p))
    return rows


def _assert_hits_match(out, ref, cfg):
    """Hit sets equal with values within ``HIT_RTOL`` on an equal ADC; a
    wire whose hits differ holds a sample within the decon tolerance of the
    threshold."""
    planes = range(cfg.num_planes) if cfg.num_planes > 1 else [None]
    for plane in planes:
        decon = np.asarray(ref.decon if plane is None else ref.decon[plane])
        port, want = _wire_hits(out.hits, plane), _wire_hits(ref.hits, plane)
        assert want, "no reference hits"
        atol = parity.ATOL_FRAC * float(np.abs(decon).max())
        thr = cfg.hit_threshold
        for w in sorted(set(port) | set(want)):
            a, b = port.get(w, []), want.get(w, [])
            if len(a) == len(b):
                for x, y in zip(a, b):
                    np.testing.assert_allclose(x, y, rtol=parity.HIT_RTOL)
            else:
                near = np.abs(decon[w] - thr) <= atol + parity.RTOL * thr
                assert near.any(), f"plane {plane} wire {w}: hits differ"


def _ref_recon(cfg, adc, ref):
    """``ref`` when its ADC is ``adc``; else the reference's jitted
    deconvolve and hit_find stages on ``adc`` (an ADC that differs by
    parity's rounding-tie flips gives hits of its own)."""
    if np.array_equal(adc, np.asarray(ref.adc)):
        return ref
    g = j_build_sim_graph(cfg, recon=True)

    @jax.jit
    def recon(adc):
        s = JSimState(key=None, kf=None, kn=None, depos=None, adc=adc)
        return g.stage("hit_find").fn(g.stage("deconvolve").fn(s))

    return recon(jax.numpy.asarray(adc))


#: (planes, charge_grid_strategy, scatter_strategy, plane_batching, recon)
FIG4_CASES = {
    "unfused_xla": (1, "unfused", "xla", "auto", False),
    "unfused_pallas": (1, "unfused", "pallas", "auto", False),
    "unfused_pallas_compact": (1, "unfused", "pallas_compact", "auto", False),
    "unfused_bf16_xla": (1, "unfused_bf16", "xla", "auto", False),
    "unfused_bf16_pallas": (1, "unfused_bf16", "pallas", "auto", False),
    "unfused_pallas_recon": (1, "unfused", "pallas", "auto", True),
    "three_planes_stacked": (3, "unfused", "pallas", "stacked", False),
    "three_planes_loop": (3, "unfused", "xla", "loop", False),
    "three_planes_recon": (3, "unfused", "pallas_compact", "stacked", True),
    "three_planes_bf16_recon": (3, "unfused_bf16", "pallas", "stacked",
                                True)}


@pytest.mark.parametrize("case", sorted(FIG4_CASES))
def test_pool_fig4_matches_reference(case):
    """Each package's standard pool (``make_pool(key(1234))``, built by
    the graph) through the whole event: grid, signal and ADC under
    parity's rules; with recon the hits too (three planes:
    ``tests/test_torch_multiplane.py``'s config)."""
    planes, strategy, scatter, batching, recon = FIG4_CASES[case]
    cfg = dataclasses.replace(POOL, num_planes=planes,
                              charge_grid_strategy=strategy,
                              scatter_strategy=scatter,
                              plane_batching=batching)
    k, d, td = _depos(cfg, 6, physical=planes > 1)
    ref = j_make_sim_fn(cfg, recon=recon)(k, d)
    out = make_sim_fn(_tcfg(cfg), device="cpu", recon=recon)(_tkey(k), td)
    assert int(out.dropped) == 0
    assert out.charge_grid.dtype == torch.float32
    _compare(interop.to_numpy(out), ref)
    if recon:
        _assert_hits_match(out, _ref_recon(cfg, out.adc.numpy(), ref), cfg)


def test_pool_given_to_fig4_matches_reference():
    """The reference's pool handed across through ``simulate_fig4``."""
    k, d, td = _depos(POOL, 7)
    pool = jfl.make_pool(jax.random.key(9), 1 << 14)
    ref = j_simulate_fig4(k, d, cfg=POOL, pool=pool)
    out = simulate_fig4(_tkey(k), td, cfg=_tcfg(POOL), device="cpu",
                        pool=interop.pool_from_numpy(pool, device="cpu"))
    _compare(interop.to_numpy(out), ref)


def test_pool_missing_raises_and_other_strategies_refuse_it():
    """The unfused chain without a pool raises as the reference asserts;
    the fused and counter-hash strategies refuse the pool stream."""
    from repro_torch.tune.registry import get_strategy

    cfg = _tcfg(POOL)
    k = prng.key(1)
    depos = generate_depos(k, cfg, device="cpu")
    with pytest.raises(ValueError, match="pre-computed pool"):
        get_strategy("charge_grid", "unfused").fn(k, depos, cfg)
    pool = tfl.make_pool(prng.key(2), 1 << 10, device="cpu")
    for name in ("fused_pallas", "fused_pallas_compact"):
        with pytest.raises(ValueError, match="pool"):
            get_strategy("charge_grid", name).fn(k, depos, cfg, pool=pool)


# ---------------------------------------------------------------------------
# Batches and the stream
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("planes,recon", [(1, False), (3, True)])
def test_pool_batch_rows_equal_per_event(planes, recon):
    """Ragged events and a padding row: every batched row == the per-event
    run on the same padded row, bit for bit; each event's valid depos come
    first, so each takes the one pool from offset 0."""
    cfg = _tcfg(dataclasses.replace(BATCH_CFG, num_planes=planes,
                                    scatter_strategy="pallas"))
    gen = generate_plane_depos if planes > 1 else generate_depos
    events = [gen(prng.fold_in(prng.key(0), 100 + i), cfg, n, device="cpu")
              for i, n in enumerate([5, 48, 17])]
    events.append(tbatch.empty_event(planes, device="cpu"))
    batch = tbatch.pack_events(events, pad_to=cfg.num_depos)
    keys = tbatch.event_keys(prng.key(1), [0, 1, 2, 9])
    pool = tfl.make_pool(prng.key(9), 1 << 14, device="cpu")
    graph = build_sim_graph(cfg, device="cpu", recon=recon, pool=pool)
    out = tbatch.simulate_events(keys, batch, graph=graph)
    for e in range(batch.num_events):
        one = graph.run(keys[e], batch.event(e), int(batch.n_depos[e]))
        for name in ("adc", "charge_grid", "signal", "decon"):
            if getattr(one, name) is not None:
                assert torch.equal(getattr(out, name)[e], getattr(one, name))
        if recon:
            for a, b in zip(out.hits, one.hits):
                assert torch.equal(a[e], b)
    batched = tbatch.make_batched_sim_fn(cfg, device="cpu", recon=recon,
                                         pool=pool)(keys, batch)
    assert torch.equal(batched.adc, out.adc)


def test_pool_batch_matches_reference_batched():
    """``tests/test_event_batch.py::test_pool_strategy_batched``'s setting,
    the reference's pool handed across: every row under parity's rules."""
    key = jax.random.key(0)
    events = [j_generate(jax.random.fold_in(key, 100 + i), BATCH_CFG, n)
              for i, n in enumerate([5, 9])]
    pool = jfl.make_pool(jax.random.key(9), 1 << 14)
    ref_batch = jbatch.pack_events(events)
    ref_keys = jbatch.event_keys(jax.random.key(1), range(2))
    ref = jbatch.simulate_events(ref_keys, ref_batch, None, BATCH_CFG,
                                 pool=pool)
    batch = interop.event_batch_from_numpy(
        *(np.asarray(getattr(ref_batch, f))
          for f in jbatch.EventBatch._fields), device="cpu")
    keys = interop.keys_from_data(np.asarray(jax.random.key_data(ref_keys)))
    out = tbatch.simulate_events(
        keys, batch, cfg=_tcfg(BATCH_CFG), device="cpu",
        pool=interop.pool_from_numpy(pool, device="cpu"))
    for e in range(2):
        parity.assert_close(out.charge_grid[e].numpy(),
                            np.asarray(ref.charge_grid[e]),
                            atol_frac=parity.GRID_ATOL_FRAC, what="grid")
        parity.assert_adc_close(out.adc[e].numpy(), np.asarray(ref.adc[e]),
                                what=f"event {e}")


def test_pool_stream_rows_equal_run_events():
    """``--set rng_strategy=pool`` streams: 3 events, 2 a batch, every row
    == ``run_events``' event bit for bit."""
    cfg = dataclasses.replace(_tcfg(POOL), scatter_strategy="pallas")
    loop = {}
    launcher.run_events(cfg, 3, device="cpu", on_event=lambda ev, out, dt:
                        loop.update({ev: out.adc}))
    rows = {}

    def on_batch(b, n_valid, n_depos, dt, out):
        for e in range(n_valid):
            rows[2 * b + e] = out.adc[e]

    stats = launcher.stream_simulate(cfg, 3, 2, device="cpu",
                                     on_batch=on_batch)
    assert stats["events"] == 3 and sorted(rows) == [0, 1, 2]
    for ev in range(3):
        assert torch.equal(rows[ev], loop[ev]), ev


# ---------------------------------------------------------------------------
# The launcher and the tuner
# ---------------------------------------------------------------------------

FIG3_LINE = re.compile(r"^event 0: 64 depos -> \(128, 512\) ADC in \d+ ms "
                       r"\([0-9.e+]+ depos/s\), max dev \d+(\.0)?$")


def _ref_main(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["repro.launch.sim"] + argv)
    j_launcher.main()


def test_launcher_fig3_prints_the_reference_line(capsys, monkeypatch):
    argv = ["--smoke", "--pipeline", "fig3", "--events", "1", "--depos",
            "64"]
    launcher.main(argv + ["--device", "cpu"])
    port = capsys.readouterr().out.strip().splitlines()
    _ref_main(argv, monkeypatch)
    ref = capsys.readouterr().out.strip().splitlines()
    assert len(port) == len(ref) == 1
    assert FIG3_LINE.match(port[0]), port[0]
    assert FIG3_LINE.match(ref[0]), ref[0]


@pytest.mark.parametrize("extra", [["--recon"], ["--journal", "J"],
                                   ["--journal", "J", "--resume"],
                                   ["--inject-faults", "nan@0"]],
                         ids=["recon", "journal", "resume", "inject_faults"])
def test_launcher_fig3_refusals(extra, tmp_path, monkeypatch):
    extra = [str(tmp_path / "j.jsonl") if x == "J" else x for x in extra]
    argv = ["--smoke", "--pipeline", "fig3", "--events", "1"] + extra
    with pytest.raises(SystemExit) as port:
        launcher.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as ref:
        _ref_main(argv, monkeypatch)
    assert str(port.value) == str(ref.value)
    assert "fig4" in str(port.value)
    assert not (tmp_path / "j.jsonl").exists()


def test_pool_tuner_refuses_like_the_reference(tmp_path):
    """The tuner's charge-grid candidates run without a pool: the
    reference fails its assertion, the port raises naming the pool."""
    with pytest.raises(AssertionError, match="pre-computed pool"):
        jtune.tune_op("charge_grid", POOL,
                      cache=jtune.TuneCache(str(tmp_path / "ref.json")),
                      sample_depos=64)
    with pytest.raises(ValueError, match="pre-computed pool"):
        ttune.tune_op("charge_grid", _tcfg(POOL),
                      cache=ttune.TuneCache(str(tmp_path / "port.json")),
                      sample_depos=64, device="cpu")

