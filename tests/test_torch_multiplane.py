"""The port's three-plane readout against the reference, on the CPU.

MicroBooNE's U and V induction planes (+-60 deg) and Y collection plane, at
the reference's plane-batching smoke config (128 x 512, 256 depos,
``num_planes=3``). Both packages get the same key and the same physical
depos (carried across by ``interop``); the projection, the per-plane
responses, the erfinv counter normals, the multi-plane fused kernels' plain
versions and the whole event are compared with the tolerances of
``repro_torch.testing.parity``. Within the port, stacked plane batching
equals the per-plane loop bit for bit, plane p of a multi-plane launch
equals the one-plane strategy run with ``fold_in(kf, p)``, and a
``planes=(p,)`` graph equals plane p of the full graph.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.config import plane_specs as jax_plane_specs
from repro.core import drift as jdrift
from repro.core import fft_conv as jfft
from repro.core import fluctuate as jfl
from repro.core import response as jresp
from repro.core.depo import generate_physical_depos as j_generate_physical
from repro.core.depo import generate_plane_depos as j_generate_planes
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.core.stages import resolve_plane_batching as j_resolve
from repro.kernels.fused_sim import ops as jops
from repro_torch import interop
from repro_torch.config import plane_specs
from repro_torch.core import drift as tdrift
from repro_torch.core import fft_conv as tfft
from repro_torch.core import fluctuate as tfl
from repro_torch.core import prng
from repro_torch.core import response as tresp
from repro_torch.core.depo import generate_physical_depos, \
    generate_plane_depos
from repro_torch.core.pipeline import make_sim_fn
from repro_torch.core.stages import (MULTIPLANE_CHARGE_GRID, build_sim_graph,
                                     resolve_plane_batching)
from repro_torch.kernels.fused_sim import ops as tops
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity

torch.set_num_threads(1)

CFG3 = dataclasses.replace(jax_get_config("lartpc-uboone", smoke=True),
                           num_planes=3)
#: (charge_grid_strategy, scatter_strategy) of the whole-event cases
EVENT_CASES = {"fused_pallas_multiplane": ("fused_pallas_multiplane", "xla"),
               "fused_pallas_multiplane_compact":
                   ("fused_pallas_multiplane_compact", "xla"),
               "multiplane_xla": ("multiplane_xla", "xla"),
               "unfused_xla": ("unfused", "xla"),
               "unfused_pallas": ("unfused", "pallas")}
#: the cases that also run the per-plane loop (the multi-plane strategies
#: refuse it, in both packages)
LOOPABLE = ("unfused_xla", "unfused_pallas")


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tkey(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)))


def _np(tree):
    return [np.array(x) for x in tree]


def _physical(seed):
    k = jax.random.key(seed)
    pd = j_generate_physical(k, CFG3)
    return k, pd, interop.physical_depos_from_numpy(*_np(pd), device="cpu")


@pytest.mark.parametrize("plane", [0, 1, 2])
def test_project_to_plane(plane):
    _, pd, tpd = _physical(1)
    spec = jax_plane_specs(CFG3)[plane]
    ref = jdrift.project_to_plane(pd, spec, CFG3)
    out = tdrift.project_to_plane(tpd, plane_specs(_tcfg(CFG3))[plane],
                                  _tcfg(CFG3))
    if spec.angle_deg == 0.0:  # the collection plane passes through
        assert out is tpd
    parity.assert_close(out.y.numpy(), np.asarray(ref.y), what="y")


@pytest.mark.parametrize("planes", [None, (2, 0)])
def test_transport_planes(planes):
    _, pd, tpd = _physical(2)
    ref = jdrift.transport_planes(pd, CFG3, planes=planes)
    out = tdrift.transport_planes(tpd, _tcfg(CFG3), planes=planes)
    assert out.wire.shape == ref.wire.shape
    for field, r, o in zip(ref._fields, _np(ref), _np(out)):
        parity.assert_close(o, r, what=field)


def test_generate_plane_depos():
    k = jax.random.key(3)
    ref = j_generate_planes(k, CFG3)
    out = generate_plane_depos(_tkey(k), _tcfg(CFG3), device="cpu")
    assert out.wire.shape == (3, CFG3.num_depos)
    for field, r, o in zip(ref._fields, _np(ref), _np(out)):
        parity.assert_close(o, r, what=field)


def test_plane_responses_and_their_interop():
    refs = jresp.make_plane_responses(CFG3)
    outs = tresp.make_plane_responses(_tcfg(CFG3), device="cpu")
    carried = interop.plane_responses_from_numpy(
        [(np.asarray(r.kernel), np.asarray(r.freq), r.pad_shape, r.plane)
         for r in refs], device="cpu")
    assert [o.plane for o in outs] == [r.plane for r in refs] == [
        "induction", "induction", "collection"]
    for r, o, c in zip(refs, outs, carried):
        assert o.pad_shape == r.pad_shape == c.pad_shape
        parity.assert_close(o.kernel.numpy(), np.asarray(r.kernel))
        parity.assert_close(o.freq.numpy(), np.asarray(r.freq))
        np.testing.assert_array_equal(c.freq.numpy(), np.asarray(r.freq))


def test_counter_normals_erfinv():
    rng = np.random.default_rng(4)
    s0, s1, stream = (rng.integers(0, 2**32, 64, dtype=np.uint64)
                      .astype(np.uint32)[:, None] for _ in range(3))
    pix = np.arange(400, dtype=np.uint32)[None, :]
    ref = np.asarray(jfl.counter_normals_erfinv(*map(jnp.asarray,
                                                     (s0, s1, stream, pix))))
    out = tfl.counter_normals_erfinv(
        *(torch.from_numpy(x.astype(np.int64)) for x in (s0, s1, stream,
                                                         pix))).numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=parity.NORMAL_ATOL)


@pytest.mark.parametrize("plane", ["induction", "collection"])
def test_fft2_matches_reference_and_rfft2(plane):
    grid = np.random.default_rng(5).random(
        (CFG3.num_wires, CFG3.num_ticks)).astype(np.float32) * 100
    r = jresp.make_response(CFG3, plane)
    ref = np.asarray(jfft.fft_convolve_fft2(jnp.asarray(grid), r))
    tr = interop.response_from_numpy(np.asarray(r.kernel),
                                     np.asarray(r.freq), r.pad_shape, plane,
                                     device="cpu")
    out = tfft.fft_convolve(torch.from_numpy(grid), tr, "fft2").numpy()
    parity.assert_close(out, ref, what="fft2")
    parity.assert_close(out, tfft.fft_convolve(torch.from_numpy(grid), tr,
                                               "rfft2").numpy(), what="rfft2")


@pytest.mark.parametrize("fluct", [False, True])
@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_plain_multiplane_kernels_match_reference(layout, fluct):
    d = j_generate_planes(jax.random.key(6), CFG3)
    kf = jax.random.split(jax.random.key(7))[0]
    keys = tkeys = None
    if fluct:
        keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
            kf, jnp.arange(3, dtype=jnp.uint32))
        tkf = _tkey(kf)
        tkeys = torch.stack([prng.fold_in(tkf, p) for p in range(3)])
    jfn, tfn = {"dense": (jops.simulate_charge_grid_multiplane,
                          tops.simulate_charge_grid_multiplane),
                "compact": (jops.simulate_charge_grid_multiplane_compact,
                            tops.simulate_charge_grid_multiplane_compact)
                }[layout]
    ref = np.asarray(jfn(d, CFG3, interpret=True, keys=keys))
    out, dropped = tfn(interop.depos_from_numpy(*_np(d), device="cpu"),
                       _tcfg(CFG3), keys=tkeys)
    assert int(dropped) == 0 and out.shape == (3, 128, 512)
    parity.assert_close(out.numpy(), ref, atol_frac=parity.GRID_ATOL_FRAC,
                        what=f"{layout} grid")


def _event(case, mode, seed=0):
    strategy, scatter = EVENT_CASES[case]
    cfg = dataclasses.replace(CFG3, charge_grid_strategy=strategy,
                              scatter_strategy=scatter, plane_batching=mode)
    k, pd, tpd = _physical(seed)
    ref = j_make_sim_fn(cfg)(k, pd)
    out = make_sim_fn(_tcfg(cfg), device="cpu")(_tkey(k), tpd)
    return ref, out


@pytest.mark.parametrize("mode", ["stacked", "loop"])
@pytest.mark.parametrize("case", sorted(EVENT_CASES))
def test_event_matches_reference(case, mode):
    if mode == "loop" and case not in LOOPABLE:
        with pytest.raises(ValueError, match="FULL stacked"):
            _event(case, mode)
        return
    ref, out = _event(case, mode)
    out = interop.to_numpy(out)
    assert out["adc"].shape == (3, 128, 512) and out["adc"].dtype == np.int16
    assert int(out["dropped"]) == 0
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_close(out["signal"], np.asarray(ref.signal),
                        atol_frac=parity.SIGNAL_ATOL_FRAC, what="signal")
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")


def _port_event(strategy, scatter="xla", mode="stacked", planes=None,
                seed=8):
    cfg = dataclasses.replace(_tcfg(CFG3), charge_grid_strategy=strategy,
                              scatter_strategy=scatter, plane_batching=mode)
    k = prng.key(seed)
    graph = build_sim_graph(cfg, device="cpu", planes=planes)
    return graph(k, generate_physical_depos(k, cfg, device="cpu"))


@pytest.mark.parametrize("strategy,scatter", [("unfused", "xla"),
                                              ("unfused", "pallas"),
                                              ("fused_pallas", "xla")])
def test_stacked_equals_loop_bitwise(strategy, scatter):
    stacked = _port_event(strategy, scatter, "stacked")
    loop = _port_event(strategy, scatter, "loop")
    for field in ("charge_grid", "signal", "adc"):
        assert torch.equal(getattr(stacked, field), getattr(loop, field))


@pytest.mark.parametrize("multi,single", [
    ("fused_pallas_multiplane", "simulate_charge_grid"),
    ("fused_pallas_multiplane_compact", "simulate_charge_grid_compact")])
def test_plane_p_equals_single_plane_with_folded_key(multi, single):
    cfg = _tcfg(CFG3)
    depos = generate_plane_depos(prng.key(9), cfg, device="cpu")
    kf = prng.split(prng.key(10))[0]
    keys = torch.stack([prng.fold_in(kf, p) for p in range(3)])
    grids, _ = getattr(tops, multi.replace(
        "fused_pallas", "simulate_charge_grid"))(depos, cfg, keys=keys)
    for p in range(3):
        one, _ = getattr(tops, single)(
            type(depos)(*(x[p] for x in depos)), cfg,
            key=prng.fold_in(kf, p))
        assert torch.equal(grids[p], one)
    # the strategy as the stacked stage dispatches it
    assert torch.equal(_port_event(multi).adc, _port_event("fused_pallas").adc)


@pytest.mark.parametrize("plane", [0, 1, 2])
def test_restricted_graph_equals_plane_of_full_graph(plane):
    full = _port_event("unfused")
    one = _port_event("unfused", planes=(plane,))
    assert one.adc.shape == (1, 128, 512)
    for field in ("charge_grid", "signal", "adc"):
        assert torch.equal(getattr(one, field)[0],
                           getattr(full, field)[plane])


def test_pre_drifted_depos_equal_physical_input():
    cfg = _tcfg(CFG3)
    k = prng.key(11)
    sim = make_sim_fn(cfg, device="cpu")
    physical = sim(k, generate_physical_depos(k, cfg, device="cpu"))
    drifted = sim(k, generate_plane_depos(k, cfg, device="cpu"))
    assert torch.equal(physical.adc, drifted.adc)
    planeless = generate_plane_depos(k, cfg, device="cpu")
    with pytest.raises(ValueError, match="planeless"):
        sim(k, type(planeless)(*(x[0] for x in planeless)))


def test_single_response_for_three_planes_raises():
    cfg = _tcfg(CFG3)
    with pytest.raises(ValueError, match="single DetectorResponse"):
        make_sim_fn(cfg, tresp.make_response(cfg, device="cpu"),
                    device="cpu")


@pytest.mark.parametrize("mode", ["auto", "loop", "stacked", "zigzag"])
def test_plane_batching_resolves_like_reference(mode):
    for planes in (1, 3):
        cfg = dataclasses.replace(CFG3, num_planes=planes,
                                  plane_batching=mode)
        if mode == "zigzag":
            with pytest.raises(ValueError, match="plane_batching"):
                resolve_plane_batching(_tcfg(cfg))
        else:
            assert resolve_plane_batching(_tcfg(cfg)) == j_resolve(cfg)


def test_multiplane_strategy_names_match_reference():
    from repro.core.stages import MULTIPLANE_CHARGE_GRID as J_MULTI

    assert MULTIPLANE_CHARGE_GRID == J_MULTI


def test_launcher_prints_per_plane_lines(capsys):
    launcher.main(["--smoke", "--planes", "3", "--events", "1", "--device",
                   "cpu", "--set",
                   "charge_grid_strategy=fused_pallas_multiplane"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("event 0: 256 depos x 3 planes -> "
                               "(3, 128, 512) ADC in ")
    assert lines[0].endswith("dropped 0")
    for p, kind in enumerate(("induction", "induction", "collection")):
        assert lines[1 + p].startswith(f"event 0 plane {p} ({kind}, ")
        assert int(lines[1 + p].rsplit(" ", 1)[1]) > 0
    assert lines[-1].startswith("total: 1 events / 256 depos in ")


def test_launcher_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launcher.main(["--smoke", "--planes", "3", "--events", "1"])


def _multiplane_args():
    from repro_torch.core.depo import depo_patch_origin
    from repro_torch.kernels.scatter_add import ops as tbin

    cfg = _tcfg(CFG3)
    depos = generate_plane_depos(prng.key(12), cfg, device="cpu")
    w0, t0 = depo_patch_origin(depos, cfg)
    k_max = tbin.default_k_max(depos.n, cfg.num_wires, cfg.num_ticks, 64, 256)
    ids = torch.cat([tbin.bin_depos_to_tiles(
        w0[p], t0[p], cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
        cfg.num_ticks, 64, 256, k_max)[0] for p in range(3)])
    kw = dict(num_planes=3, num_wires=cfg.num_wires, num_ticks=cfg.num_ticks,
              tw=64, tt=256, k_max=k_max, pw=cfg.patch_wires,
              pt=cfg.patch_ticks, seeds=[(1, 2), (3, 4), (5, 6)],
              fluctuate=True)
    return [*depos, w0, t0, ids], kw


def test_multiplane_cpu_path_does_not_count_launches():
    from repro_torch.kernels.fused_sim import kernel as tkernel

    args, kw = _multiplane_args()
    tkernel.reset_launches()
    out = tkernel.fused_rasterize_scatter_multiplane(*args, **kw)
    assert out.shape == (3, 128, 512) and float(out.sum()) > 0.0
    assert set(tkernel.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["seeds", "planes", "lists"])
def test_multiplane_wrapper_rejects_bad_inputs(bad):
    from repro_torch.kernels.fused_sim import kernel as tkernel

    args, kw = _multiplane_args()
    if bad == "seeds":
        kw["seeds"] = kw["seeds"][:2]
    elif bad == "planes":
        args[0] = args[0][:2]
    else:
        args[7] = args[7][:-1]
    with pytest.raises(ValueError):
        tkernel.fused_rasterize_scatter_multiplane(*args, **kw)
