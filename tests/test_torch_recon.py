"""The port's sim -> recon chain against the reference, on the CPU.

``simulate(..., recon=True)`` appends deconvolve -> hit_find to the fig4
chain. Both packages get the same key and the same depos (carried across by
``interop``) at ``tests/test_recon.py``'s one-plane config and at the
three-plane config of ``tests/test_torch_multiplane.py``, stacked and loop.
The ADC is identical, the deconvolved grid is within ``parity``'s float
tolerance, and the hit sets are equal with tick, charge and peak within
``parity.HIT_RTOL``; a hit may differ only on a wire where some deconvolved
sample lies within that tolerance of the threshold (a float ULP decides
``v > threshold`` there), and the tests assert it. The default graph has no
recon stage and stays bit-identical.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core.depo import generate_depos as j_generate
from repro.core.depo import generate_physical_depos as j_generate_physical
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.core.stages import FULL_STAGE_ORDER as J_FULL_ORDER
from repro_torch import interop
from repro_torch.core import prng
from repro_torch.core.depo import generate_depos, generate_physical_depos
from repro_torch.core.hitfind import HitSet
from repro_torch.core.pipeline import make_sim_fn, simulate
from repro_torch.core.stages import (FULL_STAGE_ORDER, STAGE_ORDER,
                                     build_sim_graph)
from repro_torch.kernels.hitfind import kernel as hit_kernel
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity

torch.set_num_threads(1)

#: ``tests/test_recon.py``'s config
CFG = JaxConfig(num_wires=64, num_ticks=256, num_depos=48,
                response_wires=11, response_ticks=48)
#: ``tests/test_torch_multiplane.py``'s three-plane config
CFG3 = dataclasses.replace(jax_get_config("lartpc-uboone", smoke=True),
                           num_planes=3)
#: (charge_grid_strategy, plane_batching) of the three-plane cases
CASES3 = {"fused_multiplane_stacked": ("fused_pallas_multiplane", "stacked"),
          "unfused_stacked": ("unfused", "stacked"),
          "unfused_loop": ("unfused", "loop")}


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tkey(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)))


def _run_both(cfg, seed, physical=False):
    k = jax.random.key(seed)
    if physical:
        d = j_generate_physical(k, cfg)
        td = interop.physical_depos_from_numpy(
            *(np.asarray(x) for x in d), device="cpu")
    else:
        d = j_generate(k, cfg)
        td = interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                      device="cpu")
    ref = j_make_sim_fn(cfg, recon=True)(k, d)
    out = simulate(_tkey(k), td, _tcfg(cfg), device="cpu", recon=True)
    return ref, interop.to_numpy(out)


def _wire_hits(wire, tick, charge, peak, mask):
    """{wire: [(tick, charge, peak), ...]} of the stored hits, time order."""
    rows = {}
    for w, t, q, p in zip(wire[mask], tick[mask], charge[mask], peak[mask]):
        rows.setdefault(int(w), []).append((t, q, p))
    return rows


def _assert_hits_match(out, ref, decon_ref, cfg, plane=None):
    """Hit sets equal, values within ``HIT_RTOL``; a wire whose hits differ
    must hold a sample within the decon tolerance of the threshold.
    Returns the number of such wires."""
    sel = (lambda x: np.asarray(x)) if plane is None else (
        lambda x: np.asarray(x)[plane])
    port = _wire_hits(*(out[f"hits.{f}"] if plane is None
                        else out[f"hits.{f}"][plane]
                        for f in ("wire", "tick", "charge", "peak", "mask")))
    want = _wire_hits(*(sel(getattr(ref.hits, f))
                        for f in ("wire", "tick", "charge", "peak", "mask")))
    decon = sel(decon_ref)
    atol = parity.ATOL_FRAC * float(np.abs(decon).max())
    thr = cfg.hit_threshold
    near = 0
    for w in sorted(set(port) | set(want)):
        a, b = port.get(w, []), want.get(w, [])
        if len(a) == len(b):
            for x, y in zip(a, b):
                np.testing.assert_allclose(x, y, rtol=parity.HIT_RTOL,
                                           err_msg=f"wire {w}")
            continue
        near += 1
        dist = np.abs(decon[w] - thr) <= atol + parity.RTOL * thr
        assert dist.any(), (f"wire {w}: {len(a)} port hits vs {len(b)} "
                            "reference hits, no sample near the threshold")
    return near


def _assert_event(out, ref, cfg):
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")
    np.testing.assert_array_equal(out["adc"], np.asarray(ref.adc))
    parity.assert_close(out["decon"], np.asarray(ref.decon), what="decon")
    for f in HitSet._fields:
        assert out[f"hits.{f}"].shape == np.asarray(getattr(ref.hits,
                                                            f)).shape, f


@pytest.mark.parametrize("seed", [0, 4])
def test_one_plane_recon_matches_reference(seed):
    ref, out = _run_both(CFG, seed)
    _assert_event(out, ref, CFG)
    assert out["hits.mask"].sum() > 0
    _assert_hits_match(out, ref, ref.decon, CFG)
    assert int(out["hits.n_hits"]) == int(ref.hits.n_hits)


@pytest.mark.parametrize("case", sorted(CASES3))
def test_three_plane_recon_matches_reference(case):
    strategy, mode = CASES3[case]
    cfg = dataclasses.replace(CFG3, charge_grid_strategy=strategy,
                              plane_batching=mode)
    ref, out = _run_both(cfg, 8, physical=True)
    _assert_event(out, ref, cfg)
    assert out["decon"].shape == (3, 128, 512)
    assert out["hits.wire"].shape == (3, cfg.max_hits)
    for p in range(3):
        assert out["hits.mask"][p].sum() > 0
        _assert_hits_match(out, ref, ref.decon, cfg, plane=p)


def test_stage_orders_match_reference():
    assert FULL_STAGE_ORDER == J_FULL_ORDER
    graph = build_sim_graph(_tcfg(CFG), device="cpu", recon=True)
    assert graph.stage_names == FULL_STAGE_ORDER
    assert build_sim_graph(_tcfg(CFG), device="cpu").stage_names == \
        STAGE_ORDER


@pytest.mark.parametrize("cfg", [CFG, CFG3], ids=["one_plane", "three"])
def test_default_graph_is_unchanged(cfg):
    """recon=False has no recon stage and no recon output, and the sim
    outputs of a recon graph are the default graph's bits."""
    tcfg = _tcfg(cfg)
    k = prng.key(3)
    depos = (generate_physical_depos if cfg.num_planes > 1
             else generate_depos)(k, tcfg, device="cpu")
    plain = make_sim_fn(tcfg, device="cpu")(k, depos)
    recon = make_sim_fn(tcfg, device="cpu", recon=True)(k, depos)
    assert plain.decon is None and plain.hits is None
    assert set(interop.to_numpy(plain)) == {"adc", "signal", "charge_grid",
                                            "dropped"}
    for field in ("adc", "signal", "charge_grid", "dropped"):
        assert torch.equal(getattr(plain, field), getattr(recon, field))


def test_stacked_equals_loop_with_recon_bitwise():
    outs = {}
    for mode in ("stacked", "loop"):
        cfg = dataclasses.replace(_tcfg(CFG3), plane_batching=mode)
        k = prng.key(12)
        outs[mode] = make_sim_fn(cfg, device="cpu", recon=True)(
            k, generate_physical_depos(k, cfg, device="cpu"))
    assert torch.equal(outs["stacked"].decon, outs["loop"].decon)
    for f in HitSet._fields:
        assert torch.equal(getattr(outs["stacked"].hits, f),
                           getattr(outs["loop"].hits, f))


@pytest.mark.parametrize("plane", [0, 2])
def test_restricted_recon_graph_equals_plane_of_full_graph(plane):
    cfg = _tcfg(CFG3)
    k = prng.key(13)
    depos = generate_physical_depos(k, cfg, device="cpu")
    full = build_sim_graph(cfg, device="cpu", recon=True)(k, depos)
    one = build_sim_graph(cfg, device="cpu", planes=(plane,),
                          recon=True)(k, depos)
    assert one.decon.shape == (1, 128, 512)
    assert torch.equal(one.decon[0], full.decon[plane])
    for f in HitSet._fields:
        assert torch.equal(getattr(one.hits, f)[0],
                           getattr(full.hits, f)[plane])


@pytest.mark.parametrize("strategy", ["scan", "pallas", "auto"])
def test_hit_strategies_agree_and_cpu_launches_nothing(strategy):
    cfg = dataclasses.replace(_tcfg(CFG), hitfind_strategy=strategy,
                              deconv_strategy="fft_reuse")
    k = prng.key(14)
    depos = generate_depos(k, cfg, device="cpu")
    hit_kernel.reset_launches()
    out = make_sim_fn(cfg, device="cpu", recon=True)(k, depos)
    base = make_sim_fn(_tcfg(CFG), device="cpu", recon=True)(k, depos)
    assert hit_kernel.LAUNCHES == {"hitfind_pallas": 0}
    for f in HitSet._fields:
        assert torch.equal(getattr(out.hits, f), getattr(base.hits, f))


def test_timed_graph_times_the_recon_stages():
    cfg = _tcfg(CFG)
    k = prng.key(1)
    graph = build_sim_graph(cfg, device="cpu", recon=True)
    out, timings = graph.timed(k, generate_depos(k, cfg, device="cpu"),
                               iters=1)
    assert tuple(timings) == FULL_STAGE_ORDER
    assert out.hits is not None


def test_launcher_reports_hits_per_plane(capsys):
    launcher.main(["--smoke", "--planes", "3", "--events", "1", "--recon",
                   "--device", "cpu", "--set",
                   "charge_grid_strategy=fused_pallas_multiplane"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert " hits stored, " in lines[0] and " found" in lines[0]
    assert all(" hits stored, " in line for line in lines[1:4])
    stored = [int(line.split(", ")[-2].split()[0]) for line in lines[1:4]]
    assert sum(stored) == int(lines[0].split(", ")[-2].split()[0])
    assert lines[-1].startswith("total: 1 events")
