"""The port's bfloat16 patch path against the reference, on the CPU.

``charge_grid_strategy="unfused_bf16"`` rasterises bfloat16 patches. With
fluctuation on (the physics default), they meet the float32 charge and reach
the scatter as float32; with it off, the scatter takes them as bfloat16 and
adds them in float32. Both configs run the whole event, one plane at the
smoke config and MicroBooNE's three planes at the plane-batching config,
against the reference's jitted ``make_sim_fn`` with each scatter strategy,
within the tolerances of ``repro_torch.testing.parity``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core import fft_conv as jfft
from repro.core import rasterize as jrast
from repro.core import response as jresp
from repro.core.depo import generate_depos as j_generate
from repro.core.depo import generate_physical_depos as j_generate_physical
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.tune import registry as jregistry
from repro_torch import interop
from repro_torch.core import fft_conv as tfft
from repro_torch.core import pipeline as tpipeline
from repro_torch.core import prng
from repro_torch.core import rasterize as trast
from repro_torch.core.depo import (generate_depos,
                                   generate_physical_depos)
from repro_torch.core.pipeline import make_sim_fn
from repro_torch.core.stages import build_sim_graph
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity
from repro_torch.tune import registry as tregistry

torch.set_num_threads(1)

SMOKE = jax_get_config("lartpc-uboone", smoke=True)
#: patches straddle the 64x256 tile edges, and 96 wires leave a ragged tile
EDGE = JaxConfig(num_wires=96, num_ticks=768, num_depos=128,
                 response_wires=11, response_ticks=64)
CONFIGS = {"smoke": SMOKE, "edge": EDGE}
#: the three-plane config of the reference's plane-batching tests
CFG3 = dataclasses.replace(SMOKE, num_planes=3)
SCATTERS = ["xla", "pallas", "pallas_compact"]


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _bf16(cfg):
    return dataclasses.replace(cfg, patch_dtype="bfloat16")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rasterize_bf16(name):
    """bfloat16 patches: the float32 patch rounded to nearest even, within
    ``parity.BF16_RTOL`` of the jitted reference's; origins exact."""
    cfg = _bf16(CONFIGS[name])
    d = j_generate(jax.random.key(10), cfg)
    p, w0, t0 = jax.jit(lambda d: jrast.rasterize(d, cfg))(d)
    tp, tw0, tt0 = trast.rasterize(
        interop.depos_from_numpy(*(np.asarray(x) for x in d), device="cpu"),
        _tcfg(cfg))
    assert tp.dtype == torch.bfloat16 and p.dtype == jnp.bfloat16
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(tt0.numpy(), np.asarray(t0))
    ref = np.asarray(p.astype(jnp.float32))
    parity.assert_close(tp.to(torch.float32).numpy(), ref,
                        rtol=parity.BF16_RTOL, what="bf16 patches")
    # how far apart in bfloat16 ulps (the measured values are in parity)
    ulps = np.abs(interop.bf16_bits(tp).astype(np.int32)
                  - interop.bf16_bits(p).astype(np.int32))
    above = np.abs(ref) > parity.ATOL_FRAC * np.abs(ref).max()
    assert np.count_nonzero(ulps) <= 0.25 * ulps.size
    assert np.count_nonzero((ulps > 1) & above) <= 0.005 * ulps.size
    wide, _, _ = trast.rasterize(interop.depos_from_numpy(
        *(np.asarray(x) for x in d), device="cpu"), _tcfg(CONFIGS[name]))
    assert torch.equal(tp, wide.to(torch.bfloat16))


@pytest.mark.parametrize("strategy", ["rfft2", "fft2"])
def test_fft_convolve_widens_a_bf16_grid(strategy):
    """A bfloat16 grid widens to float32 before the transform, and both
    strategies return float32, as the reference's."""
    cfg = SMOKE
    grid = (np.random.default_rng(3).random((cfg.num_wires, cfg.num_ticks))
            * 100).astype(np.float32)
    jgrid = jnp.asarray(grid).astype(jnp.bfloat16)
    resp = jresp.make_response(cfg)
    ref = jfft.fft_convolve(jgrid, resp, strategy)
    tresp_ = interop.response_from_numpy(np.asarray(resp.kernel),
                                         np.asarray(resp.freq),
                                         resp.pad_shape, device="cpu")
    tgrid = interop.bf16_from_numpy(np.asarray(jgrid), device="cpu")
    out = tfft.fft_convolve(tgrid, tresp_, strategy)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    parity.assert_close(out.numpy(), np.asarray(ref), what=strategy)
    assert torch.equal(out, tfft.fft_convolve(tgrid.to(torch.float32),
                                              tresp_, strategy))


def _event(cfg, seed=3):
    """(reference output, port output as numpy) of one event of ``cfg`` on
    the same key and depos (physical depos for several planes)."""
    k = jax.random.fold_in(jax.random.key(0), seed)
    if cfg.num_planes > 1:
        d = j_generate_physical(k, cfg)
        port_depos = interop.physical_depos_from_numpy(
            *(np.asarray(x) for x in d), device="cpu")
    else:
        d = j_generate(k, cfg)
        port_depos = interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                              device="cpu")
    ref = j_make_sim_fn(cfg)(k, d)
    out = make_sim_fn(_tcfg(cfg), device="cpu")(
        interop.key_from_data(jax.random.key_data(k)), port_depos)
    return ref, interop.to_numpy(out)


@pytest.mark.parametrize("scatter", SCATTERS)
@pytest.mark.parametrize("fluct", [False, True])
@pytest.mark.parametrize("planes", [1, 3])
def test_unfused_bf16_event_matches_reference(planes, fluct, scatter):
    """The whole event against the reference's jitted ``make_sim_fn``: one
    plane at the smoke config, three planes (per-plane dispatch, as the
    reference vmaps the strategy) at the plane-batching config."""
    base = CFG3 if planes == 3 else SMOKE
    cfg = dataclasses.replace(base, charge_grid_strategy="unfused_bf16",
                              fluctuate=fluct, scatter_strategy=scatter)
    ref, out = _event(cfg)
    shape = ((3,) if planes == 3 else ()) + (cfg.num_wires, cfg.num_ticks)
    assert out["adc"].shape == shape and out["adc"].dtype == np.int16
    assert out["charge_grid"].dtype == np.float32
    assert int(out["dropped"]) == 0
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_close(out["signal"], np.asarray(ref.signal),
                        atol_frac=parity.SIGNAL_ATOL_FRAC, what="signal")
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")


@pytest.mark.parametrize("fluct,dtype", [(False, torch.bfloat16),
                                         (True, torch.float32)])
def test_patches_reach_the_scatter_in_the_reference_dtype(monkeypatch, fluct,
                                                          dtype):
    """Without fluctuation the scatter takes bfloat16 patches; with it, the
    fluctuated patches are float32 and are not cast back."""
    seen = []
    scatter = tpipeline.scatter_add

    def spy(patches, w0, t0, cfg, *args):
        seen.append(patches.dtype)
        return scatter(patches, w0, t0, cfg, *args)

    monkeypatch.setattr(tpipeline, "scatter_add", spy)
    cfg = dataclasses.replace(_tcfg(SMOKE), charge_grid_strategy="unfused_bf16",
                              fluctuate=fluct, scatter_strategy="pallas")
    k = prng.key(4)
    make_sim_fn(cfg, device="cpu")(k, generate_depos(k, cfg, device="cpu"))
    assert seen == [dtype]


def test_stacked_equals_loop_bitwise_bf16():
    cfg = dataclasses.replace(_tcfg(CFG3), charge_grid_strategy="unfused_bf16",
                              fluctuate=False, scatter_strategy="pallas")
    k = prng.key(8)
    depos = generate_physical_depos(k, cfg, device="cpu")
    outs = [build_sim_graph(dataclasses.replace(cfg, plane_batching=mode),
                            device="cpu")(k, depos)
            for mode in ("stacked", "loop")]
    for field in ("charge_grid", "signal", "adc"):
        assert torch.equal(getattr(outs[0], field), getattr(outs[1], field))


def test_registry_entry_mirrors_reference():
    ref = jregistry.get_strategy("charge_grid", "unfused_bf16")
    port = tregistry.get_strategy("charge_grid", "unfused_bf16")
    assert (port.note, port.differentiable) == (ref.note, ref.differentiable)


def test_check_supported_takes_float32_and_bfloat16_patches():
    for dtype in ("float32", "bfloat16"):
        build_sim_graph(dataclasses.replace(_tcfg(SMOKE), patch_dtype=dtype),
                        device="cpu")
    with pytest.raises(NotImplementedError, match="patch_dtype"):
        trast.patch_dtype(dataclasses.replace(_tcfg(SMOKE),
                                              patch_dtype="float16"))


def test_launcher_names_the_patch_dtype(capsys):
    launcher.main(["--smoke", "--events", "1", "--device", "cpu", "--set",
                   "charge_grid_strategy=unfused_bf16", "fluctuate=false",
                   "scatter_strategy=pallas_compact"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("event 0: 256 depos -> (128, 512) ADC in ")
    assert lines[0].endswith(", patches bfloat16")
    assert lines[-1].startswith("total: 1 events / 256 depos in ")


def test_bf16_bit_views_round_trip():
    values = jnp.asarray(np.random.default_rng(2).standard_normal(
        (3, 5)).astype(np.float32)).astype(jnp.bfloat16)
    t = interop.bf16_from_numpy(np.asarray(values), device="cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(interop.bf16_bits(t),
                                  interop.bf16_bits(np.asarray(values)))
    np.testing.assert_array_equal(t.to(torch.float32).numpy(),
                                  np.asarray(values.astype(jnp.float32)))
    with pytest.raises(ValueError, match="bfloat16"):
        interop.bf16_bits(torch.zeros(2))
    with pytest.raises(ValueError, match="bfloat16"):
        interop.bf16_bits(np.zeros(2, np.float32))


def test_multiplane_xla_reads_patch_dtype():
    """``multiplane_xla`` rasterises in ``cfg.patch_dtype`` too (the fused
    kernels ignore it): bfloat16 patches with fluctuation, three planes,
    against the reference."""
    cfg = dataclasses.replace(CFG3, charge_grid_strategy="multiplane_xla",
                              patch_dtype="bfloat16")
    ref, out = _event(cfg)
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")
