"""Port core stages against the reference's, on the same inputs, on the CPU.

Each test builds its inputs from a seed, runs the JAX function and its port
counterpart (``device="cpu"``), and compares through numpy with the
tolerances of ``repro_torch.testing.parity``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core import depo as jdepo
from repro.core import drift as jdrift
from repro.core import fft_conv as jfft
from repro.core import noise as jnoise
from repro.core import rasterize as jrast
from repro.core import response as jresp
from repro.core import scatter as jscatter
from repro_torch import interop
from repro_torch.core import depo as tdepo
from repro_torch.core import drift as tdrift
from repro_torch.core import fft_conv as tfft
from repro_torch.core import noise as tnoise
from repro_torch.core import rasterize as trast
from repro_torch.core import response as tresp
from repro_torch.core import scatter as tscatter
from repro_torch.testing import parity

torch.set_num_threads(1)

SMOKE = jax_get_config("lartpc-uboone", smoke=True)
#: patches straddle the 64x256 tile edges, and 96 wires leave a ragged tile
EDGE = JaxConfig(num_wires=96, num_ticks=768, num_depos=128,
                 response_wires=11, response_ticks=64)
CONFIGS = {"smoke": SMOKE, "edge": EDGE}


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tkey(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)))


def _np(tree):
    return [np.asarray(x) for x in tree]


def _ref_depos(cfg, seed=0):
    return jdepo.generate_depos(jax.random.key(seed), cfg)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_generate_physical_depos(name):
    cfg = CONFIGS[name]
    k = jax.random.key(3)
    ref = jdepo.generate_physical_depos(k, cfg)
    out = tdepo.generate_physical_depos(_tkey(k), _tcfg(cfg), device="cpu")
    for field, r, o in zip(ref._fields, _np(ref), _np(out)):
        parity.assert_close(o, r, what=field)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_drift_same_physical_depos(name):
    cfg = CONFIGS[name]
    pd = jdepo.generate_physical_depos(jax.random.key(4), cfg)
    ref = jdrift.drift_depos(pd, cfg)
    out = tdrift.drift_depos(
        interop.physical_depos_from_numpy(*_np(pd), device="cpu"), _tcfg(cfg))
    # wire and tick are exact ops of the inputs (identity, power-of-2 scale)
    np.testing.assert_array_equal(np.asarray(out.wire), np.asarray(ref.wire))
    np.testing.assert_array_equal(np.asarray(out.tick), np.asarray(ref.tick))
    for field in ("sigma_w", "sigma_t", "charge"):
        parity.assert_close(getattr(out, field).numpy(),
                            np.asarray(getattr(ref, field)), what=field)


def test_drift_with_lifetime_and_recombination():
    cfg = dataclasses.replace(SMOKE, electron_lifetime_us=3000.0,
                              recombination=0.7)
    pd = jdepo.generate_physical_depos(jax.random.key(5), cfg)
    ref = jdrift.drift_depos(pd, cfg)
    out = tdrift.drift_depos(
        interop.physical_depos_from_numpy(*_np(pd), device="cpu"), _tcfg(cfg))
    parity.assert_close(out.charge.numpy(), np.asarray(ref.charge),
                        what="charge")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_depo_patch_origin_exact(name):
    cfg = CONFIGS[name]
    d = _ref_depos(cfg, 6)
    w0, t0 = jdepo.depo_patch_origin(d, cfg)
    tw0, tt0 = tdepo.depo_patch_origin(
        interop.depos_from_numpy(*_np(d), device="cpu"), _tcfg(cfg))
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(tt0.numpy(), np.asarray(t0))


def test_patch_origin_rounds_half_to_even():
    cfg = _tcfg(SMOKE)
    wire = torch.tensor([20.5, 21.5, 30.5], dtype=torch.float32)
    d = tdepo.DepoSet(wire, wire, wire, wire, wire)
    w0, _ = tdepo.depo_patch_origin(d, cfg)
    assert w0.tolist() == [10, 12, 20]


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("plane", ["induction", "collection"])
def test_make_response(name, plane):
    cfg = CONFIGS[name]
    ref = jresp.make_response(cfg, plane)
    out = tresp.make_response(_tcfg(cfg), plane, device="cpu")
    assert out.pad_shape == ref.pad_shape
    parity.assert_close(out.kernel.numpy(), np.asarray(ref.kernel),
                        what="kernel")
    parity.assert_close(out.freq.numpy(), np.asarray(ref.freq), what="freq")


def test_make_response_gain():
    cfg = dataclasses.replace(SMOKE, response_gain=1.7)
    ref = jresp.make_response(cfg)
    out = tresp.make_response(_tcfg(cfg), device="cpu")
    parity.assert_close(out.kernel.numpy(), np.asarray(ref.kernel))


@pytest.mark.parametrize("n", [1, 2, 7, 2580, 9791, 10000])
def test_next_fast_len(n):
    assert tresp.next_fast_len(n) == jresp.next_fast_len(n)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fft_convolve_same_grid(name):
    cfg = CONFIGS[name]
    grid = np.random.default_rng(7).random(
        (cfg.num_wires, cfg.num_ticks)).astype(np.float32) * 100
    resp = jresp.make_response(cfg)
    ref = np.asarray(jfft.fft_convolve(jnp.asarray(grid), resp))
    tresp_ = interop.response_from_numpy(np.asarray(resp.kernel),
                                         np.asarray(resp.freq),
                                         resp.pad_shape, device="cpu")
    out = tfft.fft_convolve(torch.from_numpy(grid), tresp_).numpy()
    parity.assert_close(out, ref, what="fft_convolve")


def test_noise_spectrum():
    for cfg in CONFIGS.values():
        parity.assert_close(tnoise.noise_spectrum(_tcfg(cfg), "cpu").numpy(),
                            np.asarray(jnoise.noise_spectrum(cfg)))


@pytest.mark.parametrize("num_ticks", [512, 511])
def test_simulate_noise(num_ticks):
    cfg = dataclasses.replace(SMOKE, num_ticks=num_ticks)
    k = jax.random.key(8)
    ref = np.asarray(jnoise.simulate_noise(k, cfg))
    out = tnoise.simulate_noise(_tkey(k), _tcfg(cfg), device="cpu").numpy()
    parity.assert_close(out, ref, what="noise")


@pytest.mark.parametrize("ste", [False, True])
def test_digitize(ste):
    cfg = dataclasses.replace(SMOKE, digitize_ste=ste)
    rng = np.random.default_rng(9)
    signal = (rng.standard_normal((64, 128)) * 3e4).astype(np.float32)
    signal[0, :4] = [-1e9, 1e9, 0.0, 50.0]  # both rails and a tie
    ref = np.asarray(jfft.digitize(jnp.asarray(signal), cfg))
    out = tfft.digitize(torch.from_numpy(signal), _tcfg(cfg)).numpy()
    assert out.dtype == ref.dtype
    parity.assert_adc_close(out, ref, what="digitize")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rasterize_same_depos(name):
    cfg = CONFIGS[name]
    d = _ref_depos(cfg, 10)
    p, w0, t0 = jrast.rasterize(d, cfg)
    tp, tw0, tt0 = trast.rasterize(
        interop.depos_from_numpy(*_np(d), device="cpu"), _tcfg(cfg))
    np.testing.assert_array_equal(tw0.numpy(), np.asarray(w0))
    np.testing.assert_array_equal(tt0.numpy(), np.asarray(t0))
    parity.assert_close(tp.numpy(), np.asarray(p), what="patches")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_xla_scatter_same_patches(name):
    cfg = CONFIGS[name]
    d = _ref_depos(cfg, 11)
    p, w0, t0 = jrast.rasterize(d, cfg)
    ref = np.asarray(jscatter.scatter_xla(p, w0, t0, cfg))
    out, dropped = tscatter.scatter_add(*(torch.from_numpy(np.array(x))
                                          for x in (p, w0, t0)), _tcfg(cfg))
    assert int(dropped) == 0
    parity.assert_close(out.numpy(), ref, what="scatter")
