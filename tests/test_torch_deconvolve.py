"""Port deconvolution against the reference, on the CPU.

The inverse filters (``wiener`` and ``gaussian``, for the bipolar induction
and the unipolar collection response) and their application (both
``deconvolve`` strategies) match the reference within the tolerances of
``repro_torch.testing.parity``: complex division and the FFTs differ by
ULPs between XLA and torch. Filter application is tested apart from filter
construction by carrying the reference's filter across with
``interop.response_from_numpy``. ``measured_signal`` divides by the gain,
so it equals the reference bit for bit.
"""
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core.response import make_plane_responses as j_plane_responses
from repro.core.response import make_response as j_response
from repro_torch import interop
from repro_torch.core import deconvolve as tdec
from repro_torch.core.response import make_response
from repro_torch.testing import parity

torch.set_num_threads(1)

#: the module (``repro.core`` re-exports the function under the same name)
jdec = importlib.import_module("repro.core.deconvolve")

CFG = JaxConfig(num_wires=64, num_ticks=256, num_depos=48,
                response_wires=11, response_ticks=48)
PLANES = ["induction", "collection"]
FILTERS = ["wiener", "gaussian"]


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tresp(resp):
    return interop.response_from_numpy(np.asarray(resp.kernel),
                                       np.asarray(resp.freq), resp.pad_shape,
                                       resp.plane, device="cpu")


def _meas(seed=0):
    """A measured-signal-like (W, T) float32 grid: smooth pulses + noise."""
    rng = np.random.default_rng(seed)
    g = rng.normal(0.0, 50.0, (CFG.num_wires, CFG.num_ticks))
    for _ in range(12):
        w, t = rng.integers(0, CFG.num_wires), rng.integers(0, CFG.num_ticks)
        g[max(w - 2, 0):w + 3, max(t - 6, 0):t + 6] += rng.uniform(1e3, 8e3)
    return g.astype(np.float32)


def _assert_complex_close(port, ref, what):
    port, ref = np.asarray(port), np.asarray(ref)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(port, ref, rtol=parity.RTOL,
                               atol=parity.ATOL_FRAC * scale, err_msg=what)


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("kind", FILTERS)
def test_filter_matches_reference(plane, kind):
    ref_resp = j_response(CFG, plane=plane)
    ref = jdec.make_deconv_filter(ref_resp, dataclasses.replace(
        CFG, deconv_filter=kind))
    port = tdec.make_deconv_filter(_tresp(ref_resp), _tcfg(
        dataclasses.replace(CFG, deconv_filter=kind)))
    assert port.pad_shape == tuple(ref.pad_shape) and port.plane == plane
    assert port.freq.dtype == torch.complex64
    _assert_complex_close(port.freq.numpy(), ref.freq, f"{kind}/{plane}")
    np.testing.assert_array_equal(port.kernel.numpy(),
                                  np.asarray(ref.kernel))


def test_filter_from_the_port_response_matches_reference():
    """Built end to end in the port (its own response) the filter stays
    within the same tolerance."""
    ref = jdec.make_deconv_filter(j_response(CFG, plane="collection"), CFG)
    port = tdec.make_deconv_filter(
        make_response(_tcfg(CFG), plane="collection", device="cpu"),
        _tcfg(CFG))
    _assert_complex_close(port.freq.numpy(), ref.freq, "port response")


@pytest.mark.parametrize("plane", PLANES)
@pytest.mark.parametrize("strategy", ["rfft2", "fft_reuse", "auto", None])
def test_deconvolve_matches_reference(plane, strategy):
    ref_filt = jdec.make_deconv_filter(j_response(CFG, plane=plane), CFG)
    meas = _meas(1)
    ref = np.asarray(jdec.deconvolve(jnp.asarray(meas), ref_filt, "rfft2"))
    port = tdec.deconvolve(torch.from_numpy(meas), _tresp(ref_filt),
                           strategy)
    assert port.shape == meas.shape and port.dtype == torch.float32
    parity.assert_close(port.numpy(), ref, what=f"{plane}/{strategy}")


@pytest.mark.parametrize("seed", [0, 1])
def test_measured_signal_divides_like_reference(seed):
    rng = np.random.default_rng(seed)
    adc = rng.integers(0, 4096, (CFG.num_wires, CFG.num_ticks)).astype(
        np.int16)
    for gain in (0.01, 0.003):
        cfg = dataclasses.replace(CFG, adc_per_electron=gain)
        ref = np.asarray(jdec.measured_signal(jnp.asarray(adc), cfg))
        port = tdec.measured_signal(torch.from_numpy(adc), _tcfg(cfg))
        np.testing.assert_array_equal(port.numpy(), ref)


def test_plane_filters_follow_plane_kinds():
    cfg3 = dataclasses.replace(CFG, num_planes=3)
    ref = jdec.make_plane_deconv_filters(cfg3, j_plane_responses(cfg3))
    port = tdec.make_plane_deconv_filters(_tcfg(cfg3), device="cpu")
    assert [f.plane for f in port] == [f.plane for f in ref] == [
        "induction", "induction", "collection"]
    for p, r in zip(port, ref):
        _assert_complex_close(p.freq.numpy(), r.freq, p.plane)


def test_unknown_names_raise_with_the_valid_list():
    resp = make_response(_tcfg(CFG), device="cpu")
    with pytest.raises(ValueError, match="wiener"):
        tdec.make_deconv_filter(resp, _tcfg(CFG), kind="bogus")
    with pytest.raises(ValueError, match="fft_reuse"):
        tdec.deconvolve(torch.zeros((CFG.num_wires, CFG.num_ticks)), resp,
                        "bogus")
