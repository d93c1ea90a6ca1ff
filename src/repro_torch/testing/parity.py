"""Tolerances of the port against the JAX reference, each with its reason.

Integer streams are exact: threefry keys and bits, ``uniform`` draws (a
bit-level transform of the bits), the fmix32 counter hash, and the tile
binning. Float stages differ by the ULPs of each library's erf, erfinv,
log, cos and FFT, so they are compared with ``allclose``; the ADC is int16
and may flip by one count where a float lands next to a rounding tie.
"""
from __future__ import annotations

import numpy as np

#: float stages (patches, grids, signals, spectra): erf/log/cos ULPs of two
#: libraries and, for FFTs, a different summation order
RTOL = 1e-5
#: absolute floor, as a fraction of max|reference|: FFT outputs carry
#: cancellation noise ~1e-7 x the field's peak in pixels near zero
ATOL_FRAC = 1e-5
#: fluctuated charge grids: where a patch pixel sits in the far tail, one
#: ULP of erf near +-1 (~6e-8) changes its mean by ~q*3e-8, and the
#: fluctuation's sqrt(variance) turns that into ~0.03 electrons times the
#: normal; measured worst 2.0e-5 x max|grid| at smoke size
GRID_ATOL_FRAC = 1e-4
#: the signal is the response convolved with that grid and inherits its
#: error (measured worst 1.5e-5 x max|signal| with the drift in the graph)
SIGNAL_ATOL_FRAC = GRID_ATOL_FRAC
#: normals: torch.erfinv vs XLA's erf_inv approximation differ by up to
#: ~2e-5 absolute in the tails (measured 2.2e-5 over 1e5 draws)
NORMAL_ATOL = 5e-5
#: bfloat16 patches, compared as float32 with ``ATOL_FRAC``: each is the
#: float32 patch rounded to nearest even, and the two float32 patches
#: differ by erf ULPs, which can land them on two neighbouring bfloat16
#: values (one bfloat16 ulp is at most 2**-7 of the value). Measured by
#: ``test_torch_bf16.py::test_rasterize_bf16``: at the smoke config 12 027
#: of 102 400 pixels differ, 519 of them above the absolute floor, 481 of
#: those by one bfloat16 ulp and the rest (small values) by 2-4; at the
#: edge config 5 441 of 51 200, 247, 227, at most 3 ulps. All lie inside
#: the floor plus 2**-7 of the value
BF16_RTOL = 2.0 ** -7
#: hits (charge, mean tick, peak of one run) of an identical ADC: sums
#: over a run of deconvolved samples, whose FFT and filter ULPs differ
#: (measured worst 3.6e-6 relative at the three-plane smoke config)
HIT_RTOL = 1e-5
#: ADC: |delta| <= 1 count everywhere ...
ADC_MAX_DELTA = 1
#: ... on at most this fraction of pixels (rounding ties after float ULPs)
ADC_MAX_FRAC = 1e-3


def assert_close(actual, reference, rtol: float = RTOL,
                 atol_frac: float = ATOL_FRAC, what: str = "") -> float:
    """``allclose`` with atol = atol_frac * max|reference|; returns the
    worst |actual - reference| for the record."""
    actual = np.asarray(actual)
    reference = np.asarray(reference)
    assert actual.shape == reference.shape, (what, actual.shape,
                                             reference.shape)
    atol = atol_frac * float(np.max(np.abs(reference))) if reference.size else 0
    np.testing.assert_allclose(actual, reference, rtol=rtol, atol=atol,
                               err_msg=what)
    return float(np.max(np.abs(actual - reference), initial=0.0))


def assert_adc_close(actual, reference, what: str = "") -> float:
    """|delta ADC| <= 1 everywhere and != 0 on <= 0.1 % of pixels; returns
    the fraction of pixels that differ."""
    delta = np.abs(np.asarray(actual, np.int32) - np.asarray(reference,
                                                             np.int32))
    assert delta.max(initial=0) <= ADC_MAX_DELTA, (what, int(delta.max()))
    frac = float(np.count_nonzero(delta)) / max(delta.size, 1)
    assert frac <= ADC_MAX_FRAC, (what, frac)
    return frac
