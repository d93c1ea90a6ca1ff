"""Tolerances of the port against the JAX reference, each with its reason.

Integer streams are exact: threefry keys and bits, ``uniform`` draws (a
bit-level transform of the bits), the fmix32 counter hash, and the tile
binning. Float stages differ by the ULPs of each library's erf, erfinv,
log, cos and FFT, so they are compared with ``allclose``; the ADC is int16
and may flip by one count where a float lands next to a rounding tie.
"""
from __future__ import annotations

import math

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


#: analytic derivatives of one function on the same inputs (autograd against
#: ``jax.grad``, and the Jacobians inside ``fit_grad_atol``): the forward's
#: float error carried through the chain rule, the signal's. A component
#: that comes out of a cancellation carries it as a fraction of the vector's
#: largest one, so it is the ``atol_frac`` of such a comparison too.
#: Measured worst on the CPU over the five stage cases of
#: ``stage_gradcheck_cases``: 1.7e-5 relative (convolve, shaping); the
#: collection plane's shaping gradient 4.5e-7 absolute = 1.5e-5 x max|grad|
GRAD_RTOL = SIGNAL_ATOL_FRAC
#: the same through bfloat16 patches: the patches of the two packages that
#: differ (11.7 % of the pixels at the smoke config, see ``BF16_RTOL``)
#: differ by one bfloat16 ulp or a few, so a derivative summed over them
#: moves by about 0.117 x 2**-7 = 9.2e-4 of itself per ulp. Measured worst
#: on the CPU 9.4e-4 (charge_grid, diffusion_scale); the other stage cases
#: stay inside ``GRAD_RTOL``
BF16_GRAD_RTOL = 2e-3


def fit_loss_atol(res_ms: float, weight: float = 1.0,
                  norm: float = 1.0) -> float:
    """Tolerance of one term ``weight * mean(r^2)`` of the calibration loss
    of two graphs that share their targets and whose ADCs keep the
    +-1-count rule. ``r`` is the reference's residual (``res_ms`` =
    mean(r^2)): the ADC's, or the deconvolved charge's, a linear map of the
    ADC whose operator norm is ``norm`` (1 for the ADC). The ADCs differ by
    d with mean(d^2) <= F = ``ADC_MAX_FRAC``, so the residual moves by e
    with mean(e^2) <= norm^2 F and, by Cauchy-Schwarz, |mean(2 r e + e^2)|
    <= 2 norm sqrt(F res_ms) + norm^2 F."""
    f = ADC_MAX_FRAC
    return weight * (2.0 * norm * math.sqrt(f * res_ms) + norm * norm * f)


def fit_grad_atol(jac_ms: float, res_ms: float, abs_terms: float,
                  weight: float = 1.0, norm: float = 1.0,
                  dnorm: float = 0.0) -> float:
    """Tolerance of one theta entry of the gradient ``weight * mean(2 r J)``
    of that term, J the reference's Jacobian of the term's output with
    respect to the entry (``jac_ms`` = mean(J^2)). The flips d move r by e
    as in ``fit_loss_atol`` and J by the derivative of the map applied to d,
    whose norm is ``dnorm`` (0 for the ADC: the STE's derivative does not
    see the rounding), so the gradient moves by at most 2 (norm sqrt(F
    jac_ms) + dnorm sqrt(F res_ms) + norm dnorm F); the Jacobian's float
    error adds ``GRAD_RTOL`` of ``abs_terms`` = mean(|2 r J|)."""
    f = ADC_MAX_FRAC
    flips = 2.0 * (norm * math.sqrt(f * jac_ms) + dnorm * math.sqrt(f * res_ms)
                   + norm * dnorm * f)
    return weight * (flips + GRAD_RTOL * abs_terms)


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


#: LM activations and logits in float32, as a fraction of max|reference|
#: (``assert_close``'s ``atol_frac``; padded-vocab logits excluded, they
#: are -1e9 on both sides): matmul summation order and the rsqrt, exp,
#: tanh, pow and sin/cos ULPs of two libraries. Measured worst 5.3e-7 of
#: max|reference| over the model and engine comparisons of
#: ``tests/test_torch_models.py`` and ``tests/test_torch_serve.py``
LM_ATOL_FRAC = ATOL_FRAC
#: the same in bfloat16: each bfloat16 rounding of an activation can land
#: on a neighbouring value (one ulp, 2**-8 to 2**-7 of it) where the two
#: libraries' float32 sums differ in their last bits, and a logit sums
#: d_model such products, so the logits differ by about one ulp of their
#: largest magnitude: measured worst 8.1e-3 of max|reference| (a decode
#: cache's v in ``test_forward_prefill_and_decode_match``), against one
#: ulp's 2**-7 = 7.8e-3
LM_BF16_ATOL_FRAC = 2.0 ** -6


def lm_bf16_atol_frac(num_layers: int) -> float:
    """``LM_BF16_ATOL_FRAC`` for a model of ``num_layers`` layers. The smoke
    configs that set it have 2; the roundings of one layer are independent
    of another's, so their effects on the logits add in quadrature:
    sqrt(num_layers / 2) times as much. ``tests/test_torch_models.py``
    holds a 26-layer model's cache path to its own forward with it
    (measured 8.6e-3 of max|logit| against 5.6e-2)."""
    return LM_BF16_ATOL_FRAC * math.sqrt(max(num_layers, 2) / 2)


def lm_atol_frac(num_layers: int) -> float:
    """``LM_ATOL_FRAC`` for a float32 model of ``num_layers`` layers, by
    ``lm_bf16_atol_frac``'s rule: the smoke configs that set it have 2
    layers, and independent roundings of the layers add in quadrature.
    ``chip_smoke.py`` holds mamba2-780m's float32 cache path (48 layers) to
    its forward with it: measured 1.8e-5 and 9.1e-6 of max|logit| on the
    H100 against 4.9e-5. (In bfloat16 that model's cache path departs from
    its forward by 3.9-10.1 % of max|logit| there, above
    ``lm_bf16_atol_frac(48)``'s 7.7 %: the departure grows about linearly
    with depth, not as its square root, and the reference's own cache path
    breaks the rule alike, 9.5 % against 6.6 % at 36 layers of full width
    on the CPU; ``tests/torch_ssm_drift.py`` measures both packages.)"""
    return LM_ATOL_FRAC * math.sqrt(max(num_layers, 2) / 2)


def moe_flips(port_ids, ref_ids, port_probs, ref_probs) -> np.ndarray:
    """The tokens whose top-k expert set differs between the packages,
    (T,) bool, each allowed only at a near-tie. A bfloat16 model's router
    reads activations that differ by bfloat16 roundings
    (``LM_BF16_ATOL_FRAC``), so its float32 probabilities differ too, and
    where the reference's k-th and (k+1)-th probabilities lie closer than
    that difference the choice may flip: a discontinuity of the function,
    not a tolerance. Asserts that every flipped token's reference margin is
    at most twice its largest probability difference (either side may
    move), and returns the flips for the caller, which compares outputs
    only where no flip reaches them."""
    port_ids, ref_ids = np.asarray(port_ids), np.asarray(ref_ids)
    port_probs = np.asarray(port_probs, np.float32)
    ref_probs = np.asarray(ref_probs, np.float32)
    k = ref_ids.shape[-1]
    flipped = np.any(np.sort(port_ids, -1) != np.sort(ref_ids, -1), axis=-1)
    ranked = -np.sort(-ref_probs, axis=-1)
    margin = ranked[:, k - 1] - ranked[:, k] if ranked.shape[-1] > k \
        else np.full(len(ranked), np.inf, np.float32)
    moved = np.max(np.abs(port_probs - ref_probs), axis=-1)
    bad = flipped & (margin > 2.0 * moved)
    assert not bad.any(), ("top-k flips away from a near-tie",
                           np.nonzero(bad)[0], margin[bad], moved[bad])
    return flipped
