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


def moe_kept_pairs(ids, limit, num_experts: int, first_token: int = 0):
    """The (token, expert) pairs an MoE call keeps: each expert's first
    ``limit`` pairs (an int, or (E,) a limit an expert) in the stable order
    by expert, token-major, as the reference's sort-based dispatch keeps
    them; tokens numbered from ``first_token``. A set, for comparing the
    pairs of a whole batch with those of its row blocks."""
    ids = np.asarray(ids)
    limit = np.broadcast_to(np.asarray(limit), (num_experts,))
    flat = ids.reshape(-1)
    seen = np.zeros(num_experts, np.int64)
    out = set()
    for p in np.argsort(flat, kind="stable"):
        e = int(flat[p])
        if seen[e] < limit[e]:
            out.add((first_token + int(p) // ids.shape[1], e))
        seen[e] += 1
    return out


#: LM gradients in float32 (the loss's gradient with respect to every
#: parameter leaf, and the flash backward's dq, dk, dv), as a fraction of
#: the leaf's max|reference gradient|: the forward's float error
#: (``LM_ATOL_FRAC``) carried through the backward's products. Measured
#: worst 2.1e-6 (recurrentgemma-2b smoke, ``groups.g1_mix.lam``) over the
#: family smoke configs of ``tests/test_torch_train_grads.py`` and
#: ``tests/test_torch_train_families.py``, 5.2e-7 in
#: ``tests/test_torch_train_flash.py``. The float32 loss is held to it as a
#: relative tolerance (measured worst 1.8e-7)
LM_GRAD_ATOL_FRAC = 1e-5
#: the same in bfloat16: the backward's bfloat16 cotangents round again
#: where the forward's activations did (``LM_BF16_ATOL_FRAC``, one ulp of
#: the logits), and a small leaf whose gradient cancels (the RG-LRU's
#: ``lam`` and ``w_a``, Mamba-2's ``d_skip``) carries that as a fraction of
#: its own largest component: 2**-4, eight ulps of 2**-7, at 2 layers.
#: Measured worst over the same files 3.1e-2 at 5 layers
#: (recurrentgemma-2b smoke, ``tail_group.g1_mix.w_a``, against 9.9e-2)
#: and 1.4e-2 at 2 (mamba2-780m smoke, ``layers.mix.d_skip``); 5.7e-2 at
#: recurrentgemma's ``groups.g0_mix.lam`` on the reference's own draw of
#: the same seed (its normals differ from the port's by ULPs)
LM_BF16_GRAD_ATOL_FRAC = 2.0 ** -4


def lm_bf16_grad_atol_frac(num_layers: int) -> float:
    """``LM_BF16_GRAD_ATOL_FRAC`` for a model of ``num_layers`` layers, by
    ``lm_bf16_atol_frac``'s rule (2 layers set it; independent layers add
    in quadrature)."""
    return LM_BF16_GRAD_ATOL_FRAC * math.sqrt(max(num_layers, 2) / 2)


#: a sharded train step in bfloat16 whose products split over ``model``
#: against the reference's sharded bfloat16 step (2 steps, AdamW eps 1):
#: the losses and grad norm as a relative tolerance, each parameter as a
#: fraction of its leaf's max. Each is the port's one-device bfloat16 gap
#: to the reference's single-device step plus the reference's own gap
#: between its sharded and single-device steps, measured worst over
#: ``tests/test_torch_serve_mesh.py``'s bfloat16 runs (the sharded-step
#: config and gemma2-2b smoke on (4, 2) and (2, 4)), rounded up to a power
#: of two: losses 5.81e-4 + 1.81e-4, parameters 6.16e-3 + 9.36e-3. The
#: MoE family's split (experts, shared columns: deepseek-moe-16b smoke on
#: (4, 2), ``tests/test_torch_moe_split.py``, every run on one recorded
#: routing, since a top-k choice flips at a near-tie) reads each gap
#: within these: the reference's sharded-vs-single 2.82e-4 / 8.80e-3, the
#: port's one device 3.83e-4 / 1.16e-2, the port's split against the
#: reference's sharded step 2.42e-4 / 1.45e-2. The SSD heads' split
#: (mamba2-780m smoke on (2, 4), ``tests/test_torch_recurrent_split.py``)
#: reads its split against the reference's sharded step 3.15e-4 / 1.42e-2
#: and the reference's sharded-vs-single 2.06e-4 / 8.59e-3; its one-device
#: gap, 1.76e-4 / 2.32e-2 (``a_log``, zero at the draw, whose gradient
#: cancels), is held to the one-device rule (``lm_bf16_grad_atol_frac``)
LM_BF16_SPLIT_RTOL = 2.0 ** -10
LM_BF16_SPLIT_ATOL_FRAC = 2.0 ** -6

#: the serving steps in bfloat16 whose products split over ``model``
#: against the reference's sharded bfloat16 serving steps: the logits and
#: each float cache leaf as a fraction of their max. The reference's own
#: gap between its sharded and single-device steps plus the port's
#: one-device gap to the single-device steps, measured worst over
#: ``tests/test_torch_serve_mesh.py``'s bfloat16 cases (the sharded-step
#: config and gemma2-2b smoke on (4, 2) and (2, 4), seeded decode tokens),
#: rounded up to a power of two: 1.045e-2 + 9.766e-3 (both the
#: sharded-step config's, on (2, 4) and on either mesh). The MLA and MoE
#: split (deepseek-v2-236b smoke on (4, 2), an append prefill and 6
#: decode steps on one recorded routing, ``tests/test_torch_moe_split.py``)
#: reads 1.277e-2 + 1.277e-2, and its split against the reference's
#: sharded steps 1.489e-2: within it
LM_BF16_SERVE_SPLIT_ATOL_FRAC = 2.0 ** -5


#: the dry run's FLOPs at one device (``launch.op_cost``, FlopCounterMode's
#: count of the eager step) against the reference's trip-count-aware count
#: of its compiled step (``hlo_cost.analyze``), as a fraction of the
#: reference's: both count 2 M N K a matrix product. Measured over the
#: family smoke steps of ``tests/test_torch_dryrun.py`` (train, prefill,
#: decode): prefill and decode 1.0000 but the SSM's prefill; train
#: 1.0015-1.0072 where the port's flash backward recomputes the scores its
#: remat segment already recomputed (XLA merges the two). Larger gaps are
#: differences found and recorded (ROADMAP queue 3), each held there to its
#: exact count: the SSM's C.B product (0.9786, 0.9818) and the enc-dec
#: decoder's remat policy (1.0918)
DRYRUN_FLOPS_RTOL = 0.01
