"""The port's calibration path (``repro_torch.core.fit``) against
``repro.core.fit``, on the CPU at smoke size.

FitParam/FitSpec transforms and ``fit_config`` against the reference's;
the consumers of every fittable field pass a gradient when the field is a
tensor; the relaxed fluctuation draw is the counter draw bit for bit; the
STE digitiser; the self-calibration contract on the port's own targets;
the port's loss and gradient on the reference's targets (carried across by
``interop.fit_targets_from_numpy``) against the reference's
``jax.value_and_grad``, the deconvolved-charge term and the two end-to-end
gradcheck losses among them, within ``parity.fit_loss_atol`` and
``parity.fit_grad_atol``; the optimisers; the launcher.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import get_config as jax_get_config
from repro.core import fit as jfit
from repro.core.deconvolve import make_deconv_filter
from repro.core.response import make_plane_responses
from repro.core.stages import build_sim_graph as j_build_sim_graph
from repro_torch import interop
from repro_torch.config import get_config
from repro_torch.core import fit, prng
from repro_torch.core import fluctuate as tfl
from repro_torch.core.depo import generate_depos
from repro_torch.core.fft_conv import digitize
from repro_torch.core.stages import build_sim_graph
from repro_torch.launch import fit as launcher
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


CFG = get_config("lartpc-uboone", smoke=True)
JCFG = jax_get_config("lartpc-uboone", smoke=True)
#: the launcher's smoke truth: lifetime on, so every field has a gradient
TRUTH = launcher.smoke_config()


def _port_cfg(jcfg):
    return interop.config_from_dict(dataclasses.asdict(jcfg))


def _grad(f, value: float) -> float:
    """d f / d x at x = ``value`` for a 0-d float32 tensor x."""
    x = torch.tensor(value, dtype=torch.float32, requires_grad=True)
    (g,) = torch.autograd.grad(f(x), x)
    return float(g)


# ---------------------------------------------------------------------------
# FitParam, FitSpec, fit_config
# ---------------------------------------------------------------------------

PARAMS = [("identity", dict(field="recombination"), 0.75),
          ("log", dict(field="electron_lifetime_us", lo=5.0), 60.0),
          ("sigmoid", dict(field="noise_rms_adc", lo=0.2, hi=5.0), 1.2)]


@pytest.mark.parametrize("kw,value", [p[1:] for p in PARAMS],
                         ids=[p[0] for p in PARAMS])
def test_transform_values_match_reference(kw, value):
    port, ref = fit.FitParam(**kw), jfit.FitParam(**kw)
    assert port.resolved_transform == ref.resolved_transform
    assert port.to_theta(value) == ref.to_theta(value)
    thetas = np.random.default_rng(0).normal(0.0, 3.0, 64).astype(np.float32)
    thetas = np.concatenate([thetas, [-50.0, 0.0, 50.0,
                                      np.float32(port.to_theta(value))]])
    got = np.array([float(port.to_value(torch.tensor(t))) for t in thetas])
    want = np.array([float(ref.to_value(jnp.float32(t))) for t in thetas])
    parity.assert_close(got, want, what=f"{kw}")
    assert got[-1] == pytest.approx(value, rel=1e-5)
    if port.lo is not None:
        assert got.min() >= port.lo
    if port.hi is not None:
        assert got.max() <= port.hi


def test_param_validation():
    with pytest.raises(ValueError, match="not a fittable"):
        fit.FitParam("num_wires")
    with pytest.raises(ValueError, match="needs"):
        fit.FitParam("recombination", transform="sigmoid")
    with pytest.raises(ValueError, match="needs"):
        fit.FitParam("recombination", lo=1.0, hi=0.5, transform="sigmoid")
    with pytest.raises(ValueError, match="unknown transform"):
        fit.FitParam("recombination", transform="tanh")
    with pytest.raises(ValueError, match="at least one"):
        fit.FitSpec(params=())
    with pytest.raises(ValueError, match="duplicate"):
        fit.FitSpec(params=(fit.FitParam("recombination"),
                            fit.FitParam("recombination")))
    assert fit.FITTABLE_FIELDS == jfit.FITTABLE_FIELDS


def test_spec_thetas_and_apply():
    spec = fit.FitSpec(params=(fit.FitParam("recombination", init=0.5),
                               fit.FitParam("noise_rms_adc")))
    vals = spec.values(spec.init_theta(CFG, device="cpu"))
    assert vals == pytest.approx({"recombination": 0.5,
                                  "noise_rms_adc": CFG.noise_rms_adc})
    true = spec.values(spec.true_theta(CFG, device="cpu"))
    assert true["recombination"] == pytest.approx(CFG.recombination)
    theta = torch.tensor([0.6, 2.5], requires_grad=True)
    cfg = spec.apply(CFG, theta)
    assert isinstance(cfg.recombination, torch.Tensor)
    assert cfg.recombination.grad_fn is not None
    assert float(cfg.noise_rms_adc) == pytest.approx(2.5)
    assert cfg.num_wires == CFG.num_wires


@pytest.mark.parametrize("names", [["noise_rms_adc"],
                                   list(fit.FITTABLE_FIELDS)])
def test_spec_from_names_matches_reference(names):
    port = fit.spec_from_names(names, CFG)
    ref = jfit.spec_from_names(names, JCFG)
    assert ([dataclasses.asdict(p) for p in port.params]
            == [dataclasses.asdict(p) for p in ref.params])


FIT_CONFIGS = {
    "default": {},
    "auto+pallas": dict(charge_grid_strategy="auto", scatter_strategy="pallas"),
    "fused": dict(charge_grid_strategy="fused_pallas_compact",
                  fft_strategy="auto", deconv_strategy="fft_reuse"),
    "bf16+sort": dict(charge_grid_strategy="unfused_bf16",
                      scatter_strategy="sort_segment"),
    "three planes": dict(num_planes=3,
                         charge_grid_strategy="fused_pallas_multiplane"),
    "no fluctuation": dict(fluctuate=False),
    "rng none": dict(rng_strategy="none"),
}


@pytest.mark.parametrize("over", FIT_CONFIGS.values(), ids=FIT_CONFIGS)
def test_fit_config_matches_reference(over):
    jcfg = dataclasses.replace(JCFG, **over)
    fcfg = fit.fit_config(_port_cfg(jcfg))
    assert dataclasses.asdict(fcfg) == dataclasses.asdict(
        jfit.fit_config(jcfg))
    fit.assert_differentiable_config(fcfg)


def test_fit_config_refusals():
    with pytest.raises(ValueError, match="pool"):
        fit.fit_config(dataclasses.replace(CFG, rng_strategy="pool"))
    with pytest.raises(ValueError, match="not differentiable"):
        fit.assert_differentiable_config(CFG)
    with pytest.raises(ValueError, match="scatter_strategy='pallas'"):
        fit.assert_differentiable_config(dataclasses.replace(
            fit.fit_config(CFG), scatter_strategy="pallas"))


# ---------------------------------------------------------------------------
# Tensor fields reach their consumers
# ---------------------------------------------------------------------------


def test_scalar_keeps_a_tensor_and_its_history():
    from repro_torch.device import scalar

    like = torch.zeros(3)
    x = torch.tensor(2.0, dtype=torch.float64, requires_grad=True)
    s = scalar(x, like)
    assert s.dtype == torch.float32 and s.shape == () and s.grad_fn
    assert torch.equal(scalar(2.0, like), torch.tensor(2.0))


def _physical():
    from repro_torch.core.depo import generate_physical_depos

    return generate_physical_depos(prng.key(3), TRUTH, device="cpu")


@pytest.mark.parametrize("field", ["electron_lifetime_us", "recombination",
                                   "diffusion_scale"])
def test_drift_fields_have_gradients(field):
    from repro_torch.core.drift import transport

    pdepos = _physical()
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=pdepos.n).astype(np.float32))

    def f(x):
        d = transport(pdepos, dataclasses.replace(TRUTH, **{field: x}))
        return torch.sum((d.charge + d.sigma_w + d.sigma_t) * w)

    value = getattr(TRUTH, field)
    assert f(torch.tensor(value)) == f(value)   # same forward bits
    g = _grad(f, value)
    assert np.isfinite(g) and g != 0.0


def test_disabled_lifetime_is_nan_free():
    """A tensor lifetime <= 0 disables the attenuation, as 0.0 does, and
    its gradient is finite (0)."""
    from repro_torch.core.drift import transport

    pdepos = _physical()

    def f(x):
        return transport(pdepos, dataclasses.replace(
            TRUTH, electron_lifetime_us=x)).charge.sum()

    assert f(torch.tensor(0.0)) == f(0.0)
    assert _grad(f, 0.0) == 0.0 and _grad(f, -5.0) == 0.0


@pytest.mark.parametrize("field,value", [("response_gain", 1.0),
                                         ("response_gain", 1.3),
                                         ("response_shaping_us", 2.0)])
def test_response_fields_have_gradients(field, value):
    """The gain is tested at exactly 1.0: a tensor gain is always applied."""
    from repro_torch.core.response import make_response

    w = torch.from_numpy(np.random.default_rng(2).normal(
        size=(CFG.response_wires, CFG.response_ticks)).astype(np.float32))

    def f(x):
        resp = make_response(dataclasses.replace(CFG, **{field: x}),
                             device="cpu")
        return torch.sum(resp.kernel * w) + resp.freq.abs().sum()

    assert f(torch.tensor(value)) == f(value)
    g = _grad(f, value)
    assert np.isfinite(g) and g != 0.0


def test_noise_rms_has_a_gradient():
    from repro_torch.core.noise import simulate_noise

    def f(x):
        return simulate_noise(prng.key(4), dataclasses.replace(
            CFG, noise_rms_adc=x), device="cpu").square().mean()

    assert f(torch.tensor(CFG.noise_rms_adc)) == f(CFG.noise_rms_adc)
    assert _grad(f, CFG.noise_rms_adc) == pytest.approx(
        2 * float(f(CFG.noise_rms_adc)) / CFG.noise_rms_adc, rel=1e-4)


@pytest.mark.parametrize("field", ["adc_per_electron", "adc_baseline"])
def test_measured_signal_fields_have_gradients(field):
    from repro_torch.core.deconvolve import measured_signal

    adc = torch.arange(880, 1200, dtype=torch.int16)

    def f(x):
        return measured_signal(adc, dataclasses.replace(
            CFG, **{field: x})).sum()

    value = getattr(CFG, field)
    assert f(torch.tensor(value)) == f(value)
    g = _grad(f, value)
    assert np.isfinite(g) and g != 0.0


def test_noise_stage_denominator_has_a_gradient():
    """The noise stage divides the noise by a tensor gain with a
    gradient; with a float gain it is the same bits."""
    from repro_torch.core.stages import noise_stage

    sig = torch.zeros((CFG.num_wires, CFG.num_ticks))
    kf, kn = prng.split(prng.key(5))
    state = build_sim_graph(CFG, device="cpu").init_state(
        prng.key(5), generate_depos(prng.key(5), CFG, device="cpu"))
    state = state._replace(signal=sig)

    def f(x):
        return noise_stage(dataclasses.replace(
            CFG, adc_per_electron=x)).fn(state).signal.abs().sum()

    assert f(torch.tensor(CFG.adc_per_electron)) == f(CFG.adc_per_electron)
    g = _grad(f, CFG.adc_per_electron)
    assert np.isfinite(g) and g < 0.0


# ---------------------------------------------------------------------------
# Relaxed fluctuation and the STE digitiser
# ---------------------------------------------------------------------------


def _patches(dtype):
    rng = np.random.default_rng(6)
    charge = (np.abs(rng.normal(size=64)) * 5000.0).astype(np.float32)
    charge[:4] = 0.0                       # zero-charge (padding) depos
    patches = (np.abs(rng.normal(size=(64, 20, 20))) * charge[:, None, None]
               / 50.0).astype(np.float32)
    patches[5] = charge[5]                 # p = 1: saturated, variance 0
    return (torch.from_numpy(patches).to(dtype), torch.from_numpy(charge))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_relaxed_is_counter_bit_for_bit(dtype):
    patches, charge = _patches(dtype)
    k = prng.key(7)
    a = tfl.fluctuate_counter(k, patches, charge)
    b = tfl.fluctuate_counter_relaxed(k, patches, charge)
    assert a.dtype == b.dtype == torch.float32
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_relaxed_gradient_is_finite_at_zero_variance(dtype):
    patches, charge = _patches(dtype)
    k = prng.key(8)

    def grads(fn):
        scale = torch.tensor(1.0, requires_grad=True)
        out = fn(k, (patches.float() * scale).to(dtype), charge * scale)
        (g,) = torch.autograd.grad(out.sum(), scale)
        return g

    assert torch.isfinite(grads(tfl.fluctuate_counter_relaxed))
    assert not torch.isfinite(grads(tfl.fluctuate_counter))


def test_relaxed_bf16_gradient_is_the_fma_derivative():
    """The bfloat16 draw's fused multiply-add passes d(a*b + c)."""
    a = torch.tensor([0.3, 2.0, 7.5], requires_grad=True)
    b = torch.tensor([1.5, -0.25, 0.125])
    c = torch.tensor([1.0, 2.0, 3.0], dtype=torch.bfloat16,
                     requires_grad=True)
    out = tfl._FusedMulAdd.apply(a, b, c)
    assert torch.equal(out, tfl.fma_f32(a.detach(), b, c.detach()))
    ga, gc = torch.autograd.grad((out * torch.arange(1.0, 4.0)).sum(),
                                 (a, c))
    assert torch.equal(ga, b * torch.arange(1.0, 4.0))
    assert gc.dtype == torch.bfloat16
    assert torch.equal(gc.float(), torch.arange(1.0, 4.0))


def test_relaxed_dispatch_fluctuates():
    """``rng_strategy="relaxed"`` fluctuates in both unfused strategies (the
    grid equals counter's bit for bit, not the unfluctuated one)."""
    from repro_torch.core.stages import compute_charge_grid

    depos = generate_depos(prng.key(9), CFG, device="cpu")
    k = prng.key(10)
    for strategy in ("unfused", "unfused_bf16"):
        grids = {rng: compute_charge_grid(k, depos, dataclasses.replace(
            CFG, rng_strategy=rng, charge_grid_strategy=strategy))[0]
                 for rng in ("counter", "relaxed", "none")}
        assert torch.equal(grids["relaxed"], grids["counter"]), strategy
        assert not torch.equal(grids["relaxed"], grids["none"]), strategy


def test_fused_strategies_refuse_relaxed():
    from repro_torch.core.pipeline import charge_grid_fused

    depos = generate_depos(prng.key(9), CFG, device="cpu")
    with pytest.raises(ValueError, match="relaxed"):
        charge_grid_fused(prng.key(1), depos, dataclasses.replace(
            CFG, rng_strategy="relaxed"))


def test_ste_forward_and_passthrough():
    sig = torch.from_numpy(np.random.default_rng(11).uniform(
        -2e5, 6e5, (64, 64)).astype(np.float32))
    hard = digitize(sig, CFG)
    soft = digitize(sig, dataclasses.replace(CFG, digitize_ste=True))
    assert hard.dtype == torch.int16 and soft.dtype == torch.float32
    assert torch.equal(hard.float(), soft)
    x = torch.tensor([-2e5, 1e4, 5e5], requires_grad=True)
    (g,) = torch.autograd.grad(digitize(x, dataclasses.replace(
        CFG, digitize_ste=True)).sum(), x)
    np.testing.assert_allclose(g.numpy(), [0.0, CFG.adc_per_electron, 0.0],
                               atol=1e-9)


# ---------------------------------------------------------------------------
# Self-calibration on the port's own targets
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def targets():
    return fit.make_fit_targets(TRUTH, prng.key(11), num_events=2,
                                device="cpu")


def test_fit_graph_forward_equals_default_quantized():
    depos = generate_depos(prng.key(7), CFG, device="cpu")
    hard = build_sim_graph(CFG, device="cpu").run(prng.key(7), depos).adc
    soft = build_sim_graph(fit.fit_config(CFG), device="cpu").run(
        prng.key(7), depos).adc
    assert soft.dtype == torch.float32
    assert torch.equal(hard.float(), soft)


@pytest.mark.parametrize("spec", [
    fit.FitSpec(params=(fit.FitParam("electron_lifetime_us", lo=5.0,
                                     hi=500.0),
                        fit.FitParam("recombination", lo=0.2, hi=1.0))),
    fit.FitSpec(params=tuple(fit.FitParam(f) for f in fit.FITTABLE_FIELDS)),
], ids=["sigmoid two", "identity all"])
def test_fit_loss_exactly_zero_at_truth(targets, spec):
    loss = fit.make_fit_loss(TRUTH, spec, targets, device="cpu")
    assert float(loss(spec.true_theta(TRUTH, device="cpu"))) == 0.0
    off = dataclasses.replace(TRUTH, electron_lifetime_us=90.0,
                              recombination=0.6)
    assert float(loss(spec.true_theta(off, device="cpu"))) > 0.0


def test_decon_weight_requires_recon_targets(targets):
    spec = fit.FitSpec(params=(fit.FitParam("recombination"),))
    with pytest.raises(ValueError, match="recon=True"):
        fit.make_fit_loss(TRUTH, spec, targets, decon_weight=0.1,
                          device="cpu")


def test_short_fit_moves_toward_truth():
    truth = TRUTH.noise_rms_adc
    spec = fit.FitSpec(params=(fit.FitParam("noise_rms_adc", init=2 * truth,
                                            lo=truth / 4, hi=truth * 4),))
    tg = fit.make_fit_targets(TRUTH, prng.key(31), num_events=1,
                              device="cpu")
    loss = fit.make_fit_loss(TRUTH, spec, tg, device="cpu")
    l_init = float(loss(spec.init_theta(TRUTH, device="cpu")))
    res = fit.calibrate(TRUTH, spec, tg, steps=60, lr=0.3, device="cpu")
    assert res.loss < 0.5 * l_init
    assert res.relative_errors({"noise_rms_adc": truth})[
        "noise_rms_adc"] < 0.25


# ---------------------------------------------------------------------------
# The port's loss and gradient on the reference's targets
# ---------------------------------------------------------------------------

#: the parity configuration: lifetime on, so every field has a gradient
_PARITY_TRUTH = dict(electrons_per_depo=150_000.0, electron_lifetime_us=60.0,
                     recombination=0.75)


def _all_fields(decon_weight=0.0, **over):
    """All eight fields at 1.1x a truth, two events of seed 12."""
    jcfg = dataclasses.replace(JCFG, **_PARITY_TRUTH, **over)
    jspec = jfit.spec_from_names(list(jfit.FITTABLE_FIELDS), jcfg)
    off = dataclasses.replace(jcfg, **{n: getattr(jcfg, n) * 1.1
                                       for n in jfit.FITTABLE_FIELDS})
    return (jcfg, jspec, np.asarray(jspec.true_theta(off)),
            jax.random.key(12), 2, decon_weight)


def _gradcheck_e2e(i, fields, mult, scale=1.0, decon_weight=0.0):
    """The loss of the reference's end-to-end gradcheck case ``i`` (its
    config, key, one event and decon weight), in theta coordinates at its
    ``mult`` x truth."""
    jcfg = jfit.fit_config(JCFG)
    jcfg = dataclasses.replace(
        jcfg, electrons_per_depo=scale * jcfg.electrons_per_depo)
    jspec = jfit.FitSpec(params=tuple(jfit.FitParam(f) for f in fields))
    theta = np.asarray(mult, np.float32) * np.asarray(
        [getattr(jcfg, f) for f in fields], np.float32)
    return (jcfg, jspec, theta, jax.random.fold_in(jax.random.key(0), i), 1,
            decon_weight)


PARITY = {
    "one plane": lambda: _all_fields(),
    "three planes": lambda: _all_fields(num_planes=3),
    "unfused_bf16": lambda: _all_fields(charge_grid_strategy="unfused_bf16"),
    "decon term": lambda: _all_fields(decon_weight=1e-4),
    "gradcheck e2e": lambda: _gradcheck_e2e(
        5, ("recombination", "adc_per_electron"), [0.9, 1.1], scale=30.0),
    "gradcheck e2e+decon": lambda: _gradcheck_e2e(
        6, ("response_gain",), [1.15], decon_weight=1e-4),
}


def _moments(out, target, jac):
    """mean(r^2) of the residual r = out - target, and per theta entry
    mean(J^2) and mean(|2 r J|) of the Jacobian J (theta last)."""
    r = out - target
    axes = tuple(range(r.ndim))
    return (float(jnp.mean(r ** 2)), np.asarray(jnp.mean(jac ** 2, axis=axes)),
            np.asarray(jnp.mean(jnp.abs(2 * r[..., None] * jac), axis=axes)))


def _reference(jcfg, spec, theta, key, num_events, decon_weight):
    """The reference's targets, its ``value_and_grad`` of the fit loss at
    ``theta``, and the loss's and each gradient entry's tolerance
    (``parity.fit_loss_atol`` and ``fit_grad_atol`` summed over the loss's
    terms), from its residuals and forward-mode Jacobians. The deconvolved
    charge is the filter G applied to adc / gain between a zero pad and a
    crop: its map's norm is max|G / gain| and that of its derivative
    max|d(G / gain) / d theta|, over the frequencies."""
    recon = decon_weight > 0.0
    targets = jfit.make_fit_targets(jcfg, key, num_events=num_events,
                                    recon=recon)
    loss = jfit.make_fit_loss(jcfg, spec, targets, decon_weight=decon_weight)
    fcfg = jfit.fit_config(jcfg)
    depos = targets.batch.physical_set()

    def outs(th):
        graph = j_build_sim_graph(spec.apply(fcfg, th), None, recon=recon)
        if recon:
            graph = jfit._drop_stage(graph, "hit_find")
        out = jax.vmap(graph.run)(targets.keys, depos)
        return (out.adc, out.decon) if recon else (out.adc,)

    (val, grad), out, jac = jax.jit(lambda th: (
        jax.value_and_grad(loss)(th), outs(th), jax.jacfwd(outs)(th)))(theta)
    res_ms, jac_ms, terms = _moments(out[0], targets.adc.astype(jnp.float32),
                                     jac[0])
    loss_atol = parity.fit_loss_atol(res_ms)
    grad_atol = np.array([parity.fit_grad_atol(m, res_ms, t)
                          for m, t in zip(jac_ms, terms)])
    if recon:
        def filt(th):
            tcfg = spec.apply(fcfg, th)
            (resp,) = make_plane_responses(tcfg)
            return (make_deconv_filter(resp, tcfg).freq
                    / jnp.maximum(tcfg.adc_per_electron, 1e-30))

        norm = float(jnp.max(jnp.abs(filt(theta))))
        dnorm = np.asarray(jnp.max(jnp.abs(jax.jacfwd(filt)(theta)),
                                   axis=(0, 1)))
        res_ms, jac_ms, terms = _moments(out[1], targets.decon, jac[1])
        loss_atol += parity.fit_loss_atol(res_ms, decon_weight, norm)
        grad_atol += np.array([
            parity.fit_grad_atol(m, res_ms, t, decon_weight, norm, d)
            for m, t, d in zip(jac_ms, terms, dnorm)])
    return targets, float(val), np.asarray(grad), loss_atol, grad_atol


@pytest.mark.parametrize("case", PARITY.values(), ids=PARITY)
def test_loss_and_gradient_match_reference(case):
    """The port's loss and gradient on the reference's own targets (so only
    the fit graph's ADC may flip) against ``jax.value_and_grad``: the
    all-field cases, the deconvolved-charge term, and the losses of the two
    end-to-end gradcheck cases."""
    jcfg, jspec, theta, key, num_events, decon_weight = case()
    jt, val, grad, loss_atol, grad_atol = _reference(
        jcfg, jspec, jnp.asarray(theta), key, num_events, decon_weight)
    b = jt.batch
    # targets of a fit config come out of the STE digitiser as float32
    adc = np.asarray(jt.adc)
    assert np.array_equal(adc.astype(np.int16), adc)
    targets = interop.fit_targets_from_numpy(
        *(np.asarray(x) for x in (b.x, b.y, b.z, b.t, b.q, b.n_depos)),
        np.asarray(jax.random.key_data(jt.keys)), adc.astype(np.int16),
        decon=None if jt.decon is None else np.asarray(jt.decon),
        device="cpu")
    cfg = _port_cfg(jcfg)
    spec = fit.FitSpec(params=tuple(fit.FitParam(**dataclasses.asdict(p))
                                    for p in jspec.params))
    got_val, got_grad = fit.value_and_grad(
        fit.make_fit_loss(cfg, spec, targets, decon_weight=decon_weight,
                          device="cpu"),
        torch.from_numpy(theta.copy()))
    assert abs(float(got_val) - val) <= loss_atol, (float(got_val), val,
                                                   loss_atol)
    err = np.abs(got_grad.numpy() - grad)
    names = [p.field for p in jspec.params]
    assert np.all(err <= grad_atol), dict(zip(names, zip(err, grad_atol,
                                                         grad)))
    assert np.all(grad != 0.0)


# ---------------------------------------------------------------------------
# Optimisers
# ---------------------------------------------------------------------------

_QSPEC = fit.FitSpec(params=(fit.FitParam("recombination"),
                             fit.FitParam("adc_baseline")))
_QTARGET = np.array([0.7, -1.3], np.float32)


def _quadratic(theta):
    return torch.sum((theta - torch.from_numpy(_QTARGET)) ** 2)


def test_adam_iterates_match_reference():
    seen, ref_seen = [], []
    res = fit.run_fit(_quadratic, _QSPEC, torch.zeros(2), steps=300, lr=0.05,
                      log_every=1, callback=lambda s, l, v: seen.append(
                          [v["recombination"], v["adc_baseline"]]))
    jspec = jfit.FitSpec(params=(jfit.FitParam("recombination"),
                                 jfit.FitParam("adc_baseline")))
    target = jnp.asarray(_QTARGET)
    ref = jfit.run_fit(lambda th: jnp.sum((th - target) ** 2), jspec,
                       jnp.zeros(2), steps=300, lr=0.05, log_every=1,
                       callback=lambda s, l, v: ref_seen.append(
                           [v["recombination"], v["adc_baseline"]]))
    parity.assert_close(np.array(seen), np.array(ref_seen), what="iterates")
    parity.assert_close([l for _, l in res.history],
                        [l for _, l in ref.history], what="losses")
    np.testing.assert_allclose(res.theta.numpy(), _QTARGET, atol=1e-3)
    assert res.loss < 1e-6 and res.steps == 300 and len(res.history) == 300


def test_bfgs_recovers_quadratic():
    res = fit.run_fit(_quadratic, _QSPEC, torch.zeros(2), steps=50,
                      optimizer="bfgs")
    np.testing.assert_allclose(res.theta.numpy(), _QTARGET, atol=1e-4)
    assert res.steps <= 50 and len(res.history) == 2


def test_run_fit_driver_details():
    with pytest.raises(ValueError, match="unknown optimizer"):
        fit.run_fit(_quadratic, _QSPEC, torch.zeros(2), optimizer="sgd")
    seen = []
    res = fit.run_fit(_quadratic, _QSPEC, torch.zeros(2), steps=10,
                      log_every=4,
                      callback=lambda s, l, v: seen.append((s, sorted(v))))
    assert [s for s, _ in seen] == [4, 8, 10]
    assert seen[0][1] == ["adc_baseline", "recombination"]
    errs = res.relative_errors({"recombination": 1.0})
    assert set(errs) == {"recombination"} and errs["recombination"] >= 0.0


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [["--optimizer", "bfgs", "--steps", "50"],
                                  ["--steps", "300"]], ids=["bfgs", "adam"])
def test_launcher_smoke_recovers(args, capsys):
    assert launcher.main(["--smoke", "--device", "cpu", "--log-every", "0"]
                         + args) == 0
    assert "-> PASS" in capsys.readouterr().out


def test_launcher_grad_smoke_is_for_the_distributed_slice(monkeypatch):
    """--grad-smoke runs on the distributed slice's ranks, one card a rank
    on the card: without the cards it raises, naming both counts, and never
    falls back to gloo on the CPU (tests/test_torch_distributed.py runs it
    on gloo ranks)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="2 CUDA devices, but 0"):
        launcher.main(["--grad-smoke", "--devices", "2", "--device",
                       "cuda"])
