"""The port's gradient verification (``repro_torch.core.gradcheck``) against
``repro.core.gradcheck``, on the CPU at smoke size.

All seven stage cases pass their finite-difference check, with the
reference's steps and tolerances. The five stage cases' analytic gradients
agree with the reference's on the same keys (the inputs are the port's own
generators' draws from those keys) within ``parity.GRAD_RTOL``; the losses
of the two end-to-end cases, whose ADCs may flip by a count, are held to
the reference's ``jax.value_and_grad`` on its own targets in
``test_torch_fit.py::test_loss_and_gradient_match_reference``. The checker
itself catches a wrong and a NaN gradient.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

from repro_torch.config import get_config
from repro_torch.core import gradcheck as gc
from repro_torch.core import prng
from repro_torch.core.fit import (FitParam, FitSpec, fit_config,
                                  make_fit_loss, make_fit_targets)
from repro_torch.launch import fit as launcher
from repro_torch.testing import parity

torch.set_num_threads(1)
#: the reference module (``repro.core`` exports a function of its name)
jgc = importlib.import_module("repro.core.gradcheck")


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield


CFG = get_config("lartpc-uboone", smoke=True)
CASES = gc.stage_gradcheck_cases()
#: the stage cases: no digitiser, so no ADC in the function
STAGE = [i for i, c in enumerate(CASES) if not c.name.startswith("e2e/")]


@pytest.fixture(scope="module")
def results():
    """(port results, reference results), one per case, seed 0."""
    return (gc.stage_gradcheck_suite(device="cpu"),
            jgc.stage_gradcheck_suite())


def test_cases_are_the_reference_matrix():
    fields = ("name", "fields", "eps", "rtol", "atol")
    assert ([tuple(getattr(c, f) for f in fields) for c in CASES]
            == [tuple(getattr(c, f) for f in fields)
                for c in jgc.stage_gradcheck_cases()])


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[c.name for c in CASES])
def test_stage_gradient_matches_fd(results, i):
    res = results[0][i]
    assert res.ok, (f"{res.name}: analytic {res.analytic} vs numeric "
                    f"{res.numeric} (rel_err {res.max_rel_err:.3e})")
    assert str(res).startswith("[ok ]")


@pytest.mark.parametrize("i", STAGE, ids=[CASES[i].name for i in STAGE])
def test_analytic_gradient_matches_reference(results, i):
    """The port's autograd gradient against the reference's ``jax.grad``."""
    port, ref = results[0][i], results[1][i]
    assert ref.ok and port.fields == ref.fields
    parity.assert_close(port.analytic, ref.analytic, rtol=parity.GRAD_RTOL,
                        atol_frac=parity.GRAD_RTOL, what=CASES[i].name)


def test_bf16_matrix_matches_reference():
    """The matrix again with bfloat16 patches (the relaxed draw's fused
    multiply-add in the charge-grid and end-to-end cases): the same
    verdicts as the reference's, whose charge-grid case fails its finite
    difference too (the bfloat16 rounding of the patches is a staircase
    in diffusion_scale), and the stage cases' analytic gradients within
    ``parity.BF16_GRAD_RTOL`` of the reference's."""
    from repro.config import get_config as jax_get_config

    over = dict(charge_grid_strategy="unfused_bf16")
    port = gc.stage_gradcheck_suite(dataclasses.replace(CFG, **over),
                                    device="cpu")
    ref = jgc.stage_gradcheck_suite(dataclasses.replace(
        jax_get_config("lartpc-uboone", smoke=True), **over))
    assert [r.ok for r in port] == [r.ok for r in ref]
    assert [r.name for r in port if not r.ok] == [
        "charge_grid/diffusion_scale"]
    for i in STAGE:
        parity.assert_close(port[i].analytic, ref[i].analytic,
                            rtol=parity.BF16_GRAD_RTOL,
                            atol_frac=parity.GRAD_RTOL, what=CASES[i].name)


@pytest.mark.parametrize("plane", ["induction", "collection"])
def test_response_gradient_per_plane_kind(plane):
    """The convolve gradient for both field-response kinds, on the
    reference's grid and weights: autograd against central differences,
    and against ``jax.grad`` on the same inputs within ``parity.GRAD_RTOL``
    (the collection plane's small shaping component comes out of a
    cancellation and differs by 5e-4 of itself, 1.5e-5 of the gain's
    component, between the two FFT libraries). The collection plane's
    shaping gradient is ~40x smaller than the gain's, so the step is 3e-3:
    at 1e-3 the float32 roundoff over the step (ulp / h) dominates the
    difference quotient, in the reference's check as in this one (it moves
    from 6.7e-4 at 1e-3 to 8.1e-4 at 3e-3 and 1e-2, against an analytic
    8.3e-4)."""
    import jax
    import jax.numpy as jnp
    from repro.config import get_config as jax_get_config
    from repro.core.depo import generate_depos as j_generate_depos
    from repro.core.fft_conv import fft_convolve as j_fft_convolve
    from repro.core.fit import fit_config as j_fit_config
    from repro.core.response import make_response as j_make_response
    from repro.core.stages import compute_charge_grid as j_charge_grid
    from repro_torch.core.fft_conv import fft_convolve
    from repro_torch.core.response import make_response

    jcfg = j_fit_config(jax_get_config("lartpc-uboone", smoke=True))
    key = jax.random.key(3)
    jgrid = j_charge_grid(jax.random.fold_in(key, 2),
                          j_generate_depos(key, jcfg), jcfg)
    jw = jax.random.normal(jax.random.fold_in(key, 1), jgrid.shape)

    def jf(theta):
        tcfg = dataclasses.replace(jcfg, response_gain=theta[0],
                                   response_shaping_us=theta[1])
        return jnp.sum(j_fft_convolve(jgrid, j_make_response(
            tcfg, plane=plane), tcfg.fft_strategy) * jw) / jgrid.size

    want = np.asarray(jax.grad(jf)(jnp.asarray([1.3, 1.7])))
    cfg = fit_config(CFG)
    grid = torch.from_numpy(np.array(jgrid))
    w = torch.from_numpy(np.array(jw))

    def f(theta):
        tcfg = dataclasses.replace(cfg, response_gain=theta[0],
                                   response_shaping_us=theta[1])
        resp = make_response(tcfg, plane=plane, device="cpu")
        return torch.sum(fft_convolve(grid, resp, tcfg.fft_strategy) * w
                         ) / grid.numel()

    res = gc.gradcheck(f, torch.tensor([1.3, 1.7]), name=f"convolve/{plane}",
                       eps=3e-3, rtol=3e-2)
    assert res.ok, res
    parity.assert_close(res.analytic, want, rtol=parity.GRAD_RTOL,
                        atol_frac=parity.GRAD_RTOL, what=plane)


def test_fit_loss_gradcheck_without_recon_chain():
    cfg = dataclasses.replace(fit_config(CFG), electrons_per_depo=150_000.0)
    spec = FitSpec(params=(FitParam("recombination"),))
    targets = make_fit_targets(cfg, prng.key(5), num_events=1, device="cpu")
    loss = make_fit_loss(cfg, spec, targets, device="cpu")

    def f(theta):
        return loss(theta * cfg.recombination)

    res = gc.gradcheck(f, torch.tensor([0.9]), name="e2e/no-recon",
                       eps=2e-2, rtol=2e-1, atol=1e-3)
    assert res.ok, res


def test_finite_difference_grad_on_quadratic():
    c = torch.tensor([1.0, -2.0, 0.5])
    x0 = torch.tensor([0.3, 0.1, -0.2])
    g = gc.finite_difference_grad(lambda x: torch.sum((x - c) ** 2), x0,
                                  eps=1e-2)
    np.testing.assert_allclose(g.numpy(), 2 * (x0 - c).numpy(), rtol=1e-3,
                               atol=1e-4)


class _BadSquare(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sum(x * x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return 3.0 * g * x  # wrong: should be 2 g x


def test_gradcheck_flags_wrong_gradient():
    assert not gc.gradcheck(_BadSquare.apply, torch.tensor([1.5]),
                            name="bad").ok
    assert gc.gradcheck(lambda x: torch.sum(x * x), torch.tensor([1.5]),
                        name="good").ok


def test_nan_analytic_gradient_fails():
    res = gc.gradcheck(lambda x: torch.sum(torch.sqrt(x)),
                       torch.tensor([0.0]), name="nan")
    assert not res.ok and res.max_rel_err == float("inf")
    assert str(res).startswith("[FAIL]")


def test_launcher_gradcheck(capsys):
    assert launcher.main(["--gradcheck", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "gradcheck: 7/7 ok" in out and "FAIL" not in out
