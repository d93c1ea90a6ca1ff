"""Port rasterize kernel module against the reference, on the CPU.

The plain PyTorch version of the rasterize kernel (what the wrapper runs on
CPU tensors) matches the reference's ``rasterize_ref`` and its Pallas
kernel in interpret mode on the same inputs made with numpy, within the
tolerances of ``repro_torch.testing.parity``: erf, log and cos differ by
ULPs between XLA and torch. ``rasterize_depos`` matches the reference's
wrapper with the same key; its uniform pools are the reference's bits and
its patch origins are exact. The reference's XLA on the CPU contracts
``patch + sqrt(var) * normal`` into one FMA, and the port's ``fma_f32``
reproduces that rounding bit for bit. The CUDA kernel itself is held
against the plain version on the card by ``chip_smoke.py``.
"""
import dataclasses
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core.depo import generate_depos as j_generate
from repro.kernels.rasterize import ops as jops
from repro.kernels.rasterize.kernel import rasterize_pallas as j_pallas
from repro.kernels.rasterize.ref import rasterize_ref as j_ref
from repro_torch import interop
from repro_torch.kernels.rasterize import kernel as tkernel
from repro_torch.kernels.rasterize import ops as tops
from repro_torch.kernels.rasterize import ref as tref
from repro_torch.testing import parity

torch.set_num_threads(1)

CFG = JaxConfig(num_wires=128, num_ticks=512, num_depos=200,
                response_wires=11, response_ticks=64)
#: (pw, pt, pw_pad, pt_pad) patch shapes: the default and a ragged one
SHAPES = {"20x20": (20, 20, 24, 128), "12x28": (12, 28, 16, 128)}


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _tkey(k):
    return interop.key_from_data(np.asarray(jax.random.key_data(k)))


def _inputs(n: int, pw_pad: int, pt_pad: int, seed: int = 0):
    """Depo parameters, patch origins and uniform pools from numpy."""
    rng = np.random.default_rng(seed)
    wire = rng.uniform(5, 120, n).astype(np.float32)
    tick = rng.uniform(5, 500, n).astype(np.float32)
    sw = rng.uniform(0.6, 3.0, n).astype(np.float32)
    st = rng.uniform(0.8, 3.0, n).astype(np.float32)
    q = rng.lognormal(np.log(5000.0), 0.5, n).astype(np.float32)
    q[:3] = (0.0, 0.5, 1.0)                   # charge below max(q, 1)
    w0 = (np.round(wire) - 10).astype(np.int32)
    t0 = (np.round(tick) - 10).astype(np.int32)
    u1 = rng.random((n, pw_pad, pt_pad), np.float32)
    u2 = rng.random((n, pw_pad, pt_pad), np.float32)
    u1[0, :2, :2] = 0.0                       # the 1e-12 floor
    return wire, tick, sw, st, q, w0, t0, u1, u2


def _assert_patches_close(port, ref, what):
    """Fluctuated patches: the grid tolerance of ``parity`` (erf, log and
    cos ULPs, scaled by the fluctuation's sqrt(variance))."""
    return parity.assert_close(port, ref, atol_frac=parity.GRID_ATOL_FRAC,
                               what=what)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("fluctuate", [True, False])
def test_plain_version_matches_reference(shape, fluctuate):
    pw, pt, pw_pad, pt_pad = SHAPES[shape]
    args = _inputs(128, pw_pad, pt_pad, seed=1)
    kw = dict(pw=pw, pt=pt, pw_pad=pw_pad, pt_pad=pt_pad, fluctuate=fluctuate)
    ref = np.asarray(jax.jit(lambda *a: j_ref(*a, **kw))(
        *(jnp.asarray(a) for a in args)))
    pal = np.asarray(j_pallas(*(jnp.asarray(a) for a in args), depo_block=64,
                              interpret=True, **kw))
    port = tkernel.rasterize_pallas(*(torch.from_numpy(a) for a in args),
                                    depo_block=64, **kw).numpy()
    assert port.shape == ref.shape == (128, pw_pad, pt_pad)
    _assert_patches_close(port, ref, f"{shape} vs rasterize_ref")
    _assert_patches_close(port, pal, f"{shape} vs interpret-mode Pallas")
    assert (port[:, pw:, :] == 0).all() and (port[:, :, pt:] == 0).all()
    assert (port >= 0).all()


def _exact_fma_f32(a, b, c) -> np.float32:
    """Correctly rounded float32 a*b + c, from exact rational arithmetic."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    guess = np.float32(float(exact))
    cands = [np.nextafter(guess, np.float32(-np.inf)), guess,
             np.nextafter(guess, np.float32(np.inf))]
    dist = [abs(Fraction(float(x)) - exact) for x in cands]
    best = min(dist)
    ties = [x for x, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda x: int(np.array(x).view(np.int32)) & 1)


def test_fma_f32_rounds_once():
    """``fma_f32`` is the correctly rounded fused multiply-add, including
    sums whose float64 rounding would be a float32 tie."""
    rng = np.random.default_rng(7)
    a = rng.normal(0, 30, 2000).astype(np.float32)
    b = rng.normal(0, 3, 2000).astype(np.float32)
    c = rng.normal(0, 500, 2000).astype(np.float32)
    # c + 2**-24 * c * (1 + 2**-30)-like cases: a*b lands just off a tie
    c[:8] = np.float32(1.0)
    a[:8] = np.float32(2.0 ** -24)
    b[:8] = np.float32(1.0) + np.float32(2.0 ** -23) * np.arange(8)
    b[8:16] = -b[:8]
    a[8:16], c[8:16] = a[:8], c[:8]
    got = tref.fma_f32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    want = np.array([_exact_fma_f32(x, y, z) for x, y, z in zip(a, b, c)],
                    np.float32)
    np.testing.assert_array_equal(got, want)
    two_roundings = (a * b + c).astype(np.float32)
    assert (two_roundings != want).any()


def test_fluctuation_step_rounds_as_the_reference():
    """XLA on the CPU fuses ``patch + sqrt(var) * normal`` into one FMA; the
    plain version's step gives the same bits from the same operands."""
    rng = np.random.default_rng(3)
    patch = (rng.random(4096) * 300).astype(np.float32)
    var = (rng.random(4096) * 300).astype(np.float32)
    normal = rng.normal(0, 1, 4096).astype(np.float32)
    ref = np.asarray(jax.jit(
        lambda p, v, z: jnp.maximum(p + jnp.sqrt(v) * z, 0.0))(
            patch, var, normal))
    # numpy's float32 sqrt is correctly rounded, as XLA's is; torch's on
    # the CPU is not always, so the operands come from numpy
    t = [torch.from_numpy(x) for x in (patch, np.sqrt(var), normal)]
    port = torch.clamp_min(tref.fma_f32(t[1], t[2], t[0]), 0.0)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("n,block", [(200, 64), (256, 256), (37, 32)])
def test_uniform_pools_are_the_reference_bits(n, block):
    k = jax.random.key(11)
    shape = ((n + block - 1) // block * block, 24, 128)
    k1, k2 = jax.random.split(k)
    u1, u2 = tops.uniform_pools(_tkey(k), shape, "cpu")
    np.testing.assert_array_equal(
        u1.numpy(), np.asarray(jax.random.uniform(k1, shape, jnp.float32)))
    np.testing.assert_array_equal(
        u2.numpy(), np.asarray(jax.random.uniform(k2, shape, jnp.float32)))


@pytest.mark.parametrize("fluctuate", [True, False])
@pytest.mark.parametrize("n,block", [(200, 64), (128, 128)])
def test_rasterize_depos_matches_reference(fluctuate, n, block):
    cfg = dataclasses.replace(CFG, num_depos=n)
    k = jax.random.key(5)
    depos = j_generate(k, cfg)
    ref, rw0, rt0 = (np.asarray(x) for x in jops.rasterize_depos(
        k, depos, cfg, depo_block=block, fluctuate=fluctuate))
    tdepos = interop.depos_from_numpy(*(np.asarray(x) for x in depos),
                                      device="cpu")
    tkernel.reset_launches()
    port, w0, t0 = tops.rasterize_depos(_tkey(k), tdepos, _tcfg(cfg),
                                        depo_block=block, fluctuate=fluctuate,
                                        device="cpu")
    assert tkernel.LAUNCHES == {"rasterize_pallas": 0}   # plain version
    assert port.shape == ref.shape == (n, 24, 128)
    np.testing.assert_array_equal(w0.numpy(), rw0)
    np.testing.assert_array_equal(t0.numpy(), rt0)
    _assert_patches_close(port.numpy(), ref, "rasterize_depos")
    assert (port[:, cfg.patch_wires:, :] == 0).all()


def test_padding_depos_have_zero_patches():
    depos = interop.depos_from_numpy(*(np.full(5, v, np.float32)
                                       for v in (30.0, 40.0, 1.2, 1.3, 900.)),
                                     device="cpu")
    padded, n = tops.pad_depos(depos, 4)
    assert n == 5 and padded.n == 8
    assert padded.sigma_w[5:].tolist() == [1.0] * 3
    assert padded.charge[5:].tolist() == [0.0] * 3
    patches, _, _ = tops.rasterize_depos(
        interop.key_from_data(np.array([0, 1], np.uint32)), depos,
        _tcfg(CFG), depo_block=4, device="cpu")
    assert patches.shape[0] == 5 and float(patches.sum()) > 0


@pytest.mark.parametrize("bad", ["block", "pools", "shape", "dtype"])
def test_wrapper_rejects(bad):
    args = [torch.from_numpy(a) for a in _inputs(64, 24, 128)]
    kw = dict(pw=20, pt=20, pw_pad=24, pt_pad=128, depo_block=64)
    if bad == "block":
        kw["depo_block"] = 48
    elif bad == "pools":
        args[7] = None
    elif bad == "shape":
        kw["pt"] = 200
    else:
        args[5] = args[5].to(torch.int64)
    with pytest.raises(ValueError):
        tkernel.rasterize_pallas(*args, **kw)
