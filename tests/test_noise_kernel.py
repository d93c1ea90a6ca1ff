"""The noise-spectrum kernel's wrapper and plain version, on the CPU.

``repro_torch.kernels.noise`` draws every plane's shaped noise spectrum in
one launch on the card (``csrc/noise.cu``) and runs its plain version on
CPU tensors. Here the plain version and the wrapper are held bit for bit
against the eager draw the noise stage ran before the kernel
(``prng.normal`` for the real and imaginary parts, one plane at a time),
which ``tests/test_torch_core.py::test_simulate_noise`` holds to the JAX
package. The kernel itself is held against the plain version on the card
by ``tests/test_noise_kernel_card.py`` and ``chip_smoke.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.analysis.census import Census
from repro_torch.config import get_config
from repro_torch.core import noise as tnoise
from repro_torch.core import prng
from repro_torch.core.stages import noise_stage
from repro_torch.kernels.noise import kernel, ref

torch.set_num_threads(1)

N_ROWS = 6
SMOKE = get_config("lartpc-uboone", smoke=True)


def _old_spectrum(k, n_rows, amp, num_ticks):
    """The noise stage's spectrum of one plane before the kernel, verbatim."""
    nfreq = num_ticks // 2 + 1
    k1, k2 = prng.split(k)
    re = prng.normal(k1, (n_rows, nfreq), amp.device)
    im = prng.normal(k2, (n_rows, nfreq), amp.device)
    im[:, 0] = 0.0
    if num_ticks % 2 == 0:
        im[:, -1] = 0.0
    scale = 0.7071067811865476
    return torch.complex(re * amp[None, :] * scale, im * amp[None, :] * scale)


def _old_rows(k, n_rows, amp, num_ticks):
    return torch.fft.irfft(_old_spectrum(k, n_rows, amp, num_ticks),
                           n=num_ticks, dim=-1).to(torch.float32)


def _amp(num_ticks, rms=1.2):
    cfg = dataclasses.replace(SMOKE, num_ticks=num_ticks, noise_rms_adc=rms)
    return tnoise.noise_spectrum(cfg, "cpu")


def _keys(n):
    return [prng.fold_in(prng.key(11), p) for p in range(n)]


@pytest.mark.parametrize("num_ticks", [64, 63])
@pytest.mark.parametrize("planes", [1, 3])
def test_plain_version_equals_old_draw(num_ticks, planes):
    amp = _amp(num_ticks)
    keys = _keys(planes)
    words = [tnoise.plane_key_words(k) for k in keys]
    got = ref.noise_spectrum_ref(words, N_ROWS, amp, num_ticks, "cpu")
    want = torch.stack([_old_spectrum(k, N_ROWS, amp, num_ticks)
                        for k in keys])
    assert got.dtype == torch.complex64
    assert got.shape == (planes, N_ROWS, num_ticks // 2 + 1)
    assert torch.equal(torch.view_as_real(got), torch.view_as_real(want))
    wrapped = kernel.noise_spectrum(words, N_ROWS, amp, num_ticks)
    assert torch.equal(torch.view_as_real(wrapped), torch.view_as_real(want))


@pytest.mark.parametrize("num_ticks", [64, 63])
def test_rows_equal_old_rows(num_ticks):
    amp = _amp(num_ticks)
    keys = _keys(3)
    got = tnoise.sample_noise_planes(keys, N_ROWS, amp, num_ticks)
    want = torch.stack([_old_rows(k, N_ROWS, amp, num_ticks) for k in keys])
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
    assert torch.equal(tnoise.sample_noise_planes(keys[1:2], N_ROWS, amp,
                                                  num_ticks)[0], want[1])


@pytest.mark.parametrize("num_ticks", [64, 63])
def test_self_conjugate_bins_are_real(num_ticks):
    spec = kernel.noise_spectrum([tnoise.plane_key_words(k) for k in _keys(2)],
                                 N_ROWS, _amp(num_ticks), num_ticks)
    assert bool((spec[..., 0].imag == 0).all())
    last = spec[..., -1].imag
    if num_ticks % 2 == 0:
        assert bool((last == 0).all())
    else:  # odd: the last bin is no Nyquist bin
        assert bool((last != 0).all())
    assert bool((spec[..., 1:-1].imag != 0).all())
    assert bool((spec.real != 0).all())


def test_plane_keys_give_distinct_draws():
    words = [tnoise.plane_key_words(k) for k in _keys(3)]
    assert len(set(words)) == 3
    spec = kernel.noise_spectrum(words, N_ROWS, _amp(64), 64)
    for a in range(3):
        for b in range(a + 1, 3):
            assert not bool(torch.isclose(spec[a], spec[b]).any())
        # a plane's draw does not depend on the planes beside it
        alone = kernel.noise_spectrum(words[a:a + 1], N_ROWS, _amp(64), 64)
        assert torch.equal(torch.view_as_real(alone[0]),
                           torch.view_as_real(spec[a]))


def test_unit_normals_without_amplitude():
    words = [tnoise.plane_key_words(k) for k in _keys(2)]
    unit = ref.noise_spectrum_ref(words, N_ROWS, None, 64, "cpu")
    k1 = torch.tensor(words[1][:2], dtype=torch.int64)
    assert torch.equal(unit[1].real, prng.normal(k1, (N_ROWS, 33), "cpu"))
    amp = _amp(64)
    shaped = ref.noise_spectrum_ref(words, N_ROWS, amp, 64, "cpu")
    assert torch.equal(shaped.real, unit.real * amp * ref.SCALE)


@pytest.mark.parametrize("num_ticks", [64, 63])
def test_gradient_matches_plain_path(num_ticks):
    """The calibration path: ``noise_rms_adc`` a 0-d tensor, so ``amp``
    takes a gradient; the wrapper draws unit normals and shapes them with
    autograd, as the eager draw did."""
    def grads(sample):
        rms = torch.tensor(1.2, requires_grad=True)
        amp = _amp(num_ticks, rms)
        assert amp.requires_grad
        rows = sample(amp)
        loss = (rows * rows).sum() + rows[:, :, 3].sum()
        (g,) = torch.autograd.grad(loss, rms)
        return rows.detach(), g

    keys = _keys(3)
    got, g_got = grads(lambda amp: tnoise.sample_noise_planes(
        keys, N_ROWS, amp, num_ticks))
    want, g_want = grads(lambda amp: torch.stack(
        [_old_rows(k, N_ROWS, amp, num_ticks) for k in keys]))
    assert torch.equal(got, want)
    assert torch.equal(g_got, g_want)
    assert float(g_got) != 0.0


@pytest.mark.parametrize("case", ["float64", "length", "2-d", "strided",
                                  "no planes", "three words", "wide word",
                                  "negative word", "no rows", "no ticks",
                                  "meta"])
def test_wrapper_refuses(case):
    amp = _amp(64)
    words = [tnoise.plane_key_words(k) for k in _keys(2)]
    rows, ticks = N_ROWS, 64
    if case == "float64":
        amp = amp.to(torch.float64)
    elif case == "length":
        amp = amp[:-1]
    elif case == "2-d":
        amp = amp[None]
    elif case == "strided":
        amp = torch.stack([amp, amp], 1)[:, 0]
    elif case == "no planes":
        words = []
    elif case == "three words":
        words = [w[:3] for w in words]
    elif case == "wide word":
        words = [(2 ** 32,) + w[1:] for w in words]
    elif case == "negative word":
        words = [(-1,) + w[1:] for w in words]
    elif case == "no rows":
        rows = 0
    elif case == "no ticks":
        ticks = 0
    elif case == "meta":
        amp = torch.empty(33, device="meta")
    with pytest.raises(ValueError):
        kernel.noise_spectrum(words, rows, amp, ticks)


def test_stage_draws_every_plane_in_one_launch():
    """The three-plane noise stage: one launch an event (the census counts
    the plain version's run as the launch the card makes), every plane
    equal to the one-plane draw with its folded key."""
    cfg = dataclasses.replace(SMOKE, num_planes=3, num_wires=8, num_ticks=64)
    stage = noise_stage(cfg)
    state = _State(torch.zeros(3, 8, 64), prng.key(5))
    kernel.reset_launches()
    with Census() as c:
        out = stage.fn(state).signal
    assert c.kernels["noise_spectrum"] == 1
    assert kernel.LAUNCHES["noise_spectrum"] == 0  # plain runs do not count
    amp = tnoise.noise_spectrum(cfg, "cpu")
    denom = cfg.adc_per_electron
    for p in range(3):
        rows = _old_rows(prng.fold_in(prng.key(5), p), 8, amp, 64)
        assert torch.equal(out[p], torch.zeros(8, 64) + rows
                           / torch.clamp_min(torch.tensor(denom), 1e-30))


class _State:
    """The two fields of a SimState the noise stage reads."""

    def __init__(self, signal, kn):
        self.signal = signal
        self.kn = kn

    def _replace(self, **kw):
        out = _State(self.signal, self.kn)
        out.__dict__.update(kw)
        return out
