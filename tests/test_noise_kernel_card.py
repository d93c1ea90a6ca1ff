"""The noise-spectrum kernel on the card (``csrc/noise.cu``).

Every test needs a CUDA card and skips without one. The card's machine has
no JAX, which ``tests/conftest.py`` imports, so this file imports none and
runs there without the conftest:

    python -m pytest -q --noconftest -p no:cacheprovider \\
        tests/test_noise_kernel_card.py

Tolerance: none. The kernel computes the plain version's operations in its
order (the uniform's FMA rounded once, ``erfinvf``, which torch's CUDA
``erfinv`` calls for float32, the products one at a time), so the spectra
are compared bit for bit, and so is the noise stage before and after.
"""
import dataclasses
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.config import get_config
from repro_torch.core import noise as tnoise
from repro_torch.core import prng
from repro_torch.core.stages import noise_stage
from repro_torch.kernels.noise import kernel, ref

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parent.parent
#: MicroBooNE width as the benchmark runs it: 2400 wires, 9600 ticks
WIRES, TICKS = 2400, 9600


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _cfg(planes=3, wires=WIRES, ticks=TICKS):
    return dataclasses.replace(get_config("lartpc-uboone"), num_planes=planes,
                               num_wires=wires, num_ticks=ticks)


def _words(n, seed=7):
    return [tnoise.plane_key_words(prng.fold_in(prng.key(seed), p))
            for p in range(n)]


def _bits(x):
    return torch.view_as_real(x) if x.is_complex() else x


@pytest.mark.parametrize("planes,rows,ticks", [
    (3, WIRES, TICKS),    # the full cell's event
    (1, 7, 63),           # odd ticks: no Nyquist bin; 7 x 32 bins, no
                          # multiple of a thread's 4
    (17, 5, 10),          # more planes than one launch takes
    (2, 1, 1),            # one bin a row
])
def test_kernel_equals_plain(dev, planes, rows, ticks):
    amp = tnoise.noise_spectrum(_cfg(1, rows, ticks), dev)
    words = _words(planes)
    kernel.reset_launches()
    got = kernel.noise_spectrum(words, rows, amp, ticks)
    again = kernel.noise_spectrum(words, rows, amp, ticks)
    want = ref.noise_spectrum_ref(words, rows, amp, ticks, dev)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["noise_spectrum"] == 2 * -(-planes // 16)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(got), _bits(again))
    unit = ref.noise_spectrum_ref(words, rows, None, ticks, dev)
    # null amplitude: the unit normals the calibration path shapes
    assert torch.equal(_bits(kernel.draw(words, rows, None, ticks, dev)),
                       _bits(unit))


def test_gradient_on_the_card(dev):
    """``amp`` with a gradient: the kernel draws unit normals and torch
    shapes them; values and gradient equal the plain version's."""
    words = _words(3)

    def run(draw):
        rms = torch.tensor(1.2, device=dev, requires_grad=True)
        amp = tnoise.noise_spectrum(dataclasses.replace(
            _cfg(1, 64, 512), noise_rms_adc=rms), dev)
        spec = draw(amp)
        rows = torch.fft.irfft(spec, n=512, dim=-1)
        (g,) = torch.autograd.grad((rows * rows).sum(), rms)
        return rows.detach(), g

    got, g_got = run(lambda amp: kernel.noise_spectrum(words, 64, amp, 512))
    want, g_want = run(lambda amp: ref.noise_spectrum_ref(words, 64, amp, 512,
                                                          dev))
    assert torch.equal(got, want)
    assert torch.equal(g_got, g_want)


def test_irfft_over_planes_equals_per_plane(dev):
    """The stage transforms all planes in one batched ``irfft``: the card's
    cuFFT gives every plane the bits of a transform of that plane alone."""
    amp = tnoise.noise_spectrum(_cfg(), dev)
    spec = kernel.noise_spectrum(_words(3), WIRES, amp, TICKS)
    batched = torch.fft.irfft(spec, n=TICKS, dim=-1)
    for p in range(3):
        assert torch.equal(batched[p],
                           torch.fft.irfft(spec[p], n=TICKS, dim=-1))


def test_noise_stage_before_and_after(dev):
    """One three-plane event at full width: the stage's signal equals the
    eager per-plane draw's (the stage before the kernel), in one launch."""
    cfg = _cfg()
    kn = prng.key(2024)
    signal = torch.randn(3, WIRES, TICKS, device=dev) * 50.0
    state = _State(signal, kn)
    stage = noise_stage(cfg)
    kernel.reset_launches()
    got = stage.fn(state).signal
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["noise_spectrum"] == 1
    amp = tnoise.noise_spectrum(cfg, dev)
    denom = torch.clamp_min(torch.tensor(cfg.adc_per_electron, device=dev),
                            1e-30)
    for p in range(3):
        k = prng.fold_in(kn, p)
        words = [tnoise.plane_key_words(k)]
        spec = ref.noise_spectrum_ref(words, WIRES, amp, TICKS, dev)[0]
        noise = torch.fft.irfft(spec, n=TICKS, dim=-1)
        assert torch.equal(got[p], signal[p] + noise / denom)


def test_one_launch_an_event_in_the_stream(dev):
    """The launcher's stream of the full cell's graph: one noise launch an
    event, none where the graph has no noise stage."""
    from repro_torch.core.batch import make_batched_sim_fn
    from repro_torch.launch.sim import stream_simulate

    cfg = dataclasses.replace(get_config("lartpc-uboone"), num_planes=3,
                              charge_grid_strategy="fused_pallas_multiplane")
    for add_noise, want in ((True, 3), (False, 0)):
        sim = make_batched_sim_fn(cfg, add_noise=add_noise, device=dev,
                                  recon=True)
        kernel.reset_launches()
        stream_simulate(cfg, 3, batch_events=1, sim=sim, recon=True,
                        device=dev)
        torch.cuda.synchronize()
        assert kernel.LAUNCHES["noise_spectrum"] == want


def test_full_cell_host_syncs(dev):
    """The benchmark's full cell: the census counts 9 reads of card tensors
    a batch, as before the kernel (the key words are read on the host)."""
    sys.path.insert(0, str(ROOT / "simbench"))
    from lartpcbench import cells, session, window

    from repro_torch.analysis.census import Census

    sess = session.Session(cells.load_cell("uboone-full.cosmics"), dev)
    sess.warm(3)
    kernel.reset_launches()
    with Census() as c:
        sess.streamer.chunk(window.chunk_seed(3, "census"), 2, None)
    reads = c.device_reads("cuda")
    assert sum(reads.values()) == 2 * 9, reads
    assert kernel.LAUNCHES["noise_spectrum"] == 2


class _State:
    """The two fields of a SimState the noise stage reads."""

    def __init__(self, signal, kn):
        self.signal = signal
        self.kn = kn

    def _replace(self, **kw):
        out = _State(self.signal, self.kn)
        out.__dict__.update(kw)
        return out
