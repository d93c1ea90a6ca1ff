"""Wrapper of the noise-spectrum CUDA kernel.

``noise_spectrum`` draws the shaped Gaussian spectrum of every plane of an
event, the draw of ``repro_torch.core.noise``: on a CUDA tensor it launches
``noise_spectrum`` from ``csrc/noise.cu`` once for up to ``MAX_PLANES``
planes, or raises; on a CPU tensor it runs the plain PyTorch version in
``ref.py``. Where ``amp`` takes a gradient (the calibration path, whose
``noise_rms_adc`` is a 0-d tensor) the kernel draws unit normals and torch
applies the amplitude, so autograd sees the shaping. The kernel replaces
no TPU kernel (the reference's XLA fuses its ``jax.random`` draw).
``LAUNCHES`` counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, plain_version, raise_on)
from repro_torch.kernels.noise import ref
from repro_torch.kernels.noise.ref import SCALE, Words

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"noise_spectrum": 0}

#: planes one launch takes (``kMaxPlanes`` of csrc/noise.cu)
MAX_PLANES = 16

#: the float32 constants of ``prng.normal``: the uniform's bounds' span
SPAN = float(np.float32(1.0) - np.float32(prng.NORMAL_LO))

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


#: the C entry point of csrc/noise.cu and its argument types: key words,
#: planes, rows, nfreq, zero_last, amp, lo, span, sqrt2, scale, out, stream
SIGNATURES = {"noise_spectrum": [_P, _I, _I, _I, _I, _P, _F, _F, _F, _F,
                                 _P, _P]}


def _library() -> ctypes.CDLL:
    lib = load_library("noise")
    for name, argtypes in SIGNATURES.items():
        declare(lib, name, argtypes)
    return lib


def _check_words(words: Sequence[Words]) -> None:
    if not words:
        raise ValueError("noise_spectrum: no plane keys")
    for w in words:
        if len(w) != 4 or not all(isinstance(x, int) and 0 <= x < 2 ** 32
                                  for x in w):
            raise ValueError(f"noise_spectrum: a plane's keys are 4 uint32 "
                             f"words, got {w!r}")


def draw(words: Sequence[Words], n_rows: int, amp: Optional[torch.Tensor],
         num_ticks: int, dev: torch.device) -> torch.Tensor:
    """``noise_spectrum``'s draw on ``dev`` with its inputs already checked:
    the spectra shaped by ``amp``, or the unit normals where it is None."""
    if dev.type == "cpu":
        with plain_version("noise_spectrum"):
            return ref.noise_spectrum_ref(words, n_rows, amp, num_ticks, dev)
    nfreq = num_ticks // 2 + 1
    out = torch.empty((len(words), n_rows, nfreq), dtype=torch.complex64,
                      device=dev)
    for start in range(0, len(words), MAX_PLANES):
        chunk = words[start:start + MAX_PLANES]
        flat = (ctypes.c_uint32 * (4 * len(chunk)))(*(x for w in chunk
                                                      for x in w))
        with torch.cuda.device(dev):
            err = _library().noise_spectrum(
                ctypes.addressof(flat), len(chunk), n_rows, nfreq,
                num_ticks % 2 == 0, None if amp is None else amp.data_ptr(),
                prng.NORMAL_LO, SPAN, prng.SQRT2_F32, SCALE,
                out[start].data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        raise_on(err, "noise_spectrum")
        LAUNCHES["noise_spectrum"] += 1
    return out


def noise_spectrum(words: Sequence[Words], n_rows: int, amp: torch.Tensor,
                   num_ticks: int) -> torch.Tensor:
    """(P, n_rows, num_ticks // 2 + 1) complex64: plane p's rfft bin f of
    row w is ``(normal(k1) * amp[f]) * SCALE`` real and ``(normal(k2) *
    amp[f]) * SCALE`` imaginary, ``normal(k)`` being element ``w * nfreq +
    f`` of ``prng.normal(k, (n_rows, nfreq))`` and the imaginary part 0 at
    DC and, for even ``num_ticks``, at Nyquist. ``words[p]`` holds plane
    p's key words, k1's two then k2's two (Python ints); ``amp`` is the
    (nfreq,) float32 amplitude spectrum on the device to draw on."""
    dev = kernel_device(amp)
    _check_words(words)
    if n_rows < 1 or num_ticks < 1:
        raise ValueError(f"noise_spectrum: {n_rows} rows of {num_ticks} "
                         "ticks")
    check_tensor("amp", amp, torch.float32, (num_ticks // 2 + 1,), dev)
    if not amp.requires_grad:
        return draw(words, n_rows, amp, num_ticks, dev)
    parts = torch.view_as_real(draw(words, n_rows, None, num_ticks, dev))
    return torch.complex(parts[..., 0] * amp * SCALE,
                         parts[..., 1] * amp * SCALE)
