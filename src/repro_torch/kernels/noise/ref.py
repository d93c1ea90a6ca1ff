"""Plain PyTorch version of the noise-spectrum kernel.

The same function as ``csrc/noise.cu``: the port's eager draw of the noise
spectrum (``repro_torch.core.prng.normal`` for the real and the imaginary
parts, the self-conjugate bins' imaginary parts zeroed, the amplitude
applied), one plane after another, returned in the kernel's layout. The CPU
path and the tests use it, so the CPU tests hold the port to the JAX
package; on the card it serves only as the kernel's comparison.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from repro_torch.core import prng

#: the shaping's 1/sqrt(2): each part carries half the bin's power
SCALE = 0.7071067811865476

Words = Tuple[int, int, int, int]


def noise_spectrum_ref(words: Sequence[Words], n_rows: int,
                       amp: Optional[torch.Tensor], num_ticks: int,
                       device) -> torch.Tensor:
    """(P, n_rows, num_ticks // 2 + 1) complex64 spectra, one a plane, from
    each plane's four key words (the real parts' key, then the imaginary
    parts'); unit normals where ``amp`` is None."""
    nfreq = num_ticks // 2 + 1
    planes = []
    for w in words:
        k1 = torch.tensor(w[:2], dtype=torch.int64)
        k2 = torch.tensor(w[2:], dtype=torch.int64)
        re = prng.normal(k1, (n_rows, nfreq), device)
        im = prng.normal(k2, (n_rows, nfreq), device)
        # a Hermitian spectrum has real DC (and, for even n, Nyquist) bins
        im[:, 0] = 0.0
        if num_ticks % 2 == 0:
            im[:, -1] = 0.0
        if amp is not None:
            re = re * amp[None, :] * SCALE
            im = im * amp[None, :] * SCALE
        planes.append(torch.complex(re, im))
    return torch.stack(planes)
