"""Wrapper of the rasterize CUDA kernel.

``rasterize_pallas`` replaces the reference's Pallas kernel of the same
name (``src/repro/kernels/rasterize/kernel.py:78``) and returns what it
returns: (N, pw_pad, pt_pad) float32 patches, fluctuated with Box-Muller
normals from the uniform pools u1, u2, zero in the padding. On CUDA tensors
it launches ``rasterize`` from ``csrc/rasterize.cu`` or raises; on CPU
tensors it runs the plain PyTorch version in ``ref.py``. ``LAUNCHES``
counts kernel launches (plain-version calls do not count).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import (check_tensor, declare, kernel_device,
                                 load_library, plain_version, raise_on)
from repro_torch.kernels.rasterize import ref

#: kernel launches per wrapper since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"rasterize_pallas": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library() -> ctypes.CDLL:
    lib = load_library("rasterize")
    # wire, tick, sigma_w, sigma_t, charge, w0, t0, u1, u2, n, pw, pt,
    # pw_pad, pt_pad, fluctuate, out, stream
    declare(lib, "rasterize", [_P] * 9 + [_I] * 6 + [_P, _P])
    return lib


def rasterize_pallas(wire, tick, sigma_w, sigma_t, charge, w0, t0,
                     u1: Optional[torch.Tensor], u2: Optional[torch.Tensor],
                     *, pw: int, pt: int, pw_pad: int = 0, pt_pad: int = 128,
                     depo_block: int = 256,
                     fluctuate: bool = True) -> torch.Tensor:
    """Rasterize every depo in one launch.

    Depo parameters are (N,) float32, w0/t0 (N,) int32 patch origins; u1/u2
    are (N, pw_pad, pt_pad) float32 uniform pools (may be None without
    ``fluctuate``). N must be a multiple of ``depo_block``, the reference's
    padding contract (the kernel itself runs one CTA per depo). Returns
    (N, pw_pad, pt_pad) float32 patches, zero in the padding.
    """
    n = wire.shape[0]
    pw_pad = pw_pad or ((pw + 7) // 8 * 8)
    if not (0 < pw <= pw_pad and 0 < pt <= pt_pad):
        raise ValueError(f"patch ({pw}, {pt}) does not fit the padded "
                         f"({pw_pad}, {pt_pad})")
    if n % depo_block:
        raise ValueError(f"pad the depo count {n} to a multiple of "
                         f"{depo_block}")
    dev = kernel_device(wire)
    for name, x in (("wire", wire), ("tick", tick), ("sigma_w", sigma_w),
                    ("sigma_t", sigma_t), ("charge", charge)):
        check_tensor(name, x, torch.float32, (n,), dev)
    check_tensor("w0", w0, torch.int32, (n,), dev)
    check_tensor("t0", t0, torch.int32, (n,), dev)
    if fluctuate:
        for name, u in (("u1", u1), ("u2", u2)):
            if u is None:
                raise ValueError(f"{name}: fluctuate needs the uniform pools")
            check_tensor(name, u, torch.float32, (n, pw_pad, pt_pad), dev)
    kw = dict(pw=pw, pt=pt, pw_pad=pw_pad, pt_pad=pt_pad,
              fluctuate=fluctuate)
    if dev.type == "cpu":
        with plain_version("rasterize_pallas"):
            return ref.rasterize_ref(wire, tick, sigma_w, sigma_t, charge, w0,
                                     t0, u1, u2, **kw)
    out = torch.empty((n, pw_pad, pt_pad), dtype=torch.float32, device=dev)
    pools = (u1.data_ptr(), u2.data_ptr()) if fluctuate else (None, None)
    with torch.cuda.device(dev):
        err = _library().rasterize(
            wire.data_ptr(), tick.data_ptr(), sigma_w.data_ptr(),
            sigma_t.data_ptr(), charge.data_ptr(), w0.data_ptr(),
            t0.data_ptr(), *pools, n, pw, pt, pw_pad, pt_pad, int(fluctuate),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    raise_on(err, "rasterize")
    LAUNCHES["rasterize_pallas"] += 1
    return out
