"""The work of each stage of one event, counted from the cell's shapes.

A stage's operations and bytes are what its function needs, whatever
implements it: every input read once and every output written once, and
the floating-point operations of its mathematics (each add, multiply,
divide, square root and transcendental counted as one; integer hashing of
the random streams is not counted). These counts give each stage's least
time on the card (``peaks.bound_s``), against which the measured time is a
roofline share.

Counts are per event, over all of the configuration's planes.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

from plainref.lartpc import pad_shape

#: float32 operations a fluctuated patch pixel needs: the mean (2
#: products), the binomial variance (a divide, a clamp, a subtract, a
#: multiply, a clamp), a normal from two uniforms (2 conversions, a log,
#: a product, a square root, a cosine, 2 products), the draw (a square
#: root, a multiply-add, a clamp) and its add into the grid
PIXEL_OPS_FLUCTUATED = 2 + 5 + 8 + 4 + 1
#: the same without fluctuation: the mean and its add
PIXEL_OPS_MEAN = 3
F32 = 4
C64 = 8


def shapes(cfg: dict) -> Dict[str, int]:
    w, t = int(cfg["num_wires"]), int(cfg["num_ticks"])
    wp, tp = pad_shape(cfg)
    return {"P": int(cfg["num_planes"]), "N": int(cfg["num_depos"]), "W": w,
            "T": t, "Wp": wp, "Tp": tp, "pw": int(cfg["patch_wires"]),
            "pt": int(cfg["patch_ticks"])}


def _rfft2_ops(rows: int, cols: int) -> float:
    """A real 2-D transform of rows x cols: 2.5 n log2 n."""
    n = rows * cols
    return 2.5 * n * math.log2(n)


def _spectrum_stage(s: Dict[str, int]) -> Tuple[float, float]:
    """One plane's padded forward transform, the product with a stored
    half spectrum and the inverse: (ops, bytes) with the grid read, the
    spectrum read and the result written once."""
    half = s["Wp"] * (s["Tp"] // 2 + 1)
    ops = 2 * _rfft2_ops(s["Wp"], s["Tp"]) + 6 * half
    nbytes = s["W"] * s["T"] * F32 * 2 + half * C64
    return ops, nbytes


def charge_grid(cfg: dict) -> Tuple[float, float]:
    """Depos (5 float32 fields a plane) in, the (P, W, T) float32 grid
    out; per depo the 2 (pw + 1, pt + 1) erf edges and their differences,
    per patch pixel ``PIXEL_OPS_*``."""
    s = shapes(cfg)
    per_pixel = PIXEL_OPS_FLUCTUATED if cfg["fluctuate"] else PIXEL_OPS_MEAN
    edges = (s["pw"] + 1) + (s["pt"] + 1)
    per_depo = 4 * edges + s["pw"] * s["pt"] * per_pixel
    ops = s["P"] * s["N"] * per_depo
    nbytes = s["P"] * (s["N"] * 5 * F32 + s["W"] * s["T"] * F32)
    return float(ops), float(nbytes)


def convolve(cfg: dict) -> Tuple[float, float]:
    s = shapes(cfg)
    ops, nbytes = _spectrum_stage(s)
    return s["P"] * ops, float(s["P"] * nbytes)


def noise(cfg: dict) -> Tuple[float, float]:
    """Per wire two normals a frequency bin (a uniform conversion, an
    erfinv, a product each), the amplitude products, the inverse real
    transform, and the division and add into the signal; the signal read
    and written once."""
    s = shapes(cfg)
    nfreq = s["T"] // 2 + 1
    draws = 2 * s["W"] * nfreq * 3
    shape = 2 * s["W"] * nfreq * 2
    inverse = s["W"] * 2.5 * s["T"] * math.log2(s["T"])
    add = 2 * s["W"] * s["T"]
    ops = s["P"] * (draws + shape + inverse + add)
    nbytes = s["P"] * s["W"] * s["T"] * F32 * 2
    return float(ops), float(nbytes)


def stages(cfg: dict, add_noise: bool) -> Dict[str, Tuple[float, float]]:
    """(ops, bytes) of every stage of one event of the cell that a
    roofline metric reads."""
    out = {"charge_grid": charge_grid(cfg), "convolve": convolve(cfg)}
    if add_noise:
        out["noise"] = noise(cfg)
    return out
