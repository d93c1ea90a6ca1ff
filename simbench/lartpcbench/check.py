"""The comparison that decides ``correct``.

Every sampled event of the window is simulated again by the plain
reference (``plainref``) from its chunk's seed and its id: the depos, the
responses and every random stream are worked out anew, nothing is taken
from the program. Its ADC is held against the program's, pixel by pixel.
For a recon cell the reference also deconvolves its own ADC and finds its
hits, which are held against the program's stored hits one by one; a hit
the program found but did not store counts as missing. So an ADC that
differs carries into the hits it moves on the program's side alone.

The numbers, each with the limit of the cell's configuration file:

``adc_diff_ppm``       pixels whose ADC differs, per million pixels
``adc_off2_ppm``       pixels whose ADC differs by 2 counts or more, per
                       million pixels (float32 rounding moves a count by
                       at most 1)
``hit_unmatched_frac`` hits without a partner on the other side, over the
                       reference's hits (recon cells only)
"""
from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np
import torch

#: two hits are partners when on one wire and their tick, charge and peak
#: agree to this relative tolerance (float32 sums of a run against
#: float64 ones) plus the absolute one beside it
HIT_RTOL = 2e-5
HIT_ATOL = {"tick": 1e-3, "charge": 1e-2, "peak": 1e-2}


def hit_mismatch(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray],
                 num_ticks: int) -> Tuple[int, int]:
    """(unmatched hits on either side, reference hits) of one plane.

    ``prog`` and ``ref`` hold ``wire``, ``tick``, ``charge``, ``peak``
    arrays. Each program hit is paired with the reference hit nearest in
    tick on its wire; a reference hit paired more than once counts once.
    """
    n_ref, n_prog = len(ref["wire"]), len(prog["wire"])
    if n_prog == 0 or n_ref == 0:
        return n_ref + n_prog, n_ref
    span = num_ticks + 2.0
    rkey = ref["wire"].astype(np.float64) * span + ref["tick"]
    order = np.argsort(rkey, kind="stable")
    rkey = rkey[order]
    r = {k: v[order] for k, v in ref.items()}
    pkey = prog["wire"].astype(np.float64) * span + prog["tick"]
    hi = np.clip(np.searchsorted(rkey, pkey), 0, n_ref - 1)
    lo = np.clip(hi - 1, 0, n_ref - 1)
    pick = np.where(np.abs(rkey[lo] - pkey) < np.abs(rkey[hi] - pkey), lo, hi)
    ok = r["wire"][pick] == prog["wire"]
    for name in ("tick", "charge", "peak"):
        want, got = r[name][pick], prog[name]
        ok &= np.abs(got - want) <= HIT_RTOL * np.abs(want) + HIT_ATOL[name]
    matched_prog = int(ok.sum())
    matched_ref = len(np.unique(pick[ok]))
    return (n_prog - matched_prog) + (n_ref - matched_ref), n_ref


def _program_hits(hits, p: int) -> Dict[str, np.ndarray]:
    """One plane's stored hits of a sampled event (a hit found but not
    stored has no partner for the reference's)."""
    wire, tick, charge, peak, mask = (x[p] for x in hits[:5])
    m = mask.cpu().numpy()
    out = {"wire": wire.cpu().numpy()[m].astype(np.int64),
           "tick": tick.cpu().numpy()[m].astype(np.float64),
           "charge": charge.cpu().numpy()[m].astype(np.float64),
           "peak": peak.cpu().numpy()[m].astype(np.float64)}
    return out


def compare(cell, samples: Iterable, ref_cfg: dict, device) -> Dict[str,
                                                                    float]:
    """The cell's numbers over ``samples`` (``window.Sample``s)."""
    from plainref import lartpc
    from plainref import threefry as tf

    det = lartpc.Detector(ref_cfg, device, recon=cell.recon)
    n_diff, n_off2, n_pix = 0, 0, 0
    unmatched, n_ref_hits = 0, 0
    for s in samples:
        k = tf.fold_in(tf.key(s.chunk_seed), s.event)
        depos = lartpc.event_depos(k, ref_cfg, det.device)
        want = lartpc.simulate(det, k, depos, add_noise=cell.add_noise)
        got = s.adc.to(det.device)
        d = (want.to(torch.int32) - got.to(torch.int32)).abs()
        n_diff += int((d > 0).sum())
        n_off2 += int((d > 1).sum())
        n_pix += d.numel()
        del got, d
        if cell.recon:
            for p, hits in enumerate(lartpc.recon(det, want)):
                ref = {k2: v.cpu().numpy() for k2, v in
                       hits._asdict().items()}
                miss, n = hit_mismatch(_program_hits(s.hits, p), ref,
                                       int(ref_cfg["num_ticks"]))
                unmatched += miss
                n_ref_hits += n
        del want
    out = {"adc_diff_ppm": 1e6 * n_diff / max(n_pix, 1),
           "adc_off2_ppm": 1e6 * n_off2 / max(n_pix, 1)}
    if cell.recon:
        out["hit_unmatched_frac"] = unmatched / max(n_ref_hits, 1)
    return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Correct when every number is at or under its limit (a number
    without a limit, or a limit without a number, is a failure)."""
    if set(numbers) != set(limits):
        return False
    return all(numbers[k] <= limits[k] for k in numbers)
