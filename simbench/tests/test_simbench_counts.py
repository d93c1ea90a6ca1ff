"""The stages' operations and bytes at one shape, against counts made by
hand; the trace reduction on a made-up trace; the window's seeded
sample."""
from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from lartpcbench import counts, peaks, trace, window  # noqa: E402

#: a small three-plane shape: 64 x 100 grids, 10 depos, 4 x 5 patches,
#: a 3 x 8 response (padded to 72 x 108: the next 2^a 3^b 5^c from 66 and
#: 107)
CFG = {"num_planes": 3, "num_depos": 10, "num_wires": 64, "num_ticks": 100,
       "response_wires": 3, "response_ticks": 8, "patch_wires": 4,
       "patch_ticks": 5, "fluctuate": True}


def test_shapes_pad_to_fast_lengths():
    s = counts.shapes(CFG)
    assert (s["Wp"], s["Tp"]) == (72, 108)
    full = dict(CFG, num_wires=2560, num_ticks=9592, response_wires=21,
                response_ticks=200)
    assert (counts.shapes(full)["Wp"], counts.shapes(full)["Tp"]) == (
        2592, 10000)


def test_charge_grid_counts():
    ops, nbytes = counts.charge_grid(CFG)
    per_depo = 4 * (5 + 6) + 4 * 5 * 20
    assert ops == 3 * 10 * per_depo
    assert nbytes == 3 * (10 * 5 * 4 + 64 * 100 * 4)
    ops_mean, _ = counts.charge_grid(dict(CFG, fluctuate=False))
    assert ops_mean == 3 * 10 * (4 * 11 + 20 * 3)


def test_convolve_counts():
    ops, nbytes = counts.convolve(CFG)
    n = 72 * 108
    half = 72 * 55
    assert ops == pytest.approx(3 * (2 * 2.5 * n * math.log2(n) + 6 * half))
    assert nbytes == 3 * (64 * 100 * 4 * 2 + half * 8)


def test_noise_counts():
    ops, nbytes = counts.noise(CFG)
    nfreq = 51
    per_plane = (2 * 64 * nfreq * 3 + 2 * 64 * nfreq * 2
                 + 64 * 2.5 * 100 * math.log2(100) + 2 * 64 * 100)
    assert ops == pytest.approx(3 * per_plane)
    assert nbytes == 3 * 64 * 100 * 4 * 2


def test_stages_follow_the_graph():
    assert set(counts.stages(CFG, True)) == {
        "charge_grid", "convolve", "noise"}
    assert set(counts.stages(CFG, False)) == {"charge_grid", "convolve"}


def test_bound_takes_the_slower_side():
    assert peaks.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.bound_s(67e9, 6.7e12) == pytest.approx(2.0)


class _Event:
    def __init__(self, name, dev, start, end, annotation=False):
        from torch.autograd import DeviceType

        self._v = (name, DeviceType.CUDA if dev == "cuda" else DeviceType.CPU,
                   start, end, annotation)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def end_ns(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_trace_reduction():
    events = [
        _Event(trace.WINDOW_SPAN, "cpu", 0, 100),
        _Event("simbench.launcher", "cpu", 0, 100),
        _Event("simbench.dispatch", "cpu", 10, 20),
        _Event("simbench.on_batch", "cpu", 70, 80),
        _Event("k1", "cuda", 5, 15),
        _Event("k2", "cuda", 12, 40),
        _Event("k1", "cuda", 75, 90),
        _Event("simbench.dispatch", "cuda", 10, 95, annotation=True),
    ]
    out = trace.reduce_events(events)
    assert out["busy_s"] == pytest.approx(50e-9)
    assert out["window_s"] == pytest.approx(100e-9)
    assert out["device_ops"] == [["k2", pytest.approx(28e-9)],
                                 ["k1", pytest.approx(25e-9)]]
    assert out["idle_gaps"] == [["launcher", pytest.approx(35e-9)],
                                ["launcher", pytest.approx(10e-9)],
                                ["launcher", pytest.approx(5e-9)]]
    assert trace.reduce_events(events[:4]) == {}


def test_gap_takes_the_innermost_span():
    events = [_Event(trace.WINDOW_SPAN, "cpu", 0, 50),
              _Event("simbench.launcher", "cpu", 0, 50),
              _Event("simbench.on_batch", "cpu", 20, 40),
              _Event("k", "cuda", 0, 25)]
    assert trace.reduce_events(events)["idle_gaps"] == [
        ["on_batch", pytest.approx(25e-9)]]


def test_reservoir_is_seeded_and_uniform_in_size():
    def draw(seed, n):
        r = window.Reservoir(3, seed)
        for i in range(n):
            slot = r.wants()
            if slot is not None:
                r.put(slot, i)
        return r.items

    assert draw(5, 100) == draw(5, 100)
    assert draw(5, 100) != draw(6, 100)
    assert sorted(draw(5, 2)) == [0, 1]
    assert len(draw(7, 1000)) == 3


def test_chunk_seeds_are_32_bit_and_distinct():
    seeds = {window.chunk_seed(2**40 + 1, c) for c in range(100)}
    assert len(seeds) == 100
    assert all(0 <= s < 2**32 for s in seeds)
    assert window.chunk_seed(1, "warmup") != window.chunk_seed(1, 0)
