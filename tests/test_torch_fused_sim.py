"""Port fused charge-grid module against the reference, on the CPU.

The tile binning is exact; the plain PyTorch version of the fused kernels
(what the wrappers run on CPU tensors) matches the reference's Pallas
kernels in interpret mode within the grid tolerance, and its compact layout
equals its dense layout bit for bit. The CUDA kernels themselves are held
against this plain version on the card by ``chip_smoke.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core.depo import depo_patch_origin as j_origin
from repro.core.depo import generate_depos as j_generate
from repro.kernels.fused_sim import ops as jops
from repro.kernels.scatter_add import ops as jbin
from repro_torch import interop
from repro_torch.core.depo import depo_patch_origin
from repro_torch.kernels import tiles
from repro_torch.kernels.fused_sim import kernel as tkernel
from repro_torch.kernels.fused_sim import ops as tops
from repro_torch.kernels.scatter_add import ops as tbin
from repro_torch.testing import parity

torch.set_num_threads(1)

SMOKE = jax_get_config("lartpc-uboone", smoke=True)
#: patches straddle tile edges in both axes, and the last tile row is ragged
EDGE = JaxConfig(num_wires=96, num_ticks=768, num_depos=128)
#: (config, tw, tt) cases: the default 64x256 tile and a small 32x128 one
CASES = {"smoke": (SMOKE, 64, 256), "edge": (EDGE, 32, 128)}


def _depos(cfg, seed=0):
    d = j_generate(jax.random.key(seed), cfg)
    return d, interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                       device="cpu")


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _origins(cfg, seed=0):
    d, td = _depos(cfg, seed)
    w0, t0 = j_origin(d, cfg)
    tw0, tt0 = depo_patch_origin(td, _tcfg(cfg))
    return (w0, t0), (tw0, tt0)


def _bin_args(cfg, tw, tt):
    k_max = jbin.default_k_max(cfg.num_depos, cfg.num_wires, cfg.num_ticks,
                               tw, tt)
    return (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires, cfg.num_ticks,
            tw, tt, k_max)


@pytest.mark.parametrize("case", sorted(CASES))
def test_dense_binning_exact(case):
    cfg, tw, tt = CASES[case]
    (w0, t0), (tw0, tt0) = _origins(cfg)
    args = _bin_args(cfg, tw, tt)
    ref, n_tiles = jbin.bin_depos_to_tiles(w0, t0, *args)
    out, tn, dropped = tbin.bin_depos_to_tiles(tw0, tt0, *args)
    assert tn == n_tiles and int(dropped) == 0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_binning_exact(case):
    cfg, tw, tt = CASES[case]
    (w0, t0), (tw0, tt0) = _origins(cfg, 1)
    args = _bin_args(cfg, tw, tt)
    n_cap = jbin.active_tile_cap(w0, *args[:-1], t0=t0)
    assert tbin.active_tile_cap(tw0, *args[:-1], t0=tt0) == n_cap
    ref_active, ref_ids = jbin.bin_depos_to_tiles_compact(w0, t0, *args,
                                                          n_cap)
    active, ids, dropped = tbin.bin_depos_to_tiles_compact(tw0, tt0, *args,
                                                           n_cap)
    assert int(dropped) == 0
    np.testing.assert_array_equal(active.numpy(), np.asarray(ref_active))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))


@pytest.mark.parametrize("case", sorted(CASES))
def test_active_tile_count_exact(case):
    cfg, tw, tt = CASES[case]
    (w0, t0), (tw0, tt0) = _origins(cfg, 2)
    kw = dict(pw_pad=cfg.patch_wires, pt_pad=cfg.patch_ticks,
              num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt)
    assert int(tbin.count_active_tiles(tw0, tt0, **kw)) == int(
        jbin.count_active_tiles(w0, t0, **kw))


@pytest.mark.parametrize("n", [0, 1, 8, 9, 1000, 4096])
def test_next_pow2_and_k_max(n):
    assert tbin.next_pow2(n) == jbin.next_pow2(n)
    assert tbin.default_k_max(max(n, 1), 2560, 9592, 64, 256) == \
        jbin.default_k_max(max(n, 1), 2560, 9592, 64, 256)


@pytest.mark.parametrize("compact", [False, True])
def test_binning_counts_dropped_entries(compact):
    """Entries past k_max are dropped (as in the reference) and counted."""
    cfg, tw, tt = CASES["smoke"]
    (_, _), (tw0, tt0) = _origins(cfg, 3)
    args = list(_bin_args(cfg, tw, tt))
    tile_s, _, _, rank, _, n_tiles = tbin._sorted_tile_runs(tw0, tt0,
                                                            *args[:-1])
    k_max = 4
    expect = int(((tile_s < n_tiles) & (rank >= k_max)).sum())
    assert expect > 0
    args[-1] = k_max
    if compact:
        _, ids, dropped = tbin.bin_depos_to_tiles_compact(tw0, tt0, *args,
                                                          n_tiles)
    else:
        ids, _, dropped = tbin.bin_depos_to_tiles(tw0, tt0, *args)
    assert int(dropped) == expect
    assert int((ids >= 0).sum()) == int((tile_s < n_tiles).sum()) - expect


def test_compact_cap_too_small_counts_dropped_tiles():
    cfg, tw, tt = CASES["edge"]
    (_, _), (tw0, tt0) = _origins(cfg, 4)
    args = _bin_args(cfg, tw, tt)
    n_act = int(tbin.count_active_tiles(
        tw0, tt0, pw_pad=args[0], pt_pad=args[1], num_wires=args[2],
        num_ticks=args[3], tw=tw, tt=tt))
    _, _, dropped = tbin.bin_depos_to_tiles_compact(tw0, tt0, *args,
                                                    n_act - 1)
    assert int(dropped) > 0


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fluct", [False, True])
def test_plain_dense_matches_reference_kernel(case, fluct):
    cfg, tw, tt = CASES[case]
    d, td = _depos(cfg, 5)
    kf = jax.random.split(jax.random.key(6))[0] if fluct else None
    ref = np.asarray(jops.simulate_charge_grid(d, cfg, tw=tw, tt=tt,
                                               interpret=True, key=kf))
    tkf = None if kf is None else interop.key_from_data(
        jax.random.key_data(kf))
    out, dropped = tops.simulate_charge_grid(td, _tcfg(cfg), tw=tw, tt=tt,
                                             key=tkf)
    assert int(dropped) == 0
    parity.assert_close(out.numpy(), ref, atol_frac=parity.GRID_ATOL_FRAC,
                        what="dense grid")


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_compact_matches_reference_kernel(case):
    cfg, tw, tt = CASES[case]
    d, td = _depos(cfg, 7)
    kf = jax.random.key(8)
    ref = np.asarray(jops.simulate_charge_grid_compact(
        d, cfg, tw=tw, tt=tt, interpret=True, key=kf))
    out, dropped = tops.simulate_charge_grid_compact(
        td, _tcfg(cfg), tw=tw, tt=tt,
        key=interop.key_from_data(jax.random.key_data(kf)))
    assert int(dropped) == 0
    parity.assert_close(out.numpy(), ref, atol_frac=parity.GRID_ATOL_FRAC,
                        what="compact grid")


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("fluct", [False, True])
def test_plain_compact_equals_plain_dense_bitwise(case, fluct):
    cfg, tw, tt = CASES[case]
    _, td = _depos(cfg, 9)
    tcfg = _tcfg(cfg)
    key = interop.key_from_data(np.array([123, 456], np.uint32)) \
        if fluct else None
    dense, _ = tops.simulate_charge_grid(td, tcfg, tw=tw, tt=tt, key=key)
    compact, _ = tops.simulate_charge_grid_compact(td, tcfg, tw=tw, tt=tt,
                                                   key=key)
    padded, _ = tops.simulate_charge_grid_compact(
        td, tcfg, tw=tw, tt=tt, key=key, n_active=10_000)
    assert torch.equal(dense, compact)
    assert torch.equal(dense, padded)


def test_plain_path_adds_in_list_order():
    """The plain version adds in list order, as the kernel does: its grid
    equals a sequential float32 sum (np.add.at) of the same contributions."""
    from repro_torch.kernels.fused_sim import ref as tref
    from repro_torch.kernels.scatter_add.ref import list_entries

    cfg, tw, tt = CASES["smoke"]
    args, kw = _kernel_args(cfg, tw, tt)
    tiles_w, tiles_t, _ = tbin.tile_counts(cfg.num_wires, cfg.num_ticks, tw,
                                           tt)
    tile, _, depo = list_entries(args[7], kw["k_max"])
    pix, e, vals = tref.tile_contributions(
        args[:7], tile, depo, tiles_t=tiles_t, tw=tw, tt=tt,
        pw=cfg.patch_wires, pt=cfg.patch_ticks, seed=(1, 2), fluctuate=True)
    t_id = tile[e]
    dest = (((t_id // tiles_t) * tw + pix // tt) * (tiles_t * tt)
            + (t_id % tiles_t) * tt + pix % tt)
    expect = np.zeros(tiles_w * tw * tiles_t * tt, np.float32)
    np.add.at(expect, dest.numpy(), vals.numpy())
    out = tkernel.fused_rasterize_scatter(*args, **kw, seed=(1, 2),
                                          fluctuate=True)
    np.testing.assert_array_equal(
        out.numpy(), expect.reshape(tiles_w * tw, -1)[:cfg.num_wires,
                                                      :cfg.num_ticks])


def _kernel_args(cfg, tw, tt, device_like=None):
    _, td = _depos(cfg, 11)
    tcfg = _tcfg(cfg)
    w0, t0 = depo_patch_origin(td, tcfg)
    k_max = tbin.default_k_max(td.n, cfg.num_wires, cfg.num_ticks, tw, tt)
    ids, _, _ = tbin.bin_depos_to_tiles(w0, t0, cfg.patch_wires,
                                        cfg.patch_ticks, cfg.num_wires,
                                        cfg.num_ticks, tw, tt, k_max)
    args = [*td, w0, t0, ids]
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max, pw=cfg.patch_wires, pt=cfg.patch_ticks)
    return args, kw


def test_cpu_path_does_not_count_launches():
    cfg, tw, tt = CASES["smoke"]
    args, kw = _kernel_args(cfg, tw, tt)
    tkernel.reset_launches()
    tkernel.fused_rasterize_scatter(*args, **kw)
    assert tkernel.LAUNCHES["fused_rasterize_scatter"] == 0


def test_non_cpu_tensors_never_take_the_plain_path():
    """Tensors on another device go to the kernel or raise; here (meta
    device) the wrapper refuses them instead of running the plain version."""
    cfg, tw, tt = CASES["smoke"]
    args, kw = _kernel_args(cfg, tw, tt)
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.fused_rasterize_scatter(*meta, **kw)


@pytest.mark.parametrize("bad", ["dtype", "shape", "stride"])
def test_wrapper_rejects_bad_inputs(bad):
    cfg, tw, tt = CASES["smoke"]
    args, kw = _kernel_args(cfg, tw, tt)
    if bad == "dtype":
        args[0] = args[0].double()
    elif bad == "shape":
        args[7] = args[7][:-1]
    else:
        args[1] = torch.stack([args[1], args[1]], 1)[:, 0]
    with pytest.raises(ValueError):
        tkernel.fused_rasterize_scatter(*args, **kw)


def _fake_nvcc(tmp_path, body: str):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(0o755)
    return tmp_path


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from repro_torch import kernels

    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.build_all(force=True)


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    from repro_torch import kernels

    home = _fake_nvcc(tmp_path, 'echo "error: bad kernel"; exit 2\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="bad kernel"):
        kernels.build_all(force=True)
    assert not list((tmp_path / "build").glob("*.so"))


def test_build_writes_the_digest_named_library(monkeypatch, tmp_path):
    from repro_torch import kernels

    # the fake compiler writes its -o argument, as nvcc would
    home = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done\n'
                                'echo lib > "$2"; echo "ptxas info"\n')
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "build")
    logs = kernels.build_all(force=True)
    assert set(logs) == set(kernels.SOURCES)
    for name in kernels.SOURCES:
        path = kernels.library_path(name)
        assert path.is_file() and path.parent == tmp_path / "build"
    assert kernels.build_all() == {}  # already built: nothing to do


#: the reference's tile-boundary cases (tests/test_tile_boundary.py): one
#: depo whose patch straddles an interior edge of the 64x256 tiles of a
#: 96x768 grid, or is clipped at the detector edge
BOUNDARY = dataclasses.replace(EDGE, num_depos=1, fluctuate=False)
BOUNDARY_CASES = {
    "straddle_wire_edge": (63.7, 100.2, 1.1, 1.4, 4321.0),
    "straddle_tick_edge": (30.0, 255.4, 1.1, 1.4, 4321.0),
    "straddle_corner": (63.7, 255.4, 1.1, 1.4, 4321.0),
    "detector_edge": (0.4, 2.0, 0.8, 1.0, 999.0),
}


@pytest.mark.parametrize("name", sorted(BOUNDARY_CASES))
def test_single_depo_tile_boundary(name):
    """One depo leaves no order freedom: the fused plain versions (dense and
    compact) equal the port's unfused chain bit for bit, and the reference's
    fused kernel within the grid tolerance."""
    from repro.core.depo import DepoSet as JaxDepoSet
    from repro_torch.core.pipeline import charge_grid_unfused

    values = [np.array([v], np.float32) for v in BOUNDARY_CASES[name]]
    td = interop.depos_from_numpy(*values, device="cpu")
    tcfg = _tcfg(BOUNDARY)
    dense, _ = tops.simulate_charge_grid(td, tcfg)
    compact, _ = tops.simulate_charge_grid_compact(td, tcfg)
    unfused, _ = charge_grid_unfused(None, td, tcfg)
    assert float(dense.sum()) > 0.0
    assert torch.equal(dense, unfused) and torch.equal(compact, unfused)
    ref = np.asarray(jops.simulate_charge_grid(
        JaxDepoSet(*(jax.numpy.asarray(v) for v in values)), BOUNDARY,
        interpret=True))
    parity.assert_close(dense.numpy(), ref, what=name)


def _lists(case, layout):
    """(per-slot lists, k_max) of the binned smoke/edge depos."""
    cfg, tw, tt = CASES[case]
    _, (tw0, tt0) = _origins(cfg, 3)
    args = _bin_args(cfg, tw, tt)
    if layout == "dense":
        return tbin.bin_depos_to_tiles(tw0, tt0, *args)[0], args[-1]
    n_cap = tbin.active_tile_cap(tw0, *args[:-1], t0=tt0)
    return tbin.bin_depos_to_tiles_compact(tw0, tt0, *args, n_cap)[1], \
        args[-1]


def _synthetic_lists():
    """Eight slots of k_max 4 with repeated lengths (3, 0, 3, 4, 1, 3, 0,
    4), each list filled from rank 0."""
    lengths = [3, 0, 3, 4, 1, 3, 0, 4]
    ids = torch.full((len(lengths), 4), -1, dtype=torch.int32)
    for slot, n in enumerate(lengths):
        ids[slot, :n] = torch.arange(n, dtype=torch.int32) + 10 * slot
    return ids.reshape(-1), 4


@pytest.mark.parametrize("lists", ["smoke-dense", "smoke-compact",
                                   "edge-dense", "edge-compact", "ties"])
def test_launch_order_is_a_stable_longest_first_permutation(lists):
    ids, k_max = (_synthetic_lists() if lists == "ties"
                  else _lists(*lists.split("-")))
    order = tiles.launch_order(ids, k_max)
    n_slots = ids.numel() // k_max
    assert order.dtype == torch.int32 and order.shape == (n_slots,)
    assert sorted(order.tolist()) == list(range(n_slots))
    lengths = (ids.view(n_slots, k_max) >= 0).sum(1)[order.long()].tolist()
    assert lengths == sorted(lengths, reverse=True)
    for a, b, la, lb in zip(order.tolist(), order.tolist()[1:], lengths,
                            lengths[1:]):
        assert la > lb or a < b  # equal lengths keep their slot order
    if lists == "ties":
        assert order.tolist() == [3, 7, 0, 2, 5, 4, 1, 6]


@pytest.mark.parametrize("num_planes", [1, 3])
@pytest.mark.parametrize("tile", [(64, 256), (32, 128)])
def test_scatter_tiles_to_grid_planes_places_each_slot_at_its_tile(
        num_planes, tile):
    """Slot i of plane i // n_cap lands at plane-local tile active[i];
    -1 slots are dropped and unoccupied tiles stay zero (the layout the
    compact kernel stores in place on the card)."""
    tw, tt = tile
    tiles_w, tiles_t, n_tiles = 3, 4, 12
    n_cap = 8
    rng = np.random.default_rng(num_planes * tw)
    active = np.full((num_planes, n_cap), -1, np.int32)
    for p in range(num_planes):
        occupied = rng.choice(n_tiles, size=5 + p, replace=False)
        active[p, :occupied.size] = occupied
    blocks = rng.standard_normal((num_planes * n_cap, tw, tt)).astype(
        np.float32)
    want = np.zeros((num_planes, tiles_w * tw, tiles_t * tt), np.float32)
    for i, t in enumerate(active.reshape(-1)):
        if t >= 0:
            r, c = divmod(int(t), tiles_t)
            want[i // n_cap, r * tw:(r + 1) * tw, c * tt:(c + 1) * tt] = \
                blocks[i]
    got = tiles.scatter_tiles_to_grid_planes(
        torch.from_numpy(blocks), torch.from_numpy(active.reshape(-1)),
        num_planes, tiles_w, tiles_t, tw, tt)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("value", [0.5, 0.6, 3.0, 4797, 1e-30])
def test_division_operand_is_a_float32_scalar_on_the_inputs_device(device,
                                                                  value):
    from repro_torch.device import scalar

    like = torch.ones(3, device=device)
    s = scalar(value, like)
    assert s.dtype == torch.float32 and s.dim() == 0
    assert s.device == like.device
    if device == "cpu":
        x = torch.linspace(0.1, 7.3, 257)
        want = x.numpy() / np.float32(value)
        np.testing.assert_array_equal((x / s).numpy(), want)


def test_launch_order_ends_a_list_at_its_first_gap():
    """A -1 ends a list, as in the kernel: entries after it do not count."""
    ids = torch.tensor([5, -1, 7, 8,  1, 2, -1, -1,  3, 4, 5, -1],
                       dtype=torch.int32)
    assert tiles.launch_order(ids, 4).tolist() == [2, 1, 0]


@pytest.mark.parametrize("name", sorted(tkernel.SIGNATURES))
def test_bound_argument_types_match_the_c_entry_points(name):
    """ctypes passes what ``SIGNATURES`` declares: one pointer (c_void_p)
    for each pointer parameter of the C function, one c_int for each int."""
    import ctypes
    import re

    from repro_torch import kernels

    src = (kernels.CSRC / kernels.SOURCES["fused_sim"]).read_text()
    params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                       src).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in params.split(",")]
    assert tkernel.SIGNATURES[name] == want
