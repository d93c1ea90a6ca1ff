"""Port scatter-add module against the reference, on the CPU.

The plain PyTorch versions of the owner-computes scatter-add kernels (what
the wrappers run on CPU tensors) equal the reference's Pallas kernels in
interpret mode bit for bit: both add plain float32 patch values in list
order, and the reference's extra ``+0.0`` outside each patch changes no
bit. The compact layout equals the dense one bit for bit. Each scatter
strategy of the port matches the reference's same strategy (bitwise for the
tile kernels; within ``parity`` tolerance for the library scatters, whose
summation order is the library's). bfloat16 patches are widened before
each add: the plain versions equal the reference's kernels on them bit for
bit, and equal their own float32 result on the widened patches. The CUDA
kernels themselves are held against the plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core import scatter as jscatter
from repro.core.depo import depo_patch_origin as j_origin
from repro.core.depo import generate_depos as j_generate
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.kernels.scatter_add import kernel as jkernel
from repro.kernels.scatter_add import ops as jops
from repro_torch import interop
from repro_torch.core import scatter as tscatter
from repro_torch.core.pipeline import make_sim_fn
from repro_torch.kernels.tiles import scatter_tiles_to_grid, tiles_of_grid
from repro_torch.kernels.scatter_add import kernel as tkernel
from repro_torch.kernels.scatter_add import ops as tops
from repro_torch.testing import parity

torch.set_num_threads(1)

SMOKE = jax_get_config("lartpc-uboone", smoke=True)
#: patches straddle tile edges in both axes, and the last tile row is ragged
EDGE = JaxConfig(num_wires=96, num_ticks=768, num_depos=128,
                 response_wires=11, response_ticks=64)
#: (config, tw, tt) cases: the default 64x256 tile and a small 32x128 one
CASES = {"smoke": (SMOKE, 64, 256), "edge": (EDGE, 32, 128)}
STRATEGIES = ["xla", "sort_segment", "pallas", "pallas_compact"]


def _tcfg(cfg):
    return interop.config_from_dict(dataclasses.asdict(cfg))


def _inputs(cfg, seed):
    """Patch origins of generated depos, and (N, pw, pt) non-negative
    float32 patches drawn with numpy: the same numbers for both packages."""
    d = j_generate(jax.random.key(seed), cfg)
    w0, t0 = (np.array(x) for x in j_origin(d, cfg))
    rng = np.random.default_rng(seed)
    patches = (rng.random((cfg.num_depos, cfg.patch_wires, cfg.patch_ticks))
               * rng.random((cfg.num_depos, 1, 1)) * 100).astype(np.float32)
    return patches, w0, t0


def _k_max(w0, t0, cfg, tw, tt):
    """The longest list, as a power of two: a short k_max keeps the
    interpret-mode reference quick and drops nothing."""
    tile_s, _, _, rank, _, n_tiles = tops._sorted_tile_runs(
        torch.from_numpy(w0), torch.from_numpy(t0), cfg.patch_wires,
        cfg.patch_ticks, cfg.num_wires, cfg.num_ticks, tw, tt)
    return tops.next_pow2(int(rank[tile_s < n_tiles].max()) + 1)


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_kernel_equals_reference_kernel(case, layout):
    cfg, tw, tt = CASES[case]
    patches, w0, t0 = _inputs(cfg, 1)
    k_max = _k_max(w0, t0, cfg, tw, tt)
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max)
    tp, tw0, tt0 = (torch.from_numpy(x) for x in (patches, w0, t0))
    if layout == "dense":
        ids, _ = jops.bin_depos_to_tiles(jnp.asarray(w0), jnp.asarray(t0),
                                         *bin_args)
        ref = jkernel.scatter_add_pallas(jnp.asarray(patches),
                                         jnp.asarray(w0), jnp.asarray(t0),
                                         ids, interpret=True, **kw)
        out = tkernel.scatter_add_pallas(
            tp, tw0, tt0, torch.from_numpy(np.asarray(ids)), **kw)
    else:
        n_cap = jops.active_tile_cap(jnp.asarray(w0), *bin_args[:-1],
                                     t0=jnp.asarray(t0))
        active, ids = jops.bin_depos_to_tiles_compact(
            jnp.asarray(w0), jnp.asarray(t0), *bin_args, n_cap)
        ref = jkernel.scatter_add_pallas_compact(
            jnp.asarray(patches), jnp.asarray(w0), jnp.asarray(t0), active,
            ids, interpret=True, **kw)
        out = tkernel.scatter_add_pallas_compact(
            tp, tw0, tt0, torch.from_numpy(np.asarray(active)),
            torch.from_numpy(np.asarray(ids)), **kw)
    assert float(out.sum()) > 0.0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_compact_equals_plain_dense_bitwise(case):
    cfg, tw, tt = CASES[case]
    args = [torch.from_numpy(x) for x in _inputs(cfg, 2)]
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt)
    dense, dropped = tops.scatter_add_tiles(*args, **kw)
    compact, cdropped = tops.scatter_add_tiles_compact(*args, **kw)
    padded, _ = tops.scatter_add_tiles_compact(*args, n_active=10_000, **kw)
    assert int(dropped) == 0 and int(cdropped) == 0
    assert torch.equal(dense, compact) and torch.equal(dense, padded)


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_matches_reference(case, strategy):
    """Each port strategy against the reference's same strategy, at the
    strategies' own tiles and k_max (the interpret-mode reference runs the
    default k_max here)."""
    cfg = CASES[case][0]
    patches, w0, t0 = _inputs(cfg, 3)
    ref = np.asarray(jscatter.STRATEGIES[strategy](
        jnp.asarray(patches), jnp.asarray(w0), jnp.asarray(t0), cfg))
    out, dropped = tscatter.scatter_add(
        *(torch.from_numpy(x) for x in (patches, w0, t0)), _tcfg(cfg),
        strategy=strategy)
    assert int(dropped) == 0
    if strategy.startswith("pallas"):
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        parity.assert_close(out.numpy(), ref, what=strategy)


def test_tile_strategies_widen_tiles_to_the_patch():
    """tw = max(tw, pw), as the reference: a 16-wire tile under 20-wire
    patches still lands every patch whole."""
    cfg = EDGE
    args = [torch.from_numpy(x) for x in _inputs(cfg, 4)]
    expect, _ = tscatter.scatter_add(*args, _tcfg(cfg), strategy="xla")
    for fn in (tops.scatter_add_tiles, tops.scatter_add_tiles_compact):
        out, dropped = fn(*args, num_wires=cfg.num_wires,
                          num_ticks=cfg.num_ticks, tw=16, tt=8)
        assert int(dropped) == 0
        parity.assert_close(out.numpy(), expect.numpy(), what=fn.__name__)


def test_plain_path_adds_in_list_order():
    """The plain version's grid equals a sequential float32 sum (np.add.at)
    of the patches in list order."""
    cfg, tw, tt = CASES["smoke"]
    patches, w0, t0 = _inputs(cfg, 5)
    k_max = tops.default_k_max(cfg.num_depos, cfg.num_wires, cfg.num_ticks,
                               tw, tt)
    tw0, tt0 = torch.from_numpy(w0), torch.from_numpy(t0)
    ids, _, _ = tops.bin_depos_to_tiles(tw0, tt0, cfg.patch_wires,
                                        cfg.patch_ticks, cfg.num_wires,
                                        cfg.num_ticks, tw, tt, k_max)
    tiles_w, tiles_t, n_tiles = tops.tile_counts(cfg.num_wires, cfg.num_ticks,
                                                 tw, tt)
    expect = np.zeros((tiles_w * tw, tiles_t * tt), np.float32)
    lists = ids.numpy().reshape(n_tiles, k_max)
    for rank in range(k_max):
        for tile in range(n_tiles):
            d = lists[tile, rank]
            if d < 0:
                continue
            r0, c0 = (tile // tiles_t) * tw, (tile % tiles_t) * tt
            rows = np.arange(w0[d], w0[d] + cfg.patch_wires)
            cols = np.arange(t0[d], t0[d] + cfg.patch_ticks)
            ri = rows[(rows >= r0) & (rows < r0 + tw)]
            ci = cols[(cols >= c0) & (cols < c0 + tt)]
            np.add.at(expect, (ri[:, None], ci[None, :]),
                      patches[d][np.ix_(ri - w0[d], ci - t0[d])])
    out = tkernel.scatter_add_pallas(torch.from_numpy(patches), tw0, tt0, ids,
                                     num_wires=cfg.num_wires,
                                     num_ticks=cfg.num_ticks, tw=tw, tt=tt,
                                     k_max=k_max)
    np.testing.assert_array_equal(out.numpy(), expect)


def test_compact_blocks_place_into_the_dense_grid():
    cfg, tw, tt = CASES["edge"]
    patches, w0, t0 = (torch.from_numpy(x) for x in _inputs(cfg, 6))
    k_max = 64
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    ids, _, _ = tops.bin_depos_to_tiles(w0, t0, *bin_args)
    tiles_w, tiles_t, n_tiles = tops.tile_counts(cfg.num_wires, cfg.num_ticks,
                                                 tw, tt)
    active, cids, _ = tops.bin_depos_to_tiles_compact(w0, t0, *bin_args,
                                                      n_tiles)
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max)
    blocks = tkernel.scatter_add_pallas_compact(patches, w0, t0, active, cids,
                                                **kw)
    assert bool((blocks[active < 0] == 0).all())
    assert torch.equal(scatter_tiles_to_grid(blocks, active, tiles_w, tiles_t,
                                             tw, tt),
                       tkernel.scatter_add_pallas(patches, w0, t0, ids, **kw))


def _wrapper_args(cfg, tw, tt):
    patches, w0, t0 = (torch.from_numpy(x) for x in _inputs(cfg, 7))
    k_max = tops.default_k_max(cfg.num_depos, cfg.num_wires, cfg.num_ticks,
                               tw, tt)
    ids, _, _ = tops.bin_depos_to_tiles(w0, t0, cfg.patch_wires,
                                        cfg.patch_ticks, cfg.num_wires,
                                        cfg.num_ticks, tw, tt, k_max)
    return [patches, w0, t0, ids], dict(num_wires=cfg.num_wires,
                                        num_ticks=cfg.num_ticks, tw=tw, tt=tt,
                                        k_max=k_max)


def test_cpu_path_does_not_count_launches():
    args, kw = _wrapper_args(*CASES["smoke"])
    tkernel.reset_launches()
    tkernel.scatter_add_pallas(*args, **kw)
    assert tkernel.LAUNCHES == {"scatter_add_pallas": 0,
                                "scatter_add_pallas_compact": 0}


def test_non_cpu_tensors_never_take_the_plain_path():
    """Tensors on another device go to the kernel or raise; here (meta
    device) the wrapper refuses them instead of running the plain version."""
    args, kw = _wrapper_args(*CASES["smoke"])
    with pytest.raises(ValueError, match="unsupported device"):
        tkernel.scatter_add_pallas(*(a.to("meta") for a in args), **kw)


@pytest.mark.parametrize("bad", ["dtype", "rank", "origins", "lists"])
def test_wrapper_rejects_bad_inputs(bad):
    args, kw = _wrapper_args(*CASES["smoke"])
    if bad == "dtype":
        args[0] = args[0].to(torch.float16)
    elif bad == "rank":
        args[0] = args[0].reshape(args[0].shape[0], -1)
    elif bad == "origins":
        args[1] = args[1].long()
    else:
        args[3] = args[3][:-1]
    with pytest.raises(ValueError):
        tkernel.scatter_add_pallas(*args, **kw)


@pytest.mark.parametrize("strategy", ["sort_segment", "pallas",
                                      "pallas_compact"])
def test_unfused_event_matches_reference(strategy):
    """The whole single-plane event with the unfused charge grid and each
    scatter strategy, against the reference's same config."""
    cfg = dataclasses.replace(SMOKE, scatter_strategy=strategy)
    k = jax.random.fold_in(jax.random.key(0), 3)
    d = j_generate(k, cfg)
    ref = j_make_sim_fn(cfg)(k, d)
    out = interop.to_numpy(make_sim_fn(_tcfg(cfg), device="cpu")(
        interop.key_from_data(jax.random.key_data(k)),
        interop.depos_from_numpy(*(np.asarray(x) for x in d), device="cpu")))
    assert int(out["dropped"]) == 0
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_layouts_blocks_and_grid_in_place(case):
    """The compact wrapper's two outputs: ``layout="blocks"`` the
    reference's blocks, ``layout="grid"`` (what the ``pallas_compact``
    strategy runs; written in place on the card) the same blocks placed
    into the padded grid, equal to the dense wrapper's grid bit for bit;
    the blocks are the grid's tiles at ``active`` (how the card returns
    them)."""
    cfg, tw, tt = CASES[case]
    patches, w0, t0 = (torch.from_numpy(x) for x in _inputs(cfg, 8))
    k_max = tops.default_k_max(cfg.num_depos, cfg.num_wires, cfg.num_ticks,
                               tw, tt)
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    ids, _, _ = tops.bin_depos_to_tiles(w0, t0, *bin_args)
    n_cap = tops.active_tile_cap(w0, *bin_args[:-1], t0=t0)
    active, cids, _ = tops.bin_depos_to_tiles_compact(w0, t0, *bin_args,
                                                      n_cap)
    tiles_w, tiles_t, _ = tops.tile_counts(cfg.num_wires, cfg.num_ticks, tw,
                                           tt)
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max)
    blocks = tkernel.scatter_add_pallas_compact(patches, w0, t0, active,
                                                cids, **kw)
    grid = tkernel.scatter_add_pallas_compact(patches, w0, t0, active, cids,
                                              layout="grid", **kw)
    assert blocks.shape == (n_cap, tw, tt)
    assert grid.shape == (tiles_w * tw, tiles_t * tt)
    assert torch.equal(grid, scatter_tiles_to_grid(blocks, active, tiles_w,
                                                   tiles_t, tw, tt))
    assert torch.equal(grid, tkernel.scatter_add_pallas(patches, w0, t0, ids,
                                                        **kw))
    assert torch.equal(tiles_of_grid(grid, active, tiles_w, tiles_t, tw, tt),
                       blocks)
    assert float(grid.sum()) > 0.0
    with pytest.raises(ValueError, match="layout"):
        tkernel.scatter_add_pallas_compact(patches, w0, t0, active, cids,
                                           layout="tiles", **kw)


@pytest.mark.parametrize("tile", [(64, 256), (20, 24)])
def test_tiles_of_grid_takes_each_slots_block_back(tile):
    """``tiles_of_grid`` returns the block of each occupied slot from the
    grid ``scatter_tiles_to_grid`` made, and +0.0 blocks for -1 slots."""
    tw, tt = tile
    tiles_w, tiles_t = 3, 5
    rng = np.random.default_rng(tw)
    active = np.full(10, -1, np.int32)
    active[[0, 2, 3, 6, 7, 9]] = rng.choice(tiles_w * tiles_t, 6,
                                            replace=False)
    blocks = torch.from_numpy(rng.standard_normal((10, tw, tt)).astype(
        np.float32))
    active = torch.from_numpy(active)
    grid = scatter_tiles_to_grid(blocks, active, tiles_w, tiles_t, tw, tt)
    got = tiles_of_grid(grid, active, tiles_w, tiles_t, tw, tt)
    kept = active >= 0
    assert got.shape == blocks.shape
    assert torch.equal(got[kept], blocks[kept])
    assert torch.equal(got[~kept], torch.zeros_like(got[~kept]))
    assert not torch.signbit(got[~kept]).any()


def _full_list_inputs(k_max: int = 48):
    """k_max depos whose patches all touch tile (0, 0) of 64 x 256 tiles
    of the EDGE grid, so that tile's list fills k_max exactly (48: no
    multiple of the kernel's 32-entry chunk)."""
    rng = np.random.default_rng(9)
    w0 = rng.integers(0, 60, k_max).astype(np.int32)
    t0 = rng.integers(0, 250, k_max).astype(np.int32)
    patches = (rng.random((k_max, EDGE.patch_wires, EDGE.patch_ticks))
               * 50).astype(np.float32)
    return patches, w0, t0


@pytest.mark.parametrize("layout", ["dense", "compact"])
def test_list_filling_an_odd_k_max_equals_reference_kernel(layout):
    """A list that fills k_max = 48 (the CUDA kernel reads lists in chunks
    of 32 and must not read past k_max): the plain version == the
    reference's interpret-mode kernel bit for bit."""
    k_max = 48
    patches, w0, t0 = _full_list_inputs(k_max)
    cfg = dataclasses.replace(EDGE, num_depos=k_max)
    tw, tt = 64, 256
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max)
    tp, tw0, tt0 = (torch.from_numpy(x) for x in (patches, w0, t0))
    jp, jw0, jt0 = (jnp.asarray(x) for x in (patches, w0, t0))
    if layout == "dense":
        ids, _, dropped = tops.bin_depos_to_tiles(tw0, tt0, *bin_args)
        ref = jkernel.scatter_add_pallas(jp, jw0, jt0,
                                         jnp.asarray(ids.numpy()),
                                         interpret=True, **kw)
        out = tkernel.scatter_add_pallas(tp, tw0, tt0, ids, **kw)
    else:
        n_cap = tops.active_tile_cap(tw0, *bin_args[:-1], t0=tt0)
        active, ids, dropped = tops.bin_depos_to_tiles_compact(
            tw0, tt0, *bin_args, n_cap)
        ref = jkernel.scatter_add_pallas_compact(
            jp, jw0, jt0, jnp.asarray(active.numpy()),
            jnp.asarray(ids.numpy()), interpret=True, **kw)
        out = tkernel.scatter_add_pallas_compact(tp, tw0, tt0, active, ids,
                                                 **kw)
    assert int(dropped) == 0
    assert int((ids.view(-1, k_max) >= 0).sum(1).max()) == k_max
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("layout", ["dense", "compact"])
@pytest.mark.parametrize("case", sorted(CASES) + ["full-list"])
def test_launch_order_over_scatter_lists(case, layout):
    """The CTA launch order the scatter-add kernel takes from the fused
    kernels' launch-order kernels, over the scatter strategies' own lists:
    a permutation of the slots, longest list first, ties in slot order."""
    from repro_torch.kernels.tiles import launch_order

    if case == "full-list":
        cfg, tw, tt, k_max = (dataclasses.replace(EDGE, num_depos=48), 64,
                              256, 48)
        patches, w0, t0 = (torch.from_numpy(x) for x in _full_list_inputs())
    else:
        cfg, tw, tt = CASES[case]
        patches, w0, t0 = (torch.from_numpy(x) for x in _inputs(cfg, 10))
        k_max = tops.default_k_max(cfg.num_depos, cfg.num_wires,
                                   cfg.num_ticks, tw, tt)
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    if layout == "dense":
        ids, _, _ = tops.bin_depos_to_tiles(w0, t0, *bin_args)
    else:
        n_cap = tops.active_tile_cap(w0, *bin_args[:-1], t0=t0)
        _, ids, _ = tops.bin_depos_to_tiles_compact(w0, t0, *bin_args, n_cap)
    order = launch_order(ids, k_max).tolist()
    n_slots = ids.numel() // k_max
    lengths = (ids.view(n_slots, k_max) >= 0).sum(1).tolist()
    assert sorted(order) == list(range(n_slots))
    keys = [(-lengths[i], i) for i in order]
    assert keys == sorted(keys)
    assert lengths[order[0]] == max(lengths) > 0


def test_c_entry_point_signature_matches_the_binding():
    """ctypes passes what ``SIGNATURES`` declares: one pointer (c_void_p)
    for each pointer parameter of the C function, one c_int for each int."""
    import ctypes
    import re

    from repro_torch import kernels

    src = (kernels.CSRC / kernels.SOURCES["scatter_add"]).read_text()
    for name, argtypes in tkernel.SIGNATURES.items():
        params = re.search(r'extern "C" int ' + name + r"\(([^)]*)\)",
                           src).group(1).split(",")
        assert argtypes == [ctypes.c_void_p if "*" in p else ctypes.c_int
                            for p in params], name


def _bf16_case(case, seed):
    """(config, tw, tt, k_max, bfloat16 patches as a JAX array, w0, t0) of
    a ``CASES`` case or of the list filling k_max = 48."""
    if case == "full-list":
        patches, w0, t0 = _full_list_inputs()
        cfg, tw, tt, k_max = dataclasses.replace(EDGE, num_depos=48), 64, \
            256, 48
    else:
        cfg, tw, tt = CASES[case]
        patches, w0, t0 = _inputs(cfg, seed)
        k_max = _k_max(w0, t0, cfg, tw, tt)
    return cfg, tw, tt, k_max, jnp.asarray(patches).astype(jnp.bfloat16), \
        w0, t0


@pytest.mark.parametrize("layout", ["dense", "blocks", "grid"])
@pytest.mark.parametrize("case", sorted(CASES) + ["full-list"])
def test_plain_kernel_bf16_equals_reference_kernel(case, layout):
    """bfloat16 patches: the plain versions (dense, compact blocks, compact
    written into the grid) == the reference's interpret-mode kernels bit
    for bit, and == the port's own float32 result on the widened
    patches."""
    cfg, tw, tt, k_max, jp, w0, t0 = _bf16_case(case, 11)
    kw = dict(num_wires=cfg.num_wires, num_ticks=cfg.num_ticks, tw=tw, tt=tt,
              k_max=k_max)
    bin_args = (cfg.patch_wires, cfg.patch_ticks, cfg.num_wires,
                cfg.num_ticks, tw, tt, k_max)
    tp = interop.bf16_from_numpy(np.asarray(jp), device="cpu")
    tw0, tt0 = torch.from_numpy(w0), torch.from_numpy(t0)
    jw0, jt0 = jnp.asarray(w0), jnp.asarray(t0)
    if layout == "dense":
        ids, _, dropped = tops.bin_depos_to_tiles(tw0, tt0, *bin_args)
        ref = jkernel.scatter_add_pallas(jp, jw0, jt0,
                                         jnp.asarray(ids.numpy()),
                                         interpret=True, **kw)

        def port(patches):
            return tkernel.scatter_add_pallas(patches, tw0, tt0, ids, **kw)
    else:
        n_cap = tops.active_tile_cap(tw0, *bin_args[:-1], t0=tt0)
        active, ids, dropped = tops.bin_depos_to_tiles_compact(
            tw0, tt0, *bin_args, n_cap)
        ref = jkernel.scatter_add_pallas_compact(
            jp, jw0, jt0, jnp.asarray(active.numpy()),
            jnp.asarray(ids.numpy()), interpret=True, **kw)
        if layout == "grid":
            tiles_w, tiles_t, _ = tops.tile_counts(cfg.num_wires,
                                                   cfg.num_ticks, tw, tt)
            ref = scatter_tiles_to_grid(torch.from_numpy(np.array(ref)),
                                        active, tiles_w, tiles_t, tw, tt)

        def port(patches):
            return tkernel.scatter_add_pallas_compact(
                patches, tw0, tt0, active, ids, layout=layout, **kw)
    out = port(tp)
    assert int(dropped) == 0 and out.dtype == torch.float32
    assert float(out.sum()) > 0.0
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert torch.equal(out, port(tp.to(torch.float32)))


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_strategy_bf16_matches_reference(case, strategy):
    """Each scatter strategy on bfloat16 patches against the reference's
    same strategy: bitwise for the tile kernels, within ``parity`` for the
    library scatters; every strategy returns float32."""
    cfg = CASES[case][0]
    patches, w0, t0 = _inputs(cfg, 12)
    jp = jnp.asarray(patches).astype(jnp.bfloat16)
    ref = np.asarray(jscatter.STRATEGIES[strategy](
        jp, jnp.asarray(w0), jnp.asarray(t0), cfg))
    out, dropped = tscatter.scatter_add(
        interop.bf16_from_numpy(np.asarray(jp), device="cpu"),
        torch.from_numpy(w0), torch.from_numpy(t0), _tcfg(cfg),
        strategy=strategy)
    assert int(dropped) == 0 and out.dtype == torch.float32
    if strategy.startswith("pallas"):
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        parity.assert_close(out.numpy(), ref, what=strategy)


def test_cpu_path_does_not_count_bf16_launches():
    args, kw = _wrapper_args(*CASES["smoke"])
    args[0] = args[0].to(torch.bfloat16)
    tkernel.reset_launches()
    tkernel.scatter_add_pallas(*args, **kw)
    assert set(tkernel.LAUNCHES.values()) == {0}
    assert tkernel.BF16_LAUNCHES == dict.fromkeys(tkernel.LAUNCHES, 0)
