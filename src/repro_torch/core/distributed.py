"""Multi-rank LArTPC simulation on ``torch.distributed``: depo-parallel
rasterisation, a reduce-scatter (or halo) scatter-add and the
pencil-decomposed FFT, the distributed executor of the same stage graph
the single-event and batched paths run (the reference's
``repro.core.distributed``, there a ``shard_map`` over a JAX mesh).

Layout, as in the reference:

  depos        : sharded over every rank (pure data parallelism), one
                 contiguous block a rank (``shard_depos``).
  scatter-add  : ``psum_scatter``: each rank accumulates a partial grid of
                 its depos at the full padded size, then one
                 ``reduce_scatter_tensor`` per mesh axis leaves the summed
                 grid wire-sharded. ``halo``: the depos arrive pre-binned
                 by wire strip (``bin_depos_by_wire``); each rank adds only
                 its strip and a halo margin, sums the margins' strips over
                 the other axes and trades the margins with its ring
                 neighbours (``batch_isend_irecv``).
  FFT          : pencil decomposition: the tick-axis rFFT is wire-local,
                 ``all_to_all_single`` transposes to frequency sharding so
                 the wire-axis FFT is local, multiply by R(w), and back.
  output       : every leaf of the event stays wire-sharded: a rank holds
                 wires ``[flat * w_shard, (flat + 1) * w_shard)`` of the
                 padded grid (``gather_outputs`` assembles the whole).

The mesh is a ``DeviceMesh`` with dimensions ``("data", "model")`` laid out
row-major, so a rank's number within the mesh is its flat shard index
``a * n_model + b`` (``flat_index``): the depo block it owns and the value
its keys fold in. The backend follows the device (NCCL on the card, gloo on
the CPU); the mesh's device type is the device of every tensor here.

Per-shard random streams are the reference's: fluctuation normals from
``fold_in(key, flat)`` (per plane ``fold_in(fold_in(key, index), flat)``)
over the shard's own patch shape; noise from ``fold_in(key, 77 + flat)``
(per plane then ``fold_in(., index)``) over the shard's ``w_shard`` wires.
The collectives sum in their own order, not XLA's: grids agree with the
reference within ``testing.parity``'s float tolerances, the ADC within its
+-1-count rule.

Every stage runs one plane per FFT call (a batched transform is not the
one-plane call's bits on the CPU), so ``plane_batching`` ``stacked`` and
``loop`` differ only in their collectives: one chain for all planes, or
one per plane.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.config import LArTPCConfig, plane_specs
from repro_torch.core import fluctuate as fl
from repro_torch.core import prng
from repro_torch.core.depo import DepoSet
from repro_torch.core.hitfind import HitSet, find_hits, stack_hits
from repro_torch.core.noise import noise_spectrum, sample_noise_planes
from repro_torch.core.rasterize import rasterize
from repro_torch.core.scatter import scatter_add
from repro_torch.core.stages import (SimOutput, SimState, build_sim_graph,
                                     resolve_plane_batching)
from repro_torch.device import resolve_device, scalar

#: the mesh's dimension names, in the reference's order
AXES = ("data", "model")
#: the noise stream's fold-in offset (``fold_in(key, 77 + flat)``)
NOISE_FOLD = 77
#: the tensor collectives under their current names (torch 2.13 renamed
#: ``reduce_scatter_tensor`` and ``all_gather_into_tensor``)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor
_all_gather = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_grid_shape(cfg: LArTPCConfig, nshards: int):
    """(W_pad, T, F_pad): the wire axis divisible by ``nshards``, the rFFT
    frequency axis too."""
    w_pad = _round_up(cfg.num_wires, nshards)
    nfreq = cfg.num_ticks // 2 + 1
    return w_pad, cfg.num_ticks, _round_up(nfreq, nshards)


def backend_for(device) -> str:
    """The collective backend of ``device``: NCCL on the card, gloo on the
    CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def mesh_device(mesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return resolve_device(torch.device("cuda",
                                           torch.cuda.current_device()))
    return resolve_device(mesh.device_type)


def _size(mesh, axis: str) -> int:
    return mesh.size(mesh.mesh_dim_names.index(axis))


def num_shards(mesh, axes: Sequence[str] = AXES) -> int:
    n = 1
    for a in axes:
        n *= _size(mesh, a)
    return n


def flat_index(mesh, axes: Sequence[str] = AXES) -> int:
    """This rank's linear index within the ``axes`` group (axes-major)."""
    idx = 0
    for a in axes:
        idx = idx * _size(mesh, a) + mesh.get_local_rank(a)
    return idx


def _reduce_partials(partial: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Reduce-scatter the wire axis (-2) of (..., W_pad, T) partials over
    every shard: one ``reduce_scatter_tensor`` per mesh axis, in axis order,
    whatever leads the wire axis. Wire ownership comes out flat and
    axes-major."""
    lead, t_len = partial.shape[:-2], partial.shape[-1]
    for a in axes:
        na = _size(mesh, a)
        blocks = partial.reshape(*lead, na, partial.shape[-2] // na,
                                 t_len).movedim(-3, 0).contiguous()
        out = torch.empty(blocks.shape[1:], dtype=blocks.dtype,
                          device=blocks.device)
        _reduce_scatter(out.view(-1), blocks.view(-1),
                                   group=mesh.get_group(a))
        partial = out
    return partial


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """``all_to_all`` of the leading axis (one block per group member),
    complex values carried as their float pairs."""
    cplx = x.is_complex()
    src = (torch.view_as_real(x) if cplx else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return torch.view_as_complex(out) if cplx else out


def _all_to_all_chain(blk: torch.Tensor, axes, mesh) -> torch.Tensor:
    """``all_to_all`` over one or two mesh axes treated as one group; blk
    (nshards, ...): the leading axis is split over the group and the blocks
    received concatenate in flat shard order."""
    if len(axes) == 1:
        return _all_to_all(blk, mesh.get_group(axes[0]))
    a, b = axes
    na, nb = _size(mesh, a), _size(mesh, b)
    rest = blk.shape[1:]
    x = _all_to_all(blk.reshape(na, nb, *rest), mesh.get_group(a))
    x = x.transpose(0, 1).reshape(nb, na, *rest)
    x = _all_to_all(x, mesh.get_group(b))
    return x.transpose(0, 1).reshape(na * nb, *rest)


def _halo_exchange(strip: torch.Tensor, w_strip: int, halo: int, axis: str,
                   mesh) -> torch.Tensor:
    """Add each strip's halo overhangs into its ring neighbours' strips
    (the reference's ``ppermute`` pair) and return the owned (...,
    w_strip, T) region. strip: (..., w_strip + 2 * halo, T).

    A ring of one adds its overhangs back into itself, cyclically, by a
    local copy (``torch.distributed`` refuses a send to oneself); in a ring
    of two both neighbours are one peer, and the tags keep the two
    messages apart."""
    lo = strip[..., :halo, :].contiguous()    # belongs to the left neighbour
    hi = strip[..., -halo:, :].contiguous()   # belongs to the right one
    group = mesh.get_group(axis)
    ranks = dist.get_process_group_ranks(group)
    n, me = len(ranks), mesh.get_local_rank(axis)
    if n == 1:
        from_left, from_right = hi, lo
    else:
        left, right = ranks[(me - 1) % n], ranks[(me + 1) % n]
        from_left, from_right = torch.empty_like(hi), torch.empty_like(lo)
        ops = [dist.P2POp(dist.isend, hi, right, group, tag=0),
               dist.P2POp(dist.isend, lo, left, group, tag=1),
               dist.P2POp(dist.irecv, from_left, left, group, tag=0),
               dist.P2POp(dist.irecv, from_right, right, group, tag=1)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    own = strip[..., halo:halo + w_strip, :].clone()
    own[..., :halo, :] += from_left
    own[..., -halo:, :] += from_right
    return own


def _scatter_partial_full(patches, w0, t0, w_pad: int, t_len: int,
                          cfg: LArTPCConfig) -> torch.Tensor:
    """This rank's patches scatter-added into a full padded grid
    (``index_put_(accumulate=True)``, the reference's ``"xla"``)."""
    cfg2 = dataclasses.replace(cfg, num_wires=w_pad, num_ticks=t_len)
    return scatter_add(patches, w0, t0, cfg2, strategy="xla")[0]


def _scatter_local_strip(patches, w0, t0, lo: int, w_strip: int, halo: int,
                         t_len: int) -> torch.Tensor:
    """Scatter-add into the wire strip ``[lo - halo, lo + w_strip + halo)``;
    pixels outside it are dropped."""
    strip_w = w_strip + 2 * halo
    dev = patches.device
    _, pw, pt = patches.shape
    wi = ((w0.long() - (lo - halo))[:, None, None]
          + torch.arange(pw, device=dev)[None, :, None])
    ti = t0.long()[:, None, None] + torch.arange(pt, device=dev)[None, None, :]
    inb = (wi >= 0) & (wi < strip_w)
    flat = (torch.where(inb, wi, 0) * t_len + ti).reshape(-1)
    vals = torch.where(inb, patches, torch.zeros_like(patches)).reshape(-1)
    grid = torch.zeros(strip_w * t_len, dtype=patches.dtype, device=dev)
    grid.index_put_((flat,), vals, accumulate=True)
    return grid.reshape(strip_w, t_len)


def bin_depos_by_wire(depos: DepoSet, n_strips: int, w_pad: int) -> DepoSet:
    """Host-side pre-binning for the halo reduction: the depos sorted by
    wire strip and each strip's bucket padded to one count (zero-charge
    filler at the strip's centre), so strip s of the first mesh axis
    receives exactly the depos that touch it. A (P, N) DepoSet bins each
    plane by its own wire coordinate, with one bucket capacity over every
    plane and strip, so a depo-axis shard carries strip s of every plane.
    Returns float32 tensors on the input's device."""
    wires = depos.wire.cpu().numpy()
    multi = wires.ndim == 2
    wires = np.atleast_2d(wires)
    strip_w = w_pad // n_strips
    plane_buckets = []
    cap = 1
    for wrow in wires:
        strip = np.clip((wrow // strip_w).astype(np.int64), 0, n_strips - 1)
        buckets = [np.nonzero(strip == s)[0] for s in range(n_strips)]
        cap = max(cap, max(len(b) for b in buckets))
        plane_buckets.append(buckets)
    n_out = cap * n_strips
    rows = []
    for buckets in plane_buckets:
        idx = np.zeros(n_out, np.int64)
        valid = np.zeros(n_out, bool)
        for s, b in enumerate(buckets):
            idx[s * cap:s * cap + len(b)] = b
            valid[s * cap:s * cap + len(b)] = True
        rows.append((idx, valid))
    center = np.array([s * strip_w + strip_w // 2 for s in range(n_strips)],
                      np.float32)
    fill_wire = np.repeat(center, cap)

    def take(x, fill):
        arr = np.atleast_2d(x.cpu().numpy())
        out = np.stack([np.where(valid, arr[p][idx], fill).astype(np.float32)
                        for p, (idx, valid) in enumerate(rows)])
        return torch.from_numpy(out if multi else out[0]).to(x.device)

    return DepoSet(wire=take(depos.wire, fill_wire),
                   tick=take(depos.tick, 100.0),
                   sigma_w=take(depos.sigma_w, 1.0),
                   sigma_t=take(depos.sigma_t, 1.0),
                   charge=take(depos.charge, 0.0))


def shard_depos(depos, mesh, axes: Sequence[str] = AXES):
    """This rank's block of ``depos``: the depo axis padded to a multiple of
    the shard count, then the rank's contiguous block (block ``flat_index``)
    on its device. A ``DepoSet`` pads with zero charge and unit sigmas (no
    0/0 in the Gaussian edges), a ``PhysicalDepoSet`` with zeros (q = 0 is
    inert); a (P, N) DepoSet (multi-plane halo input) pads and splits its
    last axis and keeps every plane."""
    nshards = num_shards(mesh, axes)
    n = depos[0].shape[-1]
    n_pad = _round_up(n, nshards)
    block = n_pad // nshards
    lo = flat_index(mesh, axes) * block
    dev = mesh_device(mesh)
    fills = dict.fromkeys(type(depos)._fields, 0.0)
    if isinstance(depos, DepoSet):
        fills.update(sigma_w=1.0, sigma_t=1.0)

    def part(x, fill):
        x = torch.nn.functional.pad(x.to(dev), (0, n_pad - n), value=fill)
        return x[..., lo:lo + block].contiguous()

    return type(depos)(*(part(x, fills[f])
                         for f, x in zip(type(depos)._fields, depos)))


def make_distributed_sim(mesh, cfg: LArTPCConfig, resp,
                         axes: Sequence[str] = AXES,
                         scatter_reduction: str = "psum_scatter",
                         add_noise: bool = True, recon: bool = False,
                         device=None):
    """The distributed event on ``mesh``: ``run(key, depos) -> SimOutput``
    of this rank's wire shard, ``depos`` its block (``shard_depos``).

    ``resp`` is the response at the distributed (W_pad, T) shape
    (``make_distributed_response``, or one per plane:
    ``make_distributed_plane_responses``). Multi-plane configs take
    physical depos (the stock drift stage projects them onto every plane)
    and carry a leading plane axis on every leaf; multi-plane ``halo``
    takes a pre-drifted (P, N) DepoSet binned per plane and needs
    ``plane_batching="stacked"``.

    The graph is ``build_sim_graph``'s, with collective-aware
    ``charge_grid``, ``convolve``, ``noise`` and, with ``recon``,
    ``deconvolve`` and ``hit_find`` stages swapped in: deconvolution rides
    the same pencil FFT; each shard scans its own wires (padding wires
    zeroed) with a capacity of ceil(max_hits / nshards) and its global wire
    offset, so its HitSet holds its own hits and ``n_hits`` its own count.

    scatter_reduction:
      psum_scatter : each rank scatter-adds its depos into a full-size
                     partial grid; one reduce-scatter per mesh axis leaves
                     it wire-sharded. Moves O(W_pad * T) bytes a rank.
      halo         : the depos arrive binned by wire strip over the FIRST
                     axis (``bin_depos_by_wire``); each rank adds only its
                     strip and margins, sums over the other axes and trades
                     the margins with its ring neighbours. Moves
                     O(W_pad * T / nshards) bytes a rank.

    ``device`` defaults to the mesh's (``mesh_device``); another raises.
    """
    axes = tuple(axes)
    dev = mesh_device(mesh)
    if device is not None:
        want = torch.device(device)
        if want.type != dev.type or want.index not in (None, dev.index):
            raise ValueError(f"device {want} is not the mesh's device {dev}")
    if scatter_reduction not in ("psum_scatter", "halo"):
        raise ValueError(f"unknown scatter_reduction {scatter_reduction!r}; "
                         "expected 'psum_scatter' or 'halo'")
    specs = plane_specs(cfg)
    multi = cfg.num_planes > 1
    stacked = multi and resolve_plane_batching(cfg) == "stacked"
    halo_mode = scatter_reduction == "halo"
    if multi and halo_mode and not stacked:
        raise ValueError(
            "multi-plane scatter_reduction='halo' requires "
            "plane_batching='stacked': the loop path pre-bins depos by ONE "
            "wire coordinate, but every plane projects its own; the "
            "stacked path takes a (num_planes, N) DepoSet pre-binned per "
            "plane-projected wire (bin_depos_by_wire)")
    resps = tuple(resp) if multi else (resp,)
    if len(resps) != len(specs):
        raise ValueError(f"got {len(resps)} responses for {len(specs)} "
                         "planes")
    nshards = num_shards(mesh, axes)
    me = flat_index(mesh, axes)
    # strips live on the FIRST axis, so strip-major wire ownership matches
    # the flat (axes-major) ownership of the pencil FFT
    halo_axis = axes[0]
    n_halo = _size(mesh, halo_axis)
    if halo_mode:
        w_pad, t_len, f_pad = padded_grid_shape(cfg, max(nshards, n_halo))
        w_strip = w_pad // n_halo
        halo = cfg.patch_wires
        if w_strip < halo:
            raise ValueError(f"halo strategy needs strip {w_strip} >= patch "
                             f"{halo}")
    else:
        w_pad, t_len, f_pad = padded_grid_shape(cfg, nshards)
    if any(r.freq.shape[0] != w_pad for r in resps):
        raise ValueError(f"responses at {[tuple(r.pad_shape) for r in resps]}"
                         f", the distributed grid is ({w_pad}, {t_len})")
    nfreq = t_len // 2 + 1
    w_shard = w_pad // nshards
    f_shard = f_pad // nshards

    def pad_freq(freq):
        out = torch.zeros((w_pad, f_pad), dtype=torch.complex64, device=dev)
        out[:, :nfreq] = freq.to(dev)
        return out

    rfreqs = torch.stack([pad_freq(r.freq) for r in resps])  # (P, w, f)
    namp = noise_spectrum(cfg, device=dev)

    def rasterize_fluct(depos: DepoSet, base_key):
        patches, w0, t0 = rasterize(depos, cfg)
        if cfg.fluctuate and cfg.rng_strategy != "none":
            patches = fl.fluctuate_counter(prng.fold_in(base_key, me),
                                           patches, depos.charge)
        return patches, w0, t0

    def local_grid(patches, w0, t0):
        if halo_mode:
            return _scatter_local_strip(patches, w0, t0,
                                        mesh.get_local_rank(halo_axis)
                                        * w_strip, w_strip, halo, t_len)
        return _scatter_partial_full(patches, w0, t0, w_pad, t_len, cfg)

    def reduce_strips(strip):
        for a in axes[1:]:
            strip = strip.contiguous()
            dist.all_reduce(strip, group=mesh.get_group(a))
        own = _halo_exchange(strip, w_strip, halo, halo_axis, mesh)
        if w_shard == w_strip:
            return own
        # my (finer) w_shard piece of the strip
        sub = flat_index(mesh, axes[1:])
        return own[..., sub * w_shard:(sub + 1) * w_shard, :].contiguous()

    reduce = reduce_strips if halo_mode else (
        lambda partial: _reduce_partials(partial, axes, mesh))

    def dist_charge_grid(state: SimState) -> SimState:
        if not multi:
            grid = reduce(local_grid(*rasterize_fluct(state.depos,
                                                      state.key)))
            return state._replace(grid=grid)
        # per-plane rasterisation and fluctuation with plane-folded keys;
        # stacked batches the collectives over the planes
        locals_ = [local_grid(*rasterize_fluct(
            DepoSet(*(x[i] for x in state.depos)),
            prng.fold_in(state.key, spec.index)))
            for i, spec in enumerate(specs)]
        if stacked:
            return state._replace(grid=reduce(torch.stack(locals_)))
        return state._replace(grid=torch.stack([reduce(g) for g in locals_]))

    def pencil(x, freq_pad):
        """x (P, w_shard, T) wire-local -> x convolved with the spectra
        freq_pad (P, W_pad, F_pad): ONE all_to_all chain each way for
        every plane, one FFT call per plane."""
        n_planes = x.shape[0]
        freq_t = torch.zeros((n_planes, w_shard, f_pad),
                             dtype=torch.complex64, device=dev)
        for p in range(n_planes):
            freq_t[p, :, :nfreq] = torch.fft.rfft(x[p], dim=-1)
        blk = freq_t.reshape(n_planes, w_shard, nshards, f_shard)
        blk = _all_to_all_chain(blk.movedim(2, 0), axes, mesh)
        cols = blk.transpose(0, 1).reshape(n_planes, w_pad, f_shard)
        rcols = freq_pad[:, :, me * f_shard:(me + 1) * f_shard]
        out = torch.stack([torch.fft.ifft(torch.fft.fft(cols[p], dim=0)
                                          * rcols[p], dim=0)
                           for p in range(n_planes)])
        blk = out.reshape(n_planes, nshards, w_shard, f_shard).transpose(0, 1)
        blk = _all_to_all_chain(blk, axes, mesh)
        freq_t = blk.movedim(0, 2).reshape(n_planes, w_shard,
                                           f_pad)[..., :nfreq]
        return torch.stack([torch.fft.irfft(freq_t[p], n=t_len, dim=-1)
                            for p in range(n_planes)]).to(torch.float32)

    def apply_spectra(x, freqs):
        """One plane (w_shard, T), or P planes through one chain (stacked)
        or one chain each (loop)."""
        if not multi:
            return pencil(x[None], freqs)[0]
        if stacked:
            return pencil(x, freqs)
        return torch.stack([pencil(x[i:i + 1], freqs[i:i + 1])[0]
                            for i in range(len(specs))])

    def dist_convolve(state: SimState) -> SimState:
        return state._replace(signal=apply_spectra(state.grid, rfreqs))

    def dist_noise(state: SimState) -> SimState:
        kn = prng.fold_in(state.key, NOISE_FOLD + me)
        keys = [prng.fold_in(kn, spec.index) for spec in specs] if multi \
            else [kn]
        noise = sample_noise_planes(keys, w_shard, namp, t_len)
        if not multi:
            noise = noise[0]
        denom = torch.clamp_min(scalar(cfg.adc_per_electron, noise), 1e-30)
        return state._replace(signal=state.signal + noise / denom)

    overrides = {"charge_grid": dist_charge_grid, "convolve": dist_convolve}
    if add_noise:
        overrides["noise"] = dist_noise

    if recon:
        from repro_torch.core.deconvolve import (make_deconv_filter,
                                                 measured_signal)

        gfreqs = torch.stack([pad_freq(make_deconv_filter(r, cfg).freq)
                              for r in resps])
        cap_shard = -(-cfg.max_hits // nshards)
        off = me * w_shard
        # the wire axis is padded to W_pad: zero the padding wires so their
        # waveforms cannot fire hits
        real = (off + torch.arange(w_shard, device=dev)
                < cfg.num_wires)[:, None]

        def dist_deconvolve(state: SimState) -> SimState:
            return state._replace(decon=apply_spectra(
                measured_signal(state.adc, cfg), gfreqs))

        def hits_one(decon_local) -> HitSet:
            masked = torch.where(real, decon_local,
                                 torch.zeros_like(decon_local))
            return find_hits(masked, cfg, cfg.hitfind_strategy,
                             wire_offset=off, max_hits=cap_shard)

        def dist_hit_find(state: SimState) -> SimState:
            if not multi:
                return state._replace(hits=hits_one(state.decon))
            return state._replace(hits=stack_hits(
                hits_one(state.decon[i]) for i in range(len(specs))))

        overrides["deconvolve"] = dist_deconvolve
        overrides["hit_find"] = dist_hit_find

    graph = build_sim_graph(cfg, resps if multi else resp,
                            add_noise=add_noise, device=dev,
                            recon=recon).replace(**overrides)

    def run(key: torch.Tensor, depos) -> SimOutput:
        return graph.run(key, depos)

    return run


def _gather_flat(x: torch.Tensor, axes, mesh) -> torch.Tensor:
    """Every shard's ``x`` stacked along a new leading axis in flat shard
    order: one ``all_gather_into_tensor`` per mesh axis, the last axis
    first. Types the backends do not carry (bool, int16) travel widened."""
    dtype = x.dtype
    carry = {torch.bool: torch.uint8, torch.int16: torch.int32}.get(dtype,
                                                                   dtype)
    flat = x.to(carry).reshape(-1).contiguous()
    for a in reversed(axes):
        out = torch.empty(_size(mesh, a) * flat.numel(), dtype=carry,
                          device=flat.device)
        _all_gather(out, flat, group=mesh.get_group(a))
        flat = out
    return flat.reshape((num_shards(mesh, axes),) + tuple(x.shape)).to(dtype)


def gather_outputs(out: SimOutput, mesh,
                   axes: Sequence[str] = AXES) -> SimOutput:
    """The whole event from every rank's shard, on every rank: each grid
    leaf (..., W_pad, T) gathered along its wire axis, the HitSets
    concatenated along the capacity axis in shard order with ``n_hits``
    summed over the shards (the reference's outputs as ``np.asarray``
    reads them), ``finite_ok`` the AND of the shards'."""
    axes = tuple(axes)

    def wires(x):
        if x is None:
            return None
        g = _gather_flat(x, axes, mesh).movedim(0, -3)
        return g.reshape(*g.shape[:-3], -1, g.shape[-1])

    hits = None
    if out.hits is not None:
        leaves = []
        for f, x in zip(HitSet._fields, out.hits):
            g = _gather_flat(x, axes, mesh)
            if f == "n_hits":
                leaves.append(g.sum(0).to(x.dtype))
            else:
                g = g.movedim(0, -2)
                leaves.append(g.reshape(*g.shape[:-2], -1))
        hits = HitSet(*leaves)
    finite = (None if out.finite_ok is None
              else _gather_flat(out.finite_ok, axes, mesh).all())
    return SimOutput(adc=wires(out.adc), signal=wires(out.signal),
                     charge_grid=wires(out.charge_grid), dropped=None,
                     decon=wires(out.decon), hits=hits, finite_ok=finite)
