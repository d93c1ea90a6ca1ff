"""The port's distributed executor (``repro_torch.core.distributed``) on gloo
ranks against the live reference ``make_distributed_sim`` on 8 forced host
devices, on the CPU.

One subprocess runs the reference at mesh (4, 2) (and at (2, 1) and (1, 1)
for two cases) and writes its inputs and outputs; one spawn of 8 gloo
ranks (``repro_torch.testing.ranks``) runs the port on the same depos and
keys at the same meshes, the (2, 1) and (1, 1) runs on the first ranks.
Cases, at the reference tests' size (128 wires x 512 ticks, 256 depos),
from key 12, whose track crosses every strip edge of the rings of 4 and 2
on one plane and on planes 0 and 2 (the reference tests' key 0 puts every
depo inside the last strip, so their halo exchange carries no charge):

  a  one plane, psum_scatter, noise and fluctuation off
  b  one plane, halo on bin_depos_by_wire depos, noise and fluctuation off
  c  one plane, psum_scatter, noise and fluctuation on
  d  three planes, stacked psum_scatter, noise and fluctuation on
  e  three planes, loop psum_scatter, noise and fluctuation on
  f  three planes, stacked halo on per-plane binned (P, N) depos, noise and
     fluctuation on
  g  one plane with recon, psum_scatter (the reference recon test's event)
  h  three stacked planes with recon, psum_scatter

Every ADC holds the reference's under ``parity``'s +-1-count rule, grids
and deconvolved charge within its float tolerances, and hits are the same
set with values within ``parity.HIT_RTOL`` (a wire whose hits differ must
hold a sample within the decon tolerance of the threshold, as in
``tests/test_torch_recon.py``: the reference test's rounding rule, ticks to
3 and charges to 1 decimal, splits values that differ by float ULPs); the
stored count and ``n_hits`` are equal. The collectives sum in their own
order, so nothing here is held bit for bit against the reference.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core import distributed as jdist
from repro.core.depo import generate_depos as j_generate
from repro.core.response import (
    make_distributed_plane_responses as j_plane_responses)
from repro.core.response import make_distributed_response as j_response
from repro_torch import interop
from repro_torch.core import batch as tbatch
from repro_torch.core import distributed as tdist
from repro_torch.core.depo import DepoSet
from repro_torch.core.response import (make_distributed_plane_responses,
                                       make_distributed_response)
from repro_torch.launch import distributed as launcher
from repro_torch.launch import fit as fit_launcher
from repro_torch.testing import parity
from repro_torch.testing.ranks import run_ranks

pytestmark = pytest.mark.subprocess

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent

#: the reference distributed tests' config
CFG = JaxConfig(num_wires=128, num_ticks=512, num_depos=256,
                response_wires=11, response_ticks=64)
CFG3 = dataclasses.replace(CFG, num_planes=3)
MESH = (4, 2)
#: name -> (planes and batching, reduction, noise and fluctuation, recon,
#: mesh)
CASES = {
    "a": ("one", "psum_scatter", False, False, MESH),
    "b": ("one", "halo", False, False, MESH),
    "c": ("one", "psum_scatter", True, False, MESH),
    "d": ("stacked", "psum_scatter", True, False, MESH),
    "e": ("loop", "psum_scatter", True, False, MESH),
    "f": ("stacked", "halo", True, False, MESH),
    "g": ("one", "psum_scatter", False, True, MESH),
    "h": ("stacked", "psum_scatter", False, True, MESH),
    "b21": ("one", "halo", False, False, (2, 1)),
    "c21": ("one", "psum_scatter", True, False, (2, 1)),
    "b11": ("one", "halo", False, False, (1, 1)),
    "c11": ("one", "psum_scatter", True, False, (1, 1)),
}

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json
import jax, numpy as np
from repro.config import LArTPCConfig
from repro.core.depo import (generate_depos, generate_physical_depos,
                             generate_plane_depos)
from repro.core.distributed import (bin_depos_by_wire, make_distributed_sim,
                                    padded_grid_shape, shard_depos)
from repro.core.fft_conv import digitize
from repro.core.rasterize import rasterize
from repro.core.response import (make_distributed_plane_responses,
                                 make_distributed_response)
from repro.core.scatter import scatter_xla

out_path, cases = sys.argv[1], json.loads(sys.argv[2])
cfg = LArTPCConfig(num_wires=128, num_ticks=512, num_depos=256,
                   response_wires=11, response_ticks=64)
cfg3 = dataclasses.replace(cfg, num_planes=3)
key = jax.random.key(12)
k1 = jax.random.fold_in(key, 1)
inputs = {"detector": generate_depos(key, cfg),
          "physical": generate_physical_depos(key, cfg3),
          "planes": generate_plane_depos(key, cfg3),
          "recon_detector": generate_depos(k1, cfg),
          "recon_physical": generate_physical_depos(k1, cfg3)}
res = {"key": np.asarray(jax.random.key_data(key))}
for name, d in inputs.items():
    for i, x in enumerate(d):
        res[f"in/{name}/{i}"] = np.asarray(x)

for name, (mode, reduction, noisy, recon, shape) in cases.items():
    c = cfg if mode == "one" else dataclasses.replace(
        cfg3, plane_batching=mode)
    c = dataclasses.replace(c, fluctuate=noisy)
    mesh = jax.make_mesh(tuple(shape), ("data", "model"))
    n = shape[0] * shape[1]
    kind = (("recon_" if recon else "")
            + ("detector" if mode == "one" else
               "planes" if reduction == "halo" else "physical"))
    depos = inputs[kind]
    if reduction == "halo":
        w_pad = padded_grid_shape(c, max(n, shape[0]))[0]
        depos = bin_depos_by_wire(depos, n_strips=shape[0], w_pad=w_pad)
        for i, x in enumerate(depos):
            res[f"{name}/binned/{i}"] = np.asarray(x)
    else:
        w_pad = padded_grid_shape(c, n)[0]
    resp = (make_distributed_plane_responses(c, w_pad) if c.num_planes > 1
            else make_distributed_response(c, w_pad))
    sd = shard_depos(depos, mesh)
    for i, x in enumerate(sd):
        res[f"{name}/sharded/{i}"] = np.asarray(x)
    sim = make_distributed_sim(mesh, c, resp, scatter_reduction=reduction,
                               add_noise=noisy, recon=recon)
    out = sim(key, sd)
    if recon:
        adc, decon, hits = out
        res[f"{name}/decon"] = np.asarray(decon)
        for f, x in zip(hits._fields, hits):
            res[f"{name}/hits.{f}"] = np.asarray(x)
    else:
        adc = out
    res[f"{name}/adc"] = np.asarray(adc)
    res[f"{name}/kind"] = np.asarray(kind)

# the reference test's single-device cyclic construction of case a
import jax.numpy as jnp
d = inputs["detector"]
c = dataclasses.replace(cfg, fluctuate=False)
w_pad = padded_grid_shape(c, 8)[0]
patches, w0, t0 = rasterize(d, c)
grid = scatter_xla(patches, w0, t0, c)
gpad = jnp.zeros((w_pad, c.num_ticks)).at[:c.num_wires].set(grid)
sig = jnp.fft.irfft2(jnp.fft.rfft2(gpad) * make_distributed_response(
    c, w_pad).freq, s=(w_pad, c.num_ticks))[:c.num_wires]
res["cyclic/grid"] = np.asarray(grid)
res["cyclic/adc"] = np.asarray(digitize(sig.astype(jnp.float32), c))
np.savez(out_path, **res)
print("RESULTS_WRITTEN")
"""


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own (the spawned ranks inherit the variable)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield


def _case_config(name):
    mode, _, noisy, _, _ = CASES[name]
    cfg = CFG if mode == "one" else dataclasses.replace(CFG3,
                                                        plane_batching=mode)
    return dataclasses.replace(cfg, fluctuate=noisy)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's inputs and outputs of every case (one subprocess)."""
    path = tmp_path_factory.mktemp("dist_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH="src", JAX_PLATFORMS="cpu")
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT, str(path), json.dumps(CASES)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _inputs(ref, kind):
    return tuple(ref[f"in/{kind}/{i}"] for i in range(5))


@pytest.fixture(scope="module")
def port(ref, tmp_path_factory):
    """The port's outputs of every case: one spawn of 8 gloo ranks, rank 0's
    gathered outputs."""
    cases = []
    for name, (mode, reduction, noisy, recon, shape) in CASES.items():
        kind = str(ref[f"{name}/kind"])
        cases.append({
            "name": name,
            "cfg": interop.config_from_dict(dataclasses.asdict(
                _case_config(name))),
            "key": ref["key"],
            "depos": ("physical" if kind.endswith("physical") else kind,
                      _inputs(ref, kind)),
            "scatter_reduction": reduction, "add_noise": noisy,
            "recon": recon, "mesh": None if shape == MESH else shape})
    tmp = tmp_path_factory.mktemp("dist_port")
    return run_ranks(launcher.run_cases, 8, MESH, "gloo", tmp, cases)[0]


class FakeMesh:
    """The ``DeviceMesh`` surface the sharding helpers read, for one rank of
    a (data, model) mesh, without a process group."""

    mesh_dim_names = tdist.AXES
    device_type = "cpu"

    def __init__(self, shape, flat):
        self.shape = tuple(shape)
        self.coords = (flat // shape[1], flat % shape[1])

    def size(self, dim):
        return self.shape[dim]

    def get_local_rank(self, name):
        return self.coords[self.mesh_dim_names.index(name)]


# ---------------------------------------------------------------------------
# Shapes, binning, sharding and responses, in process
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nshards", [1, 2, 3, 7, 8, 16])
def test_padded_grid_shape_matches_reference(nshards):
    for cfg in (CFG, dataclasses.replace(CFG, num_wires=2560,
                                         num_ticks=9592)):
        tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
        assert tdist.padded_grid_shape(tcfg, nshards) == \
            jdist.padded_grid_shape(cfg, nshards)


@pytest.mark.parametrize("n_strips", [1, 2, 4])
def test_bin_depos_by_wire_matches_reference(n_strips):
    depos = j_generate(jax.random.key(5), CFG)
    planes = jax.tree.map(lambda x: np.stack([np.asarray(x), np.asarray(x)
                                              [::-1]]), depos)
    for d in (depos, planes):
        want = jdist.bin_depos_by_wire(d, n_strips, 128)
        got = tdist.bin_depos_by_wire(
            interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                     device="cpu"), n_strips, 128)
        for f, a, b in zip(DepoSet._fields, got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), f)


def test_shard_depos_padding_and_blocks_match_reference(ref):
    """Every rank's block of the port, in flat order, is the reference's
    padded sharded array (a 256-depo event over 8 shards and, binned, over
    (2, 1); three planes physical and (P, N) binned)."""
    for name in ("a", "b21", "d", "f", "c11"):
        shape = CASES[name][4]
        n = shape[0] * shape[1]
        kind = str(ref[f"{name}/kind"])
        arrays = (tuple(ref[f"{name}/binned/{i}"] for i in range(5))
                  if f"{name}/binned/0" in ref else _inputs(ref, kind))
        depos = (interop.physical_depos_from_numpy if kind.endswith(
            "physical") else interop.depos_from_numpy)(*arrays, device="cpu")
        blocks = [tdist.shard_depos(depos, FakeMesh(shape, r))
                  for r in range(n)]
        for i in range(5):
            got = torch.cat([b[i] for b in blocks], dim=-1).numpy()
            np.testing.assert_array_equal(got, ref[f"{name}/sharded/{i}"],
                                          f"{name} leaf {i}")


@pytest.mark.parametrize("planes", [1, 3])
def test_distributed_responses_match_reference(planes):
    cfg = CFG3 if planes == 3 else CFG
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    for w_pad in (128, 136):
        if planes == 1:
            want = (j_response(cfg, w_pad),)
            got = (make_distributed_response(tcfg, w_pad, device="cpu"),)
        else:
            want = j_plane_responses(cfg, w_pad)
            got = make_distributed_plane_responses(tcfg, w_pad,
                                                   device="cpu")
        assert len(got) == len(want) == planes
        for a, b in zip(got, want):
            assert a.pad_shape == tuple(b.pad_shape) == (w_pad, 512)
            assert a.plane == b.plane
            parity.assert_close(a.freq.numpy(), np.asarray(b.freq),
                                what=f"response {b.plane} w_pad {w_pad}")
            parity.assert_close(a.kernel.numpy(), np.asarray(b.kernel))


@pytest.mark.parametrize("mesh", [None, (4, 2), (3, 1)])
def test_shard_events_splits_and_pads_the_event_axis(mesh):
    events = [DepoSet(*(torch.full((n,), float(e + 1)) for _ in range(5)))
              for e, n in enumerate([5, 3, 7, 2, 6])]
    batch = tbatch.pack_events(events)
    if mesh is None:
        out = tbatch.shard_events(batch, "cpu")
        assert all(torch.equal(a, b) for a, b in zip(out, batch))
        return
    n = mesh[0] * mesh[1]
    per = -(-5 // n)
    parts = [tbatch.shard_events(batch, "cpu", FakeMesh(mesh, r))
             for r in range(n)]
    assert all(p.num_events == per for p in parts)
    assert torch.cat([p.n_depos for p in parts]).tolist() == \
        [5, 3, 7, 2, 6] + [0] * (n * per - 5)
    empty = tbatch.pad_depos(tbatch.empty_event(1, "cpu"), batch.max_depos)
    for f, full, fill in zip(DepoSet._fields, batch, empty):
        joined = torch.cat([getattr(p, f) for p in parts])
        assert torch.equal(joined[:5], full), f
        assert all(torch.equal(row, fill) for row in joined[5:]), f


# ---------------------------------------------------------------------------
# The distributed event against the live reference
# ---------------------------------------------------------------------------


def _wire_hits(out, plane):
    sel = (lambda x: x) if plane is None else (lambda x: x[plane])
    mask = sel(out["hits.mask"]).astype(bool)
    rows = {}
    for w, t, q, p in zip(*(sel(out[f"hits.{f}"])[mask]
                            for f in ("wire", "tick", "charge", "peak"))):
        rows.setdefault(int(w), []).append((t, q, p))
    return rows


def _assert_hits_match(got, want, decon, cfg, plane=None):
    a, b = _wire_hits(got, plane), _wire_hits(want, plane)
    decon = decon if plane is None else decon[plane]
    atol = parity.ATOL_FRAC * float(np.abs(decon).max())
    thr = cfg.hit_threshold
    for w in sorted(set(a) | set(b)):
        x, y = a.get(w, []), b.get(w, [])
        if len(x) == len(y):
            for u, v in zip(x, y):
                np.testing.assert_allclose(u, v, rtol=parity.HIT_RTOL,
                                           err_msg=f"wire {w}")
            continue
        near = np.abs(decon[w] - thr) <= atol + parity.RTOL * thr
        assert near.any(), (f"wire {w}: {len(x)} port hits vs {len(y)} "
                            "reference hits, no sample near the threshold")


def _outputs(res, name):
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in res.items()
            if k.startswith(prefix)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_adc_matches_reference(ref, port, name):
    got, want = _outputs(port, name), _outputs(ref, name)
    assert got["adc"].shape == want["adc"].shape
    assert got["adc"].dtype == want["adc"].dtype == np.int16
    parity.assert_adc_close(got["adc"], want["adc"], what=name)
    cfg = _case_config(name)
    assert (got["adc"][..., :cfg.num_wires, :] != cfg.adc_baseline).any()


@pytest.mark.parametrize("name", ["g", "h"])
def test_recon_matches_reference(ref, port, name):
    got, want = _outputs(port, name), _outputs(ref, name)
    cfg = _case_config(name)
    parity.assert_close(got["decon"], want["decon"], what=f"{name} decon")
    for f in ("wire", "tick", "charge", "peak", "mask", "n_hits"):
        assert got[f"hits.{f}"].shape == want[f"hits.{f}"].shape, f
    np.testing.assert_array_equal(got["hits.n_hits"], want["hits.n_hits"])
    planes = [None] if cfg.num_planes == 1 else range(cfg.num_planes)
    for p in planes:
        sel = (lambda x: x) if p is None else (lambda x: x[p])
        assert sel(got["hits.mask"]).sum() == sel(want["hits.mask"]).sum() > 0
        _assert_hits_match(got, want, want["decon"], cfg, p)


def test_grid_matches_single_device_cyclic_reference(ref, port):
    """Case a's grid and ADC against the reference test's single-device
    construction: one scatter of every depo, rfft2 x response at the
    cyclic (W_pad, T) shape."""
    got = _outputs(port, "a")
    parity.assert_close(got["charge_grid"][:128], ref["cyclic/grid"],
                        what="grid")
    parity.assert_adc_close(got["adc"], ref["cyclic/adc"], what="adc")


@pytest.mark.parametrize("pair", [("b", "a"), ("b21", "a"), ("b11", "a"),
                                  ("e", "d")])
def test_port_paths_agree(port, pair):
    """The port's halo against its psum_scatter (binned depos add the same
    patches in another order), at rings of 4, 2 and 1, and its loop
    plane batching against stacked (one collective chain per plane or one
    for all): grids within tolerance, ADC under the +-1 rule."""
    x, y = (_outputs(port, n) for n in pair)
    parity.assert_close(x["charge_grid"], y["charge_grid"],
                        atol_frac=parity.GRID_ATOL_FRAC, what=str(pair))
    parity.assert_adc_close(x["adc"], y["adc"], what=str(pair))


# ---------------------------------------------------------------------------
# The launchers, on gloo ranks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [[], ["--recon"], ["--planes", "3"]],
                         ids=["one_plane", "recon", "three_planes"])
def test_launcher_runs_on_gloo_ranks(args, capsys):
    assert launcher.main(["--devices", "2", "--smoke", "--device", "cpu"]
                         + args) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK")
    assert "mesh: {'data': 1, 'model': 2} over 2 gloo ranks" in out
    assert out.count("plane ") == (3 if "--planes" in args else 1)
    assert ("hits: " in out) == ("--recon" in args)


def test_grad_smoke_on_gloo_ranks(capsys):
    assert fit_launcher.main(["--grad-smoke", "--devices", "2", "--device",
                              "cpu"]) == 0
    assert "grad-smoke: PASS" in capsys.readouterr().out


@pytest.mark.parametrize("main", [launcher.main, fit_launcher.main],
                         ids=["distributed", "grad_smoke"])
def test_cuda_ranks_without_cards_raise(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--devices", "2", "--device", "cuda"]
    if main is fit_launcher.main:
        argv = ["--grad-smoke"] + argv
    with pytest.raises(RuntimeError, match="2 CUDA devices, but 0"):
        main(argv)
