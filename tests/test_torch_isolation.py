"""The port stands alone: no JAX and no reference module in its imports, no
silent CPU fallback, and a config copy that matches the reference's."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (the port's tests run beside the reference)
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.config import plane_specs as jax_plane_specs
from repro_torch import config as tconfig
from repro_torch import interop


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield


ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_import_leaves_jax_out_of_sys_modules():
    code = ("import sys, repro_torch.core.pipeline, repro_torch.launch.sim, "
            "repro_torch.interop, repro_torch.kernels.fused_sim.ops, "
            "repro_torch.kernels.scatter_add.kernel, "
            "repro_torch.core.scatter, repro_torch.core.drift, "
            "repro_torch.core.deconvolve, repro_torch.core.hitfind, "
            "repro_torch.kernels.hitfind.ops, "
            "repro_torch.kernels.rasterize.ops, repro_torch.core.batch, "
            "repro_torch.core.validate, repro_torch.launch.journal, "
            "repro_torch.testing.faults, repro_torch.tune, "
            "repro_torch.tune.autotune, repro_torch.core.fit, "
            "repro_torch.core.gradcheck, repro_torch.launch.fit, "
            "repro_torch.core.distributed, repro_torch.launch.distributed, "
            "repro_torch.testing.ranks, repro_torch.analysis, "
            "repro_torch.analysis.census, repro_torch.analysis.audit, "
            "repro_torch.analysis.lint, repro_torch.launch.audit, "
            "repro_torch.configs, repro_torch.models.params, "
            "repro_torch.models.layers, repro_torch.models.attention, "
            "repro_torch.models.transformer, repro_torch.models.model, "
            "repro_torch.models.moe, repro_torch.models.ssm, "
            "repro_torch.models.rglru, repro_torch.models.encdec, "
            "repro_torch.serve.engine, repro_torch.launch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro')]; print(bad); sys.exit(bool(bad))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _entry_points():
    from repro_torch.core import prng
    from repro_torch.core.batch import (empty_event, make_batched_sim_fn,
                                        pack_events, shard_events)
    from repro_torch.core.deconvolve import make_plane_deconv_filters
    from repro_torch.core import fit
    from repro_torch.core.drift import PhysicalDepoSet
    from repro_torch.core.depo import generate_depos, generate_plane_depos
    from repro_torch.core.gradcheck import (stage_gradcheck_cases,
                                            stage_gradcheck_suite)
    from repro_torch.core.fluctuate import make_pool
    from repro_torch.core.pipeline import make_sim_fn, simulate, \
        simulate_fig4
    from repro_torch.core.response import (make_distributed_plane_responses,
                                           make_distributed_response,
                                           make_plane_responses)
    from repro_torch.kernels.rasterize.ops import rasterize_depos
    from repro_torch.launch import fit as launch_fit
    from repro_torch.launch import sim as launch_sim
    from repro_torch.launch.sim import run_events, stream_simulate
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models.model import Model
    from repro_torch.models.params import init_params

    cfg = tconfig.get_config("lartpc-uboone", smoke=True)
    cfg3 = dataclasses.replace(cfg, num_planes=3,
                               charge_grid_strategy="fused_pallas_multiplane")
    k = prng.key(0)
    lm_cfg = tconfig.get_config("qwen3-32b", smoke=True)
    spec = fit.FitSpec(params=(fit.FitParam("recombination", init=0.9),))
    cpu_targets = fit.make_fit_targets(cfg, k, num_events=1, device="cpu")
    return {
        "make_sim_fn": lambda **kw: make_sim_fn(cfg, **kw),
        "simulate_fig4": lambda **kw: simulate_fig4(
            k, generate_depos(k, cfg, device="cpu"), cfg=cfg, **kw),
        "generate_depos": lambda **kw: generate_depos(k, cfg, **kw),
        "run_events": lambda **kw: run_events(cfg, 1, **kw),
        "generate_plane_depos": lambda **kw: generate_plane_depos(k, cfg3,
                                                                  **kw),
        "make_plane_responses": lambda **kw: make_plane_responses(cfg3, **kw),
        "run_events_3planes": lambda **kw: run_events(cfg3, 1, **kw),
        "make_sim_fn_recon": lambda **kw: make_sim_fn(cfg, recon=True, **kw),
        "simulate_recon": lambda **kw: simulate(
            k, generate_depos(k, cfg, device="cpu"), cfg, recon=True, **kw),
        "make_plane_deconv_filters": lambda **kw: make_plane_deconv_filters(
            cfg3, **kw),
        "rasterize_depos": lambda **kw: rasterize_depos(
            k, generate_depos(k, cfg, device="cpu"), cfg, **kw),
        "make_batched_sim_fn": lambda **kw: make_batched_sim_fn(cfg, **kw),
        "stream_simulate": lambda **kw: stream_simulate(cfg, 1, **kw),
        "stream_simulate_3planes": lambda **kw: stream_simulate(
            cfg3, 2, 2, recon=True, **kw),
        "empty_event": lambda **kw: empty_event(3, **kw),
        "from_mm": lambda **kw: PhysicalDepoSet.from_mm(
            [1.0], [2.0], [3.0], [0.0], [9.0], cfg, **kw),
        "make_fit_targets": lambda **kw: fit.make_fit_targets(
            cfg, k, num_events=1, **kw),
        "make_fit_loss": lambda **kw: fit.make_fit_loss(
            cfg, spec, cpu_targets, **kw),
        "calibrate": lambda **kw: fit.calibrate(cfg, spec, cpu_targets,
                                                steps=1, **kw),
        "stage_gradcheck_suite": lambda **kw: stage_gradcheck_suite(
            cases=stage_gradcheck_cases()[:1], **kw),
        "simulate_fig3": lambda **kw: simulate(
            k, generate_depos(k, cfg, device="cpu"),
            dataclasses.replace(cfg, pipeline="fig3"), max_depos=4, **kw),
        "make_pool": lambda **kw: make_pool(k, 1 << 10, **kw),
        "pool_from_numpy": lambda **kw: interop.pool_from_numpy([0.5], **kw),
        "launch_fig3": lambda device="cuda": launch_sim.main(
            ["--smoke", "--pipeline", "fig3", "--events", "1", "--depos",
             "4", "--device", device]),
        "make_distributed_response": lambda **kw: make_distributed_response(
            cfg, 136, **kw),
        "make_distributed_plane_responses":
            lambda **kw: make_distributed_plane_responses(cfg3, 128, **kw),
        "shard_events": lambda **kw: shard_events(
            pack_events([generate_depos(k, cfg, device="cpu")]), **kw),
        "launch_fit": lambda device="cuda": launch_fit.main(
            ["--smoke", "--optimizer", "bfgs", "--steps", "1", "--tol", "1",
             "--device", device]),
        "lm_model": lambda **kw: Model(lm_cfg, **kw).init(k),
        "init_params": lambda **kw: init_params(
            lambda make: make("w", (2,), ("embed",)), k, **kw),
        "model_params_from_numpy": lambda **kw:
            interop.model_params_from_numpy({"w": np.zeros(2, np.float32)},
                                            **kw),
        "launch_serve": lambda device="cuda": launch_serve.main(
            ["--arch", "qwen3-32b", "--requests", "1", "--new-tokens", "1",
             "--device", device]),
    }


@pytest.mark.parametrize("name", ["make_sim_fn", "simulate_fig4",
                                  "generate_depos", "run_events",
                                  "generate_plane_depos",
                                  "make_plane_responses",
                                  "run_events_3planes", "make_sim_fn_recon",
                                  "simulate_recon",
                                  "make_plane_deconv_filters",
                                  "rasterize_depos", "make_batched_sim_fn",
                                  "stream_simulate",
                                  "stream_simulate_3planes", "empty_event",
                                  "from_mm", "make_fit_targets",
                                  "make_fit_loss", "calibrate",
                                  "stage_gradcheck_suite", "launch_fit",
                                  "simulate_fig3", "make_pool",
                                  "pool_from_numpy", "launch_fig3",
                                  "make_distributed_response",
                                  "make_distributed_plane_responses",
                                  "shard_events", "lm_model", "init_params",
                                  "model_params_from_numpy",
                                  "launch_serve"])
def test_entry_points_default_to_the_card(name, monkeypatch):
    """Without a card the default device raises; device="cpu" runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = _entry_points()[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn()
    fn(device="cpu")


def test_config_copy_has_reference_fields_and_defaults():
    ref = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    port = {f.name: f.default for f in dataclasses.fields(tconfig.LArTPCConfig)}
    assert port == ref


@pytest.mark.parametrize("smoke", [False, True])
def test_config_registration_round_trips(smoke):
    ref = jax_get_config("lartpc-uboone", smoke=smoke)
    port = tconfig.get_config("lartpc-uboone", smoke=smoke)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert interop.config_from_dict(dataclasses.asdict(ref)) == port


@pytest.mark.parametrize("planes", [1, 2, 3])
def test_plane_specs_match(planes):
    ref = dataclasses.replace(JaxConfig(), num_planes=planes)
    port = dataclasses.replace(tconfig.LArTPCConfig(), num_planes=planes)
    assert tuple(map(tuple, tconfig.plane_specs(port))) == tuple(
        map(tuple, jax_plane_specs(ref)))


def test_apply_overrides_parses_like_reference():
    from repro.config import apply_overrides as jax_apply

    over = {"num_depos": "77", "fluctuate": "false", "tick_us": "0.25",
            "charge_grid_strategy": "fused_pallas"}
    port = tconfig.apply_overrides(tconfig.LArTPCConfig(), dict(over))
    ref = jax_apply(JaxConfig(), dict(over))
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    with pytest.raises(KeyError):
        tconfig.apply_overrides(tconfig.LArTPCConfig(), {"nope": "1"})


def test_every_cuda_source_is_built_and_wrapped():
    """Each source under csrc/ is registered for the build, and each
    kernel wrapper module counts its launches per wrapper."""
    from repro_torch import kernels
    from repro_torch.kernels.fused_sim import kernel as fused
    from repro_torch.kernels.hitfind import kernel as hitfind
    from repro_torch.kernels.rasterize import kernel as rasterize
    from repro_torch.kernels.scatter_add import kernel as scatter

    sources = sorted(p.name for p in kernels.CSRC.glob("*.cu"))
    assert sorted(kernels.SOURCES.values()) == sources
    assert set(fused.LAUNCHES) == {
        "fused_rasterize_scatter", "fused_rasterize_scatter_compact",
        "fused_rasterize_scatter_multiplane",
        "fused_rasterize_scatter_multiplane_compact"}
    assert set(scatter.LAUNCHES) == {"scatter_add_pallas",
                                     "scatter_add_pallas_compact"}
    assert set(hitfind.LAUNCHES) == {"hitfind_pallas"}
    assert set(rasterize.LAUNCHES) == {"rasterize_pallas"}
    assert {"hitfind", "rasterize"} <= set(kernels.SOURCES)
    for module in (fused, scatter, hitfind, rasterize):
        for name in module.LAUNCHES:
            assert callable(getattr(module, name))
