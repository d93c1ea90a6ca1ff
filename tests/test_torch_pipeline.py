"""The port's fig4 slice as a whole against the reference, on the CPU.

Port ``make_sim_fn(cfg, device="cpu")`` and reference ``make_sim_fn(cfg)``
get the same key and the same depos (carried across by ``interop``, so
generator ULPs cannot flip a patch origin), with fluctuation and noise on,
for each charge-grid strategy the port runs; ``simulate`` likewise for the
pool stream and the fig3 pipeline, which the port runs too.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.config import get_config as jax_get_config
from repro.core.depo import generate_depos as j_generate
from repro.core.depo import generate_physical_depos as j_generate_physical
from repro.core.pipeline import make_sim_fn as j_make_sim_fn
from repro.core.pipeline import simulate as j_simulate
from repro_torch import interop
from repro_torch.config import get_config
from repro_torch.core import prng
from repro_torch.core.depo import generate_depos
from repro_torch.core.pipeline import make_sim_fn, simulate
from repro_torch.core.stages import STAGE_ORDER, build_sim_graph
from repro_torch.launch import sim as launcher
from repro_torch.testing import parity

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield

SMOKE = jax_get_config("lartpc-uboone", smoke=True)
#: patches straddle the 64x256 tile edges; 96 wires leave a ragged tile
EDGE = JaxConfig(num_wires=96, num_ticks=768, num_depos=128,
                 response_wires=11, response_ticks=64)
STRATEGIES = ["unfused", "fused_pallas", "fused_pallas_compact"]


def _run_both(cfg, ev=0, physical=False):
    k = jax.random.fold_in(jax.random.key(0), ev)
    if physical:
        d = j_generate_physical(k, cfg)
        td = interop.physical_depos_from_numpy(
            *(np.asarray(x) for x in d), device="cpu")
    else:
        d = j_generate(k, cfg)
        td = interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                      device="cpu")
    ref = j_make_sim_fn(cfg)(k, d)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    out = make_sim_fn(tcfg, device="cpu")(
        interop.key_from_data(jax.random.key_data(k)), td)
    return ref, interop.to_numpy(out)


def _compare(ref, out):
    assert out["adc"].dtype == np.int16
    assert int(out.get("dropped", 0)) == 0  # fig3 bins no tiles
    parity.assert_close(out["charge_grid"], np.asarray(ref.charge_grid),
                        atol_frac=parity.GRID_ATOL_FRAC, what="grid")
    parity.assert_close(out["signal"], np.asarray(ref.signal),
                        atol_frac=parity.SIGNAL_ATOL_FRAC, what="signal")
    parity.assert_adc_close(out["adc"], np.asarray(ref.adc), what="adc")


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("name,cfg", [("smoke", SMOKE), ("edge", EDGE)])
def test_sim_matches_reference(strategy, name, cfg):
    cfg = dataclasses.replace(cfg, charge_grid_strategy=strategy)
    _compare(*_run_both(cfg, ev=1))


@pytest.mark.parametrize("strategy", ["unfused", "fused_pallas"])
def test_sim_from_physical_depos_matches_reference(strategy):
    """The drift stage runs inside the graph on PhysicalDepoSet input."""
    cfg = dataclasses.replace(SMOKE, charge_grid_strategy=strategy)
    _compare(*_run_both(cfg, ev=2, physical=True))


def test_sim_without_fluctuation_matches_reference():
    cfg = dataclasses.replace(SMOKE, charge_grid_strategy="fused_pallas",
                              fluctuate=False)
    _compare(*_run_both(cfg, ev=3))


def test_fused_strategies_agree_bitwise():
    cfg = get_config("lartpc-uboone", smoke=True)
    k = prng.fold_in(prng.key(1), 0)
    depos = generate_depos(k, cfg, device="cpu")
    outs = [make_sim_fn(dataclasses.replace(cfg, charge_grid_strategy=s),
                        device="cpu")(k, depos)
            for s in ("fused_pallas", "fused_pallas_compact")]
    assert torch.equal(outs[0].charge_grid, outs[1].charge_grid)
    assert torch.equal(outs[0].adc, outs[1].adc)


def test_launcher_event0_equals_make_sim_fn():
    cfg = dataclasses.replace(get_config("lartpc-uboone", smoke=True),
                              charge_grid_strategy="fused_pallas")
    seen = {}
    stats = launcher.run_events(cfg, 2, seed=5, device="cpu",
                                on_event=lambda ev, out, dt: seen.update(
                                    {ev: out}))
    assert stats["events"] == 2 and stats["depos"] == 2 * cfg.num_depos
    k = prng.fold_in(prng.key(5), 0)
    direct = make_sim_fn(cfg, device="cpu")(
        k, generate_depos(k, cfg, device="cpu"))
    assert torch.equal(seen[0].adc, direct.adc)
    assert not torch.equal(seen[0].adc, seen[1].adc)


def test_launcher_event0_matches_reference_event0():
    """Both launchers' event 0 (fold_in(key(seed), 0), generated depos):
    the generators differ by sin/cos/erfinv ULPs only, so the ADCs agree."""
    cfg = SMOKE
    k = jax.random.fold_in(jax.random.key(0), 0)
    ref = j_make_sim_fn(cfg)(k, j_generate(k, cfg))
    seen = {}
    launcher.run_events(interop.config_from_dict(dataclasses.asdict(cfg)), 1,
                        seed=0, device="cpu",
                        on_event=lambda ev, out, dt: seen.update({ev: out}))
    parity.assert_adc_close(seen[0].adc.numpy(), np.asarray(ref.adc))


def test_launcher_main_prints_reference_lines(capsys):
    launcher.main(["--smoke", "--events", "1", "--device", "cpu", "--set",
                   "charge_grid_strategy=fused_pallas_compact"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("batch 0: 1 events / 256 depos -> "
                               "(1, 128, 512) ADC in ")
    assert "depos/s), max dev " in lines[0]
    assert lines[-1].startswith("total: 1 events / 256 depos in ")


def test_launcher_refuses_dropped_entries():
    cfg = get_config("lartpc-uboone", smoke=True)
    graph = make_sim_fn(cfg, device="cpu")

    def dropping(k, depos):
        return graph(k, depos)._replace(dropped=torch.tensor(3))

    with pytest.raises(RuntimeError, match="dropped 3"):
        launcher.run_events(cfg, 1, device="cpu", sim=dropping)


def test_graph_order_timing_and_replace():
    cfg = get_config("lartpc-uboone", smoke=True)
    graph = build_sim_graph(cfg, device="cpu")
    assert graph.stage_names == STAGE_ORDER
    k = prng.key(2)
    depos = generate_depos(k, cfg, device="cpu")
    out, timings = graph.timed(k, depos, warmup=1, iters=1)
    assert set(timings) == set(STAGE_ORDER)
    assert torch.equal(out.adc, graph(k, depos).adc)
    quiet = graph.replace(noise=lambda state: state)
    assert torch.equal(quiet(k, depos).adc,
                       build_sim_graph(cfg, add_noise=False,
                                       device="cpu")(k, depos).adc)
    assert any(n.endswith("response_freq") for n, _ in graph.named_buffers())


def test_simulate_entry_point_matches_graph():
    cfg = get_config("lartpc-uboone", smoke=True)
    k = prng.key(4)
    depos = generate_depos(k, cfg, device="cpu")
    assert torch.equal(simulate(k, depos, cfg, device="cpu").adc,
                       make_sim_fn(cfg, device="cpu")(k, depos).adc)


@pytest.mark.parametrize("field,value", [("patch_dtype", "float16")])
def test_unported_features_raise(field, value):
    cfg = dataclasses.replace(get_config("lartpc-uboone", smoke=True),
                              **{field: value})
    with pytest.raises(NotImplementedError):
        make_sim_fn(cfg, device="cpu")


@pytest.mark.parametrize("field,value", [("rng_strategy", "pool"),
                                         ("pipeline", "fig3")])
def test_pool_and_fig3_run_like_reference(field, value):
    """The configs the port refused before it ran them: ``simulate`` in
    both packages on the same key and depos (each package's default pool:
    the graph's ``make_pool(key(1234))`` for the pool stream, fig3's
    ``make_pool(fold_in(key, 7), 2**16)``), under parity's rules."""
    cfg = dataclasses.replace(SMOKE, **{field: value})
    k = jax.random.fold_in(jax.random.key(0), 4)
    d = j_generate(k, cfg)
    ref = j_simulate(k, d, cfg)
    out = simulate(interop.key_from_data(jax.random.key_data(k)),
                   interop.depos_from_numpy(*(np.asarray(x) for x in d),
                                            device="cpu"),
                   interop.config_from_dict(dataclasses.asdict(cfg)),
                   device="cpu")
    _compare(ref, interop.to_numpy(out))


def test_fig3_refuses_three_planes():
    """The fig3 baseline is one plane only, in both packages, with the
    reference's message."""
    cfg = dataclasses.replace(SMOKE, pipeline="fig3", num_planes=3)
    k = jax.random.key(0)
    d = j_generate(k, dataclasses.replace(cfg, num_planes=1))
    with pytest.raises(ValueError) as ref:
        j_simulate(k, d, cfg)
    tcfg = interop.config_from_dict(dataclasses.asdict(cfg))
    with pytest.raises(ValueError) as port:
        simulate(prng.key(0), generate_depos(prng.key(0), tcfg, device="cpu"),
                 tcfg, device="cpu")
    assert str(port.value) == str(ref.value)
    assert "single-plane" in str(port.value)
