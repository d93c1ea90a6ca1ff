"""The port's autotuner (``repro_torch.tune``) against the reference's
(``repro.tune``), on the CPU.

The configs are ``tests/test_tune.py``'s: ``CFG`` (96 x 768, 64 depos),
full width, ``rng_strategy="pool"``, ``fluctuate=False`` and three planes.
On the CPU both packages have backend ``"cpu"`` and device kind ``"cpu"``,
so shapes, buckets, cache keys and availability sets must be equal, and
under the reference's ``FAKE_TIMES`` timer (extended to the strategies
``tests/test_tune.py`` never times) every decision too. Then the cache's
robustness, each ``"auto"`` dispatch site (the cached winner, else today's
default) and the launcher's ``--tune`` / ``--retune`` / ``--strategy``.
The reference's tuner always gets a cache file of its own.
"""
import dataclasses
import json
import os

import jax  # noqa: F401  (the reference runs beside the port, on the CPU)
import pytest
import torch

from repro import tune as jtune
from repro.config import LArTPCConfig as JaxConfig
from repro_torch import interop
from repro_torch import tune
from repro_torch.config import LArTPCConfig
from repro_torch.core import prng
from repro_torch.testing.faults import corrupt_tune_cache
from repro_torch.tune import autotune, registry
from test_tune import FAKE_TIMES as REF_FAKE_TIMES

torch.set_num_threads(1)

#: the reference tests' fake timings plus the strategies they never time
#: (drift, deconvolve's fft_reuse, the multi-plane charge grids)
FAKE_TIMES = dict(REF_FAKE_TIMES, jnp=1.0, fft_reuse=1.5,
                  fused_pallas_multiplane=0.5,
                  fused_pallas_multiplane_compact=0.75, multiplane_xla=0.9)

CFG = JaxConfig(num_wires=96, num_ticks=768, num_depos=64)
CONFIGS = {
    "cfg": CFG,
    "full": JaxConfig(),
    "pool": dataclasses.replace(CFG, rng_strategy="pool"),
    "quiet": dataclasses.replace(CFG, fluctuate=False),
    "planes3": dataclasses.replace(CFG, num_planes=3),
    "full_planes3": dataclasses.replace(JaxConfig(), num_planes=3),
}
OPS = ("drift", "scatter_add", "charge_grid", "fft_convolve", "deconvolve",
       "hit_find")
ALL_AUTO = {f: "auto" for f in autotune.OP_FIELDS.values()}


def _tcfg(cfg: JaxConfig) -> LArTPCConfig:
    return interop.config_from_dict(dataclasses.asdict(cfg))


def fake_timer(calls):
    def timer(name, thunk):
        calls.append(name)
        return FAKE_TIMES[name]

    return timer


def prefer(winner, calls=None):
    """A timer under which ``winner`` is the fastest candidate."""
    def timer(name, thunk):
        if calls is not None:
            calls.append(name)
        return 1.0 if name == winner else 2.0

    return timer


@pytest.fixture
def caches(tmp_path):
    """(port cache, reference cache): two files, one per package."""
    return (tune.TuneCache(str(tmp_path / "port.json")),
            jtune.TuneCache(str(tmp_path / "reference.json")))


@pytest.fixture(autouse=True)
def _tune_cache(tmp_path, monkeypatch):
    """``"auto"`` resolves through a per-test cache; no test touches the
    default path."""
    monkeypatch.setenv("REPRO_TORCH_TUNE_CACHE", str(tmp_path / "tc.json"))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "ref_tc.json"))


def _decided(d):
    return (d.op, d.strategy, d.source, d.cache_key)


# ---------------------------------------------------------------------------
# The registry's surface
# ---------------------------------------------------------------------------


def test_public_names_are_the_references():
    assert sorted(tune.__all__) == sorted(jtune.__all__)
    for name in tune.__all__:
        assert hasattr(tune, name), name
    assert autotune.OP_FIELDS == jtune.autotune.OP_FIELDS
    assert autotune.PLANE_KEYED_OPS == jtune.autotune.PLANE_KEYED_OPS
    assert autotune.TUNABLE_OPS == jtune.TUNABLE_OPS
    assert autotune.SCHEMA_VERSION == jtune.autotune.SCHEMA_VERSION
    assert tune.list_ops() == jtune.list_ops()
    assert registry.declared_collectives() == \
        jtune.registry.declared_collectives()


@pytest.mark.parametrize("op", OPS)
def test_strategies_and_defaults_match(op):
    port, ref = tune.strategies(op), jtune.strategies(op)
    assert set(port) == set(ref)
    assert set(tune.differentiable_strategies(op)) == set(
        jtune.differentiable_strategies(op))
    for name in port:
        assert tune.is_differentiable(op, name) == jtune.is_differentiable(
            op, name)
        assert (port[name].available is None) == (ref[name].available is None)
    assert tune.default_strategy(op, "cpu") == jtune.default_strategy(op,
                                                                      "cpu")
    assert tune.default_strategy(op, "*") == jtune.default_strategy(op, "*")


def test_hit_find_default_on_the_card_is_the_kernel():
    assert tune.default_strategy("hit_find", "cuda") == "pallas"
    assert tune.default_strategy("scatter_add", "cuda") == "xla"


def test_context_names_the_device():
    ctx = tune.make_context(_tcfg(CFG), {"num_depos": 1}, device="cpu")
    ref = jtune.make_context(CFG, {"num_depos": 1})
    assert (ctx.backend, ctx.device_kind) == (ref.backend,
                                              ref.device_kind) == ("cpu",
                                                                   "cpu")
    assert registry.current_backend("cpu") == "cpu"
    assert registry.current_device_kind(torch.device("cpu")) == "cpu"
    assert tune.make_context(None, {}, device="cpu",
                             backend="cuda").backend == "cuda"


def test_context_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.make_context(_tcfg(CFG), {"num_depos": 1})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tune.resolve("hit_find", _tcfg(CFG))


# ---------------------------------------------------------------------------
# Shapes, buckets, keys and availability against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("op", OPS)
def test_shapes_and_keys_match(op, name):
    cfg = CONFIGS[name]
    shape = tune.op_shape(op, _tcfg(cfg))
    assert shape == jtune.op_shape(op, cfg)
    assert tune.shape_bucket(shape) == jtune.shape_bucket(shape)
    assert tune.cache_key(op, "cpu", "cpu", shape) == jtune.cache_key(
        op, "cpu", "cpu", shape)


def test_bucketing_shares_and_splits_keys():
    keys = [tune.cache_key("scatter_add", "cpu", "cpu", {"num_depos": n})
            for n in (100_000, 120_000, 1_000, 0)]
    assert keys[0] == keys[1] != keys[2]
    assert keys == [jtune.cache_key("scatter_add", "cpu", "cpu",
                                    {"num_depos": n})
                    for n in (100_000, 120_000, 1_000, 0)]
    assert tune.shape_bucket({"plane": "collection", "num_wires": 96}) == \
        "num_wires=128;plane=collection"


@pytest.mark.parametrize("backends", [("cpu", "cpu"), ("cuda", "tpu")],
                         ids=["cpu", "cuda_vs_tpu"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("op", OPS)
def test_available_strategies_match(op, name, backends):
    cfg = CONFIGS[name]
    shape = jtune.op_shape(op, cfg)
    port = tune.make_context(_tcfg(cfg), shape, device="cpu",
                             backend=backends[0])
    ref = jtune.make_context(cfg, shape, backend=backends[1])
    assert set(tune.available_strategies(op, port)) == set(
        jtune.available_strategies(op, ref))


def test_availability_rules():
    """The fused kernels compete in the counter-RNG config, not with the
    pool stream; the plain kernels leave the candidates at production
    grids off the card, and stay on it."""
    full = _tcfg(JaxConfig())
    for op in ("scatter_add", "hit_find"):
        shape = tune.op_shape(op, full)
        cpu = tune.make_context(full, shape, device="cpu")
        card = tune.make_context(full, shape, device="cpu", backend="cuda")
        assert "pallas" not in tune.available_strategies(op, cpu)
        assert "pallas" in tune.available_strategies(op, card)
    shape = tune.op_shape("charge_grid", _tcfg(CFG))
    avail = tune.available_strategies(
        "charge_grid", tune.make_context(_tcfg(CFG), shape, device="cpu"))
    assert {"fused_pallas", "fused_pallas_compact"} <= set(avail)
    assert "fused_pallas_multiplane" not in avail
    pooled = _tcfg(CONFIGS["pool"])
    avail = tune.available_strategies(
        "charge_grid", tune.make_context(pooled, shape, device="cpu"))
    assert set(avail) == {"unfused", "unfused_bf16"}


# ---------------------------------------------------------------------------
# Decisions under the fake timer against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["cfg", "quiet", "planes3"])
@pytest.mark.parametrize("op", OPS)
def test_tune_op_matches_reference(op, name, caches):
    cfg = CONFIGS[name]
    port_calls, ref_calls = [], []
    d = tune.tune_op(op, _tcfg(cfg), cache=caches[0],
                     timer=fake_timer(port_calls), device="cpu")
    r = jtune.tune_op(op, cfg, cache=caches[1], timer=fake_timer(ref_calls))
    assert _decided(d) == _decided(r)
    assert d.source == "tuned"
    assert sorted(port_calls) == sorted(ref_calls)
    assert dict(d.timings_us) == dict(r.timings_us)
    assert d.describe() == r.describe()


@pytest.mark.parametrize("tune_explicit", [False, True])
@pytest.mark.parametrize("name", ["cfg", "planes3"])
def test_resolve_config_with_decisions_matches(name, tune_explicit, caches):
    """Every op's decision (per plane kind for a three-plane config), and
    the resolved config: all fields "auto", or the defaults re-tuned."""
    cfg = CONFIGS[name]
    if not tune_explicit:
        cfg = dataclasses.replace(cfg, **ALL_AUTO)
    tcfg, tdec = tune.resolve_config_with_decisions(
        _tcfg(cfg), tune=True, cache=caches[0], timer=fake_timer([]),
        tune_explicit=tune_explicit, device="cpu")
    rcfg, rdec = jtune.resolve_config_with_decisions(
        cfg, tune=True, cache=caches[1], timer=fake_timer([]),
        tune_explicit=tune_explicit)
    assert [_decided(d) for d in tdec] == [_decided(d) for d in rdec]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    kinds = 2 if cfg.num_planes > 1 else 1
    assert len(tdec) == len(OPS) + 2 * (kinds - 1)
    # a second resolution is all cache hits and times nothing
    calls = []
    _, again = tune.resolve_config_with_decisions(
        _tcfg(cfg), tune=True, cache=tune.TuneCache(caches[0].path),
        timer=fake_timer(calls), tune_explicit=tune_explicit, device="cpu")
    assert calls == [] and all(d.source == "cache" for d in again)
    assert [d.strategy for d in again] == [d.strategy for d in tdec]


@pytest.mark.parametrize("name", ["cfg", "planes3"])
def test_resolve_config_without_tuning_keeps_todays_defaults(name, caches):
    cfg = dataclasses.replace(CONFIGS[name], **ALL_AUTO)
    tcfg, tdec = tune.resolve_config_with_decisions(
        _tcfg(cfg), cache=caches[0], device="cpu")
    rcfg, rdec = jtune.resolve_config_with_decisions(cfg, cache=caches[1])
    assert [_decided(d) for d in tdec] == [_decided(d) for d in rdec]
    assert all(d.source == "default" for d in tdec)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(rcfg)
    assert not os.path.exists(caches[0].path)


# ---------------------------------------------------------------------------
# The cache
# ---------------------------------------------------------------------------


def test_cache_round_trip_and_record(caches):
    calls = []
    d1 = tune.tune_op("scatter_add", _tcfg(CFG), cache=caches[0],
                      timer=fake_timer(calls), device="cpu")
    n = len(calls)
    assert d1.strategy == "pallas" and d1.source == "tuned" and n == 4
    # a fresh handle finds the decision on disk and times nothing
    d2 = tune.tune_op("scatter_add", _tcfg(CFG),
                      cache=tune.TuneCache(caches[0].path),
                      timer=fake_timer(calls), device="cpu")
    assert d2.cache_hit and d2.strategy == "pallas" and len(calls) == n
    assert d2.describe() == (f"tune[scatter_add]: selected 'pallas' "
                             f"(cache hit: {d1.cache_key})")
    rec = json.load(open(caches[0].path))[d1.cache_key]
    assert rec["backend"] == "cpu" and rec["device_kind"] == "cpu"
    assert rec["schema"] == autotune.SCHEMA_VERSION
    assert rec["torch_version"] == torch.__version__
    assert rec["cuda_version"] == torch.version.cuda
    assert rec["timer"] == "timer"
    assert set(rec["timings_us"]) == {"xla", "sort_segment", "pallas",
                                      "pallas_compact"}


def test_force_retunes_and_explicit_wins(caches):
    calls = []
    tune.tune_op("scatter_add", _tcfg(CFG), cache=caches[0],
                 timer=fake_timer(calls), device="cpu")
    n = len(calls)
    d = tune.tune_op("scatter_add", _tcfg(CFG), cache=caches[0],
                     timer=fake_timer(calls), force=True, device="cpu")
    assert d.source == "tuned" and len(calls) == 2 * n
    d = tune.resolve("scatter_add", _tcfg(CFG), cache=caches[0])
    assert d.source == "explicit" and d.strategy == "xla"
    auto = _tcfg(dataclasses.replace(CFG, scatter_strategy="auto"))
    d = tune.resolve("scatter_add", auto, cache=caches[0], device="cpu")
    assert d.source == "cache" and d.strategy == "pallas"


def test_cached_winner_ignored_when_its_predicate_fails(caches):
    counter = _tcfg(dataclasses.replace(CFG, charge_grid_strategy="auto"))
    d = tune.tune_op("charge_grid", counter, cache=caches[0],
                     timer=fake_timer([]), device="cpu")
    assert d.strategy == "fused_pallas"
    pooled = dataclasses.replace(counter, rng_strategy="pool")
    d2 = tune.resolve("charge_grid", pooled, cache=caches[0], device="cpu")
    assert (d2.strategy, d2.source) == ("unfused", "default")
    d3 = tune.resolve("charge_grid", counter, cache=caches[0], device="cpu")
    assert d3.strategy == "fused_pallas" and d3.cache_hit


@pytest.mark.parametrize("mode", ["truncate", "garbage", "foreign"])
def test_corrupt_cache_degrades_to_a_miss_and_recovers(mode, caches):
    path = caches[0].path
    d = tune.tune_op("scatter_add", _tcfg(CFG), cache=caches[0],
                     timer=fake_timer([]), device="cpu")
    corrupt_tune_cache(path, mode)
    fresh = tune.TuneCache(path)
    assert fresh.get(d.cache_key) is None
    calls = []
    d2 = tune.tune_op("scatter_add", _tcfg(CFG), cache=fresh,
                      timer=fake_timer(calls), device="cpu")
    assert d2.source == "tuned" and calls
    assert tune.TuneCache(path).get(d.cache_key)["strategy"] == "pallas"


def test_corrupt_mode_unknown_raises(tmp_path):
    with pytest.raises(ValueError, match="truncate"):
        corrupt_tune_cache(str(tmp_path / "c.json"), "melt")


def test_two_handles_merge_and_leave_no_temp_files(tmp_path):
    path = str(tmp_path / "shared" / "cache.json")
    a, b = tune.TuneCache(path), tune.TuneCache(path)
    a.get("anything")  # a loads (empty) before b writes
    b.put("k_b", {"strategy": "xla"})
    a.put("k_a", {"strategy": "pallas"})
    on_disk = tune.TuneCache(path)
    assert on_disk.get("k_a")["strategy"] == "pallas"
    assert on_disk.get("k_b")["strategy"] == "xla"
    assert os.listdir(tmp_path / "shared") == ["cache.json"]


@pytest.mark.parametrize("hit", [None, "pallas", 3, ["pallas"],
                                 {"strategy": "atomics"}],
                         ids=["none", "str", "int", "list", "unknown"])
def test_usable_hit_rejects_non_records(hit):
    shape = tune.op_shape("scatter_add", _tcfg(CFG))
    ctx = tune.make_context(_tcfg(CFG), shape, device="cpu")
    assert not autotune._usable_hit("scatter_add", hit, ctx)
    assert autotune._usable_hit("scatter_add", {"strategy": "pallas"}, ctx)


def test_default_cache_path_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_TUNE_CACHE")
    path = autotune.default_cache_path()
    assert path.endswith(os.path.join(".cache", "repro-torch-tune",
                                      "tune_cache.json"))
    monkeypatch.delenv("REPRO_TUNE_CACHE")
    assert path != jtune.autotune.default_cache_path()


def test_median_timer_on_the_cpu():
    calls = []
    t = tune.median_timer("x", lambda: calls.append(1), device="cpu")
    assert t >= 0.0 and len(calls) == 4          # warm-up 1 + 3 timed
    t = tune.median_timer("x", lambda: calls.append(1), warmup=0, iters=5,
                          device="cpu")
    assert len(calls) == 9


def test_a_failing_candidate_fails_the_tune(caches):
    def boom(name, thunk):
        if name == "pallas":
            raise RuntimeError("launch failed")
        return 1.0

    with pytest.raises(RuntimeError, match="launch failed"):
        tune.tune_op("scatter_add", _tcfg(CFG), cache=caches[0], timer=boom,
                     device="cpu")
    assert caches[0].get(tune.cache_key(
        "scatter_add", "cpu", "cpu",
        tune.op_shape("scatter_add", _tcfg(CFG)))) is None


def test_thunks_run_on_the_cpu():
    """Every candidate thunk builds and runs at the test size."""
    cfg = _tcfg(dataclasses.replace(CFG, num_planes=3))
    for op in OPS:
        thunks = tune.candidate_thunks(op, cfg, device="cpu")
        assert set(thunks) == set(jtune.candidate_thunks(
            op, dataclasses.replace(CFG, num_planes=3)))
        for fn in thunks.values():
            fn()


# ---------------------------------------------------------------------------
# The "auto" dispatch sites: the cached winner, else today's default
# ---------------------------------------------------------------------------


@pytest.fixture
def spy(monkeypatch):
    """Wrap every registered strategy of ``op``: returns the list of
    (name, plane kind or None) of each call."""
    def install(op):
        calls = []
        for name, strat in registry.strategies(op).items():
            def fn(*args, _name=name, _fn=strat.fn, **kw):
                plane = getattr(args[1], "plane", None) if len(args) > 1 \
                    else None
                calls.append((_name, plane if isinstance(plane, str)
                              else None))
                return _fn(*args, **kw)

            monkeypatch.setitem(registry._OPS[op], name,
                                dataclasses.replace(strat, fn=fn))
        return calls

    return install


def _site_inputs(site, cfg):
    """(call, op) for one dispatch site at ``cfg`` on the CPU."""
    from repro_torch.core.deconvolve import deconvolve, make_deconv_filter
    from repro_torch.core.depo import generate_depos, generate_physical_depos
    from repro_torch.core.drift import transport
    from repro_torch.core.fft_conv import fft_convolve
    from repro_torch.core.hitfind import find_hits
    from repro_torch.core.rasterize import rasterize
    from repro_torch.core.response import make_response
    from repro_torch.core.scatter import scatter_add
    from repro_torch.core.stages import compute_charge_grid

    k = prng.key(0)
    grid = prng.uniform(prng.key(2), (cfg.num_wires, cfg.num_ticks), 0.0,
                        1.0, "cpu")
    resp = make_response(cfg, device="cpu")
    if site == "drift":
        pdepos = generate_physical_depos(k, cfg, device="cpu")
        return lambda: transport(pdepos, cfg)
    if site == "scatter_add":
        patches, w0, t0 = rasterize(generate_depos(k, cfg, device="cpu"),
                                    cfg)
        return lambda: scatter_add(patches, w0, t0, cfg)
    if site == "charge_grid":
        depos = generate_depos(k, cfg, device="cpu")
        return lambda: compute_charge_grid(prng.key(1), depos, cfg)
    if site == "fft_convolve":
        return lambda: fft_convolve(grid, resp, "auto")
    if site == "deconvolve":
        filt = make_deconv_filter(resp, cfg)
        return lambda: deconvolve(grid, filt, "auto")
    return lambda: find_hits(grid * cfg.hit_threshold * 4, cfg, "auto")


#: site -> (a winner other than the CPU default where one exists, default)
SITE_WINNERS = {"drift": ("jnp", "jnp"), "scatter_add": ("pallas", "xla"),
                "charge_grid": ("fused_pallas", "unfused"),
                "fft_convolve": ("fft2", "rfft2"),
                "deconvolve": ("fft_reuse", "rfft2"),
                "hit_find": ("pallas", "scan")}


@pytest.mark.parametrize("cached", [True, False], ids=["cached", "empty"])
@pytest.mark.parametrize("site", OPS)
def test_auto_dispatch_takes_the_cached_winner(site, cached, spy):
    cfg = _tcfg(dataclasses.replace(CFG, fluctuate=False, **ALL_AUTO))
    winner, default = SITE_WINNERS[site]
    if cached:
        tune.tune_op(site, cfg, timer=prefer(winner), device="cpu")
    call = _site_inputs(site, cfg)
    calls = spy(site)
    call()
    assert calls and {n for n, _ in calls} == {winner if cached else default}


def test_auto_dispatch_through_the_graph_per_plane(spy):
    """A three-plane graph with every field "auto": each plane's convolve
    and deconvolve take their own plane kind's cached winner, the other
    ops their single decision; an empty cache gives today's strategies and
    today's bits."""
    from repro_torch.core.depo import generate_physical_depos
    from repro_torch.core.pipeline import make_sim_fn

    cfg = _tcfg(dataclasses.replace(CFG, num_planes=3, **ALL_AUTO))
    k = prng.key(7)
    pdepos = generate_physical_depos(k, cfg, device="cpu")
    default = make_sim_fn(cfg, device="cpu", recon=True)(k, pdepos)
    today = make_sim_fn(_tcfg(dataclasses.replace(CFG, num_planes=3)),
                        device="cpu", recon=True)(k, pdepos)
    assert torch.equal(default.adc, today.adc)
    assert torch.equal(default.hits.charge, today.hits.charge)

    per_kind = {("fft_convolve", "induction"): "fft2",
                ("fft_convolve", "collection"): "rfft2",
                ("deconvolve", "induction"): "rfft2",
                ("deconvolve", "collection"): "fft_reuse"}
    for (op, kind), name in per_kind.items():
        shape = dict(tune.op_shape(op, cfg), plane=kind)
        tune.tune_op(op, cfg, timer=prefer(name), shape=shape, device="cpu")
    for op, name in (("charge_grid", "multiplane_xla"),
                     ("scatter_add", "sort_segment"), ("hit_find", "pallas")):
        tune.tune_op(op, cfg, timer=prefer(name), device="cpu")
    rcfg = tune.resolve_config(cfg, device="cpu")
    assert (rcfg.fft_strategy, rcfg.deconv_strategy) == ("auto", "auto")
    assert rcfg.charge_grid_strategy == "multiplane_xla"
    fft, dec, grid, hit = (spy(op) for op in ("fft_convolve", "deconvolve",
                                              "charge_grid", "hit_find"))
    make_sim_fn(cfg, device="cpu", recon=True)(k, pdepos)
    kinds = ["induction", "induction", "collection"]
    # fft_reuse's own forward transform resolves the collection plane's
    # fft_convolve winner
    assert fft == [(per_kind["fft_convolve", p], p) for p in kinds] + [
        ("rfft2", "collection")]
    assert dec == [(per_kind["deconvolve", p], p) for p in kinds]
    assert grid == [("multiplane_xla", None)]
    assert hit == [("pallas", None)] * 3


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def _tune_lines(capsys, argv):
    from repro_torch.launch import sim

    sim.main(argv)
    out = capsys.readouterr().out
    return [line for line in out.splitlines() if line.startswith("tune[")], \
        out


def test_launcher_tune_then_cache_hit_then_retune(capsys):
    argv = ["--smoke", "--device", "cpu", "--events", "1", "--tune"]
    first, out = _tune_lines(capsys, argv)
    assert [line.split("]")[0][5:] for line in first] == list(OPS)
    assert all("(tuned: " in line for line in first)
    assert "total: 1 events" in out
    second, _ = _tune_lines(capsys, argv)
    assert len(second) == len(OPS)
    assert all("(cache hit: " in line for line in second)
    third, _ = _tune_lines(capsys, argv + ["--retune"])
    assert all("(tuned: " in line for line in third)
    cache = json.load(open(os.environ["REPRO_TORCH_TUNE_CACHE"]))
    assert len(cache) == len(OPS)
    assert {r["backend"] for r in cache.values()} == {"cpu"}


def test_launcher_strategy_flag(capsys):
    from repro_torch.launch import sim

    _tune_lines(capsys, ["--smoke", "--device", "cpu", "--events", "1",
                         "--strategy", "sort_segment", "--stage-board"])
    with pytest.raises(SystemExit, match="unknown --strategy"):
        sim.main(["--smoke", "--device", "cpu", "--strategy", "atomics"])


def test_launcher_tune_without_a_card_raises(monkeypatch):
    from repro_torch.launch import sim

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sim.main(["--smoke", "--tune"])
    assert not os.path.exists(os.environ["REPRO_TORCH_TUNE_CACHE"])
