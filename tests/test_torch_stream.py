"""The port's streaming launcher and its fault-tolerance layer, on the CPU.

The behaviours ``tests/test_robustness.py`` and
``tests/test_event_batch.py::TestStreaming`` hold the reference to, run on
the port (``repro_torch.launch.sim.stream_simulate``,
``repro_torch.core.validate``, ``repro_torch.launch.journal``,
``repro_torch.testing.faults``): ingest validation gives the reference's
reasons on the same inputs; quarantine, validation off, retry halving and
journal resume leave every surviving row bit-identical; non-OOM errors
fail fast; the ``check_finite`` sentinel leaves the ADC as it was and
agrees with the reference's on a NaN-injected batch. The port's stream
matches the reference's ``stream_simulate`` under ``parity``; a
three-plane stream at one event a batch equals ``run_events`` event for
event; ``PhysicalDepoSet.from_mm`` equals the reference's bit for bit; and
the launcher's new flags run on the CPU.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.config import LArTPCConfig as JaxConfig
from repro.core import batch as jbatch
from repro.core import validate as jvalidate
from repro.core.depo import generate_depos as j_generate
from repro.core.drift import PhysicalDepoSet as JPhysical
from repro.launch.sim import stream_simulate as j_stream
from repro.testing.faults import FaultPlan as JFaultPlan
from repro_torch import interop, kernels
from repro_torch.core import prng
from repro_torch.core.batch import (empty_event, event_keys,
                                    make_batched_sim_fn, pack_events,
                                    screen_events)
from repro_torch.core.depo import generate_depos
from repro_torch.core.drift import PhysicalDepoSet
from repro_torch.core.pipeline import make_sim_fn
from repro_torch.core.validate import (RunHealth, SimBatchError, check_depos,
                                       dead_letter, is_oom_error)
from repro_torch.launch import sim as launcher
from repro_torch.launch.journal import (JournalError, RunJournal,
                                        load_journal_records,
                                        run_fingerprint)
from repro_torch.launch.sim import run_events, stream_simulate
from repro_torch.testing import parity
from repro_torch.testing.faults import (FaultPlan, InjectedDispatchError,
                                        InjectedOOM)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield

#: ``tests/test_robustness.py``'s config
JCFG = JaxConfig(num_wires=64, num_ticks=256, num_depos=48,
                 response_wires=11, response_ticks=48)
CFG = interop.config_from_dict(dataclasses.asdict(JCFG))
CFG3 = dataclasses.replace(CFG, num_planes=3,
                           charge_grid_strategy="fused_pallas_multiplane")


def _depos(ev: int, cfg=CFG, seed: int = 0):
    return generate_depos(prng.fold_in(prng.key(seed), ev), cfg,
                          device="cpu")


def _nan_depos(ev: int):
    d = _depos(ev)
    q = d.charge.clone()
    q[0] = float("nan")
    return d._replace(charge=q)


def _both(edit=None, cfg=JCFG):
    """The same detector-frame event for both packages (reference
    generated), edited by ``edit(dict of numpy leaves)``."""
    d = j_generate(jax.random.fold_in(jax.random.key(0), 0), cfg)
    leaves = {f: np.array(getattr(d, f)) for f in d._fields}
    if edit is not None:
        edit(leaves)
    ref = type(d)(**leaves)
    return ref, interop.depos_from_numpy(**leaves, device="cpu")


def _set(field, index, value):
    def edit(leaves):
        leaves[field][index] = value
    return edit


def _planes(leaves):
    for f in leaves:
        leaves[f] = np.stack([leaves[f]] * 2)


# ---------------------------------------------------------------------------
# Validation rules: the reference's reasons on the same inputs
# ---------------------------------------------------------------------------

#: name -> (edit, check_depos kwargs, config, expected reason substring)
VALIDATION_CASES = {
    "clean": (None, {}, JCFG, None),
    "nan_charge": (_set("charge", 0, np.nan), {}, JCFG, "nonfinite charge"),
    "inf_position": (_set("wire", 3, np.inf), {}, JCFG, "nonfinite wire"),
    "negative_charge": (_set("charge", 1, -5.0), {}, JCFG,
                        "negative charge"),
    "zero_sigma": (lambda lv: lv["sigma_w"].fill(0.0), {}, JCFG,
                   "non-positive sigma_w"),
    "mild_overhang": (_set("wire", 0, -1.5), {}, JCFG, None),
    "far_out_of_frame": (_set("wire", 0, 1e7), {}, JCFG, "wire outside"),
    "oversize": (None, {"max_depos": 47}, JCFG, "oversized"),
    "at_capacity": (None, {"max_depos": 48}, JCFG, None),
    "inconsistent_shapes": (
        lambda lv: lv.__setitem__("charge", lv["charge"][:-1]), {}, JCFG,
        "inconsistent leaf shapes"),
    "plane_axis_mismatch": (_planes, {}, dataclasses.replace(
        JCFG, num_planes=3), "plane axis 2 != num_planes 3"),
}


@pytest.mark.parametrize("case", sorted(VALIDATION_CASES))
def test_check_depos_gives_the_reference_reasons(case):
    edit, kw, jcfg, want = VALIDATION_CASES[case]
    ref, port = _both(edit)
    tcfg = interop.config_from_dict(dataclasses.asdict(jcfg))
    reasons = check_depos(port, tcfg, **kw)
    assert reasons == jvalidate.check_depos(ref, jcfg, **kw)
    if want is None:
        assert reasons == []
    else:
        assert any(want in r for r in reasons), reasons


def test_physical_frame_rules_match_reference():
    n = 16
    leaves = dict(x=np.full(n, 5.0, np.float32), y=np.zeros(n, np.float32),
                  z=np.zeros(n, np.float32), t=np.zeros(n, np.float32),
                  q=np.full(n, 100.0, np.float32))
    for field, value, want in ((None, None, None),
                               ("x", -3.0, "negative drift time"),
                               ("q", -1.0, "negative charge")):
        lv = dict(leaves)
        if field is not None:
            lv[field] = np.full(n, value, np.float32)
        port = interop.physical_depos_from_numpy(**lv, device="cpu")
        reasons = check_depos(port, CFG)
        assert reasons == jvalidate.check_depos(JPhysical(**lv), JCFG)
        assert (reasons == []) if want is None else any(want in r
                                                        for r in reasons)


def test_screen_events_quarantines_and_counts():
    health = RunHealth()
    events = [_depos(0), _nan_depos(1), _depos(2)]
    kept, ids, letters = screen_events(events, [0, 1, 2], CFG, batch=7,
                                       health=health)
    assert ids == [0, 2] and len(kept) == 2 and kept[0] is events[0]
    assert health.quarantined == 1
    (letter,) = letters
    assert letter["event"] == 1 and letter["batch"] == 7
    assert letter["reasons"] == check_depos(events[1], CFG)
    json.dumps(letter)
    assert dead_letter(3, 1, ["r"], events[0]) == {
        "event": 3, "batch": 1, "reasons": ["r"], "n_depos": 48}


# ---------------------------------------------------------------------------
# OOM classification
# ---------------------------------------------------------------------------


def test_oom_classification(monkeypatch):
    assert is_oom_error(InjectedOOM("RESOURCE_EXHAUSTED: boom"))
    assert is_oom_error(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 20.00 GiB"))
    assert is_oom_error(RuntimeError("OUT_OF_MEMORY while allocating"))
    assert not is_oom_error(InjectedDispatchError("nope"))
    assert not is_oom_error(ValueError("shape mismatch"))
    # a kernel wrapper's launch failure carries the runtime's text
    # (cudaErrorMemoryAllocation = 2 reads "out of memory")
    monkeypatch.setattr(kernels, "error_string",
                        lambda err: {2: "out of memory (2)"}.get(
                            err, f"invalid argument ({err})"))
    with pytest.raises(RuntimeError) as oom:
        kernels.raise_on(2, "fused_sim_dense")
    assert is_oom_error(oom.value)
    with pytest.raises(RuntimeError) as other:
        kernels.raise_on(1, "fused_sim_dense")
    assert not is_oom_error(other.value)
    kernels.raise_on(0, "fused_sim_dense")


# ---------------------------------------------------------------------------
# Fault plan
# ---------------------------------------------------------------------------


def test_fault_plan_parse_matches_reference():
    spec = "nan@0, neg@3,oversize@2,oom@1,oom@4x2,error@5"
    p, r = FaultPlan.parse(spec), JFaultPlan.parse(spec)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    for bad in ("explode@1", "nan@1x2"):
        with pytest.raises(ValueError):
            FaultPlan.parse(bad)


def test_corrupt_event_matches_reference_on_the_depos_device():
    p = FaultPlan.parse("nan@0,neg@1,oversize@2")
    jp = JFaultPlan.parse("nan@0,neg@1,oversize@2")
    for ev in (0, 1, 2):
        ref, port = _both()
        out = p.corrupt_event(ev, port)
        assert all(x.device.type == "cpu" and x.dtype == torch.float32
                   for x in out)
        for o, r in zip(out, jp.corrupt_event(ev, ref)):
            np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    d = _depos(3)
    assert p.corrupt_event(3, d) is d


def test_fault_plan_dispatch_faults():
    p = FaultPlan.parse("oom@0x2,error@1")
    for _ in range(2):
        with pytest.raises(InjectedOOM):
            p.before_dispatch(0)
    p.before_dispatch(0)
    for _ in range(2):
        with pytest.raises(InjectedDispatchError):
            p.before_dispatch(1)


# ---------------------------------------------------------------------------
# Journal
# ---------------------------------------------------------------------------


def test_journal_create_append_reload_and_torn_line(tmp_path):
    path = str(tmp_path / "j.jsonl")
    with RunJournal(path, fingerprint="abc") as j:
        j.append_batch({"batch": 0, "events": 2})
        j.append_batch({"batch": 1, "events": 1})
    with open(path, "a") as f:
        f.write('{"kind": "batch", "batch": 2, "eve')
    j2 = RunJournal(path, fingerprint="abc", resume=True)
    assert sorted(j2.completed) == [0, 1]
    assert j2.completed[1]["events"] == 1
    j2.close()
    assert [r["batch"] for r in load_journal_records(path)] == [0, 1]
    assert load_journal_records(str(tmp_path / "missing")) is None


def test_journal_refuses_other_runs_and_garbage(tmp_path):
    path = str(tmp_path / "j.jsonl")
    RunJournal(path, fingerprint="abc").close()
    with pytest.raises(JournalError, match="fingerprint"):
        RunJournal(path, fingerprint="DIFFERENT", resume=True)
    with open(path, "w") as f:
        f.write("not a journal\n")
    with pytest.raises(JournalError):
        RunJournal(path, fingerprint="abc", resume=True)
    a = run_fingerprint(CFG, seed=0, batch_events=2)
    assert a == run_fingerprint(CFG, seed=0, batch_events=2)
    assert a != run_fingerprint(CFG, seed=1, batch_events=2)
    assert a != run_fingerprint(dataclasses.replace(CFG, num_wires=128),
                                seed=0, batch_events=2)


# ---------------------------------------------------------------------------
# Streaming fault tolerance
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def sim_fn():
    return make_batched_sim_fn(CFG, device="cpu")


def _stream_rows(sim, cfg=CFG, num_events=4, batch_events=2, **kw):
    """stream_simulate + each batch's valid ADC rows."""
    rows = {}

    def grab(b, n_valid, n_depos, dt, out):
        rows[b] = out.adc[:n_valid].clone()

    stats = stream_simulate(cfg, num_events, batch_events, sim=sim,
                            on_batch=grab, device="cpu", **kw)
    return rows, stats


def test_clean_run_health_and_counts(sim_fn):
    rows, stats = _stream_rows(sim_fn, num_events=5)
    assert stats["events"] == 5 and stats["depos"] == 5 * CFG.num_depos
    assert len(stats["batches"]) == 3 and stats["batches"][-1]["events"] == 1
    h = stats["health"]
    assert h["events_ok"] == 5 and h["quarantined"] == 0
    assert h["retries"] == 0 and h["resumed"] == 0
    assert stats["wall_s"] > 0


def test_stream_matches_direct_batch(sim_fn):
    rows, _ = _stream_rows(sim_fn, num_events=2)
    key = prng.key(0)
    batch = pack_events([_depos(ev) for ev in range(2)], pad_to=48)
    direct = sim_fn(event_keys(key, range(2)), batch)
    assert torch.equal(rows[0], direct.adc)


def test_quarantine_preserves_survivors_bitwise(sim_fn):
    clean, _ = _stream_rows(sim_fn)
    rows, stats = _stream_rows(sim_fn, faults=FaultPlan.parse("nan@1"))
    h = stats["health"]
    assert h["quarantined"] == 1 and h["events_ok"] == 3
    (letter,) = h["dead_letters"]
    assert letter["event"] == 1 and letter["batch"] == 0
    assert torch.equal(rows[0][0], clean[0][0])
    assert torch.equal(rows[1], clean[1])


def test_validation_off_is_bit_identical_on_clean_input(sim_fn):
    on, _ = _stream_rows(sim_fn)
    off, _ = _stream_rows(sim_fn, validate=False)
    assert all(torch.equal(on[b], off[b]) for b in on)


def test_oversized_event_quarantined_not_crash(sim_fn):
    _, stats = _stream_rows(sim_fn, faults=FaultPlan.parse("oversize@2"))
    assert stats["health"]["quarantined"] == 1
    assert any("oversized" in r
               for r in stats["health"]["dead_letters"][0]["reasons"])


def test_retry_halving_is_bit_identical(sim_fn):
    clean, _ = _stream_rows(sim_fn, num_events=4, batch_events=4)
    rows, stats = _stream_rows(sim_fn, num_events=4, batch_events=4,
                               faults=FaultPlan.parse("oom@0"))
    h = stats["health"]
    assert h["retries"] == 1 and h["halvings"] == 1
    assert torch.equal(rows[0], clean[0])


def test_nonretryable_fails_fast_with_context(sim_fn):
    with pytest.raises(SimBatchError) as ei:
        _stream_rows(sim_fn, faults=FaultPlan.parse("error@1"))
    assert ei.value.batch == 1 and ei.value.attempts == 1
    assert isinstance(ei.value.cause, InjectedDispatchError)
    assert isinstance(ei.value.__cause__, InjectedDispatchError)


def test_retry_budget_exhausted_raises(sim_fn):
    with pytest.raises(SimBatchError) as ei:
        _stream_rows(sim_fn, faults=FaultPlan.parse("oom@0x9"),
                     max_retries=2)
    assert ei.value.attempts == 3 and is_oom_error(ei.value.cause)


def test_resume_is_bit_identical(sim_fn, tmp_path):
    jpath = str(tmp_path / "run.jsonl")
    cpath = str(tmp_path / "clean.jsonl")
    _stream_rows(sim_fn, num_events=6, journal=cpath)
    shas = {r["batch"]: r["adc_sha"] for r in load_journal_records(cpath)}
    with pytest.raises(SimBatchError):
        _stream_rows(sim_fn, num_events=6, journal=jpath,
                     faults=FaultPlan.parse("error@1"))
    assert {r["batch"] for r in load_journal_records(jpath)} == {0}
    rows, stats = _stream_rows(sim_fn, num_events=6, journal=jpath,
                               resume=True)
    assert sorted(rows) == [1, 2]
    assert stats["health"]["resumed"] == 2 and stats["events"] == 6
    assert {r["batch"]: r["adc_sha"]
            for r in load_journal_records(jpath)} == shas


def test_resume_refuses_other_runs(sim_fn, tmp_path):
    jpath = str(tmp_path / "run.jsonl")
    _stream_rows(sim_fn, journal=jpath)
    with pytest.raises(JournalError, match="fingerprint"):
        _stream_rows(sim_fn, seed=99, journal=jpath, resume=True)
    with pytest.raises(ValueError, match="journal"):
        stream_simulate(CFG, 2, sim=sim_fn, resume=True, device="cpu")


def test_callback_error_does_not_lose_stats(sim_fn):
    def bad_callback(b, n_valid, n_depos, dt, out):
        raise KeyError("user bug")

    with pytest.warns(RuntimeWarning) as rec:
        stats = stream_simulate(CFG, 4, 2, sim=sim_fn, on_batch=bad_callback,
                                device="cpu")
    assert sum("callback failed for batch" in str(w.message)
               for w in rec) == 2
    assert stats["events"] == 4 and len(stats["batches"]) == 2
    assert stats["health"]["callback_errors"] == 2


def test_zero_and_negative_event_counts(sim_fn):
    stats = stream_simulate(CFG, 0, 2, sim=sim_fn, device="cpu")
    assert stats["events"] == 0 and stats["batches"] == []
    assert stats["health"]["events_ok"] == 0
    with pytest.raises(ValueError, match="num_events"):
        stream_simulate(CFG, -1, sim=sim_fn, device="cpu")


def test_all_quarantined_batch_still_streams(sim_fn):
    rows, stats = _stream_rows(sim_fn, faults=FaultPlan.parse("nan@0,nan@1"))
    assert stats["health"]["quarantined"] == 2 and stats["events"] == 2
    assert rows[0].shape[0] == 0
    clean, _ = _stream_rows(sim_fn)
    assert torch.equal(rows[1], clean[1])


# ---------------------------------------------------------------------------
# check_finite sentinel
# ---------------------------------------------------------------------------


def test_check_finite_on_equals_off():
    key = prng.key(0)
    depos = _depos(0)
    base = make_sim_fn(CFG, device="cpu")(key, depos)
    checked = make_sim_fn(dataclasses.replace(CFG, check_finite=True),
                          device="cpu", recon=True)(key, depos)
    assert torch.equal(base.adc, checked.adc)
    assert base.finite_ok is None
    assert checked.finite_ok.dtype == torch.bool and bool(checked.finite_ok)


def test_sentinel_matches_reference_on_a_nan_batch():
    """Validation off: event 1's NaN charge and Inf wire reach the
    sentinel, in both packages."""
    jcfg = dataclasses.replace(JCFG, check_finite=True)
    plan, jplan = FaultPlan.parse("nan@1"), JFaultPlan.parse("nan@1")
    key = jax.random.key(0)
    refs = [jplan.corrupt_event(ev, j_generate(jax.random.fold_in(key, ev),
                                               JCFG)) for ev in range(2)]
    ref = jbatch.make_batched_sim_fn(jcfg)(
        jbatch.event_keys(key, [0, 1]), jbatch.pack_events(refs, pad_to=48))
    ports = [plan.corrupt_event(ev, _depos(ev)) for ev in range(2)]
    out = make_batched_sim_fn(dataclasses.replace(CFG, check_finite=True),
                              device="cpu")(event_keys(prng.key(0), [0, 1]),
                                            pack_events(ports, pad_to=48))
    assert out.finite_ok.tolist() == np.asarray(ref.finite_ok).tolist() == [
        True, False]


def test_replaced_stage_keeps_the_sentinel():
    """A function put in place of a checked stage is checked on the same
    field: a NaN it writes trips the sentinel."""
    graph = make_sim_fn(dataclasses.replace(CFG, check_finite=True),
                        device="cpu")

    def nan_noise(state):
        return state._replace(signal=state.signal * float("nan"))

    key, depos = prng.key(0), _depos(0)
    assert bool(graph.replace(noise=lambda state: state)(key, depos)
                .finite_ok)
    assert not bool(graph.replace(noise=nan_noise)(key, depos).finite_ok)


def test_stream_counts_nonfinite_events():
    cfg = dataclasses.replace(CFG, check_finite=True)
    sim = make_batched_sim_fn(cfg, device="cpu")
    _, stats = _stream_rows(sim, cfg=cfg, validate=False,
                            faults=FaultPlan.parse("nan@1"))
    assert stats["health"]["nonfinite_events"] == 1
    assert [b["nonfinite"] for b in stats["batches"]] == [1, 0]


# ---------------------------------------------------------------------------
# Degenerate recon inputs
# ---------------------------------------------------------------------------


def test_empty_events_yield_zero_hits():
    cfg = dataclasses.replace(CFG, noise_rms_adc=0.0)
    sim = make_batched_sim_fn(cfg, device="cpu", recon=True)
    batch = pack_events([empty_event(device="cpu")] * 2, pad_to=48)
    out = sim(event_keys(prng.key(0), [100, 101]), batch)
    assert int(out.hits.mask.sum()) == 0 and int(out.hits.n_hits.sum()) == 0


def test_stream_recon_with_all_quarantined_batch():
    cfg = dataclasses.replace(CFG, noise_rms_adc=0.0)
    sim = make_batched_sim_fn(cfg, device="cpu", recon=True)
    hits = {}

    def grab(b, n_valid, n_depos, dt, out):
        hits[b] = int(out.hits.mask[:n_valid].sum())

    stats = stream_simulate(cfg, 4, 2, sim=sim, recon=True, on_batch=grab,
                            faults=FaultPlan.parse("nan@0,nan@1"),
                            device="cpu")
    assert stats["health"]["quarantined"] == 2
    assert hits[0] == 0 and stats["batches"][0]["hits"] == 0


# ---------------------------------------------------------------------------
# Against the reference, and against the per-event loop
# ---------------------------------------------------------------------------


def test_stream_matches_reference_stream():
    """Both streams generate their own events from one seed (the
    generators differ by sin/cos/erfinv ULPs), so the ADCs agree under
    parity; a short last batch is padded in both."""
    ref, out = {}, {}
    stats = j_stream(JCFG, 3, 2, seed=0, on_batch=lambda b, nv, nd, dt, o:
                     ref.update({b: np.asarray(o.adc)[:nv]}))
    tstats = stream_simulate(CFG, 3, 2, seed=0, device="cpu",
                             on_batch=lambda b, nv, nd, dt, o:
                             out.update({b: o.adc[:nv].numpy()}))
    assert tstats["events"] == stats["events"] == 3
    assert [b["events"] for b in tstats["batches"]] == [2, 1]
    for b in ref:
        assert out[b].shape == ref[b].shape
        parity.assert_adc_close(out[b], ref[b], what=f"batch {b}")


def test_three_plane_stream_equals_run_events():
    """generate_plane_depos before the graph and the graph's own drift of
    generate_physical_depos give the same bits, so each streamed row
    equals ``run_events``' event."""
    loop = {}
    run_events(CFG3, 3, device="cpu",
               on_event=lambda ev, o, dt: loop.update({ev: o}))
    streamed = {}

    def grab(b, n_valid, n_depos, dt, out):
        streamed[b] = out

    stream_simulate(CFG3, 3, 1, device="cpu", on_batch=grab)
    for ev in range(3):
        for field in ("adc", "charge_grid", "signal"):
            assert torch.equal(getattr(streamed[ev], field)[0],
                               getattr(loop[ev], field)), (ev, field)


def test_from_mm_matches_reference_bitwise():
    rng = np.random.default_rng(7)
    x, y, z, t, q = (rng.uniform(0, 3000, 1000).astype(np.float32)
                     for _ in range(5))
    ref = JPhysical.from_mm(x, y, z, t, q, JCFG)
    out = PhysicalDepoSet.from_mm(x, y, z, t, q, CFG, device="cpu")
    for f in JPhysical._fields:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), f)
    np.testing.assert_array_equal(out.x_mm(CFG).numpy(),
                                  np.asarray(ref.x_mm(JCFG)))
    np.testing.assert_array_equal(out.y_mm(CFG).numpy(),
                                  np.asarray(ref.y_mm(JCFG)))


# ---------------------------------------------------------------------------
# The launcher's flags on the CPU
# ---------------------------------------------------------------------------


def _main(capsys, *args):
    launcher.main(["--smoke", "--device", "cpu", "--depos", "48", *args])
    return capsys.readouterr().out.strip().splitlines()


def test_launcher_streams_batches_with_faults_and_journal(capsys, tmp_path):
    jpath = str(tmp_path / "run.jsonl")
    lines = _main(capsys, "--events", "5", "--batch-events", "2",
                  "--journal", jpath, "--check-finite", "--max-retries", "1",
                  "--inject-faults", "nan@1,oom@2")
    assert lines[0].startswith("batch 0: 1 events / 48 depos -> "
                               "(2, 128, 512) ADC in ")
    assert lines[0].endswith("patches float32")
    assert lines[2].startswith("batch 2: 1 events / 48 depos")
    assert lines[3].startswith("total: 4 events / 192 depos in ")
    assert lines[4].startswith("health: events_ok=4, quarantined=1, "
                               "retries=1, halvings=1")
    assert lines[5].startswith("  dead-letter event 1 (batch 0): ")
    assert [r["batch"] for r in load_journal_records(jpath)] == [0, 1, 2]
    lines = _main(capsys, "--events", "5", "--batch-events", "2",
                  "--journal", jpath, "--resume", "--check-finite",
                  "--max-retries", "1", "--inject-faults", "nan@1,oom@2")
    assert lines[0].startswith("total: 4 events") and "resumed=4" in lines[1]


def test_launcher_no_validate_sentinel_and_stage_board(capsys):
    lines = _main(capsys, "--events", "2", "--batch-events", "2",
                  "--no-validate", "--check-finite", "--stage-board",
                  "--inject-faults", "nan@0")
    stages = [ln.split()[1] for ln in lines if ln.startswith("stage ")]
    assert stages == ["drift", "charge_grid", "convolve", "noise",
                      "digitize"]
    batch = next(ln for ln in lines if ln.startswith("batch 0:"))
    assert batch.endswith(", 1 NON-FINITE")
    assert "nonfinite_events=1" in lines[-1]


def test_launcher_stage_board_per_plane(capsys):
    lines = _main(capsys, "--planes", "3", "--events", "1", "--recon",
                  "--stage-board", "--set", "charge_grid_strategy=unfused")
    assert sum(ln.startswith("stage plane") for ln in lines) == 3 * 7
    assert lines[-1].startswith("total: 1 events / 48 depos in ")


def test_launcher_flag_errors(capsys):
    with pytest.raises(SystemExit):
        launcher.main(["--smoke", "--device", "cpu", "--resume"])
    with pytest.raises(SystemExit, match="stream failed: batch 0"):
        launcher.main(["--smoke", "--device", "cpu", "--depos", "48",
                       "--events", "1", "--inject-faults", "error@0"])
