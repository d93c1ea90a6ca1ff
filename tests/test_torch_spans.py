"""The port's span and wait-counter layer (``repro_torch.spans``) on the
CPU, over one chunk of the stream in each of the benchmark's two
configurations (``simbench/configs/``) at the simulator's smoke sizes,
with their strategies (the kernels run their plain versions).

The span tree (names, parents, batch ids, the finish of batch b-1 run in
step b carrying b-1); nothing recorded and no ``record_function`` built
with tracing off; the recorder's stamps on kineto's clock under a CPU
``torch.profiler``; ``spans.enabled()`` recording without one; every host
read the census counts in the stream inside a wait span, the exempt sites
named with their reasons, and the waits' read count equal to the census's
count of the rest; the card-event resolution on stand-in events; and
``--profile`` on the launcher.
"""
import collections
import json
from pathlib import Path

import pytest
import torch

from repro_torch import spans
from repro_torch.analysis import census
from repro_torch.analysis.census import Census
from repro_torch.config import apply_overrides, get_config
from repro_torch.core.batch import make_batched_sim_fn
from repro_torch.launch import sim as launcher
from repro_torch.launch.sim import stream_simulate

torch.set_num_threads(1)

SIMBENCH = Path(__file__).resolve().parent.parent / "simbench"
#: the simulator's smoke sizes, as the benchmark's CPU tests cut a cell
SMOKE = {"num_wires": 128, "num_ticks": 512, "response_wires": 11,
         "response_ticks": 64, "num_depos": 256}
#: configuration file -> events a batch, as the benchmark's cells run them
CELLS = {"uboone-full": 1, "uboone-signal": 4}
#: case -> (configuration file, fields set over it): the cells, and the
#: signal cell with the compact lists (their occupancy read and two masked
#: writes a row)
CASES = {"uboone-full": ("uboone-full", {}),
         "uboone-signal": ("uboone-signal", {}),
         "uboone-signal-compact": ("uboone-signal", {
             "charge_grid_strategy": "fused_pallas_multiplane_compact"})}
SEED = 2**31 + 77

LAUNCHER_SPANS = {"sim.generate", "sim.validate", "sim.validate.copy",
                  "sim.pack", "sim.dispatch", "sim.bin.mask", "sim.finish",
                  "sim.finish.flags", "sim.on_batch"}
STAGES = {"uboone-full": ("drift", "charge_grid", "convolve", "noise",
                          "digitize", "deconvolve", "hit_find"),
          "uboone-signal": ("drift", "charge_grid", "convolve",
                            "digitize")}
#: blocking reads a batch: the validation copy, 2 a (event, plane) row of
#: the binning's masks, the flags, and with recon the stored-hit count
READS = {"uboone-full": 1 + 2 * 3 + 1 + 1, "uboone-signal": 1 + 2 * 12 + 1,
         "uboone-signal-compact": 1 + 1 + 4 * 12 + 1}

#: host-read sites the census counts in the stream that read host tensors
#: by design, never the card, each with its reason
EXEMPT_SITES = {
    "core/prng.py:_words": "the two words of a key: keys live on the host",
    "core/batch.py:simulate_events": "n_depos.tolist(): the packer's valid "
                                     "depo counts, a host tensor",
    "kernels/fused_sim/ops.py:_seeds": "the fused kernels' seed words, "
                                       "read from host keys",
}
#: host-read ops that never read the card: ``.numpy()`` works on host
#: tensors only (it reads the copy the ``.cpu()`` before it made)
EXEMPT_OPS = {"numpy": "reads the host copy its .cpu() made"}


def cell_config(name, fields=()):
    doc = json.loads((SIMBENCH / "configs" / f"{name}.json").read_text())
    values = {k: tuple(v) if isinstance(v, list) else v
              for k, v in doc["config"].items()}
    values.update(SMOKE)
    values.update(fields)
    return (apply_overrides(get_config("lartpc-uboone"), values),
            doc["graph"])


@pytest.fixture(scope="module")
def programs(tmp_path_factory):
    """Each configuration's executor, built once and warmed on one batch."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        out = {}
        for name, (config, fields) in CASES.items():
            e = CELLS[config]
            cfg, graph = cell_config(config, fields)
            sim = make_batched_sim_fn(cfg, add_noise=graph["add_noise"],
                                      recon=graph["recon"], device="cpu")
            stream_simulate(cfg, e, e, seed=1, sim=sim, recon=graph["recon"],
                            device="cpu")
            out[name] = (cfg, graph, sim, e)
        yield out


@pytest.fixture(autouse=True)
def fresh_recorder():
    spans.reset()
    yield
    spans.reset()


def run_chunk(programs, name, batches=2, **kw):
    cfg, graph, sim, e = programs[name]
    return stream_simulate(cfg, batches * e, e, seed=SEED, sim=sim,
                           recon=graph["recon"], device="cpu", **kw)


@pytest.mark.parametrize("name", list(CELLS))
def test_span_tree(programs, name):
    seen = []
    with spans.enabled():
        run_chunk(programs, name,
                  on_batch=lambda b, *a: seen.append(spans.open_span()))
    recs = spans.RECORDER.records
    assert not spans.RECORDER.stack
    names = {r.name for r in recs}
    stages = {spans.STAGE + s for s in STAGES[name]}
    hits = {"sim.finish.hits"} if name == "uboone-full" else set()
    assert names == LAUNCHER_SPANS | stages | hits

    parent = {"sim.validate.copy": "sim.validate",
              "sim.bin.mask": spans.STAGE + "charge_grid",
              "sim.finish.flags": "sim.finish", "sim.finish.hits":
              "sim.finish", "sim.on_batch": "sim.finish"}
    parent.update({s: "sim.dispatch" for s in stages})
    for r in recs:
        assert r.parent == parent.get(r.name), r
        assert r.wait == (r.name in ("sim.validate.copy", "sim.bin.mask",
                                     "sim.finish.flags", "sim.finish.hits"))
        assert 0 <= r.self_ns <= r.end_ns - r.start_ns
        assert r.batch in (0, 1)
    # a child carries its parent's batch and lies inside it
    by_end = sorted(recs, key=lambda r: r.end_ns)
    for r in recs:
        if r.parent is not None:
            p = next(q for q in by_end if q.name == r.parent
                     and q.start_ns <= r.start_ns and q.end_ns >= r.end_ns)
            assert p.batch == r.batch
    # the finish of batch 0 runs in step 1, after batch 1's dispatch, and
    # carries batch 0; the callback ran inside it
    order = [(r.name, r.batch) for r in sorted(
        (r for r in recs if r.parent is None), key=lambda r: r.start_ns)]
    assert order.index(("sim.finish", 0)) > order.index(("sim.dispatch", 1))
    assert order[-1] == ("sim.finish", 1)
    assert [s.name for s in seen] == ["sim.on_batch"] * 2
    assert [s.batch for s in seen] == [0, 1]

    s = spans.summary()
    assert s["batches"] == 2
    assert s["reads"] == 2 * READS[name]
    assert s["device_ms"] == {}
    waits = {"launcher": 0.0, "executor": 0.0}
    for r in recs:
        if r.wait:
            side = "executor" if r.name == "sim.bin.mask" else "launcher"
            waits[side] += (r.end_ns - r.start_ns) / 1e6
    assert s["wait_ms"] == pytest.approx(waits)
    for n, v in s["spans"].items():
        own = sum(r.self_ns for r in recs if r.name == n) / 1e6
        assert v["self_ms"] == pytest.approx(own)
    assert "sim.generate" in spans.table(s)


def test_off_records_nothing_and_builds_no_record_function(programs,
                                                           monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("built while tracing is off")

    monkeypatch.setattr(spans, "record_function", refuse)
    monkeypatch.setattr(spans, "_clock", refuse)
    assert spans.span("sim.x", batch=3) is spans.NULL
    assert spans.wait("sim.x", reads=2) is spans.NULL
    assert spans.span("sim.x", device=torch.device("cpu")) is spans.NULL
    run_chunk(programs, "uboone-signal", batches=1)
    assert spans.RECORDER.records == []
    assert spans.summary()["batches"] == 0


def test_enabled_records_without_a_profiler(programs, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function without a profiler")

    monkeypatch.setattr(spans, "record_function", refuse)
    assert not torch.autograd._profiler_enabled()
    with spans.enabled():
        with spans.enabled():
            pass
        run_chunk(programs, "uboone-signal", batches=1)
    assert spans.span("sim.x") is spans.NULL
    assert spans.summary()["batches"] == 1


def test_stamps_match_kineto_events(programs):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run_chunk(programs, "uboone-signal", batches=2)
    kineto = collections.defaultdict(list)
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith("sim."):
            kineto[ev.name()].append(ev)
    ours = collections.defaultdict(list)
    for r in spans.RECORDER.records:
        ours[r.name].append(r)
    assert set(ours) == set(kineto)
    for name, recs in ours.items():
        evs = sorted(kineto[name], key=lambda e: e.start_ns())
        recs = sorted(recs, key=lambda r: r.start_ns)
        assert len(evs) == len(recs), name
        for r, ev in zip(recs, evs):
            assert abs(r.start_ns - ev.start_ns()) < 1_000_000, name
            assert abs(r.end_ns - ev.end_ns()) < 1_000_000, name


@pytest.mark.parametrize("name", list(CASES))
def test_every_card_read_of_the_stream_is_in_a_wait(programs, name,
                                                    monkeypatch):
    reads = []
    host = Census._host

    def watched(self, op, device_type):
        reads.append((census.site().rsplit(":", 1)[0], op,
                      spans.open_span()))
        host(self, op, device_type)

    monkeypatch.setattr(Census, "_host", watched)
    with spans.enabled(), Census():
        run_chunk(programs, name, batches=1)
    counted = [(where, op, sp) for where, op, sp in reads
               if where not in EXEMPT_SITES and op not in EXEMPT_OPS]
    assert set(EXEMPT_SITES) <= {where for where, _, _ in reads}
    outside = [(where, op, None if sp is None else sp.name)
               for where, op, sp in counted if sp is None or not sp.reads]
    assert outside == []
    assert len(counted) == spans.summary()["reads"] == READS[name]


class _Event:
    """A stand-in CUDA event: a card time in ms, passed or not."""

    def __init__(self, t, passed=True):
        self.t, self.passed = t, passed

    def query(self):
        return self.passed

    def elapsed_time(self, later):
        return later.t - self.t


def test_card_events_resolve_in_order_once_passed():
    rec = spans.Recorder()
    rec.pending = [(0, "sim.stage.a", _Event(0.0), _Event(2.0)),
                   (0, "sim.stage.b", _Event(2.5), _Event(4.0)),
                   (1, "sim.stage.a", _Event(10.0), _Event(13.0)),
                   (1, "sim.stage.b", _Event(13.0), _Event(20.0, False)),
                   (2, "sim.stage.a", _Event(30.0), _Event(31.0))]
    rec.resolve()
    assert rec.device_ms == {"sim.stage.a": 5.0, "sim.stage.b": 1.5,
                             spans.GAP: 6.0}
    assert rec.device_calls == {"sim.stage.a": 2, "sim.stage.b": 1,
                                spans.GAP: 1}
    assert len(rec.pending) == 2
    rec.pending[0][3].passed = True
    rec.resolve()
    assert rec.pending == []
    assert rec.device_ms["sim.stage.b"] == 8.5
    assert rec.device_ms[spans.GAP] == 16.0
    assert rec.device_calls[spans.GAP] == 2


def test_profile_flag_writes_a_trace_with_every_span(tmp_path, capsys):
    path = tmp_path / "trace.json"
    launcher.main(["--smoke", "--device", "cpu", "--events", "3",
                   "--batch-events", "2", "--planes", "3", "--recon",
                   "--journal", str(tmp_path / "j.jsonl"), "--set",
                   "charge_grid_strategy=fused_pallas_multiplane",
                   "--profile", str(path)])
    out = capsys.readouterr().out
    names = {e.get("name") for e in json.loads(path.read_text())[
        "traceEvents"]}
    want = (LAUNCHER_SPANS | {"sim.finish.hits", "sim.finish.journal"}
            | {spans.STAGE + s for s in STAGES["uboone-full"]})
    assert want <= names
    assert "spans over 2 batches" in out
    assert "sim.finish.journal" in out
