"""The port's program contract auditor, the counterpart of
``tests/test_audit.py``.

* unit tests of the policy and of the diff/glob machinery (no program);
* the census on fixture ops with known host reads, float64 writes,
  divisions, collectives and kernel wrappers;
* the audit's programs in-process (contract == the committed baseline,
  repeat drift, every ``--inject`` mode trips the gate naming its field);
* the gate end to end in one subprocess (``python -m
  repro_torch.launch.audit --json``: lint, every program, the distributed
  ones on one spawn of 2 gloo ranks), and its fresh contracts held
  against the reference's ``AUDIT_contracts.json``.
"""
import ast
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import jax  # noqa: F401  (the port's tests run beside the reference)
import pytest
import torch

from repro_torch.analysis import audit, census
from repro_torch.analysis.audit import (ALLOWED_F64, INJECT_MODES,
                                        KNOWN_HOST_SYNCS, PROGRAMS,
                                        SCATTER_REDUCTION_COLLECTIVES,
                                        diff_contracts,
                                        expand_contract_names,
                                        extract_contract, policy_violations,
                                        program_names)
from repro_torch.analysis.census import Census

ROOT = Path(__file__).resolve().parent.parent
BASELINE = ROOT / audit.DEFAULT_BASELINE
REF_BASELINE = ROOT / "AUDIT_contracts.json"
PORT = ROOT / "src" / "repro_torch"
#: the programs the port audits beyond the reference's
PORT_ONLY = {"p1/single_fused", "p3/single_fused", "p1/unfused_pallas_compact",
             "p3/recon_kernels"}

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _tune_cache(tmp_path_factory):
    """``"auto"`` strategy fields resolve through an empty tuning cache of
    this module's own, never the default path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("REPRO_TORCH_TUNE_CACHE",
                  str(tmp_path_factory.mktemp("tune") / "tune_cache.json"))
        yield


def _clean(**over):
    c = {"collectives": {}, "dtypes": ["f32", "s32"], "scatter_dtypes": [],
         "host_syncs": {}, "kernels": {}, "float_divisions": {},
         "f64_bytes": {}, "repeat_drift": []}
    c.update(over)
    return c


class TestPolicy:
    def test_clean_contract_passes(self):
        assert policy_violations("p1/single", _clean()) == []

    def test_f64_at_an_unlisted_site_flagged(self):
        v = policy_violations("p1/single", _clean(
            dtypes=["f32", "f64"], f64_bytes={"core/x.py:f:1": 8}))
        assert any("f64" in x and "core/x.py:f:1" in x for x in v)

    def test_f64_at_an_allowed_site_passes(self):
        site = next(iter(ALLOWED_F64))
        assert policy_violations("p1/single", _clean(
            dtypes=["f32", "f64"], f64_bytes={site: 8})) == []

    def test_f64_without_a_site_flagged(self):
        v = policy_violations("p1/single", _clean(dtypes=["f32", "f64"]))
        assert any("f64" in x for x in v)

    def test_bf16_scatter_flagged(self):
        v = policy_violations("p1/single", _clean(scatter_dtypes=["bf16"]))
        assert any("accumulate" in x for x in v)

    def test_new_host_sync_site_flagged_whatever_its_count(self):
        site = next(iter(KNOWN_HOST_SYNCS))
        assert policy_violations("p1/single", _clean(
            host_syncs={site: {"tolist@cpu": 9}})) == []
        v = policy_violations("p1/single", _clean(
            host_syncs={"core/new.py:f:3": {"item@cpu": 1}}))
        assert any("host_syncs" in x and "core/new.py" in x for x in v)

    def test_float_division_flagged(self):
        v = policy_violations("p1/single", _clean(
            float_divisions={"core/x.py:f:2": 1}))
        assert any("float_divisions" in x for x in v)

    def test_repeat_drift_flagged(self):
        v = policy_violations("p1/single", _clean(repeat_drift=["kernels"]))
        assert any("repeat_drift" in x for x in v)

    def test_collective_in_local_program_flagged(self):
        v = policy_violations("p1/batched", _clean(
            collectives={"all-reduce": 1}))
        assert any("collectives" in x for x in v)

    def test_declared_distributed_collectives_allowed(self):
        c = _clean(collectives={"reduce-scatter": 2, "all-to-all": 4})
        assert policy_violations("p1/distributed_psum", c) == []

    def test_undeclared_distributed_collective_flagged(self):
        v = policy_violations("p1/distributed_psum", _clean(
            collectives={"all-gather": 1}))
        assert any("all-gather" in x for x in v)

    def test_strategy_table_is_the_reference_s(self):
        from repro.analysis.audit import \
            SCATTER_REDUCTION_COLLECTIVES as REF

        assert SCATTER_REDUCTION_COLLECTIVES == REF
        for kinds in SCATTER_REDUCTION_COLLECTIVES.values():
            assert set(kinds) <= set(census.COLLECTIVE_KINDS)


class TestDiffMachinery:
    BASE = {"p1/a": _clean(), "p1/b": _clean()}

    def test_identical_passes(self, capsys):
        assert diff_contracts(self.BASE, dict(self.BASE)) == 0
        assert "ok" in capsys.readouterr().out

    def test_field_drift_fails_with_diff(self, capsys):
        fresh = {"p1/a": _clean(kernels={"hitfind_pallas": 3}),
                 "p1/b": _clean()}
        assert diff_contracts(self.BASE, fresh) == 1
        out = capsys.readouterr().out
        assert "p1/a: FAIL" in out
        assert "kernels: {} -> {'hitfind_pallas': 3}" in out

    def test_missing_fresh_contract_fails(self, capsys):
        assert diff_contracts(self.BASE, {"p1/a": _clean()}) == 1
        assert "MISSING" in capsys.readouterr().out

    def test_new_contract_warns_not_fails(self, capsys):
        fresh = dict(self.BASE, **{"p1/new": _clean()})
        assert diff_contracts(self.BASE, fresh) == 0
        assert "(new" in capsys.readouterr().out

    def test_policy_violation_fails_even_when_baseline_matches(self):
        bad = {"p1/a": _clean(float_divisions={"core/x.py:f:2": 1})}
        assert diff_contracts(dict(bad), dict(bad)) == 1

    def test_glob_gates_subset(self):
        fresh = {"p1/a": _clean(kernels={"x": 1}), "p1/b": _clean()}
        assert diff_contracts(self.BASE, fresh, patterns=["p1/b"]) == 0

    def test_glob_matching_nothing_fails(self, capsys):
        assert diff_contracts(self.BASE, dict(self.BASE),
                              patterns=["p9/*"]) == 1
        assert "matched no" in capsys.readouterr().err

    def test_expand_names_semantics(self):
        base, fresh = {"p1/a": {}}, {"p1/a": {}, "p1/c": {}}
        assert expand_contract_names(["p1/*"], base, fresh) == ["p1/a",
                                                               "p1/c"]
        assert expand_contract_names(["p1/c*"], base, fresh) == []
        assert expand_contract_names(["p1/zzz"], base, fresh) == ["p1/zzz"]

    def test_baseline_round_trips(self, tmp_path):
        path = tmp_path / "b.json"
        audit.write_baseline(str(path), dict(self.BASE), devices=2)
        audit.write_baseline(str(path), {"p3/c": _clean()}, devices=2,
                             merge_into=str(path))
        assert audit.load_baseline(str(path)) == dict(self.BASE,
                                                      **{"p3/c": _clean()})


class TestCensus:
    """Fixture ops with a known census (issued from this file, whose ops
    carry the site ``<outside>``)."""

    def test_host_reads_count_once_each(self):
        x = torch.arange(5.0)
        with Census() as c:
            x.tolist()
            x.sum().item()
            int(x[1])
            bool(x[2] > 1)
            x.numpy()
        assert c.host_syncs[census.OUTSIDE] == {
            "tolist@cpu": 1, "item@cpu": 1, "__int__@cpu": 1,
            "__bool__@cpu": 1, "numpy@cpu": 1}

    def test_data_sized_ops(self):
        x = torch.arange(6.0)
        with Census() as c:
            x[x > 2]
            torch.nonzero(x)
            torch.repeat_interleave(x, torch.tensor([1, 0, 1, 0, 1, 0]))
            torch.repeat_interleave(x, torch.tensor([1, 0, 1, 0, 1, 0]),
                                    output_size=3)
            x.repeat_interleave(2)
        assert c.host_syncs[census.OUTSIDE] == {
            "index@cpu": 1, "nonzero@cpu": 1, "repeat_interleave@cpu": 1}

    def test_masked_writes(self):
        """A mask with a tensor of values waits; one host number takes
        torch's masked_fill path, which does not."""
        x = torch.zeros(6)
        with Census() as c:
            x[x == 0] = torch.ones(6)
            x[x > 0] = 3.0
        assert c.host_syncs[census.OUTSIDE] == {"index_put_@cpu": 1}

    def test_site_is_the_first_package_frame(self):
        from repro_torch.core import prng

        with Census() as c:
            prng.fold_in(prng.key(0), 1)
        assert list(c.host_syncs) == ["core/prng.py:_words:66"]
        assert c.device_reads("cpu") == {"core/prng.py:_words:66": 1}
        assert c.device_reads("cuda") == {}

    def test_float64_bytes_and_dtypes(self):
        with Census() as c:
            torch.ones(4).to(torch.float64)  # repro-lint: disable=f64-literal — the fixture's float64
        assert c.f64_bytes == {census.OUTSIDE: 32}
        assert {"f32", "f64"} <= set(c.dtypes)

    @pytest.mark.parametrize("divisor,counted", [(3.0, True), (0.1, True),
                                                 (7, True), (2.0, False),
                                                 (0.25, False), (1, False)])
    def test_float_divisions(self, divisor, counted):
        x = torch.ones(3)
        with Census() as c:
            x / divisor
        assert dict(c.float_divisions) == ({census.OUTSIDE: 1} if counted
                                           else {})

    def test_division_by_a_0d_tensor_is_clean(self):
        from repro_torch.device import scalar

        x = torch.ones(3)
        with Census() as c:
            x / scalar(3.0, x)
        assert dict(c.float_divisions) == {}

    def test_scatter_dtypes(self):
        g = torch.zeros(4, dtype=torch.bfloat16)
        idx = torch.tensor([0, 0, 1])
        with Census() as c:
            g.index_put_((idx,), torch.ones(3, dtype=torch.bfloat16),
                         accumulate=True)
            torch.zeros(4).index_put_((idx,), torch.ones(3))
        assert c.scatter_dtypes == {"bf16"}
        assert any("accumulate" in v for v in policy_violations(
            "p1/fixture", c.contract() | {"repeat_drift": []}))

    def test_kernel_wrapper_counts_its_launch_not_its_plain_ops(self):
        """On CPU tensors the wrapper runs its plain version: the census
        counts the launch the card would make and none of the plain
        version's ops (its ``.tolist()`` in ``scatter_add/ref.py``);
        ``LAUNCHES`` stays as it was."""
        from repro_torch.kernels.scatter_add import kernel as scatter
        from repro_torch.kernels.scatter_add.ops import bin_depos_to_tiles

        w0 = torch.tensor([0, 3, 40], dtype=torch.int32)
        t0 = torch.tensor([0, 5, 100], dtype=torch.int32)
        patches = torch.ones((3, 4, 4))
        ids, _, _ = bin_depos_to_tiles(w0, t0, 4, 4, 64, 256, 32, 128, 8)
        before = dict(scatter.LAUNCHES)
        with Census() as c:
            scatter.scatter_add_pallas(patches, w0, t0, ids, num_wires=64,
                                       num_ticks=256, tw=32, tt=128, k_max=8)
        assert dict(c.kernels) == {"scatter_add_pallas": 1}
        assert dict(c.host_syncs) == {} and c.dtypes == {}
        assert scatter.LAUNCHES == before

    def test_plain_watch_restored(self):
        from repro_torch import kernels

        with Census():
            with Census():
                pass
            assert kernels.PLAIN_WATCH is not None
        assert kernels.PLAIN_WATCH is None

    def test_collectives_of_a_gloo_group(self, tmp_path):
        import torch.distributed as dist

        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
        try:
            x = torch.ones(4)
            reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
                or dist.reduce_scatter_tensor
            all_gather = getattr(dist, "all_gather_single", None) \
                or dist.all_gather_into_tensor
            with Census() as c:
                dist.all_reduce(x)
                dist.all_to_all_single(torch.empty(4), x)
                reduce_scatter(torch.empty(4), x)
                all_gather(torch.empty(4), x)
        finally:
            dist.destroy_process_group()
        assert dict(c.collectives) == {"all-reduce": 1, "all-to-all": 1,
                                       "reduce-scatter": 1, "all-gather": 1}
        assert any("collectives" in v for v in policy_violations(
            "p1/fixture", c.contract() | {"repeat_drift": []}))


class TestPrograms:
    def test_contract_of_single_fused_is_the_baseline(self):
        prog = audit.program_named("single_fused")
        with audit.hermetic_tune_cache():
            got = extract_contract(*prog.build(audit.context_for(prog, 1)))
        assert got == audit.load_baseline(str(BASELINE))["p1/single_fused"]

    def test_repeat_drift_fixture(self):
        """A host cache that misses on the first call only: the second
        call's census differs."""
        seen = []

        def fn(x):
            if not seen:
                seen.append(x.tolist())
            return x * 2

        c = extract_contract(fn, lambda i: (torch.ones(3) * i,))
        assert c["repeat_drift"] == ["host_syncs"]
        assert any("repeat_drift" in v for v in policy_violations(
            "p1/fixture", c))

    @pytest.mark.parametrize("mode,field", [("f64_noise", "f64_bytes"),
                                            ("host_sync", "host_syncs"),
                                            ("float_division",
                                             "float_divisions")])
    def test_inject_trips_the_gate(self, mode, field, capsys):
        fresh = audit.collect_contracts(planes=(1,), patterns=["p1/single"],
                                        inject=mode)
        assert diff_contracts(audit.load_baseline(str(BASELINE)), fresh,
                              patterns=["p1/single"]) == 1
        out = capsys.readouterr().out
        assert "p1/single: FAIL" in out and f"{field}:" in out
        assert "policy" in out

    def test_inject_extra_collective_trips_the_gate(self, tmp_path, capsys):
        """``plane_batching="loop"`` in the three-plane distributed_psum:
        one chain a plane, on one in-process gloo rank. Mesh (1, 1) issues
        the collectives of the baseline's (1, 2), and the injected run is
        diffed against the clean one (one rank draws all the depos)."""
        import torch.distributed as dist
        from torch.distributed.device_mesh import DeviceMesh

        from repro_torch.core.distributed import AXES

        prog = audit.program_named("distributed_psum")
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
        try:
            mesh = DeviceMesh("cpu", torch.tensor([[0]]),
                              mesh_dim_names=AXES)
            fresh = {}
            for inject in (None, "extra_collective"):
                ctx = audit.context_for(prog, 3, inject=inject, mesh=mesh)
                fresh[inject] = {"p3/distributed_psum": extract_contract(
                    *prog.build(ctx))}
        finally:
            dist.destroy_process_group()
        base = audit.load_baseline(str(BASELINE))["p3/distributed_psum"]
        assert fresh[None]["p3/distributed_psum"]["collectives"] \
            == base["collectives"]
        assert diff_contracts(fresh[None], fresh["extra_collective"],
                              patterns=["p3/distributed_psum"]) == 1
        out = capsys.readouterr().out
        assert "collectives: {'all-to-all': 4, 'reduce-scatter': 2} -> " \
               "{'all-to-all': 12, 'reduce-scatter': 6}" in out

    def test_inject_modes(self):
        assert set(INJECT_MODES) == {"f64_noise", "host_sync",
                                     "float_division", "extra_collective"}
        with pytest.raises(ValueError, match="unknown inject"):
            audit.collect_contracts(planes=(1,), patterns=["p1/single"],
                                    inject="nonsense")


class TestBaselineCoverage:
    def test_baseline_covers_every_program(self):
        contracts = audit.load_baseline(str(BASELINE))
        assert sorted(contracts) == sorted(program_names())
        assert len(contracts) == 17

    def test_shared_names_are_the_reference_s(self):
        from repro.analysis.audit import PROGRAMS as REF_PROGRAMS
        from repro.analysis.audit import program_names as ref_names

        assert [p.name for p in PROGRAMS][:len(REF_PROGRAMS)] \
            == [p.name for p in REF_PROGRAMS]
        assert set(program_names()) - PORT_ONLY == set(ref_names((1, 3)))
        assert set(program_names()) - set(ref_names((1, 3))) == PORT_ONLY

    def test_programs_cover_the_port_executors(self):
        import importlib

        covered = {p.name for p in PROGRAMS}
        inventory = {
            "repro_torch.core.pipeline.make_sim_fn": {
                "single", "recon", "single_fused", "unfused_pallas_compact",
                "recon_kernels"},
            "repro_torch.core.batch.make_batched_sim_fn": {"batched"},
            "repro_torch.launch.sim.make_streaming_sim_fn": {"streaming"},
            "repro_torch.core.distributed.make_distributed_sim": {
                "distributed_psum", "distributed_halo"},
            "repro_torch.core.fit.make_fit_loss": {"fit_loss", "fit_grad"},
        }
        for entry, progs in inventory.items():
            assert progs <= covered, entry
            mod, fn = entry.rsplit(".", 1)
            assert hasattr(importlib.import_module(mod), fn), entry

    def test_baseline_satisfies_policy(self):
        for name, c in audit.load_baseline(str(BASELINE)).items():
            assert policy_violations(name, c) == [], name

    def test_port_programs_pin_their_kernels(self):
        c = audit.load_baseline(str(BASELINE))
        # one noise-spectrum launch an event, every plane in it
        assert c["p1/single_fused"]["kernels"] == {
            "fused_rasterize_scatter": 1, "noise_spectrum": 1}
        assert c["p3/single_fused"]["kernels"] == {
            "fused_rasterize_scatter_multiplane": 1, "noise_spectrum": 1}
        assert c["p1/unfused_pallas_compact"]["kernels"] == {
            "scatter_add_pallas_compact": 1, "noise_spectrum": 1}
        assert c["p3/recon_kernels"]["kernels"] == {
            "fused_rasterize_scatter_multiplane": 1, "hitfind_pallas": 3,
            "noise_spectrum": 1}
        assert c["p1/unfused_pallas_compact"]["host_syncs"][
            "kernels/scatter_add/ops.py:bin_depos_to_tiles_compact:142"] \
            == {"index@cpu": 2}

    def test_stacked_distributed_contract_matches_single_plane(self):
        c = audit.load_baseline(str(BASELINE))
        assert c["p3/distributed_psum"]["collectives"] \
            == c["p1/distributed_psum"]["collectives"]

    def test_every_listed_site_is_seen(self):
        contracts = audit.load_baseline(str(BASELINE)).values()
        assert set(KNOWN_HOST_SYNCS) == {s for c in contracts
                                         for s in c["host_syncs"]}
        assert set(ALLOWED_F64) == {s for c in contracts
                                    for s in c["f64_bytes"]}


def _site_line(where: str):
    path, func, line = where.rsplit(":", 2)
    source = (PORT / path).read_text()
    tree = ast.parse(source)
    fns = [n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
           and n.name == func and n.lineno <= int(line) <= n.end_lineno]
    return fns, source.splitlines()[int(line) - 1]


@pytest.mark.parametrize("where", sorted(ALLOWED_F64))
def test_allowed_f64_site_carries_its_suppression(where):
    fns, line = _site_line(where)
    assert fns, f"{where}: no such function at that line"
    assert "repro-lint: disable=f64-literal" in line and "—" in line


@pytest.mark.parametrize("where", sorted(KNOWN_HOST_SYNCS))
def test_known_host_sync_site_is_current(where):
    fns, line = _site_line(where)
    assert fns, f"{where}: no such function at that line"
    assert line.strip()


@pytest.fixture(scope="module")
def gate():
    """The gate end to end, once: lint + every program (the distributed
    ones on one spawn of 2 gloo ranks), fresh contracts kept."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "fresh.json"
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.audit", "--quiet",
             "--json", str(out)], env=env, cwd=ROOT, capture_output=True,
            text=True, timeout=600)
        fresh = json.loads(out.read_text())["contracts"] \
            if out.exists() else {}
    return proc, fresh


class TestGate:
    def test_gate_passes_against_committed_baseline(self, gate):
        proc, fresh = gate
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 finding(s)" in proc.stdout
        assert "gated 17 contract(s)" in proc.stdout
        assert fresh == audit.load_baseline(str(BASELINE))

    def test_collective_kinds_equal_the_reference_s(self, gate):
        """Shared distributed contracts issue the reference's kinds (the
        all-to-all counts differ: PERF.md); local ones issue none."""
        _, fresh = gate
        ref = json.loads(REF_BASELINE.read_text())["contracts"]
        for name, c in fresh.items():
            if name in ref:
                assert set(c["collectives"]) == set(ref[name]["collectives"])
            if "distributed" not in name:
                assert c["collectives"] == {}, name
        assert fresh["p1/distributed_psum"]["collectives"]["reduce-scatter"] \
            == ref["p1/distributed_psum"]["collectives"]["reduce-scatter"]

    def test_dtypes_within_the_reference_s(self, gate):
        _, fresh = gate
        ref = json.loads(REF_BASELINE.read_text())["contracts"]
        mapped = {d for c in ref.values() for d in c["dtypes"]} | {"s64"}
        for name, c in fresh.items():
            extra = set(c["dtypes"]) - mapped
            assert extra <= {"f64"}, (name, extra)
            assert set(c["f64_bytes"]) <= set(ALLOWED_F64), name

    def test_cli_inject_fails_naming_the_field(self):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   JAX_PLATFORMS="cpu")
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.audit", "--check",
             "--quiet", "--planes", "1", "--programs", "p1/single",
             "--inject", "host_sync"], env=env, cwd=ROOT,
            capture_output=True, text=True, timeout=300)
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "p1/single: FAIL" in proc.stdout
        assert "host_syncs:" in proc.stdout
