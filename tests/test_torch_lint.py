"""torch-lint, the port's counterpart of ``tests/test_repro_lint.py``: every
rule catches a minimal violation and stays quiet on its clean form, the
suppressions (the port's marker and the reference's, for the shared
rules) work, and ``src/repro_torch`` is clean."""
import ast
import json
import textwrap
from pathlib import Path

from repro_torch.analysis import lint
from repro_torch.analysis.lint import (RULES, SHARED_RULES, lint_paths,
                                       lint_source, stage_function_names)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
#: a path inside the port's core/, where scalar-division applies
CORE = str(PORT / "core" / "x.py")


def findings(src, path="x.py"):
    return lint_source(textwrap.dedent(src), path)


def rules_of(fs):
    return [f.rule for f in fs]


class TestKeyReuse:
    def test_minimal_violation(self):
        fs = findings("""
            from repro_torch.core import prng
            def f(k):
                a = prng.normal(k, (3,), "cpu")
                b = prng.uniform(k, (3,), 0.0, 1.0, "cpu")
                return a + b
        """)
        assert rules_of(fs) == ["key-reuse"]

    def test_split_between_is_clean(self):
        fs = findings("""
            from repro_torch.core import prng
            def f(k):
                k1, k2 = prng.split(k)
                return prng.normal(k1, (3,), "cpu") + prng.normal(k2, (3,),
                                                                  "cpu")
        """)
        assert fs == []

    def test_fold_in_reassignment_resets(self):
        fs = findings("""
            from repro_torch.core import prng
            def f(k):
                a = prng.random_bits(k, (3,), "cpu")
                k = prng.fold_in(k, 1)
                return a, prng.random_bits(k, (3,), "cpu")
        """)
        assert fs == []

    def test_bare_sampler_inside_prng(self):
        fs = findings("""
            def normal(k, shape, device):
                u = uniform(k, shape, -1.0, 1.0, device)
                return u + uniform(k, shape, -1.0, 1.0, device)
        """)
        assert rules_of(fs) == ["key-reuse"]

    def test_returning_branch_is_clean(self):
        """``prng.uniform``'s idiom: a returning branch consumes the key on
        an exclusive path."""
        fs = findings("""
            def uniform(k, shape, lo, hi, device, dtype):
                if dtype == "bf16":
                    return random_bits(k, shape, device)
                return random_bits(k, shape, device) * 2
        """)
        assert fs == []

    def test_torch_and_numpy_samplers_are_not_keys(self):
        fs = findings("""
            import numpy as np, torch
            def f(k):
                return torch.normal(k, 1.0) + np.random.uniform(k) \\
                    + torch.normal(k, 1.0)
        """)
        assert fs == []


class TestMutableDefault:
    def test_list_default_flagged(self):
        assert rules_of(findings("def f(x, acc=[]):\n    return acc\n")) \
            == ["mutable-default"]

    def test_none_default_clean(self):
        assert findings("def f(x, acc=None):\n    return acc\n") == []


class TestF64Literal:
    def test_torch_attribute_flagged(self):
        fs = findings("""
            import torch
            def f(x):
                return x.to(torch.float64)
        """)
        assert rules_of(fs) == ["f64-literal"]

    def test_double_attribute_and_method_flagged(self):
        fs = findings("""
            import torch
            def f(x):
                return x.double() + torch.zeros(3, dtype=torch.double)
        """)
        assert rules_of(fs) == ["f64-literal", "f64-literal"]

    def test_dtype_string_flagged(self):
        fs = findings("""
            def f(x):
                return x.to("float64")
        """)
        assert rules_of(fs) == ["f64-literal"]

    def test_dtype_comparison_is_clean(self):
        fs = findings("""
            import torch
            def f(x):
                return x.dtype in (torch.float32, torch.float64)
        """)
        assert fs == []

    def test_float32_is_clean(self):
        assert findings("import torch\ny = torch.float32\n") == []


class TestHostSync:
    def test_item_in_stage_function_flagged(self):
        fs = findings("""
            def noise_stage(cfg):
                def fn(state):
                    return state.signal.sum().item()
                return Stage("noise", fn)
        """)
        assert rules_of(fs) == ["host-sync"]

    def test_tolist_in_simstate_annotated_function_flagged(self):
        fs = findings("""
            def fn(state: SimState) -> SimState:
                n = state.grid.tolist()
                return state
        """)
        assert rules_of(fs) == ["host-sync"]

    def test_int_of_tensor_in_kernel_wrapper_flagged(self):
        fs = findings("""
            LAUNCHES = {"k": 0}
            def k(x, *, cap: int):
                return int(x.max()) + int(cap)
        """)
        assert rules_of(fs) == ["host-sync"]

    def test_graph_replace_marks_kwarg(self):
        tree = ast.parse(textwrap.dedent("""
            def noisy(s):
                return s
            graph = graph.replace(noise=noisy)
        """))
        assert "noisy" in stage_function_names(tree)

    def test_static_metadata_is_clean(self):
        fs = findings("""
            def fn(state: SimState) -> SimState:
                n = int(state.grid.shape[0]) + int(state.n_valid or 0)
                return state
        """)
        assert fs == []

    def test_outside_stage_and_wrapper_is_clean(self):
        fs = findings("""
            def helper(x):
                return x.tolist(), float(x)
        """)
        assert fs == []


class TestConfigBranch:
    def test_if_on_fittable_field_flagged(self):
        fs = findings("""
            def f(cfg, x):
                if cfg.electron_lifetime_us > 0:
                    return x
                return -x
        """)
        assert rules_of(fs) == ["config-branch"]

    def test_float_and_max_flagged(self):
        fs = findings("""
            def f(cfg):
                return float(cfg.recombination), max(cfg.noise_rms_adc, 1.0)
        """)
        assert rules_of(fs) == ["config-branch", "config-branch"]

    def test_other_fields_and_scalar_are_clean(self):
        fs = findings("""
            def f(cfg, x):
                if cfg.fluctuate:
                    x = x * scalar(cfg.recombination, x)
                return x
        """)
        assert fs == []

    def test_fields_read_from_fit_module(self):
        from repro_torch.core.fit import FITTABLE_FIELDS

        assert lint.fittable_fields() == FITTABLE_FIELDS


class TestTensorFork:
    def test_isinstance_on_config_field_flagged(self):
        fs = findings("""
            import torch
            def f(cfg, x):
                if isinstance(cfg.response_gain, torch.Tensor):
                    return x
                return x * 2
        """)
        assert rules_of(fs) == ["tensor-fork"]

    def test_device_scalar_is_the_one_fork(self):
        src = textwrap.dedent("""
            import torch
            def scalar(value, like):
                if isinstance(value.recombination, torch.Tensor):
                    return value
                return like
        """)
        assert lint_source(src, str(PORT / "device.py")) == []
        assert rules_of(lint_source(src, "other.py")) == ["tensor-fork"]

    def test_isinstance_on_a_local_is_clean(self):
        fs = findings("""
            import torch
            def f(x):
                return isinstance(x, torch.Tensor)
        """)
        assert fs == []


class TestScalarDivision:
    def test_tensor_by_inexact_literal_flagged(self):
        fs = findings("""
            def f(x):
                y = x / 3.0
                y /= 0.1
                return y
        """, CORE)
        assert rules_of(fs) == ["scalar-division", "scalar-division"]

    def test_tensor_by_config_field_flagged(self):
        fs = findings("""
            def f(cfg, noise):
                return noise / cfg.adc_per_electron
        """, CORE)
        assert rules_of(fs) == ["scalar-division"]

    def test_clean_forms(self):
        """Powers of two divide exactly; a Python-number dividend is host
        arithmetic; a 0-d divisor is a true division."""
        fs = findings("""
            def f(cfg, x):
                rw = cfg.response_wires
                a = x / 2.0 + x / 0.25
                b = rw / 6.0 + cfg.num_ticks / 3.0 + len(x) / 3.0
                return a / scalar(3.0, a), b
        """, CORE)
        assert fs == []

    def test_outside_core_and_kernels_is_clean(self):
        assert findings("def f(x):\n    return x / 3.0\n",
                        str(PORT / "launch" / "x.py")) == []


class TestAtomicIndexAdd:
    def test_index_add_flagged(self):
        fs = findings("""
            def f(out, idx, vals):
                out.index_add_(0, idx, vals)
                return out
        """)
        assert rules_of(fs) == ["atomic-index-add"]

    def test_index_put_accumulate_is_clean(self):
        fs = findings("""
            def f(out, idx, vals):
                return out.index_put_((idx,), vals, accumulate=True)
        """)
        assert fs == []


class TestSuppressions:
    def test_port_marker_suppresses_its_rule_only(self):
        fs = findings("""
            def f(out, idx, vals, acc=[]):  # torch-lint: disable=atomic-index-add
                return out.index_add_(0, idx, vals)  # torch-lint: disable=atomic-index-add — int counts
        """)
        assert rules_of(fs) == ["mutable-default"]

    def test_reference_marker_suppresses_shared_rules(self):
        fs = findings("""
            import torch
            def f(x):
                return x.to(torch.float64)  # repro-lint: disable=f64-literal — why
        """)
        assert fs == []

    def test_reference_marker_does_not_suppress_port_rules(self):
        fs = findings("""
            def f(out, idx, vals):
                return out.index_add_(0, idx, vals)  # repro-lint: disable=atomic-index-add
        """)
        assert rules_of(fs) == ["atomic-index-add"]

    def test_file_suppression(self):
        fs = findings("""
            # torch-lint: disable-file=mutable-default
            def f(x, acc=[]):
                return acc
            def g(x, acc={}):
                return acc
        """)
        assert fs == []

    def test_every_shared_rule_is_a_reference_rule(self):
        from repro.analysis.lint import RULES as REF_RULES

        assert set(SHARED_RULES) <= set(REF_RULES) and set(SHARED_RULES) \
            <= set(RULES)

    def test_port_suppressions_give_a_reason(self):
        """Each deliberate exception in the port says why on its line."""
        for path in PORT.rglob("*.py"):
            for i, line in enumerate(path.read_text().splitlines(), 1):
                if "# torch-lint: disable=" in line:
                    assert "—" in line.split("# torch-lint:")[1], \
                        f"{path}:{i} suppresses without a reason"


class TestGate:
    def test_rule_catalog(self):
        assert len(RULES) == 8
        for name in RULES:
            assert name == name.lower() and " " not in name

    def test_port_src_is_clean(self):
        """The gate's contract: zero findings over src/repro_torch."""
        assert lint_paths([str(PORT)]) == []

    def test_parse_error_reported_not_raised(self):
        assert rules_of(findings("def broken(:\n")) == ["parse-error"]

    def test_cli_list_rules_and_json(self, tmp_path, capsys):
        assert lint.main(["--list-rules"]) == 0
        assert "atomic-index-add" in capsys.readouterr().out
        bad = tmp_path / "bad.py"
        bad.write_text("def f(x, acc=[]):\n    return acc\n")
        assert lint.main(["--json", str(bad)]) == 1
        assert json.loads(capsys.readouterr().out)[0]["rule"] \
            == "mutable-default"

    def test_launch_audit_lint_layer(self, capsys):
        from repro_torch.launch import audit as launch_audit

        assert launch_audit.main(["--skip-audit", "--lint-paths",
                                  str(PORT)]) == 0
        assert "0 finding(s)" in capsys.readouterr().out
