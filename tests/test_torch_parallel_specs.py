"""The port's sharding specs against the reference's, entry for entry: the
rule tables, every parameter's spec of every registered LM config at full
width on five meshes under ``PARAM_RULES`` and ``rules_without_fsdp``,
the activation-rule choice, and ``build_spec`` on activation shapes.

No devices: both packages' ``build_spec`` read only a mesh's ``.shape``,
so one stand-in object serves both.
"""
import numpy as np
import pytest

from repro import config as jconfig
from repro.models.model import Model as JModel
from repro.parallel import sharding as jsharding
from repro_torch import config as tconfig
from repro_torch.models.model import Model as TModel
from repro_torch.parallel import sharding as tsharding

ARCHS = sorted(a for a in tconfig.list_archs() if a != "lartpc-uboone")
MESHES = [(1, 1), (4, 2), (2, 4), (8, 1), (16, 16)]
RULES = ["param", "no_fsdp"]


class StandIn:
    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}


def _rules(pkg, which):
    rules = pkg.PARAM_RULES
    return pkg.rules_without_fsdp(rules) if which == "no_fsdp" else rules


def _flatten(tree, prefix=""):
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = tuple(v)
    return out


def test_ten_archs_registered():
    assert len(ARCHS) == 10
    assert set(ARCHS) <= set(jconfig.list_archs())


def test_rule_tables_equal():
    for name in ("PARAM_RULES", "ACT_RULES", "DP_ACT_RULES"):
        assert getattr(tsharding, name) == getattr(jsharding, name), name
    assert (tsharding.rules_without_fsdp(tsharding.PARAM_RULES)
            == jsharding.rules_without_fsdp(jsharding.PARAM_RULES))


@pytest.mark.parametrize("rules", RULES)
@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, mesh, rules):
    stand_in = StandIn(*mesh)
    port = _flatten(TModel(tconfig.get_config(arch), "cpu").specs(
        stand_in, rules=_rules(tsharding, rules)))
    ref = _flatten(JModel(jconfig.get_config(arch)).specs(
        stand_in, rules=_rules(jsharding, rules)))
    assert port.keys() == ref.keys()
    for name, spec in ref.items():
        assert port[name] == spec, (name, port[name], spec)


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_act_rules_choice_equals_reference(arch, mesh):
    stand_in = StandIn(*mesh)
    port = tsharding.act_rules_for(tconfig.get_config(arch), stand_in)
    ref = jsharding.act_rules_for(jconfig.get_config(arch), stand_in)
    assert port == ref
    assert (port is tsharding.DP_ACT_RULES) == (ref is jsharding.DP_ACT_RULES)


ACT_CASES = [
    ((8, 4096, 2304), ("batch", "seq", "embed")),
    ((1, 1, 2304), ("batch", "seq", "embed")),
    ((8, 4096, 8, 256), ("batch", "attn_seq", "heads", "head_dim")),
    ((8, 4096, 4, 256), ("batch", "attn_seq", "kv_heads", "head_dim")),
    ((8, 4096, 9216), ("batch", "seq", "mlp")),
    ((8, 4096, 256000), ("batch", "seq", "vocab")),
    ((64, 40, 2048), ("experts", "capacity", "embed")),
    ((6, 4096), ("batch", None)),
    ((100000,), ("depos",)),
    ((4, 2560, 9592), ("events", "wires", "ticks")),
]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def test_build_spec_activations_equal_reference(mesh):
    stand_in = StandIn(*mesh)
    for rules in ("ACT_RULES", "DP_ACT_RULES"):
        for shape, names in ACT_CASES:
            port = tsharding.build_spec(shape, names, stand_in,
                                        getattr(tsharding, rules))
            ref = jsharding.build_spec(shape, names, stand_in,
                                       getattr(jsharding, rules))
            assert port == tuple(ref), (rules, shape, names, port, ref)


def test_no_mesh_gives_the_empty_spec():
    assert tsharding.build_spec((4, 4), ("batch", None), None,
                                tsharding.ACT_RULES) == ()
    assert tsharding.named_sharding((4, 4), ("batch", None)) is None
    assert tsharding.act_rules_for(None, None) is tsharding.ACT_RULES


def test_local_shape_divides_every_axis():
    stand_in = StandIn(4, 2)
    spec = tsharding.build_spec((8, 32, 64), ("batch", "seq", "mlp"),
                                stand_in, tsharding.ACT_RULES)
    assert spec == ("data", "model", None)
    assert tsharding.local_shape((8, 32, 64), spec, stand_in) == (2, 16, 64)
    assert int(np.prod(tsharding.local_shape((8, 32, 64), spec, stand_in))
               ) * 8 == 8 * 32 * 64
