"""The port's serving specs against the reference's, entry for entry:
``DECODE_RULES`` and ``_CACHE_NAMES``, every cache leaf's spec of every
registered LM config at full width (``cache_shardings(cache_specs(cfg,
128, 32768))``, ``decode_32k``'s batch and length) on five meshes, and the
token, batch, ``enc_out`` and cache specs that ``build_decode`` /
``build_prefill`` return.

No tensor is built: the port's specs come from meta tensors on a mesh
stand-in (an object with a ``.shape`` dict), the reference's from
``ShapeDtypeStruct``s on a ``jax.sharding.AbstractMesh``. A cache's
``index`` is the one stated exception: the port's is a host int and takes
no sharding, the reference's is a (layers,) array left whole.
"""
import jax
import pytest
from jax.sharding import AbstractMesh

from repro import config as jconfig
from repro.launch import specs as jspecs
from repro.parallel import sharding as jsharding
from repro_torch import config as tconfig
from repro_torch.launch import specs as tspecs
from repro_torch.parallel import sharding as tsharding
from repro_torch.tree import tree_items

ARCHS = sorted(a for a in tconfig.list_archs() if a != "lartpc-uboone")
MESHES = [(1, 1), (4, 2), (2, 4), (8, 1), (16, 16)]
BATCH, MAX_LEN = 128, 32768


class StandIn:
    def __init__(self, data: int, model: int):
        self.shape = {"data": data, "model": model}


def _meshes(dims):
    return StandIn(*dims), AbstractMesh(tuple(dims), ("data", "model"))


def _port_specs(tree):
    """{path: spec} of a port sharding tree (an index's None is no
    leaf)."""
    return {key: sh.spec for key, sh in tree_items(tree)}


def _ref_specs(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.NamedSharding))[0]
    return {"/".join(str(getattr(p, "name", getattr(p, "key", p)))
                     for p in path): tuple(sh.spec) for path, sh in leaves}


def _equal_but_index(port, ref):
    index = {k for k in ref if k.endswith("/index")}
    # the port's index is a host int: no sharding to place
    assert port.keys() == ref.keys() - index
    assert all(ref[k] == (None,) for k in index)
    for key, spec in port.items():
        assert spec == ref[key], (key, spec, ref[key])


def test_ten_archs_registered():
    assert len(ARCHS) == 10


def test_decode_rules_and_cache_names_equal_reference():
    assert tspecs.DECODE_RULES == jspecs.DECODE_RULES
    assert tspecs._CACHE_NAMES == jspecs._CACHE_NAMES
    assert tspecs.DECODE_RULES["kv_seq"] == "model"
    assert tspecs.DECODE_RULES["heads"] == "model"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_reference(arch, mesh):
    stand_in, abstract = _meshes(mesh)
    port = tspecs.cache_shardings(
        tspecs.cache_specs(tconfig.get_config(arch), BATCH, MAX_LEN),
        stand_in)
    ref = jspecs.cache_shardings(
        jspecs.cache_specs(jconfig.get_config(arch), BATCH, MAX_LEN),
        abstract)
    _equal_but_index(_port_specs(port), _ref_specs(ref))


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_builder_specs_equal_reference(arch, mesh, monkeypatch):
    """The token, batch, ``enc_out`` and cache shardings of both builders at
    ``decode_32k``'s shape, under the arch's activation rules (a prompt's
    batch follows them; a decode token and ``enc_out`` follow
    ``ACT_RULES``)."""
    stand_in, abstract = _meshes(mesh)
    tcfg, jcfg = tconfig.get_config(arch), jconfig.get_config(arch)
    shape_t = tconfig.ShapeConfig("decode_32k", "decode", MAX_LEN, BATCH)
    shape_j = jconfig.ShapeConfig("decode_32k", "decode", MAX_LEN, BATCH)
    # the reference's use_mesh enters its mesh, which an AbstractMesh
    # refuses: set the rules its batch_shardings reads directly
    monkeypatch.setattr(jsharding._state, "act_rules",
                        jsharding.act_rules_for(jcfg, abstract),
                        raising=False)
    with tsharding.use_mesh(stand_in, tsharding.act_rules_for(tcfg,
                                                              stand_in)):
        _, _, tdec, _ = tspecs.build_decode(tcfg, shape_t, stand_in)
        _, _, tpre, _ = tspecs.build_prefill(tcfg, shape_t, stand_in)
    _, _, jdec, _ = jspecs.build_decode(jcfg, shape_j, abstract)
    _, _, jpre, _ = jspecs.build_prefill(jcfg, shape_j, abstract)

    assert tdec[1].spec == tuple(jdec[1].spec)                    # token
    assert tdec[3] is None and tuple(jdec[3].spec) == ()          # index
    _equal_but_index(_port_specs(tdec[2]), _ref_specs(jdec[2]))   # caches
    if tcfg.is_encoder_decoder:
        assert [s.spec for s in tdec[4]] == [tuple(s.spec) for s in jdec[4]]
    else:
        assert len(tdec) == len(jdec) == 4
    assert tpre[1].keys() == jpre[1].keys()                       # batch
    for key, sh in jpre[1].items():
        assert tpre[1][key].spec == tuple(sh.spec), key
    _equal_but_index(_port_specs(tpre[2]), _ref_specs(jpre[2]))
