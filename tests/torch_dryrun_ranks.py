"""Rank functions of ``tests/test_torch_dryrun.py``, importable without
JAX (spawn imports a rank function's module anew in every child).

``collectives`` runs the plain sharded train step and one decode step of
``CFG`` on the spawn's (4, 2) mesh of gloo ranks, each under the op census
(``analysis.census``), and returns the c10d collectives each issued, count
and operand bytes by kind. The test holds them against the same steps on a
fake world of 8 (``launch.dryrun.measure``).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.analysis.census import Census
from repro_torch.config import ShapeConfig, get_config
from repro_torch.core import prng
from repro_torch.data.tokens import make_batch, shard_batch
from repro_torch.launch.specs import build_decode, build_train
from repro_torch.models.model import Model
from repro_torch.optim.adamw import init_opt_state
from repro_torch.parallel import fsdp, kvcache
from repro_torch.parallel import sharding as S

ARCH = "gemma2-2b"
MESH = (4, 2)
SHAPES = {"train": ShapeConfig("t", "train", 16, 8),
          "decode": ShapeConfig("d", "decode", 32, 8)}


def cfg():
    return get_config(ARCH, smoke=True)


def _counted(census: Census, kind: str) -> Dict[str, np.ndarray]:
    out = {}
    for k, n in census.collectives.items():
        out[f"{kind}.{k}.count"] = np.int64(n)
        out[f"{kind}.{k}.bytes"] = np.int64(census.collective_bytes[k])
    return out


def collectives(mesh) -> Dict[str, np.ndarray]:
    """One train step and one decode step (at position 0 of fresh caches)
    of ``cfg()`` on ``mesh``, each under a census: rank 0's collectives."""
    c = cfg()
    out = {}
    with S.use_mesh(mesh, S.act_rules_for(c, mesh)):
        fn, _, (psh, osh, _), _ = build_train(c, SHAPES["train"], mesh)
        full = Model(c, "cpu").init(prng.key(0), trainable=True)
        params = fsdp.place(full, psh)
        opt = fsdp.place(init_opt_state(full), osh)
        batch = shard_batch(make_batch(c, SHAPES["train"], 0, 0), mesh)
        with Census() as census:
            fn(params, opt, batch)
        out.update(_counted(census, "train"))

        shape = SHAPES["decode"]
        dec, _, dsh, _ = build_decode(c, shape, mesh)
        served = kvcache.place(Model(c, "cpu").init(prng.key(1)), dsh[0])
        tok = kvcache.place(torch.zeros((shape.global_batch, 1),
                                        dtype=torch.int32), dsh[1])
        caches = kvcache.init_blocks(c, shape.global_batch, shape.seq_len,
                                     dsh[2], "cpu")
        with Census() as census:
            dec(served, tok, caches, 0)
        out.update(_counted(census, "decode"))
    return out
