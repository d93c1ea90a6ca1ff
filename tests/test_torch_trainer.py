"""The port's training loop, checkpoints, data pipeline and launcher on the
CPU: counterparts of ``tests/test_trainer.py`` and of
``tests/test_substrates.py``'s ``TestCheckpoint`` and ``TestDataPipeline``,
a bfloat16 checkpoint round trip, resume bit for bit, the port's
``Trainer`` against the reference's on ``TINY``, and
``repro_torch.launch.train``.
"""
import dataclasses
import json
import os
import signal

import numpy as np
import pytest
import torch

from repro.config import CheckpointConfig as JCheckpointConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import OptimizerConfig as JOptimizerConfig
from repro.config import ShapeConfig as JShapeConfig
from repro.config import TrainConfig as JTrainConfig
from repro.data.tokens import make_batch as jmake_batch
from repro.train.trainer import Trainer as JTrainer
from repro_torch.ckpt.checkpoint import CheckpointManager
from repro_torch.config import (CheckpointConfig, ModelConfig,
                                OptimizerConfig, ShapeConfig, TrainConfig)
from repro_torch.data.tokens import DataPipeline, make_batch
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import OptState
from repro_torch.tree import tree_leaves
from repro_torch.testing import parity
from repro_torch.train.trainer import Trainer

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """A run installs the trainer's SIGTERM handler, as the reference's
    does; each test gives the process its own back."""
    saved = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, saved)


TINY = ModelConfig(num_layers=2, d_model=32, num_heads=2, num_kv_heads=2,
                   d_ff=64, vocab_size=128, remat="none")
SHAPE = ShapeConfig("tiny", "train", seq_len=32, global_batch=4)


def _cfg(tmp_path, total=12, every=5):
    return TrainConfig(
        model=TINY, shape=SHAPE,
        optimizer=OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=total,
                                  schedule="cosine"),
        checkpoint=CheckpointConfig(directory=str(tmp_path),
                                    every_steps=every, keep=2,
                                    async_save=False),
        log_every=1000,
    )


# ---------------------------------------------------------------------------
# tests/test_trainer.py on the port
# ---------------------------------------------------------------------------

def test_loss_decreases(tmp_path):
    result = Trainer(_cfg(tmp_path, total=30, every=100), "cpu").run()
    assert result.steps_run == 30
    first = np.mean(result.losses[:5])
    last = np.mean(result.losses[-5:])
    assert last < first, (first, last)


def test_checkpoint_resume_continues(tmp_path):
    r1 = Trainer(_cfg(tmp_path), "cpu").run(max_steps=12)
    assert r1.final_step == 12
    r2 = Trainer(_cfg(tmp_path, total=15), "cpu").run(max_steps=15)
    assert r2.resumed_from == 10
    assert r2.steps_run == 5  # 10 -> 15


def test_resume_is_deterministic_bit_for_bit(tmp_path):
    """An unbroken 10-step run against 8 steps, a checkpoint at 8 and a
    resumed run to 10: the last loss and every parameter equal bit for
    bit (the reference's test allows 1e-4)."""
    t1 = Trainer(_cfg(tmp_path / "a", total=10, every=4), "cpu")
    r1 = t1.run(max_steps=10)
    Trainer(_cfg(tmp_path / "b", total=10, every=4), "cpu").run(max_steps=8)
    t2 = Trainer(_cfg(tmp_path / "b", total=10, every=4), "cpu")
    r2 = t2.run(max_steps=10)
    assert r2.resumed_from == 8 and r2.steps_run == 2
    assert r1.losses[-2:] == r2.losses
    for a, b in zip(tree_leaves(t1.model.params()),
                    tree_leaves(t2.model.params())):
        assert torch.equal(a, b)


def test_straggler_detection(tmp_path):
    cfg = dataclasses.replace(_cfg(tmp_path), straggler_deadline_s=1e-9)
    result = Trainer(cfg, "cpu").run(max_steps=3)
    assert result.straggler_steps == 3  # every step exceeds a 1ns deadline


def test_sigterm_checkpoints_and_stops(tmp_path):
    """The SIGTERM handler the run installs, called while the third batch
    is fetched: that step saves a checkpoint and the run stops there."""
    trainer = Trainer(_cfg(tmp_path, total=20, every=100), "cpu")
    real_next = DataPipeline.__next__

    def next_then_term(self):
        if self.step == 2:
            signal.getsignal(signal.SIGTERM)(signal.SIGTERM, None)
        return real_next(self)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(DataPipeline, "__next__", next_then_term)
        result = trainer.run()
    assert result.final_step == 3
    assert trainer.ckpt.latest_step() == 3


# ---------------------------------------------------------------------------
# The port's Trainer against the reference's
# ---------------------------------------------------------------------------

def test_trainer_losses_match_reference(tmp_path):
    """``TINY`` (bfloat16 activations, the config's default) over 10
    steps: the port's losses against the reference's ``Trainer`` (its own
    parameter draw from the same seed, equal to the port's up to the ULPs
    of erfinv), within ``lm_bf16_atol_frac(2)`` relative per step
    (measured 2.3e-4); the tokens of every step equal bit for bit."""
    jcfg = JTrainConfig(
        model=JModelConfig(**{f.name: getattr(TINY, f.name)
                              for f in dataclasses.fields(TINY)}),
        shape=JShapeConfig(**dataclasses.asdict(SHAPE)),
        optimizer=JOptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=10,
                                   schedule="cosine"),
        checkpoint=JCheckpointConfig(directory=str(tmp_path / "ref"),
                                     every_steps=100, async_save=False),
        log_every=1000)
    ref = JTrainer(jcfg).run(max_steps=10)
    ours = Trainer(dataclasses.replace(
        _cfg(tmp_path / "port", total=10, every=100)), "cpu").run(
            max_steps=10)
    np.testing.assert_allclose(ours.losses, ref.losses,
                               rtol=parity.lm_bf16_atol_frac(
                                   TINY.num_layers))
    for step in range(10):
        np.testing.assert_array_equal(
            make_batch(TINY, SHAPE, 0, step)["tokens"],
            jmake_batch(jcfg.model, jcfg.shape, 0, step)["tokens"])


# ---------------------------------------------------------------------------
# Checkpoints (tests/test_substrates.py::TestCheckpoint on the port)
# ---------------------------------------------------------------------------

class TestCheckpoint:
    def test_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 4))}}
        mgr.save(5, tree, extra={"step": 5})
        restored, extra = mgr.restore(5, tree)
        assert extra["step"] == 5
        for x, y in zip(tree_leaves(tree), tree_leaves(restored)):
            assert torch.equal(x, y)

    def test_keep_rotation(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
        tree = {"a": torch.zeros(4)}
        for s in [1, 2, 3, 4]:
            mgr.save(s, tree)
        assert mgr.all_steps() == [3, 4]

    def test_latest_and_async(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=True)
        tree = {"a": torch.ones(8)}
        mgr.save(7, tree)
        tree["a"].add_(1.0)      # after save: the snapshot is the old value
        mgr.wait()
        assert mgr.latest_step() == 7
        restored, _ = mgr.restore(7, tree)
        assert torch.equal(restored["a"], torch.ones(8))

    def test_crash_safety_tmp_ignored(self, tmp_path):
        """A partial (crashed) write must not be visible as a
        checkpoint."""
        mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
        os.makedirs(tmp_path / "step_00000009")  # no manifest.json inside
        assert mgr.all_steps() == []

    def test_bf16_and_opt_state_round_trip(self, tmp_path):
        """bfloat16 leaves stored as their uint16 bits and restored bit for
        bit; an ``OptState`` with its step and a None master under the
        reference's path keys."""
        bits = torch.randint(-2 ** 15, 2 ** 15, (6, 5), dtype=torch.int16)
        bits[0, :3] = torch.tensor([0x7FC0, -0x80, 0x0001])  # nan, -0, tiny
        params = {"w": bits.view(torch.bfloat16), "s": torch.ones(3)}
        opt = OptState(step=torch.tensor(4, dtype=torch.int32),
                       m={"s": torch.zeros(3), "w": torch.ones(6, 5)},
                       v={"s": torch.zeros(3), "w": torch.ones(6, 5)})
        mgr = CheckpointManager(str(tmp_path), keep=1, async_save=False)
        tree = {"params": params, "opt": opt}
        mgr.save(4, tree, extra={"step": 4, "data_state": 4})
        with open(tmp_path / "step_00000004" / "manifest.json") as f:
            manifest = json.load(f)
        keys = {e["key"]: e["dtype"] for e in manifest["leaves"]}
        assert keys == {"opt/m/s": "float32", "opt/m/w": "float32",
                        "opt/step": "int32", "opt/v/s": "float32",
                        "opt/v/w": "float32", "params/s": "float32",
                        "params/w": "bfloat16"}
        restored, extra = mgr.restore(4, tree)
        assert extra == {"step": 4, "data_state": 4}
        w = restored["params"]["w"]
        assert w.dtype == torch.bfloat16
        assert torch.equal(w.view(torch.int16), bits)
        assert isinstance(restored["opt"], OptState)
        assert restored["opt"].master is None
        assert int(restored["opt"].step) == 4


# ---------------------------------------------------------------------------
# Data (tests/test_substrates.py::TestDataPipeline on the port)
# ---------------------------------------------------------------------------

class TestDataPipeline:
    CFG = ModelConfig(d_model=16, vocab_size=128, num_heads=2,
                      num_kv_heads=2)
    SHAPE = ShapeConfig("t", "train", seq_len=16, global_batch=4)

    def test_deterministic(self):
        b1 = make_batch(self.CFG, self.SHAPE, seed=3, step=7)
        b2 = make_batch(self.CFG, self.SHAPE, seed=3, step=7)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        b3 = make_batch(self.CFG, self.SHAPE, seed=3, step=8)
        assert not np.array_equal(b1["tokens"], b3["tokens"])

    def test_restart_resumes_exactly(self):
        p1 = DataPipeline(self.CFG, self.SHAPE, seed=0, start_step=0,
                          device="cpu")
        batches = [next(p1)["tokens"] for _ in range(3)]
        state = p1.state()
        p1.close()
        p2 = DataPipeline(self.CFG, self.SHAPE, seed=0, start_step=state,
                          device="cpu")
        nxt = next(p2)["tokens"]
        p2.close()
        assert len(batches) == 3 and nxt.dtype == torch.int32
        expect = make_batch(self.CFG, self.SHAPE, seed=0, step=3)["tokens"]
        np.testing.assert_array_equal(nxt.numpy(), expect)

    def test_tokens_in_range_and_equal_reference(self):
        b = make_batch(self.CFG, self.SHAPE, seed=0, step=0)
        assert b["tokens"].min() >= 0
        assert b["tokens"].max() < self.CFG.vocab_size
        ref = jmake_batch(JModelConfig(d_model=16, vocab_size=128,
                                       num_heads=2, num_kv_heads=2),
                          JShapeConfig("t", "train", 16, 4), seed=0, step=0)
        np.testing.assert_array_equal(b["tokens"], ref["tokens"])


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

def test_launch_train_smoke_on_the_cpu(tmp_path, capsys):
    result = launch_train.main(["--arch", "gemma2-2b", "--smoke", "--steps",
                                "3", "--batch", "2", "--seq", "16",
                                "--ckpt-dir", str(tmp_path), "--device",
                                "cpu"])
    assert result.steps_run == 3 and len(result.losses) == 3
    assert all(np.isfinite(result.losses))
    assert "done: 3 steps" in capsys.readouterr().out


def test_launch_train_refuses_a_mesh(tmp_path):
    """``--mesh`` runs ranks (``tests/test_torch_parallel.py``); a mesh the
    launcher cannot lay out (a third dim, an empty dim) is refused before
    any rank starts."""
    for mesh in ("4x2x1", "0x2"):
        with pytest.raises(ValueError, match="expected D or DxM"):
            launch_train.main(["--arch", "gemma2-2b", "--smoke", "--mesh",
                               mesh, "--ckpt-dir", str(tmp_path),
                               "--device", "cpu"])


def test_train_configs_match_reference():
    """Every field and default of the training dataclasses, but the
    checkpoint directory's default (under ``TMPDIR``, not ``/tmp``)."""
    import repro.config as J
    import repro_torch.config as T
    for name in ("ShapeConfig", "ParallelConfig", "OptimizerConfig",
                 "CheckpointConfig", "TrainConfig"):
        jf = {f.name: f for f in dataclasses.fields(getattr(J, name))}
        tf = {f.name: f for f in dataclasses.fields(getattr(T, name))}
        assert list(jf) == list(tf), name
        if name in ("ShapeConfig",):
            continue
        jd, td = getattr(J, name)(), getattr(T, name)()
        for k in jf:
            if (name, k) in (("CheckpointConfig", "directory"),
                             ("TrainConfig", "checkpoint")):
                continue
            a, b = getattr(jd, k), getattr(td, k)
            if dataclasses.is_dataclass(a):
                a, b = dataclasses.asdict(a), dataclasses.asdict(b)
            assert a == b, (name, k)
    assert T.SHAPES.keys() == J.SHAPES.keys()
    for k in J.SHAPES:
        assert dataclasses.asdict(T.SHAPES[k]) == dataclasses.asdict(
            J.SHAPES[k])
    assert T.CheckpointConfig().directory.endswith("repro_torch_ckpt")
