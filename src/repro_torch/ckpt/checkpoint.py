"""Fault-tolerant checkpointing, as the reference's
``src/repro/ckpt/checkpoint.py`` and in its layout.

* atomic: write to ``<dir>/tmp.<step>`` then ``os.rename`` to
  ``step_<N>`` (a crashed save can never shadow a good checkpoint)
* keep-N rotation
* async: the device->host copy happens at ``save`` (so later in-place
  updates cannot reach the snapshot), the file write runs on a background
  thread
* leaves are stored as full arrays under their path keys
  (``params/embed/table``, ``opt/m/...``) + a ``manifest.json``; a
  directory without a manifest is not a checkpoint
* stores data-pipeline state + step so restarts are exactly-once
* elastic: a sharded leaf (``parallel.fsdp``) is gathered to its full
  logical array at ``save`` on every rank, and only rank 0 writes;
  ``restore(..., shardings=)`` places each leaf's block for the current
  mesh, whatever its size

A tree is nested dicts and NamedTuples (``OptState``) of tensors; a None
leaf is no leaf, as in JAX. numpy has no bfloat16 (the
reference stores ``ml_dtypes``' type, which the port does not need): a
bfloat16 leaf is stored as its uint16 bit view with ``"dtype":
"bfloat16"`` in the manifest and restored bit for bit.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.distributed import mesh_device
from repro_torch.parallel.fsdp import full_value, mark
from repro_torch.tree import tree_items, tree_unflatten


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """(a numpy copy of ``leaf``, its dtype name): bfloat16 as uint16 bits."""
    t = torch.as_tensor(leaf).detach()
    if t.dtype == torch.bfloat16:
        return (t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16), "bfloat16")
    arr = t.to("cpu", copy=True).numpy()
    return arr, str(arr.dtype)


def _from_host(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, extra: Optional[Dict[str, Any]] = None):
        """Snapshot ``tree`` (copied to the host now, written in the
        background). Sharded leaves are gathered on every rank (under the
        current mesh); only rank 0 of a process group writes."""
        host = [(k, *_to_host(full_value(v))) for k, v in tree_items(tree)]
        if dist.is_initialized() and dist.get_rank() != 0:
            return
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host, extra or {}),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, host, extra or {})

    def _write(self, step: int, host, extra):
        tmp = os.path.join(self.directory, f"tmp.{step}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "extra": extra, "leaves": []}
        for i, (key, arr, dtype) in enumerate(host):
            fname = f"leaf_{i:05d}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"].append(
                {"key": key, "file": fname, "shape": list(arr.shape),
                 "dtype": dtype})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._rotate()

    def _rotate(self):
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    # -- restore ------------------------------------------------------------
    def all_steps(self) -> List[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                # ignore manifests mid-write (no manifest.json yet)
                if os.path.exists(os.path.join(self.directory, name,
                                               "manifest.json")):
                    steps.append(int(name[5:]))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """Restore into the structure of ``target_tree``: each leaf with
        its target's shape, on its target's device; where ``shardings``
        (a tree of ``NamedSharding`` by the same paths, None entries
        whole) names one, this rank's block of the full array on the
        sharding's mesh, marked (the elastic re-shard). Returns (tree,
        extra)."""
        d = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {entry["key"]: entry for entry in manifest["leaves"]}
        placed = dict(tree_items(shardings)) if shardings is not None else {}
        leaves = []
        for key, tgt in tree_items(target_tree):
            entry = by_key[key]
            arr = np.load(os.path.join(d, entry["file"]))
            sh = placed.get(key)
            full = _from_host(arr, entry["dtype"])
            block = full if sh is None else sh.shard(full)
            if (list(arr.shape) != list(tgt.shape)
                    and list(block.shape) != list(tgt.shape)):
                raise ValueError(f"checkpoint leaf {key}: shape "
                                 f"{arr.shape} (block {tuple(block.shape)})"
                                 f" != {tuple(tgt.shape)}")
            if sh is None:
                leaves.append(full.to(torch.as_tensor(tgt).device))
            else:
                leaves.append(mark(block.to(mesh_device(sh.mesh), copy=True),
                                   sh.spec))
        return tree_unflatten(target_tree, leaves), manifest["extra"]
