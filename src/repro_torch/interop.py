"""Carry the reference's values into the port, as numpy arrays and dicts.

The simulation has no weights: its state is the config, the PRNG keys, the
depos (with a leading plane axis (P, N) for multi-plane configs) and the
detector responses, one per readout plane. These helpers build the port's
objects from the JAX package's values once those are turned into numpy (the
caller does that; nothing here imports JAX), and turn a port ``SimOutput``
back into numpy for comparison. A deconvolution filter is a
``DetectorResponse`` too, so ``response_from_numpy`` carries the
reference's filters across as well. Like every entry point of the port,
the builders put their tensors on the card unless ``device="cpu"`` is
passed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.depo import DepoSet
from repro_torch.core.drift import PhysicalDepoSet
from repro_torch.core.response import DetectorResponse
from repro_torch.core.stages import SimOutput
from repro_torch.device import resolve_device


def config_from_dict(d: Mapping[str, Any]) -> LArTPCConfig:
    """``LArTPCConfig`` from ``dataclasses.asdict`` of the reference config
    (tuples come back as lists from asdict and are restored)."""
    fields = {f.name for f in dataclasses.fields(LArTPCConfig)}
    unknown = set(d) - fields
    if unknown:
        raise KeyError(f"fields the port's config lacks: {sorted(unknown)}")
    return LArTPCConfig(**{k: tuple(v) if isinstance(v, list) else v
                           for k, v in d.items()})


def key_from_data(data) -> torch.Tensor:
    """A port key from the reference's ``key_data`` (two uint32 words)."""
    words = np.asarray(data, dtype=np.uint32).reshape(-1)
    if words.shape != (2,):
        raise ValueError(f"expected 2 key words, got {words.shape}")
    return torch.from_numpy(words.astype(np.int64))


def _f32(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32)).to(
        resolve_device(device))


def depos_from_numpy(wire, tick, sigma_w, sigma_t, charge,
                     device="cuda") -> DepoSet:
    """A ``DepoSet`` of (N,) arrays, or of (P, N) arrays for the per-plane
    depos of a multi-plane event."""
    return DepoSet(*(_f32(a, device)
                     for a in (wire, tick, sigma_w, sigma_t, charge)))


def physical_depos_from_numpy(x, y, z, t, q,
                              device="cuda") -> PhysicalDepoSet:
    return PhysicalDepoSet(*(_f32(a, device) for a in (x, y, z, t, q)))


def response_from_numpy(kernel, freq, pad_shape, plane: str = "induction",
                        device="cuda") -> DetectorResponse:
    dev = resolve_device(device)
    freq = torch.from_numpy(np.array(freq, dtype=np.complex64))
    return DetectorResponse(kernel=_f32(kernel, dev), freq=freq.to(dev),
                            pad_shape=tuple(int(s) for s in pad_shape),
                            plane=plane)


def plane_responses_from_numpy(responses, device="cuda"):
    """One ``DetectorResponse`` per plane, in plane order, from
    ``(kernel, freq, pad_shape, plane)`` tuples."""
    return tuple(response_from_numpy(kernel, freq, pad_shape, plane, device)
                 for kernel, freq, pad_shape, plane in responses)


def bf16_bits(x) -> np.ndarray:
    """The uint16 bit patterns of a bfloat16 array, as numpy: of a torch
    tensor (torch has no ``.numpy()`` for bfloat16) or of a numpy array of
    JAX's bfloat16 type (``ml_dtypes.bfloat16``; numpy has none of its
    own). Bit views compare two packages' bfloat16 values exactly."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.bfloat16:
            raise ValueError(f"expected a bfloat16 tensor, got {x.dtype}")
        return x.detach().cpu().view(torch.int16).numpy().view(np.uint16)
    arr = np.asarray(x)
    if arr.dtype.name != "bfloat16":
        raise ValueError(f"expected a bfloat16 array, got {arr.dtype}")
    return arr.view(np.uint16)


def bf16_from_numpy(x, device="cuda") -> torch.Tensor:
    """A bfloat16 tensor from a numpy array of JAX's bfloat16 type, carried
    across as its bits."""
    bits = np.ascontiguousarray(bf16_bits(x)).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(
        resolve_device(device))


def to_numpy(out: SimOutput) -> Dict[str, np.ndarray]:
    """A port ``SimOutput`` as a dict of numpy arrays (None fields left
    out); a recon output's ``HitSet`` leaves come as ``hits.<field>``."""
    arrays = {}
    for name, value in out._asdict().items():
        if name == "hits" and value is not None:
            arrays.update({f"hits.{f}": v.detach().cpu().numpy()
                           for f, v in value._asdict().items()})
        elif value is not None:
            arrays[name] = value.detach().cpu().numpy()
    return arrays
