"""Carry the reference's values into the port, as numpy arrays and dicts.

The simulation has no weights: its state is the config, the PRNG keys, the
depos (with a leading plane axis (P, N) for multi-plane configs) and the
detector responses, one per readout plane. These helpers build the port's
objects from the JAX package's values once those are turned into numpy (the
caller does that; nothing here imports JAX): single keys and stacked
per-event keys, depos, padded event batches, responses, the normal pool
of ``rng_strategy="pool"``; and turn a port
``SimOutput`` back into numpy for comparison. A deconvolution filter is a
``DetectorResponse`` too, so ``response_from_numpy`` carries the
reference's filters across as well; ``fit_targets_from_numpy`` carries a
calibration fit's targets. The LM slice carries weights:
``model_params_from_numpy`` builds the port's parameter tree from the
reference's, key for key (every family's tree), and ``caches_to_numpy``
turns a port cache tree of any kind (KV, MLA, SSM, RG-LRU) back into
numpy. The training slice carries the optimizer state both ways:
``opt_state_from_numpy`` / ``opt_state_to_numpy``. Like every entry point
of the port,
the builders put their tensors on the card unless ``device="cpu"`` is
passed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping

import numpy as np
import torch

from repro_torch.config import LArTPCConfig
from repro_torch.core.batch import EventBatch, PhysicalEventBatch
from repro_torch.core.depo import DepoSet
from repro_torch.core.drift import PhysicalDepoSet
from repro_torch.core.fit import FitTargets
from repro_torch.core.response import DetectorResponse
from repro_torch.core.stages import SimOutput
from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState
from repro_torch.tree import tree_map


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


def keys_from_data(data) -> torch.Tensor:
    """Stacked port keys (E, 2) from the reference's ``key_data`` of E keys
    (e.g. of ``repro.core.batch.event_keys``)."""
    words = np.asarray(data, dtype=np.uint32)
    if words.ndim != 2 or words.shape[1] != 2:
        raise ValueError(f"expected (E, 2) key words, got {words.shape}")
    return torch.from_numpy(words.astype(np.int64))


def event_batch_from_numpy(wire, tick, sigma_w, sigma_t, charge, n_depos,
                           device="cuda") -> EventBatch:
    """An ``EventBatch`` from the reference's numpy leaves: (E[, P], N_max)
    depo fields on ``device`` and the (E,) valid counts on the host."""
    return EventBatch(*depos_from_numpy(wire, tick, sigma_w, sigma_t, charge,
                                        device=device),
                      n_depos=torch.from_numpy(
                          np.array(n_depos, dtype=np.int32)))


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


def fit_targets_from_numpy(x, y, z, t, q, n_depos, keys, adc, decon=None,
                           device="cuda"):
    """A port ``FitTargets`` from the reference's: the (E, N_max) physical
    batch leaves and (E,) valid counts, the per-event ``key_data`` (E, 2),
    the (E, W, T) int16 ADC and, for recon targets, the deconvolved
    charge. With it the port's fit loss runs on the reference's own
    targets."""
    dev = resolve_device(device)
    batch = PhysicalEventBatch(
        *physical_depos_from_numpy(x, y, z, t, q, device=dev),
        n_depos=torch.from_numpy(np.array(n_depos, dtype=np.int32)))
    adc = np.asarray(adc)
    if adc.dtype != np.int16:
        raise ValueError(f"expected int16 target ADC, got {adc.dtype}")
    return FitTargets(batch=batch, keys=keys_from_data(keys),
                      adc=torch.from_numpy(adc.copy()).to(dev),
                      decon=None if decon is None else _f32(decon, dev))


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


def pool_from_numpy(pool, device="cuda") -> torch.Tensor:
    """The reference's normal pool (``make_pool``; ``rng_strategy="pool"``)
    as a float32 tensor, so both packages fluctuate from the same
    normals."""
    return _f32(pool, device)


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


def model_params_from_numpy(tree, device="cuda"):
    """The reference's LM parameter tree (nested dicts of numpy arrays) as
    the port's, key for key, each leaf at its dtype (bfloat16 carried as
    its bits)."""
    if isinstance(tree, Mapping):
        return {k: model_params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return bf16_from_numpy(arr, device)
    return torch.from_numpy(np.array(arr)).to(resolve_device(device))


def _cache_to_numpy(cache) -> Dict[str, np.ndarray]:
    """One stacked cache NamedTuple as ``{field: array}``: floats widened to
    float32 (exact for bfloat16), integers as int32, and the host ``index``
    as the reference's (layers,) int32 array."""
    fields = cache._asdict()
    layers = next(v.shape[0] for v in fields.values()
                  if isinstance(v, torch.Tensor))
    out = {}
    for name, value in fields.items():
        if not isinstance(value, torch.Tensor):
            out[name] = np.full((layers,), value, dtype=np.int32)
        elif value.is_floating_point():
            out[name] = value.detach().float().cpu().numpy()
        else:
            out[name] = value.cpu().numpy().astype(np.int32)
    return out


def caches_to_numpy(caches) -> Dict[str, Any]:
    """A port cache tree (``Model.init_caches``' layout: ``{stack: {entry:
    cache}}``, entries ``kv``, ``mla``, ``ssm`` or a griffin group's
    ``g{j}``) as the same tree with every cache a ``{field: array}`` dict,
    the reference's field names and shapes."""
    if isinstance(caches, Mapping):
        return {k: caches_to_numpy(v) for k, v in caches.items()}
    return _cache_to_numpy(caches)


def opt_state_from_numpy(state, device="cuda") -> OptState:
    """The reference's ``OptState`` (``step``, ``m``, ``v``, ``master``;
    its leaves as numpy, a NamedTuple or a mapping) as the port's: the
    step a 0-d int32 tensor, the trees key for key (``master`` None where
    the reference's is)."""
    fields = state if isinstance(state, Mapping) else state._asdict()
    master = fields.get("master")
    return OptState(
        step=torch.as_tensor(np.array(fields["step"], np.int32)).to(
            resolve_device(device)),
        m=model_params_from_numpy(fields["m"], device),
        v=model_params_from_numpy(fields["v"], device),
        master=(None if master is None
                else model_params_from_numpy(master, device)))


def opt_state_to_numpy(state: OptState) -> Dict[str, Any]:
    """A port ``OptState`` as ``{"step", "m", "v", "master"}`` of numpy
    (float32 trees; ``master`` None without a master copy), the fields of
    the reference's ``OptState``."""
    def to_numpy(tree):
        return tree_map(lambda t: t.detach().cpu().numpy(), tree)

    return {"step": state.step.cpu().numpy(), "m": to_numpy(state.m),
            "v": to_numpy(state.v), "master": to_numpy(state.master)}
