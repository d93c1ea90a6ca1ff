"""LArTPC simulation config: the port's own copy of the reference's fields.

Same field names and defaults as the JAX package's ``LArTPCConfig``, so a
config round-trips between the two packages as a plain dict
(``repro_torch.interop.config_from_dict``). Only the simulation config is
carried here; the LM ``ModelConfig`` family waits for its own slice.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, NamedTuple, Tuple


@dataclass(frozen=True)
class LArTPCConfig:
    name: str = "lartpc_uboone"
    family: str = "lartpc"
    # readout grid of one MicroBooNE-like plane
    num_wires: int = 2560
    num_ticks: int = 9592          # readout window, 0.5 us ticks
    # depos
    num_depos: int = 100_000
    patch_wires: int = 20
    patch_ticks: int = 20
    # padded patch shape the reference's TPU kernels use
    pad_wires: int = 24
    pad_ticks: int = 128
    # physics-ish constants
    wire_pitch_mm: float = 3.0
    tick_us: float = 0.5
    drift_speed_mm_us: float = 1.6
    diffusion_long: float = 6.4
    diffusion_tran: float = 9.8
    # drift width = sqrt(2 D t_drift) / metric * diffusion_scale + floor
    diffusion_scale: float = 1e-2
    sigma_w_floor: float = 0.6     # wire units
    sigma_t_floor: float = 0.8     # tick units
    electron_lifetime_us: float = 0.0   # 0 disables lifetime attenuation
    recombination: float = 1.0          # flat recombination survival factor
    drift_strategy: str = "jnp"
    nsigma: float = 3.0
    # electrons per depo (mean), fluctuation model
    electrons_per_depo: float = 5000.0
    fluctuate: bool = True
    # counter | pool | relaxed | none (the port runs counter and none)
    rng_strategy: str = "counter"
    # xla | sort_segment | pallas | pallas_compact | auto
    scatter_strategy: str = "xla"
    # unfused | fused_pallas | fused_pallas_compact | fused_pallas_multiplane
    # | fused_pallas_multiplane_compact | multiplane_xla | auto
    charge_grid_strategy: str = "unfused"
    patch_dtype: str = "float32"
    # rfft2 | fft2 | auto
    fft_strategy: str = "rfft2"
    pipeline: str = "fig4"         # fig3 | fig4 (the port runs fig4)
    # response
    response_ticks: int = 200
    response_wires: int = 21
    response_gain: float = 1.0
    response_shaping_us: float = 2.0
    noise_rms_adc: float = 1.2
    adc_per_electron: float = 0.01
    adc_baseline: float = 900.0
    digitize_ste: bool = False
    dtype: str = "float32"
    # multi-plane readout geometry (MicroBooNE: U, V induction at +-60 deg,
    # Y collection); plane_batching: auto | loop | stacked
    num_planes: int = 1
    plane_angles_deg: Tuple[float, ...] = (60.0, -60.0, 0.0)
    plane_pitches_mm: Tuple[float, ...] = ()
    plane_types: Tuple[str, ...] = ("induction", "induction", "collection")
    plane_batching: str = "auto"
    # recon (carried for round-tripping; no recon stage in the port yet)
    deconv_filter: str = "wiener"
    deconv_wiener_lambda: float = 2e-3
    deconv_gauss_cut: float = 0.25
    deconv_strategy: str = "rfft2"
    hitfind_strategy: str = "auto"
    hit_threshold: float = 500.0
    max_hits: int = 4096
    max_hits_per_wire: int = 8
    check_finite: bool = False


class PlaneSpec(NamedTuple):
    """Resolved geometry of one readout plane."""

    index: int
    kind: str          # "induction" | "collection"
    angle_deg: float   # wire angle from vertical, degrees
    pitch_mm: float    # wire pitch of this plane


def plane_specs(cfg: LArTPCConfig) -> Tuple[PlaneSpec, ...]:
    """Resolved per-plane geometry of ``cfg`` (single plane: identity
    projection with the bipolar induction response)."""
    if cfg.num_planes < 1:
        raise ValueError(f"num_planes must be >= 1, got {cfg.num_planes}")
    if cfg.num_planes == 1:
        return (PlaneSpec(0, "induction", 0.0, cfg.wire_pitch_mm),)
    pitches = cfg.plane_pitches_mm or (cfg.wire_pitch_mm,) * cfg.num_planes
    for name, tup in (("plane_angles_deg", cfg.plane_angles_deg),
                      ("plane_pitches_mm", pitches),
                      ("plane_types", cfg.plane_types)):
        if len(tup) < cfg.num_planes:
            raise ValueError(
                f"{name} has {len(tup)} entries < num_planes={cfg.num_planes}")
    for kind in cfg.plane_types[: cfg.num_planes]:
        if kind not in ("induction", "collection"):
            raise ValueError(f"unknown plane type {kind!r}; expected "
                             "'induction' or 'collection'")
    return tuple(
        PlaneSpec(p, cfg.plane_types[p], cfg.plane_angles_deg[p], pitches[p])
        for p in range(cfg.num_planes))


def _uboone_full() -> LArTPCConfig:
    return LArTPCConfig()  # 2560 wires x 9592 ticks, 100k depos


def _uboone_smoke() -> LArTPCConfig:
    return LArTPCConfig(num_wires=128, num_ticks=512, num_depos=256,
                        response_wires=11, response_ticks=64)


_REGISTRY: Dict[str, Callable[[], Any]] = {"lartpc-uboone": _uboone_full}
_SMOKE_REGISTRY: Dict[str, Callable[[], Any]] = {
    "lartpc-uboone": _uboone_smoke}


def get_config(arch_id: str, smoke: bool = False) -> LArTPCConfig:
    table = _SMOKE_REGISTRY if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]()


def apply_overrides(cfg, overrides: Dict[str, Any]):
    """dot.path=value overrides onto nested frozen dataclasses."""
    for key, value in overrides.items():
        cfg = _apply_one(cfg, key.split("."), value)
    return cfg


def _apply_one(cfg, parts, value):
    if len(parts) == 1:
        fields = {f.name: f for f in dataclasses.fields(cfg)}
        if parts[0] not in fields:
            raise KeyError(f"unknown config field {parts[0]!r}; known: "
                           f"{sorted(fields)}")
        typ = fields[parts[0]].type
        if isinstance(value, str):
            if typ in ("int", int):
                value = int(value)
            elif typ in ("float", float):
                value = float(value)
            elif typ in ("bool", bool):
                value = value.lower() in ("1", "true", "yes")
        return replace(cfg, **{parts[0]: value})
    sub = getattr(cfg, parts[0])
    return replace(cfg, **{parts[0]: _apply_one(sub, parts[1:], value)})
