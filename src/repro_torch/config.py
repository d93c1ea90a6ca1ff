"""Configs: the port's own copy of the reference's dataclasses and registry.

Same field names and defaults as the JAX package's ``LArTPCConfig`` and LM
``ModelConfig`` (with its ``MoEConfig``, ``MLAConfig``, ``SSMConfig`` and
``RGLRUConfig``), so a config round-trips between the two packages as a
plain dict (``repro_torch.interop.config_from_dict``). Every architecture
registers a full and a smoke factory under its ``--arch <id>``:
``lartpc-uboone`` here, the LM architectures in ``repro_torch.configs``.
The training configs (``ShapeConfig`` and ``SHAPES``, ``ParallelConfig``,
``OptimizerConfig``, ``CheckpointConfig``, ``TrainConfig``) copy the
reference's too, but for the checkpoint directory's default
(``default_ckpt_dir``).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple


# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts block config (DeepSeek-style fine-grained MoE)."""

    num_experts: int = 0          # routed experts
    num_shared: int = 0           # always-on shared experts
    top_k: int = 0
    expert_ff: int = 0            # per-expert hidden size
    router_aux_weight: float = 0.001
    # layers [first_moe_layer, num_layers) are MoE; earlier layers are dense
    first_moe_layer: int = 1
    dense_ff: int = 0             # ff size of the dense (non-MoE) layers
    capacity_factor: float = 1.25  # per-expert token capacity multiplier


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2)."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 = full-rank q projection
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 SSD block config."""

    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 256              # SSD chunk length


@dataclass(frozen=True)
class RGLRUConfig:
    """RecurrentGemma RG-LRU block config."""

    lru_width: int = 0            # 0 -> d_model
    conv_width: int = 4
    block_pattern: Tuple[str, ...] = ("recurrent", "recurrent", "attention")


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | vlm | audio | lartpc
    num_layers: int = 2
    d_model: int = 128
    num_heads: int = 2
    num_kv_heads: int = 2
    head_dim: int = 0             # 0 -> d_model // num_heads
    d_ff: int = 256
    vocab_size: int = 1000
    max_seq_len: int = 8192
    # attention details
    attn_kind: str = "global"     # global | local | local_global | none
    window_size: int = 4096       # for local attention
    qk_norm: bool = False
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    # mlp
    mlp_kind: str = "swiglu"      # swiglu | squared_relu | gelu | relu
    # norm / embeddings
    norm_kind: str = "rmsnorm"    # rmsnorm | layernorm
    tie_embeddings: bool = False
    embedding_scale: bool = False  # gemma-style sqrt(d_model) input scaling
    # sub-configs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # enc-dec
    is_encoder_decoder: bool = False
    num_encoder_layers: int = 0
    # multimodal stub frontends: number of precomputed embedding positions
    frontend: str = "none"        # none | vision | speech
    frontend_tokens: int = 0
    # numerics
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    # remat: none | full | selective
    remat: str = "selective"

    #: embedding/unembedding tables are padded to a multiple of this so the
    #: vocab dim shards cleanly over the model axis (Megatron convention)
    vocab_pad_to: int = 256

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return (self.vocab_size + m - 1) // m * m

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    def param_count(self) -> int:
        """Approximate parameter count (used for 6ND model flops)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)


# ---------------------------------------------------------------------------
# LArTPC sim config (the paper's own workload)
# ---------------------------------------------------------------------------


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
    # counter | pool | relaxed | none
    rng_strategy: str = "counter"
    # xla | sort_segment | pallas | pallas_compact | auto
    scatter_strategy: str = "xla"
    # unfused | fused_pallas | fused_pallas_compact | fused_pallas_multiplane
    # | fused_pallas_multiplane_compact | multiplane_xla | auto
    charge_grid_strategy: str = "unfused"
    patch_dtype: str = "float32"
    # rfft2 | fft2 | auto
    fft_strategy: str = "rfft2"
    pipeline: str = "fig4"         # fig3 | fig4
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
    # recon: build_sim_graph(..., recon=True) appends deconvolve -> hit_find
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


# ---------------------------------------------------------------------------
# Shapes (assigned input-shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                     # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


# ---------------------------------------------------------------------------
# Run/training config
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParallelConfig:
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: str = "pod"
    fsdp: bool = True              # shard params over data axis
    expert_axis: str = "model"     # EP placement
    sequence_parallel: bool = False
    grad_compression: str = "none"  # none | int8_ef
    microbatches: int = 1
    remat_policy: str = "selective"


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"       # cosine | linear | constant


def default_ckpt_dir() -> str:
    """``repro_torch_ckpt`` under the temp directory (``TMPDIR``): the
    reference's default is ``/tmp/repro_ckpt``; the port keeps to the
    directory its environment names."""
    return os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")


@dataclass(frozen=True)
class CheckpointConfig:
    directory: str = field(default_factory=default_ckpt_dir)
    every_steps: int = 50
    keep: int = 3
    async_save: bool = True


@dataclass(frozen=True)
class TrainConfig:
    model: Any = None
    shape: ShapeConfig = SHAPES["train_4k"]
    parallel: ParallelConfig = ParallelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    checkpoint: CheckpointConfig = field(default_factory=CheckpointConfig)
    seed: int = 0
    log_every: int = 10
    straggler_deadline_s: float = 0.0   # 0 disables


def _uboone_full() -> LArTPCConfig:
    return LArTPCConfig()  # 2560 wires x 9592 ticks, 100k depos


def _uboone_smoke() -> LArTPCConfig:
    return LArTPCConfig(num_wires=128, num_ticks=512, num_depos=256,
                        response_wires=11, response_ticks=64)


_REGISTRY: Dict[str, Callable[[], Any]] = {"lartpc-uboone": _uboone_full}
_SMOKE_REGISTRY: Dict[str, Callable[[], Any]] = {
    "lartpc-uboone": _uboone_smoke}


def register(arch_id: str, full: Callable[[], Any],
             smoke: Callable[[], Any]) -> None:
    _REGISTRY[arch_id] = full
    _SMOKE_REGISTRY[arch_id] = smoke


def get_config(arch_id: str, smoke: bool = False):
    import repro_torch.configs  # noqa: F401  (registers the LM archs)

    table = _SMOKE_REGISTRY if smoke else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]()


def list_archs() -> Sequence[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)


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
