"""Kernel-strategy registry + empirical autotuner of the PyTorch/CUDA port.

Public surface, the reference's ``repro.tune``:

  registry   : register_strategy / strategies / get_strategy /
               available_strategies / default_strategy / TuneContext
  autotuner  : tune_op / resolve / resolve_config / TuneCache / TuneDecision
"""

from repro_torch.tune.autotune import (
    OP_FIELDS,
    TUNABLE_OPS,
    TuneCache,
    TuneDecision,
    cache_key,
    candidate_thunks,
    median_timer,
    op_shape,
    resolve,
    resolve_config,
    resolve_config_with_decisions,
    shape_bucket,
    tune_op,
)
from repro_torch.tune.registry import (
    Strategy,
    TuneContext,
    available_strategies,
    default_strategy,
    differentiable_strategies,
    ensure_registered,
    get_strategy,
    is_differentiable,
    list_ops,
    make_context,
    register_strategy,
    set_default,
    strategies,
)

__all__ = [
    "OP_FIELDS",
    "TUNABLE_OPS",
    "Strategy",
    "TuneCache",
    "TuneContext",
    "TuneDecision",
    "available_strategies",
    "cache_key",
    "candidate_thunks",
    "default_strategy",
    "differentiable_strategies",
    "ensure_registered",
    "get_strategy",
    "is_differentiable",
    "list_ops",
    "make_context",
    "median_timer",
    "op_shape",
    "register_strategy",
    "resolve",
    "resolve_config",
    "resolve_config_with_decisions",
    "set_default",
    "shape_bucket",
    "strategies",
    "tune_op",
]
