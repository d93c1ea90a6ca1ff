"""Architecture registry: one module per LM architecture, copied as data
from the reference's ``configs`` package.

Importing this package registers every arch under its ``--arch <id>``;
``lartpc-uboone``, the simulator's own config, is registered by
``repro_torch.config`` itself. ``Model`` builds every one of the ten
architectures (``models/model.py``).
"""
from repro_torch.configs import (  # noqa: F401
    deepseek_moe_16b,
    deepseek_v2_236b,
    gemma2_2b,
    internvl2_1b,
    mamba2_780m,
    nemotron4_15b,
    qwen3_32b,
    recurrentgemma_2b,
    seamless_m4t_large_v2,
    stablelm_12b,
)

ARCH_IDS = [
    "mamba2-780m",
    "internvl2-1b",
    "qwen3-32b",
    "nemotron-4-15b",
    "gemma2-2b",
    "stablelm-12b",
    "deepseek-moe-16b",
    "deepseek-v2-236b",
    "recurrentgemma-2b",
    "seamless-m4t-large-v2",
]
