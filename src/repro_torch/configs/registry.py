"""Architecture registry: ``--arch <id>`` resolution for all entry points."""
from __future__ import annotations

from typing import Callable, Dict

from repro_torch.configs import (
    gemma3_27b,
    granite_3_8b,
    internvl2_26b,
    kimi_k2_1t_a32b,
    mamba2_1_3b,
    mistral_nemo_12b,
    olmoe_1b_7b,
    qwen1_5_0_5b,
    recurrentgemma_9b,
    whisper_base,
)
from repro_torch.configs.base import ModelConfig

_MODULES = (
    mamba2_1_3b,
    kimi_k2_1t_a32b,
    olmoe_1b_7b,
    qwen1_5_0_5b,
    gemma3_27b,
    mistral_nemo_12b,
    granite_3_8b,
    recurrentgemma_9b,
    internvl2_26b,
    whisper_base,
)

ARCHS: Dict[str, Callable[[], ModelConfig]] = {m.ARCH: m.config for m in _MODULES}
REDUCED: Dict[str, Callable[[], ModelConfig]] = {m.ARCH: m.reduced for m in _MODULES}
ARCH_IDS = tuple(ARCHS)


def get_config(arch: str, reduced: bool = False) -> ModelConfig:
    table = REDUCED if reduced else ARCHS
    if arch not in table:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(table)}")
    return table[arch]()
