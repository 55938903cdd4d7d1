"""--arch <id> registry (``repro.configs.registry``) for the decoder
archs.  ``get_config(id)`` returns the full-scale
ModelConfig, ``get_smoke(id)`` the reduced same-family variant the CPU
tests use.  An arch of the reference that is not ported yet raises a
KeyError that says so."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ModelConfig

_MODULES: Dict[str, str] = {
    "phi4-mini-3.8b": "repro_torch.configs.phi4_mini_3_8b",
    "gemma2-27b":     "repro_torch.configs.gemma2_27b",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "rwkv6-7b":       "repro_torch.configs.rwkv6_7b",
    "mixtral-8x7b":   "repro_torch.configs.mixtral_8x7b",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "stablelm-3b":    "repro_torch.configs.stablelm_3b",
    "granite-20b":    "repro_torch.configs.granite_20b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
}

ARCH_IDS: List[str] = list(_MODULES)

# the reference's encoder-decoder arch (cross attention, models/encdec.py)
NOT_PORTED = ("whisper-tiny",)


def _module(arch_id: str):
    if arch_id in NOT_PORTED:
        raise KeyError(f"arch {arch_id!r} is not ported yet; ported: "
                       f"{ARCH_IDS}")
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return importlib.import_module(_MODULES[arch_id])


def get_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).SMOKE
