"""--arch <id> registry (``repro.configs.registry``).  ``get_config(id)``
returns the full-scale ModelConfig, ``get_smoke(id)`` the reduced
same-family variant the CPU tests use, ``long_context_variant(cfg)``
the sliding-window variant the dry-run prices at ``long_500k``.  Every
arch of the reference is ported (``NOT_PORTED`` is empty); an unknown
id raises a KeyError."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import ATTN, ATTN_LOCAL, ModelConfig

_MODULES: Dict[str, str] = {
    "phi4-mini-3.8b":        "repro_torch.configs.phi4_mini_3_8b",
    "mixtral-8x7b":          "repro_torch.configs.mixtral_8x7b",
    "gemma2-27b":            "repro_torch.configs.gemma2_27b",
    "recurrentgemma-2b":     "repro_torch.configs.recurrentgemma_2b",
    "llava-next-mistral-7b": "repro_torch.configs.llava_next_mistral_7b",
    "stablelm-3b":           "repro_torch.configs.stablelm_3b",
    "deepseek-moe-16b":      "repro_torch.configs.deepseek_moe_16b",
    "whisper-tiny":          "repro_torch.configs.whisper_tiny",
    "rwkv6-7b":              "repro_torch.configs.rwkv6_7b",
    "granite-20b":           "repro_torch.configs.granite_20b",
}

ARCH_IDS: List[str] = list(_MODULES)

# archs of the reference that the port cannot build yet
NOT_PORTED: tuple = ()


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


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sub-quadratic variant used for the long_500k shape: a dense
    config gets every ``ATTN`` block as ``ATTN_LOCAL`` with window
    ``min(window or 4096, 4096)`` and the name suffix "-swa"; a config
    that is sub-quadratic already comes back unchanged (the same
    object)."""
    if cfg.subquadratic:
        return cfg
    pattern = tuple(ATTN_LOCAL if k == ATTN else k for k in cfg.pattern)
    win = cfg.window if cfg.window else 4096
    return cfg.replace(pattern=pattern, window=min(win, 4096),
                       name=cfg.name + "-swa")
