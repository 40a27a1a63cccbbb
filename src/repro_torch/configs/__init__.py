"""Assigned-architecture registry: ``get_config('<arch-id>')``.

The config modules are pure data, copied from the JAX package so that
each arch id resolves to the same shapes in both packages.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.config import ModelConfig

ARCH_IDS: List[str] = [
    "qwen1.5-0.5b",
    "qwen2-vl-2b",
    "xlstm-350m",
    "gemma3-27b",
    "seamless-m4t-large-v2",
    "llama3-405b",
    "olmo-1b",
    "llama4-maverick-400b-a17b",
    "jamba-1.5-large-398b",
    "deepseek-v3-671b",
]

_MODULES: Dict[str, str] = {
    "qwen1.5-0.5b": "qwen1_5_0_5b",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "xlstm-350m": "xlstm_350m",
    "gemma3-27b": "gemma3_27b",
    "seamless-m4t-large-v2": "seamless_m4t_large_v2",
    "llama3-405b": "llama3_405b",
    "olmo-1b": "olmo_1b",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "jamba-1.5-large-398b": "jamba_1_5_large_398b",
    "deepseek-v3-671b": "deepseek_v3_671b",
}


def get_config(arch_id: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.CONFIG.validate()
