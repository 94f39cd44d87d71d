"""Assigned-architecture registry: ``get_config(arch_id)`` / ``--arch <id>``.

Each module defines CONFIG (the full published config) and SMOKE (a reduced
same-family config for CPU smoke tests).  Input shapes per arch are defined
in ``repro_torch.configs.shapes``.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "gemma3_12b",
    "qwen3_8b",
    "mistral_nemo_12b",
    "qwen2_1_5b",
    "whisper_large_v3",
    "rwkv6_3b",
    "llama32_vision_90b",
    "deepseek_v2_236b",
    "granite_moe_3b",
    "hymba_1_5b",
)

ALIASES = {
    "gemma3-12b": "gemma3_12b",
    "qwen3-8b": "qwen3_8b",
    "mistral-nemo-12b": "mistral_nemo_12b",
    "qwen2-1.5b": "qwen2_1_5b",
    "whisper-large-v3": "whisper_large_v3",
    "rwkv6-3b": "rwkv6_3b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "granite-moe-3b-a800m": "granite_moe_3b",
    "hymba-1.5b": "hymba_1_5b",
}


def canonical(arch: str) -> str:
    return ALIASES.get(arch, arch)


def get_config(arch: str, smoke: bool = False):
    mod = importlib.import_module(f"repro_torch.configs.{canonical(arch)}")
    return mod.SMOKE if smoke else mod.CONFIG
