"""Architecture registry: ``get_config("<arch-id>")`` for every assigned
architecture plus the paper's own Llama-2 models; ``SHAPES`` for the four
assigned input shapes; ``reduced()`` for smoke-test variants."""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import InputShape, ModelConfig, SHAPES, reduced  # noqa: F401

_MODULES: Dict[str, str] = {
    "starcoder2-3b": "repro_torch.configs.starcoder2_3b",
    "whisper-large-v3": "repro_torch.configs.whisper_large_v3",
    "recurrentgemma-2b": "repro_torch.configs.recurrentgemma_2b",
    "starcoder2-15b": "repro_torch.configs.starcoder2_15b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "qwen2.5-3b": "repro_torch.configs.qwen2_5_3b",
    "qwen2-moe-a2.7b": "repro_torch.configs.qwen2_moe_a2_7b",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick_400b_a17b",
    "stablelm-1.6b": "repro_torch.configs.stablelm_1_6b",
    "xlstm-1.3b": "repro_torch.configs.xlstm_1_3b",
}

ASSIGNED_ARCHS: List[str] = list(_MODULES)

# The paper's own models (for figure reproductions).
_PAPER = {"llama2-7b": "llama2_7b", "llama2-13b": "llama2_13b",
          "llama2-70b": "llama2_70b"}


def get_config(arch_id: str) -> ModelConfig:
    if arch_id in _MODULES:
        return importlib.import_module(_MODULES[arch_id]).config()
    if arch_id in _PAPER:
        mod = importlib.import_module("repro_torch.configs.llama2")
        return getattr(mod, _PAPER[arch_id])()
    raise KeyError(f"unknown arch {arch_id!r}; known: "
                   f"{ASSIGNED_ARCHS + list(_PAPER)}")


def list_archs(include_paper: bool = False) -> List[str]:
    return ASSIGNED_ARCHS + (list(_PAPER) if include_paper else [])
