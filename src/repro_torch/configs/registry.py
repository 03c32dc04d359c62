"""Architecture registry: id -> (full ``CONFIG``, reduced ``SMOKE``), the
port's copy of the JAX package's ``repro/configs/registry.py``.

``--arch <id>`` in the port's launchers resolves here.
"""
from __future__ import annotations

from typing import Dict, Tuple

from repro_torch.configs import (
    deepseek_v2_236b,
    gemma2_2b,
    kimi_k2_1t_a32b,
    mamba2_780m,
    minicpm_2b,
    minitron_4b,
    phi_3_vision_4_2b,
    qwen2_72b,
    whisper_base,
    zamba2_7b,
)
from repro_torch.configs.base import ModelConfig

_MODULES = {
    "kimi-k2-1t-a32b": kimi_k2_1t_a32b,
    "deepseek-v2-236b": deepseek_v2_236b,
    "phi-3-vision-4.2b": phi_3_vision_4_2b,
    "mamba2-780m": mamba2_780m,
    "minicpm-2b": minicpm_2b,
    "minitron-4b": minitron_4b,
    "qwen2-72b": qwen2_72b,
    "gemma2-2b": gemma2_2b,
    "zamba2-7b": zamba2_7b,
    "whisper-base": whisper_base,
}

ARCH_IDS = tuple(_MODULES)

# Archs whose decode path is sub-quadratic in context (run long_500k).
LONG_CONTEXT_OK = ("mamba2-780m", "zamba2-7b")


def get_config(arch: str) -> ModelConfig:
    return _MODULES[arch].CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _MODULES[arch].SMOKE


def all_configs() -> Dict[str, Tuple[ModelConfig, ModelConfig]]:
    return {k: (m.CONFIG, m.SMOKE) for k, m in _MODULES.items()}


def cell_supported(arch: str, shape_name: str) -> Tuple[bool, str]:
    """Is (arch x shape) a cell of the roofline table? Returns (ok, reason)."""
    if shape_name == "long_500k" and arch not in LONG_CONTEXT_OK:
        return False, ("full-attention decode at 524288 ctx is O(S) mem / "
                       "O(S^2) aggregate — sub-quadratic archs only "
                       "(see DESIGN.md long_500k applicability)")
    return True, ""
