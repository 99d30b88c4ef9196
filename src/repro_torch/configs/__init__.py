"""Architecture registry: one module per assigned architecture.

``get(name)`` returns the full published config; ``smoke(name)`` returns the
reduced same-family config used by the CPU smoke tests (small widths, few
layers/experts, tiny vocab — full configs are exercised only via the
dry-run).  The port's copy of ``repro/configs``: the same ten configs,
field for field.
"""

from __future__ import annotations

import importlib
from typing import Dict

from ..models.config import ModelConfig

ARCHS = (
    "zamba2_2p7b",
    "xlstm_350m",
    "phi3_medium_14b",
    "granite_3_2b",
    "deepseek_coder_33b",
    "starcoder2_15b",
    "internvl2_2b",
    "olmoe_1b_7b",
    "mixtral_8x22b",
    "hubert_xlarge",
)

_ALIASES = {
    "zamba2-2.7b": "zamba2_2p7b",
    "xlstm-350m": "xlstm_350m",
    "phi3-medium-14b": "phi3_medium_14b",
    "granite-3-2b": "granite_3_2b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "starcoder2-15b": "starcoder2_15b",
    "internvl2-2b": "internvl2_2b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "mixtral-8x22b": "mixtral_8x22b",
    "hubert-xlarge": "hubert_xlarge",
}


def _module(name: str):
    mod = _ALIASES.get(name, name).replace("-", "_").replace(".", "p")
    return importlib.import_module(f".{mod}", __package__)


def get(name: str) -> ModelConfig:
    return _module(name).CONFIG


def smoke(name: str) -> ModelConfig:
    return _module(name).smoke()


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get(a) for a in ARCHS}
