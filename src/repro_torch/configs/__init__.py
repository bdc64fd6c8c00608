"""Model and layer configurations (``--arch <id>``), the counterpart of
``repro.configs``: the paper's own ResNet-50 conv shapes (``resnet50_convs``)
and the dense pure-attention LM architectures whose blocks are ported. Each
LM module exposes CONFIG (published widths) and SMOKE (reduced, runs on the
CPU).

The reference's other architectures need blocks that are not ported yet;
asking for one raises ``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig, reduced

ARCH_IDS: List[str] = [
    "qwen2_5_3b",
    "stablelm_1_6b",
    "phi3_medium_14b",
    "minitron_8b",
]

# the reference's architectures that wait for blocks of a later slice
NOT_PORTED: Dict[str, str] = {
    "phi3_5_moe_42b": "the MoE FFN (ROADMAP queue 1, item 6: left out)",
    "olmoe_1b_7b": "the MoE FFN (ROADMAP queue 1, item 6: left out)",
    "xlstm_1_3b": "mLSTM/sLSTM blocks (ROADMAP queue 1, item 9)",
    "jamba_1_5_large": "mamba blocks (ROADMAP queue 1, item 9) and the MoE "
                       "FFN (item 6: left out)",
    "hubert_xlarge": "the encoder stub frontend (ROADMAP queue 1, item 6: "
                     "left out)",
    "internvl2_1b": "the VLM stub frontend (ROADMAP queue 1, item 6: left "
                    "out)",
}


def _module(arch: str):
    if arch in NOT_PORTED:
        raise NotImplementedError(
            f"{arch} needs {NOT_PORTED[arch]}, not ported to repro_torch yet")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; ported: {ARCH_IDS}")
    return importlib.import_module(f"repro_torch.configs.{arch}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke(arch: str) -> ModelConfig:
    mod = _module(arch)
    return getattr(mod, "SMOKE", None) or reduced(mod.CONFIG)
