"""Model and layer configurations (``--arch <id>``), the counterpart of
``repro.configs``: the paper's own ResNet-50 conv shapes (``resnet50_convs``)
and every LM architecture of the reference: the dense pure-attention ones,
the MoE ones (OLMoE, Phi-3.5-MoE), InternVL2's backbone (its vision frontend
is a stub: patch embeddings enter through ``embeds=``), HuBERT's encoder
(its waveform frontend is a stub too: frame embeddings enter through
``embeds=``), jamba's hybrid mamba + attention unit with its MoE FFNs and
xLSTM's mLSTM + sLSTM unit. Each LM module exposes CONFIG (published widths)
and SMOKE (reduced, runs on the CPU).

``NOT_PORTED`` names an architecture of the reference that waits for blocks
of a later slice (none now); asking for one raises ``NotImplementedError``
naming its ROADMAP item.

``SKIPS``, ``cells`` and ``all_cells`` are the reference's dry-run cells:
every (arch, shape) pair of ``LM_SHAPES`` but the skipped ones.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import (LM_SHAPES, ModelConfig, ShapeSpec,
                                       reduced)

ARCH_IDS: List[str] = [
    "qwen2_5_3b",
    "stablelm_1_6b",
    "phi3_medium_14b",
    "minitron_8b",
    "jamba_1_5_large",
    "olmoe_1b_7b",
    "phi3_5_moe_42b",
    "internvl2_1b",
    "hubert_xlarge",
    "xlstm_1_3b",
]

# shape cells skipped per arch: long_500k needs sub-quadratic attention;
# encoder-only models have no decode step
SKIPS: Dict[str, List[str]] = {
    "qwen2_5_3b": ["long_500k"],
    "stablelm_1_6b": ["long_500k"],
    "phi3_medium_14b": ["long_500k"],
    "minitron_8b": ["long_500k"],
    "phi3_5_moe_42b": ["long_500k"],
    "olmoe_1b_7b": ["long_500k"],
    "xlstm_1_3b": [],
    "hubert_xlarge": ["decode_32k", "long_500k"],
    "internvl2_1b": ["long_500k"],
    "jamba_1_5_large": [],
}

# the reference's architectures that wait for blocks of a later slice
NOT_PORTED: Dict[str, str] = {}


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


def cells(arch: str) -> List[ShapeSpec]:
    return [s for n, s in LM_SHAPES.items() if n not in SKIPS[arch]]


def all_cells() -> List[tuple]:
    return [(a, s) for a in ARCH_IDS for s in cells(a)]
