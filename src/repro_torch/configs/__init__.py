"""Architecture registry: ``get_config(arch_id)`` + the assigned shape table.

Data copied from ``repro/configs`` (the ten ``<arch>.py`` files too), so
``--arch`` names, aliases and numbers are the reference's.

Every assigned (arch × shape) cell is enumerable via :func:`all_cells`;
inapplicable cells (DESIGN.md §4 skips) carry a ``skip`` reason instead of
being silently dropped.
"""

from __future__ import annotations

import importlib
from typing import Dict, List, NamedTuple, Optional

from repro_torch.models.lm.config import ModelConfig

ARCH_IDS = [
    "minitron_8b",
    "qwen1_5_4b",
    "deepseek_coder_33b",
    "llama3_2_3b",
    "jamba_1_5_large",
    "whisper_base",
    "granite_moe_1b",
    "deepseek_v2_236b",
    "mamba2_130m",
    "llava_next_mistral_7b",
]

# canonical external names (``--arch`` accepts either form)
ALIASES = {
    "minitron-8b": "minitron_8b",
    "qwen1.5-4b": "qwen1_5_4b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "llama3.2-3b": "llama3_2_3b",
    "jamba-1.5-large-398b": "jamba_1_5_large",
    "whisper-base": "whisper_base",
    "granite-moe-1b-a400m": "granite_moe_1b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "mamba2-130m": "mamba2_130m",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
}


class ShapeSpec(NamedTuple):
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = [
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
]


def get_config(arch: str) -> ModelConfig:
    arch = ALIASES.get(arch, arch).replace("-", "_").replace(".", "_")
    if arch not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    module = importlib.import_module(f"repro_torch.configs.{arch}")
    return module.CONFIG


class Cell(NamedTuple):
    arch: str
    shape: ShapeSpec
    skip: Optional[str]  # None = runs; else DESIGN.md §4 skip reason


def all_cells() -> List[Cell]:
    cells = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES:
            skip = None
            if shape.name == "long_500k" and not cfg.subquadratic:
                skip = (
                    "long_500k requires sub-quadratic attention; "
                    f"{arch} is pure full-attention (DESIGN.md §4)"
                )
            cells.append(Cell(arch=arch, shape=shape, skip=skip))
    return cells
