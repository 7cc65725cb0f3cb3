"""Architecture registry of the port: ``get_config(arch_id, smoke=)``.

The ids are the reference's (``repro/configs/__init__.py``).  Two are
ported, llama3-8b (dense GQA) and rwkv6-7b (Finch); the others raise
``NotImplementedError`` naming the ROADMAP item that ports their
family.  The shape grid (``SHAPES``, ``all_cells``) waits for the
dry-run."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "llama3-8b": "llama3_8b",
    "rwkv6-7b": "rwkv6_7b",
}

# where each id that is not ported yet waits (ROADMAP queue A)
_WAITS = {
    "command-r-plus-104b": "A9 (dense configs beyond llama3-8b)",
    "qwen1.5-110b": "A9 (dense configs beyond llama3-8b)",
    "yi-34b": "A9 (dense configs beyond llama3-8b)",
    "seamless-m4t-medium": "A9 (encdec family)",
    "jamba-1.5-large-398b": "A9 (hybrid Mamba + MoE family)",
    "phi-3-vision-4.2b": "A9 (vlm family)",
    "granite-moe-3b-a800m": "A9 (MoE family)",
    "qwen2-moe-a2.7b": "A9 (MoE family)",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in _WAITS:
        raise NotImplementedError(
            f"{arch_id} is not ported to repro_torch yet: ROADMAP {_WAITS[arch_id]}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
