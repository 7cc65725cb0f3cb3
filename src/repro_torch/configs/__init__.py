"""Architecture registry of the port: ``get_config(arch_id, smoke=)``.

The ids are the reference's (``repro/configs/__init__.py``).  Seven are
ported: the dense GQA transformers (llama3-8b, command-r-plus-104b with
its parallel block and tied embeddings, qwen1.5-110b with its qkv bias,
yi-34b), rwkv6-7b (Finch) and the MoE family (granite-moe-3b-a800m,
qwen2-moe-a2.7b with shared experts).  The others raise
``NotImplementedError`` naming the ROADMAP item that ports their
family.  The shape grid (``SHAPES``, ``all_cells``) waits for the
dry-run."""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "command-r-plus-104b": "command_r_plus_104b",
    "llama3-8b": "llama3_8b",
    "qwen1.5-110b": "qwen15_110b",
    "yi-34b": "yi_34b",
    "rwkv6-7b": "rwkv6_7b",
    "granite-moe-3b-a800m": "granite_moe_3b_a800m",
    "qwen2-moe-a2.7b": "qwen2_moe_a27b",
}

# where each id that is not ported yet waits (ROADMAP queue A)
_WAITS = {
    "seamless-m4t-medium": "A9 (encdec family)",
    "jamba-1.5-large-398b": "A9 (hybrid Mamba + MoE family)",
    "phi-3-vision-4.2b": "A9 (vlm family)",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    if arch_id in _WAITS:
        raise NotImplementedError(
            f"{arch_id} is not ported to repro_torch yet: ROADMAP {_WAITS[arch_id]}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
