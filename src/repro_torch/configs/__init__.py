"""Architecture registry of the port: ``get_config(arch_id, smoke=)``.

The ids are the reference's (``repro/configs/__init__.py``), all ten of
them: the dense GQA transformers (llama3-8b, command-r-plus-104b with its
parallel block and tied embeddings, qwen1.5-110b with its qkv bias,
yi-34b), rwkv6-7b (Finch), the MoE family (granite-moe-3b-a800m,
qwen2-moe-a2.7b with shared experts), the hybrid jamba-1.5-large-398b
(Mamba + MoE), the vlm phi-3-vision-4.2b (a patch-embedding frontend
stub) and the encoder-decoder seamless-m4t-medium (a frame-embedding
frontend stub).  The shape grid (``SHAPES``, ``all_cells``) waits for
the dry-run."""
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
    "jamba-1.5-large-398b": "jamba_15_large_398b",
    "phi-3-vision-4.2b": "phi3_vision_42b",
    "seamless-m4t-medium": "seamless_m4t_medium",
}


def get_config(arch_id: str, smoke: bool = False) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")
    return mod.SMOKE if smoke else mod.CONFIG
