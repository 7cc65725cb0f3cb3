"""Architecture registry of the port: ``get_config(arch_id, smoke=)``.

The ids are the reference's (``repro/configs/__init__.py``), all ten of
them: the dense GQA transformers (llama3-8b, command-r-plus-104b with its
parallel block and tied embeddings, qwen1.5-110b with its qkv bias,
yi-34b), rwkv6-7b (Finch), the MoE family (granite-moe-3b-a800m,
qwen2-moe-a2.7b with shared experts), the hybrid jamba-1.5-large-398b
(Mamba + MoE), the vlm phi-3-vision-4.2b (a patch-embedding frontend
stub) and the encoder-decoder seamless-m4t-medium (a frame-embedding
frontend stub).

The shape grid is the reference's: ``SHAPES`` (``train_4k``,
``prefill_32k``, ``decode_32k``, ``long_500k``), ``cell_enabled``
(``long_500k`` only for the sub-quadratic families) and ``all_cells``,
every (architecture × shape) cell, whose inputs ``launch/specs.py`` builds
and which ``launch/dryrun.py`` runs on a fake world of ranks."""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig

ARCH_IDS = [
    "command-r-plus-104b",
    "llama3-8b",
    "qwen1.5-110b",
    "yi-34b",
    "seamless-m4t-medium",
    "rwkv6-7b",
    "jamba-1.5-large-398b",
    "phi-3-vision-4.2b",
    "granite-moe-3b-a800m",
    "qwen2-moe-a2.7b",
]

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


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def cell_enabled(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, and why not when it does not."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k requires sub-quadratic attention (skip: " \
                      "pure full-attention arch)"
    return True, ""


def all_cells(include_skipped: bool = False):
    """Yield (arch_id, shape_name, enabled, reason)."""
    for a in ARCH_IDS:
        cfg = get_config(a)
        for s in SHAPES.values():
            ok, why = cell_enabled(cfg, s)
            if ok or include_skipped:
                yield a, s.name, ok, why
