"""qwen2-moe-a2.7b [moe] — 24L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=151936, MoE 60e top-4 — 4 shared + 60 routed.
[hf:Qwen/Qwen1.5-MoE-A2.7B]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    num_experts=60,
    experts_per_token=4,
    num_shared_experts=4,
    qkv_bias=True,
)

SMOKE = ModelConfig(
    name="qwen2moe-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=32,
    vocab_size=512,
    num_experts=6,
    experts_per_token=2,
    num_shared_experts=2,
    qkv_bias=True,
)
