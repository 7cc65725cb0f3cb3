"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40e top-8.  [hf:ibm-granite/granite-3.0-3b-a800m-base]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="granite-smoke",
    family="moe",
    num_layers=2,
    d_model=48,
    num_heads=6,
    num_kv_heads=2,
    head_dim=8,
    d_ff=32,
    vocab_size=512,
    num_experts=5,            # preserves non-divisible expert count
    experts_per_token=2,
    tie_embeddings=True,
)
