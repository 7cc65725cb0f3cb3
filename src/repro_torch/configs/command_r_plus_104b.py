"""command-r-plus-104b [dense] — 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias, Cohere parallel attn+FFN block.
[hf:CohereForAI/c4ai-command-r-v01]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-plus-104b",
    family="dense",
    num_layers=64,
    d_model=12288,
    num_heads=96,
    num_kv_heads=8,
    d_ff=33792,
    vocab_size=256000,
    qkv_bias=False,
    parallel_block=True,      # Cohere: x + attn(ln x) + mlp(ln x)
    tie_embeddings=True,      # command-r ties input/output embeddings
    rope_theta=75e6,
)

SMOKE = ModelConfig(
    name="command-r-plus-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=8,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    parallel_block=True,
    tie_embeddings=True,
)
