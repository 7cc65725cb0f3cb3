"""phi-3-vision-4.2b [vlm] — 32L d_model=3072 32H (GQA kv=32) d_ff=8192
vocab=32064 — phi3-mini backbone + CLIP frontend.  The vision frontend is a
stub, as in the reference: the caller passes 576 precomputed patch
embeddings as ``batch["frontend_embeds"]``.
[hf:microsoft/Phi-3-vision-128k-instruct]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="patches",
    frontend_positions=576,   # CLIP ViT-L/14 @ 336px: 24×24 patches
    rope_theta=1e4,
)

SMOKE = ModelConfig(
    name="phi3v-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    frontend="patches",
    frontend_positions=16,
)
