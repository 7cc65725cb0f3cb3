"""yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000 —
llama-arch GQA.  [arXiv:2403.04652]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-34b",
    family="dense",
    num_layers=60,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=20480,
    vocab_size=64000,
    rope_theta=5e6,
)

SMOKE = ModelConfig(
    name="yi-smoke",
    family="dense",
    num_layers=2,
    d_model=56,          # 7 heads * hd 8: preserves the non-16-divisible heads
    num_heads=7,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=8,
)
