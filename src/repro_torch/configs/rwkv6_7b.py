"""rwkv6-7b [ssm] — 32L d_model=4096 (attention-free) d_ff=14336 vocab=65536
— Finch, data-dependent decay.  [arXiv:2404.05892]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    num_layers=32,
    d_model=4096,
    num_heads=64,             # wkv heads = d_model / head_size
    num_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_size=64,
)

SMOKE = ModelConfig(
    name="rwkv6-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    rwkv_head_size=16,
)
