"""seamless-m4t-medium [audio] — 12L d_model=1024 16H (GQA kv=16) d_ff=4096
vocab=256206 — enc-dec, multimodal.  The speech frontend is a stub, as in
the reference: the caller passes precomputed frame embeddings as the
encoder's input (``batch["frames"]``).  [arXiv:2308.11596]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,            # decoder layers
    encoder_layers=12,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    frontend="frames",
    frontend_positions=0,     # frames arrive as the encoder input itself
)

SMOKE = ModelConfig(
    name="seamless-smoke",
    family="encdec",
    num_layers=2,
    encoder_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=512,
    frontend="frames",
)
