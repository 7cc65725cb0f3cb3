"""LM token serving: the static-batch :class:`~repro_torch.serve.engine.Engine`.
The continuous batcher waits (ROADMAP A8)."""
from repro_torch.serve.engine import Engine, SamplingParams, sample_token

__all__ = ["Engine", "SamplingParams", "sample_token"]
