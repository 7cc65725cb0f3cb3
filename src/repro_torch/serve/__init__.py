"""Serving: the scheduling-decision control plane
(:mod:`repro_torch.serve.control`) and LM token serving: the static-batch
:class:`~repro_torch.serve.engine.Engine` and the slot-recycling
:class:`~repro_torch.serve.continuous.ContinuousBatcher`."""
from repro_torch.serve.continuous import ContinuousBatcher, Request
from repro_torch.serve.control import (ControlPlane, ControlService,
                                       DecisionRequest, latency_stats,
                                       nearest_rank_percentile)
from repro_torch.serve.engine import Engine, SamplingParams, sample_token

__all__ = ["ContinuousBatcher", "ControlPlane", "ControlService", "DecisionRequest",
           "Engine", "Request", "SamplingParams", "latency_stats",
           "nearest_rank_percentile", "sample_token"]
