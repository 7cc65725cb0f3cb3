"""Batched serving engine: prefill + decode with sampling
(``repro/serve/engine.py``).

A static batch over ``models/lm.serve_step``: all slots advance in
lockstep.  Prompt prefill steps the decode step over the prompt token by
token, as the reference does (exact and cache-consistent for every
family); ``lm.prefill_forward`` is the full-sequence prefill beside it.
An encdec config's memory comes from ``frames`` given to ``generate``,
which ``lm.prefill_encoder`` runs before the prompt; the engine is
otherwise text-only, as the reference's is."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig


@dataclasses.dataclass
class SamplingParams:
    temperature: float = 0.0          # 0 => greedy
    top_k: int = 0                    # 0 => no top-k filter


def sample_token(logits: torch.Tensor, sp: SamplingParams,
                 generator: torch.Generator | None = None) -> torch.Tensor:
    """logits ``[B, V]`` → ``[B]`` int32.  Greedy takes the first maximum;
    otherwise a draw from ``generator`` (on the logits' device) among the
    ``top_k`` largest logits, or all of them."""
    if sp.temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    logits = logits / sp.temperature
    if sp.top_k > 0:
        cut = torch.topk(logits, sp.top_k, dim=-1).values[:, -1:]
        logits = logits.masked_fill(logits < cut, -1e30)
    probs = torch.softmax(logits.float(), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(torch.int32)


class Engine:
    """Prompt prefill through the decode step, then batched autoregressive
    decode, on ``device`` (default CUDA; raises without a GPU).  ``enc_len``
    is the number of cross-attention rows a fresh encdec cache holds
    (zeros until ``generate`` is given frames)."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int,
                 batch_size: int, device: str | torch.device | None = None,
                 enc_len: int = 0):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.batch_size = batch_size
        self.enc_len = enc_len
        self.device = resolve_device(device)
        self._step = lm.serve_step(cfg)

    def new_cache(self) -> dict:
        return lm.init_cache(self.cfg, batch=self.batch_size,
                             max_seq=self.max_seq, device=self.device,
                             enc_len=self.enc_len)

    def prefill(self, cache: dict, prompt_tokens: torch.Tensor):
        """prompt_tokens ``[B, T]``, T ≥ 1: step the decode step over the
        prompt.  Returns (cache, last-position logits ``[B, V]``)."""
        if prompt_tokens.shape[1] == 0:
            raise ValueError("prefill needs at least one prompt token")
        logits = None
        for t in range(prompt_tokens.shape[1]):
            logits, cache = self._step(self.params, cache, prompt_tokens[:, t:t + 1])
        return cache, logits

    def generate(self, generator: torch.Generator | None,
                 prompt_tokens: torch.Tensor, max_new_tokens: int,
                 sp: SamplingParams | None = None,
                 frames: torch.Tensor | None = None) -> torch.Tensor:
        """Returns ``[B, max_new_tokens]`` int32 sampled continuations.  As in
        the reference, each sampled token is fed through one more step, the
        last one included.  An encdec config encodes ``frames`` ``[B, S_enc,
        d]`` first, where given."""
        sp = sp if sp is not None else SamplingParams()
        cache = self.new_cache()
        if self.cfg.encoder_layers and frames is not None:
            cache = lm.prefill_encoder(self.cfg, self.params, cache,
                                       frames.to(self.device))
        cache, logits = self.prefill(cache, prompt_tokens.to(self.device))
        toks = []
        for _ in range(max_new_tokens):
            tok = sample_token(logits, sp, generator)
            logits, cache = self._step(self.params, cache, tok[:, None])
            toks.append(tok)
        if not toks:
            return torch.zeros(prompt_tokens.shape[0], 0, dtype=torch.int32,
                               device=self.device)
        return torch.stack(toks, dim=1)
