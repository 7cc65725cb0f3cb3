"""Continuous batching: admission, in-slot prefill and eviction
(``repro/serve/continuous.py``).

A fixed pool of batch slots and a queue of pending requests; each engine
step decodes one token for every active slot, retires the slots that
emit EOS or exhaust their budget, and fills them again from the queue at
the next step (whose prompt is fed token by token in the slot,
interleaved with the other slots' decode: chunked prefill with chunk 1).

As in the reference, the slots share one cache length: ``cache["len"]``
advances at every step, idle slots included, and is never reset.  So a
request admitted into a recycled slot at step t writes its prompt at rows
t, t+1, ... with rotary positions from t, its attention reads the rows
its slot's earlier occupants left at 0..t-1, and an RWKV slot carries on
from their state (a Mamba slot its ``h`` and ``conv``): three equal
prompts served one after another through one slot give three different
outputs, in both packages (ROADMAP C9).  An encdec config is served
without a memory, as the reference serves it: the cache holds no
cross-attention rows, so each cross-attention adds nothing.
For the same reason the batcher's whole life fits in ``max_seq`` steps
of an attention model, whatever its requests' lengths.  Past that the
reference's cache write clamps to the last row and its tokens are
garbage; the port's ``serve_step`` refuses, and the batcher passes the
``ValueError`` on."""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serve.engine import SamplingParams, sample_token


@dataclasses.dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new_tokens: int
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    """Host-side slot scheduler around the decode step, on ``device``
    (default CUDA; raises without a GPU).  Each step builds the
    ``[n_slots, 1]`` token matrix on the host and brings the sampled
    tokens back: one wait on the device a step."""

    def __init__(self, cfg: ModelConfig, params, max_seq: int, n_slots: int,
                 eos_id: int = 0, sp: SamplingParams | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.params = params
        self.max_seq = max_seq
        self.n_slots = n_slots
        self.eos_id = eos_id
        self.sp = sp if sp is not None else SamplingParams()
        self.device = resolve_device(device)
        self.queue: deque[Request] = deque()
        self.slots: list[Optional[Request]] = [None] * n_slots
        self.slot_pos = np.zeros(n_slots, np.int32)       # prompt cursor
        self.cache = lm.init_cache(cfg, batch=n_slots, max_seq=max_seq,
                                   device=self.device)
        self._step = lm.serve_step(cfg)
        self._finished: list[Request] = []

    # -- public API ----------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self, generator: torch.Generator | None = None,
            max_steps: int = 10_000) -> list[Request]:
        """Step until the queue and the slots are empty, or ``max_steps``.
        Returns the finished requests in the order they finished.  The
        sampler draws from ``generator`` (on the batcher's device), which
        advances by itself where the reference splits a key a step."""
        steps = 0
        while (self.queue or any(self.slots)) and steps < max_steps:
            self.step(generator)
            steps += 1
        return self._finished

    # -- one engine iteration ---------------------------------------------------
    def step(self, generator: torch.Generator | None = None) -> None:
        self._admit()
        tokens = np.zeros((self.n_slots, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            cur = self.slot_pos[i]
            if cur < len(req.prompt):
                tokens[i, 0] = req.prompt[cur]            # in-slot prefill
            elif req.out:
                tokens[i, 0] = req.out[-1]
            else:
                tokens[i, 0] = req.prompt[-1]
        try:
            logits, self.cache = self._step(
                self.params, self.cache, torch.from_numpy(tokens).to(self.device))
        except ValueError as e:
            raise ValueError(
                f"{e}: the batcher's slots share one cache length, which counts "
                f"every step since the batcher was built ({self.cache['len']} "
                f"steps of max_seq {self.max_seq}), whatever its requests' "
                "lengths") from e
        sampled = sample_token(logits, self.sp, generator).cpu().numpy()
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.slot_pos[i] += 1
            if self.slot_pos[i] < len(req.prompt):
                continue                                   # still prefilling
            tok = int(sampled[i])
            req.out.append(tok)
            if (tok == self.eos_id
                    or len(req.out) >= req.max_new_tokens
                    or int(self.slot_pos[i]) + len(req.out) >= self.max_seq):
                req.done = True
                self._finished.append(req)
                self.slots[i] = None                       # recycle slot

    def _admit(self) -> None:
        for i in range(self.n_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.popleft()
                self.slots[i] = req
                self.slot_pos[i] = 0

    @property
    def active(self) -> int:
        return sum(r is not None for r in self.slots)
