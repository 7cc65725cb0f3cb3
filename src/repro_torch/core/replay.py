"""Experience replay ring buffer, one per lane (paper: |B| = 1000, H = 32).

Port of ``repro/core/replay.py`` with the fleet axis in front: the buffer
is ``[F, cap, ·]`` and ``ptr``/``size`` are ``[F]``.  Unlike the
reference's pure functions, ``replay_add`` writes into the buffer IN PLACE
(and returns it); oldest samples are overwritten when full."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device


@dataclasses.dataclass
class Replay:
    states: torch.Tensor        # [F, cap, state_dim]
    actions: torch.Tensor       # [F, cap, action_dim]
    rewards: torch.Tensor       # [F, cap]
    next_states: torch.Tensor   # [F, cap, state_dim]
    ptr: torch.Tensor           # [F] int32 — next write slot
    size: torch.Tensor          # [F] int32

    @property
    def capacity(self) -> int:
        return self.states.shape[1]


def replay_init(fleet: int, capacity: int, state_dim: int, action_dim: int,
                device: str | torch.device | None = None) -> Replay:
    """An empty buffer per lane on ``device`` (default CUDA; raises without
    a GPU)."""
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(fleet, *shape, device=device)
    return Replay(
        states=z(capacity, state_dim),
        actions=z(capacity, action_dim),
        rewards=z(capacity),
        next_states=z(capacity, state_dim),
        ptr=torch.zeros(fleet, dtype=torch.int32, device=device),
        size=torch.zeros(fleet, dtype=torch.int32, device=device),
    )


def replay_add(buf: Replay, s, a, r, s_next) -> Replay:
    """Write ``n`` transitions per lane (``s [F, n, ·]``, ``r [F, n]``) at
    the ring pointer, in place.  ``n`` must not exceed the capacity.  A
    single transition per lane may also be passed as ``s [F, ·]``,
    ``r [F]``."""
    if r.dim() == 1:
        s, a, r, s_next = s[:, None], a[:, None], r[:, None], s_next[:, None]
    cap, n = buf.capacity, r.shape[1]
    if n > cap:
        raise ValueError(f"{n} transitions do not fit a buffer of {cap}")
    lanes = torch.arange(r.shape[0], device=r.device)[:, None]
    slot = (buf.ptr[:, None].long() + torch.arange(n, device=r.device)) % cap
    buf.states[lanes, slot] = s
    buf.actions[lanes, slot] = a
    buf.rewards[lanes, slot] = r
    buf.next_states[lanes, slot] = s_next
    buf.ptr = ((buf.ptr + n) % cap).to(torch.int32)
    buf.size = torch.clamp(buf.size + n, max=cap).to(torch.int32)
    return buf


def sample_indices(buf: Replay, batch: int,
                   gen: torch.Generator | None,
                   u: torch.Tensor | None = None) -> torch.Tensor:
    """``[F, batch]`` uniform indices, with replacement, over each lane's
    filled prefix (an empty buffer samples slot 0), from the float64
    uniforms ``u [F, batch]`` in [0, 1) or, when None, from ``gen``."""
    high = torch.clamp(buf.size, min=1).to(torch.float64)[:, None]
    if u is None:
        u = torch.rand(buf.size.shape[0], batch, generator=gen,
                       device=buf.size.device, dtype=torch.float64)
    return torch.clamp((u * high).long(), max=buf.capacity - 1)


def replay_sample(buf: Replay, idx: torch.Tensor):
    """The transitions at ``idx [F, B]``: (s, a, r, s_next)."""
    idx = idx.long()
    lanes = torch.arange(idx.shape[0], device=idx.device)[:, None]
    return (buf.states[lanes, idx], buf.actions[lanes, idx],
            buf.rewards[lanes, idx], buf.next_states[lanes, idx])
