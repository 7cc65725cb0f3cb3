"""Heartbeat-based failure detection (``repro/fault/heartbeat.py``): the
master-side view, as in Storm §2.1: "the master monitors heartbeat
signals from all worker processes periodically; it re-schedules them when
it discovers a failure".

Works on an injected clock so tests are deterministic; in production the
clock is ``time.monotonic`` and beats arrive from worker RPCs."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable


@dataclasses.dataclass
class HeartbeatMonitor:
    num_workers: int
    timeout_s: float = 10.0
    clock: Callable[[], float] | None = None

    def __post_init__(self):
        if self.clock is None:
            self.clock = time.monotonic
        now = self.clock()
        self.last_beat = {w: now for w in range(self.num_workers)}
        self._known_dead: set[int] = set()

    def beat(self, worker: int) -> None:
        self.last_beat[worker] = self.clock()
        self._known_dead.discard(worker)

    def dead_workers(self) -> set[int]:
        now = self.clock()
        return {w for w, t in self.last_beat.items() if now - t > self.timeout_s}

    def newly_dead(self) -> set[int]:
        dead = self.dead_workers()
        new = dead - self._known_dead
        self._known_dead |= new
        return new

    @property
    def alive(self) -> list[int]:
        dead = self.dead_workers()
        return [w for w in range(self.num_workers) if w not in dead]
