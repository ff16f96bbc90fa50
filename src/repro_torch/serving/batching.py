"""Request batching for the serving engine.

The paper's edge performs per-window batched inference; a production serving
plane needs continuous batching: requests arrive asynchronously, are admitted
into fixed slots, and finished slots are recycled.  This scheduler is
deterministic (driven by the runtime simulator's clock or by arrival order).

The scheduler is generic over the *request* type: anything with ``done``
(finished predicate), ``prefill_len`` (how many positions its admission
prefill consumes — token prompts report their prompt length, forecast
queries report 0), ``admitted_at`` and ``finished_at`` stamp fields works.
``repro_torch.serving.engine.Engine.serve`` drives it with token
:class:`Request`s; the reference's ``QueryPlane`` drives it with
``ForecastQuery``s.  Copied from the reference (numpy only).
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Deque, List, Optional

import numpy as np


@dataclass
class Request:
    uid: int
    prompt: np.ndarray  # (S,) int32
    max_new_tokens: int
    arrived_at: float = 0.0
    # filled by the engine
    generated: List[int] = field(default_factory=list)
    admitted_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    @property
    def prefill_len(self) -> int:
        return len(self.prompt)


@dataclass
class Slot:
    request: Optional[Request] = None
    pos: int = 0  # next decode position (absolute)

    @property
    def free(self) -> bool:
        return self.request is None


class BatchScheduler:
    """Fixed-slot continuous batcher.

    The queue is a deque, so FIFO admission of ``k`` requests costs O(k)
    ``popleft``s instead of the O(queue) list-head pops a ``list.pop(0)``
    queue pays per admission.
    """

    def __init__(self, n_slots: int):
        self.slots = [Slot() for _ in range(n_slots)]
        self.queue: Deque = deque()

    def submit(self, req) -> None:
        self.queue.append(req)

    def admit(self, now: Optional[float] = None) -> List[int]:
        """Move queued requests into free slots in strict FIFO order;
        returns the slot ids admitted (these need a prefill before
        decoding).  ``now`` stamps each admitted request's ``admitted_at``
        when the caller threads a clock through (the runtime executors do;
        clockless callers may omit it)."""
        admitted = []
        for i, s in enumerate(self.slots):
            if s.free and self.queue:
                s.request = self.queue.popleft()
                s.pos = s.request.prefill_len
                if now is not None:
                    s.request.admitted_at = now
                admitted.append(i)
        return admitted

    def active(self) -> List[int]:
        return [i for i, s in enumerate(self.slots) if not s.free]

    def retire_finished(self, now: float) -> List:
        """Free every slot whose request is done, stamping ``finished_at``
        with the caller's clock — ``now`` is required, so latency accounting
        can never silently default to 0.0."""
        done = []
        for s in self.slots:
            if s.request is not None and s.request.done:
                s.request.finished_at = now
                done.append(s.request)
                s.request = None
                s.pos = 0
        return done

    @property
    def idle(self) -> bool:
        return not self.queue and all(s.free for s in self.slots)
