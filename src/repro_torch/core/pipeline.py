"""Batch staging: prepare the next steps' batches ahead of the current one.

``BatchPipeline`` is a lookahead buffer over an *indexed* producer
``k -> host batch`` (the sync ``batch_source`` contract), as in
``repro.core.pipeline``.  The buffer is warmed ``depth`` entries ahead;
each ``get(k)`` returns the staged batch for step ``k`` and immediately
stages ``k + depth``.  Batches are consumed in exactly the order produced,
and a *stateful* producer is drawn from up to ``depth`` steps ahead of
consumption in the same order as the reference, so a numpy rng source
yields the same batches in both packages.  Producers signal exhaustion by
raising ``StopIteration`` or ``IndexError``.

Staging is ``torch.as_tensor(..., device=...)`` on PyTorch's current
stream; ``device_batch(..., non_blocking=True)`` (the async scheduler's
prefetch) stages through pinned host memory instead.  A side copy stream is
later work.

``stack_window`` stacks a round engine's window of iteration batches on a
new leading axis.  ``gather_client_batches`` draws the async scheduler's
per-client batches from a ``ClientBatcher``-like source, as
``repro.core.pipeline`` does.
"""
from __future__ import annotations

import collections
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

__all__ = ["BatchPipeline", "device_batch", "gather_client_batches", "stack_window"]


def device_batch(batch: dict, device, non_blocking: bool = False) -> dict:
    """Copy every entry of a flat host batch dict to ``device``.

    With ``non_blocking`` a CUDA copy is staged through pinned host memory
    and queued on the current stream, so the host does not wait for it.
    """
    device = torch.device(device)
    if not (non_blocking and device.type == "cuda"):
        return {k: torch.as_tensor(np.asarray(v), device=device) for k, v in batch.items()}
    return {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(device, non_blocking=True)
            for k, v in batch.items()}


def stack_window(batch_source: Callable[[int], dict], start: int, count: int) -> dict:
    """Stack batches ``start .. start + count - 1`` on a new leading axis
    (host numpy when every entry is numpy, else torch)."""
    batches = [batch_source(start + i) for i in range(count)]
    out = {}
    for k in batches[0]:
        xs = [b[k] for b in batches]
        out[k] = (np.stack(xs) if all(isinstance(x, np.ndarray) for x in xs)
                  else torch.stack([torch.as_tensor(x) for x in xs]))
    return out


class BatchPipeline:
    """Lookahead buffer over an indexed batch producer.

    ``get`` is strictly sequential from ``start`` — a scheduler asked to
    step out of order (or handed a different source) drops the pipeline and
    builds a fresh one; ``next_index`` says what the pipeline expects.
    """

    def __init__(self, producer: Callable[[int], Any], transfer: Callable[[Any], Any],
                 start: int = 1, depth: int = 2):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self._producer = producer
        self._transfer = transfer
        self._depth = depth
        self._next_produce = start
        self._next_get = start
        self._exhausted = False
        self._buf: collections.deque = collections.deque()
        self._fill()

    @property
    def next_index(self) -> int:
        """Index the next ``get`` must request."""
        return self._next_get

    @property
    def exhausted(self) -> bool:
        """True once the producer has signaled end-of-stream."""
        return self._exhausted and not self._buf

    def _fill(self) -> None:
        while not self._exhausted and len(self._buf) < self._depth:
            try:
                host = self._producer(self._next_produce)
            except (StopIteration, IndexError):
                self._exhausted = True
                return
            self._buf.append(self._transfer(host))
            self._next_produce += 1

    def get(self, k: int):
        """Staged batch for step ``k``; stages ``k + depth`` before returning."""
        if k != self._next_get:
            raise ValueError(
                f"BatchPipeline is sequential: expected get({self._next_get}), got get({k})"
            )
        if not self._buf:
            raise StopIteration(f"batch producer exhausted before index {k}")
        batch = self._buf.popleft()
        self._next_get += 1
        self._fill()
        return batch


def gather_client_batches(batch_source, clients: Sequence[int], count: int) -> dict:
    """``count`` batches for each of ``clients``, entries (len(clients), count, ...).

    Prefers the bulk ``next_batches(clients, count)`` method; a source with
    only the per-call ``next_batch(client)`` is served by a loop that draws
    in the same client-major order, so both consume a stateful source's
    streams identically.  Host numpy in, host numpy out.
    """
    bulk: Optional[Callable] = getattr(batch_source, "next_batches", None)
    if bulk is not None:
        return bulk(list(clients), count)
    per_client = []
    for c in clients:
        draws = [batch_source.next_batch(c) for _ in range(count)]
        per_client.append({k: np.stack([np.asarray(b[k]) for b in draws]) for k in draws[0]})
    return {k: np.stack([b[k] for b in per_client]) for k in per_client[0]}
