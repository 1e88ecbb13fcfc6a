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

``BatchFeed`` is what the sync and round schedulers draw from: a
``BatchPipeline`` over their producer whose transfer, on a CUDA device, is
a ``CopyStream``: each batch is pinned and copied on a stream of its own,
and the compute stream waits on that copy's event only when it takes the
batch.  On the CPU (and with ``prefetch=False``) ``device_batch`` stages with
``torch.as_tensor(..., device=...)``; ``device_batch(..., non_blocking=True)``
(the async scheduler's prefetch) goes through pinned memory on the current
stream.

``OperandStage`` takes the async scheduler's small per-event operands (the
fired cluster's index, factors, weights, step mask and ``P_t``) to the
device in one non-blocking copy out of a ring of two pinned host buffers.

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

__all__ = ["BatchFeed", "BatchPipeline", "CopyStream", "OperandStage", "device_batch",
           "gather_client_batches", "stack_window"]


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


class CopyStream:
    """Host batches to a CUDA device on a copy stream of their own.

    ``stage`` pins every entry (PyTorch's caching host allocator holds a
    pinned block until the copy out of it has run), queues the copies on the
    copy stream and records an event there; the host does not wait.
    ``take`` makes the current (compute) stream wait on that event and marks
    the device tensors as used by it (``record_stream``): the allocator does
    not give their memory to a later staged batch before the compute stream
    has read them, which in graph mode is the copy into the graph's static
    input buffers ahead of the replay.
    """

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)

    def stage(self, batch: dict) -> tuple[dict, "torch.cuda.Event"]:
        pinned = {k: torch.as_tensor(np.ascontiguousarray(v)).pin_memory()
                  for k, v in batch.items()}
        with torch.cuda.stream(self.stream):
            staged = {k: t.to(self.device, non_blocking=True) for k, t in pinned.items()}
            ready = torch.cuda.Event()
            ready.record(self.stream)
        return staged, ready

    def take(self, staged: tuple[dict, "torch.cuda.Event"]) -> dict:
        batch, ready = staged
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(ready)
        for t in batch.values():
            t.record_stream(compute)
        return batch


class BatchFeed:
    """A scheduler's batches on its device, staged ``depth`` steps ahead.

    ``get(k, source, producer)`` returns step ``k``'s batch; ``producer``
    (``source`` itself by default) maps a step to its host batch.  A
    different ``source``, or a step out of order, starts a new pipeline;
    with ``prefetch=False`` every batch is drawn and copied when asked for.
    """

    def __init__(self, device, prefetch: bool = True):
        self.device = torch.device(device)
        self.prefetch = prefetch
        self._copy = CopyStream(self.device) if self.device.type == "cuda" else None
        self._pipeline: Optional[BatchPipeline] = None
        self._source = None

    def _stage(self, batch: dict):
        return self._copy.stage(batch) if self._copy else device_batch(batch, self.device)

    def get(self, k: int, source, producer: Optional[Callable[[int], Any]] = None) -> dict:
        producer = source if producer is None else producer
        if not self.prefetch:
            return device_batch(producer(k), self.device)
        if (self._pipeline is None or self._source is not source
                or self._pipeline.next_index != k):
            self._pipeline = BatchPipeline(producer, self._stage, start=k)
            self._source = source
        staged = self._pipeline.get(k)
        return self._copy.take(staged) if self._copy else staged


class OperandStage:
    """Small host arrays to the device in one non-blocking copy.

    ``stage({name: array})`` packs the arrays (16-byte aligned, any dtypes)
    into one pinned host buffer, queues one copy of it on the current
    stream and returns device views of the copy, one per array.  The host
    does not wait for the copy, as it would for a copy out of pageable
    memory.  The pinned buffers form a ring of ``slots``: a buffer is
    written again only after the copy out of it has run (an event recorded
    behind each copy, waited on before the buffer is rewritten), so a
    staged operand never changes under a copy still queued.  On the CPU the
    arrays become tensors as they are.
    """

    ALIGN = 16

    def __init__(self, device, slots: int = 2):
        self.device = torch.device(device)
        self._ring: list = [None] * slots  # (pinned uint8 buffer, event) a slot
        self._next = 0

    def stage(self, arrays: dict) -> dict:
        arrays = {k: np.ascontiguousarray(v) for k, v in arrays.items()}
        if self.device.type != "cuda":
            return {k: torch.from_numpy(v.copy()) for k, v in arrays.items()}
        offsets, total = {}, 0
        for k, a in arrays.items():
            offsets[k] = total
            total += -(-a.nbytes // self.ALIGN) * self.ALIGN
        slot = self._ring[self._next]
        if slot is None or slot[0].numel() < total:
            size = max(total, 1 << 12)
            slot = (torch.empty(size, dtype=torch.uint8).pin_memory(), torch.cuda.Event())
            self._ring[self._next] = slot
        else:
            slot[1].synchronize()  # the copy out of this buffer has run
        self._next = (self._next + 1) % len(self._ring)
        host, copied = slot
        raw = host.numpy()
        for k, a in arrays.items():
            raw[offsets[k]:offsets[k] + a.nbytes] = a.reshape(-1).view(np.uint8)
        dev = host[:total].to(self.device, non_blocking=True)
        copied.record()
        return {k: dev[offsets[k]:offsets[k] + a.nbytes].view(_TORCH_DTYPES[a.dtype]).view(a.shape)
                for k, a in arrays.items()}


_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.int64): torch.int64}


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
