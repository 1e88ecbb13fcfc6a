"""Serving engines: static batch drain and continuous slot-pool batching.

The port's ``repro.serving.engine``.  Two engines share the request and
stats surface:

* :class:`BatchServer`, the static-drain baseline.  The scheduler pulls a
  length-bucketed batch from the queue (the fullest key inside a bounded
  reorder window, the head's key forced after ``max_head_skips`` skips),
  prefills it, decodes lock-step until every member finishes, then admits
  the next batch; every decode step fetches its tokens to the host.  On the
  card each batch's decode step is captured once and replayed
  (``graph=None``; the reference jits it): a batch's first step is eager,
  its second captures.

* :class:`ContinuousServer`, a fixed slot pool: one padded ring-buffer cache
  allocation reused for the server's whole life.  Finished requests free
  their slot and queued requests are admitted between decode chunks (an
  in-place scatter of a batch-1 prefill, eager); the decode runs
  ``chunk_steps`` steps a chunk on the device, replayed from one CUDA graph
  on the card (``serving/slots.py``), so the host fetches one ``done`` vector
  a chunk instead of a token a step.  ``compile_counts()`` counts the
  prefill's and admission's shapes and the chunk's graph captures.

Per-request TTFT and submit-to-done latency (p50/p95), and the
time-weighted slot occupancy, in :class:`ServeStats`.  Both engines run on
the device their weights are on; ``FederatedServer`` and
``ContinuousFederatedServer`` (``serving/federated.py``) serve per-cluster
replicas through them.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..core.cuda_graph import GraphedStep, resolve_graph
from ..launch.serve import grow_caches, initial_keys, next_keys, sample_tokens
from .slots import build_slot_programs, compile_count, init_slot_state

__all__ = ["Request", "BatchServer", "ContinuousServer", "ServeStats"]


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray            # (S,) int32 token ids
    max_new_tokens: int = 32
    eos_id: Optional[int] = None
    cluster_id: Optional[int] = None  # FederatedServer routing key
    # filled by the server:
    output: Optional[np.ndarray] = None
    submit_s: float = 0.0         # stamped by submit()
    ttft_s: float = 0.0           # submit -> first token available
    latency_s: float = 0.0        # submit -> done


@dataclasses.dataclass
class ServeStats:
    requests: int = 0
    batches: int = 0              # static: drained batches; continuous: chunks
    tokens_generated: int = 0
    decode_steps: int = 0
    wall_s: float = 0.0
    # time-weighted: sum over decode steps of live_slots / max_batch
    occupancy_sum: float = 0.0
    ttfts: list = dataclasses.field(default_factory=list)
    latencies: list = dataclasses.field(default_factory=list)

    @property
    def requests_per_s(self) -> float:
        return self.requests / max(self.wall_s, 1e-9)

    @property
    def tokens_per_s(self) -> float:
        return self.tokens_generated / max(self.wall_s, 1e-9)

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / max(self.decode_steps, 1)

    @property
    def mean_decode_steps(self) -> float:
        return self.decode_steps / max(self.batches, 1)

    def _pct(self, xs: list, q: float) -> float:
        return float(np.percentile(np.asarray(xs), q)) if xs else 0.0

    @property
    def ttft_p50(self) -> float:
        return self._pct(self.ttfts, 50)

    @property
    def ttft_p95(self) -> float:
        return self._pct(self.ttfts, 95)

    @property
    def latency_p50(self) -> float:
        return self._pct(self.latencies, 50)

    @property
    def latency_p95(self) -> float:
        return self._pct(self.latencies, 95)


def _bucket_len(n: int, buckets: tuple[int, ...]) -> int:
    """Smallest bucket holding an ``n``-token prompt.

    Prompts longer than every bucket are a caller error: silently padding to
    ``buckets[-1]`` would truncate context and decode garbage attention, so
    the admission guard lives here (``submit`` delegates).
    """
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(
        f"prompt of {n} tokens exceeds the largest length bucket "
        f"{buckets[-1]}; add a bucket or truncate the prompt"
    )


def _pad_prompt(r: Request, blen: int) -> np.ndarray:
    # left-pad to the bucket (repeat first token; positions are absolute so
    # the pad prefix is a benign repeated-context prefix)
    return np.concatenate([
        np.full(blen - r.prompt.shape[-1], r.prompt[0], np.int32),
        r.prompt.astype(np.int32),
    ])


class BatchServer:
    """Static-drain serving of one model's ``params`` (see the module
    docstring)."""

    def __init__(self, model, params, *, max_batch: int = 8,
                 length_buckets: tuple[int, ...] = (32, 64, 128), temperature: float = 0.0,
                 seed: int = 0, cache_len: Optional[int] = None,
                 reorder_window: Optional[int] = None, max_head_skips: int = 4,
                 graph: Optional[bool] = None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.buckets = tuple(sorted(length_buckets))
        self.temperature = temperature
        # fixed decode cache length (None = exact blen + gen a batch); the
        # continuous engine always uses a fixed length, so comparisons pass
        # the same value here to keep the masks identical
        self.cache_len = cache_len
        self.reorder_window = reorder_window or 4 * max_batch
        self.max_head_skips = max_head_skips
        self._head_skips = 0
        self._queue: deque[Request] = deque()
        self._key = seed
        self.stats = ServeStats()
        # the reference jits its decode step: here one CUDA graph a batch
        # (its shapes and cache), replayed for the batch's steps on the card
        self._graph = resolve_graph(graph, self.device)
        self._decode_state: tuple = ()
        self._decode_graph = (GraphedStep(self._decode_body, lambda: self._decode_state,
                                          self.device) if self._graph else None)

    @property
    def device(self) -> torch.device:
        return _device_of(self.params)

    def _decode_body(self, batch: dict) -> torch.Tensor:
        params, cache = self._decode_state
        logits, _ = self.model.decode_step(params, batch["tok"], cache, batch["pos"])
        return logits[:, -1]

    def _decode(self, params: dict, tok: torch.Tensor, cache: dict, pos: int) -> torch.Tensor:
        """The last logits of one decode step, the cache written in place."""
        self._decode_state = (params, cache)
        batch = {"tok": tok, "pos": torch.full((), pos, dtype=torch.int32, device=tok.device)}
        if self._decode_graph is None:
            return self._decode_body(batch)
        return self._decode_graph(batch)

    # -- queue -------------------------------------------------------------
    def submit(self, req: Request):
        self._batch_key(req)  # validates against the largest bucket
        req.submit_s = time.time()
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    # -- scheduling ----------------------------------------------------------
    def _batch_key(self, req: Request):
        """Co-batchability key: requests sharing a key share a batch."""
        return _bucket_len(req.prompt.shape[-1], self.buckets)

    def _next_batch(self) -> list[Request]:
        """The fullest batch inside a bounded reorder window: the key that
        fills the largest batch among the first ``reorder_window`` requests
        (ties toward the earliest submitter), members only from the window;
        the head's key is forced after ``max_head_skips`` consecutive skips."""
        if not self._queue:
            return []
        window = list(self._queue)[: self.reorder_window]
        counts: dict = {}
        first_pos: dict = {}
        for i, r in enumerate(window):
            k = self._batch_key(r)
            counts.setdefault(k, []).append(r)
            first_pos.setdefault(k, i)
        head_key = self._batch_key(window[0])
        if self._head_skips >= self.max_head_skips:
            chosen = head_key
        else:
            chosen = max(counts,
                         key=lambda k: (min(len(counts[k]), self.max_batch), -first_pos[k]))
        if chosen == head_key:
            self._head_skips = 0
        else:
            self._head_skips += 1
        batch = counts[chosen][: self.max_batch]
        picked = set(id(r) for r in batch)
        self._queue = deque(r for r in self._queue if id(r) not in picked)
        return batch

    # -- model hooks (FederatedServer routes these per cluster) --------------
    def _begin_batch(self, batch: list[Request]) -> None:
        """Batch boundary: the only point where weights may change."""

    def _batch_params(self, batch: list[Request]) -> dict:
        return self.params

    def _draw(self, logits: torch.Tensor, keys: torch.Tensor) -> torch.Tensor:
        return sample_tokens(logits, self.model.cfg.vocab_size, self.temperature, keys)

    # -- execution -----------------------------------------------------------
    @torch.no_grad()
    def _run_batch(self, batch: list[Request]):
        model = self.model
        self._begin_batch(batch)
        params = self._batch_params(batch)
        t0 = time.time()
        blen = _bucket_len(max(r.prompt.shape[-1] for r in batch), self.buckets)
        gen = max(r.max_new_tokens for r in batch)
        b = len(batch)
        toks = torch.from_numpy(np.stack([_pad_prompt(r, blen) for r in batch])).to(self.device)

        logits, cache = model.prefill(params, {"tokens": toks})
        cache = grow_caches(model, cache, max(self.cache_len or 0, blen + gen))

        eos = np.array([-1 if r.eos_id is None else r.eos_id for r in batch])
        budget = np.array([r.max_new_tokens for r in batch])
        done = np.zeros(b, dtype=bool)
        keys = initial_keys(self._key, b, self.device)
        self._key += 1
        tok = self._draw(logits[:, -1], keys)
        outs = []
        t_first = None
        for i in range(gen):
            host_tok = tok.cpu().numpy()
            if t_first is None:
                t_first = time.time()
            outs.append(host_tok)
            # a request is finished once it has emitted its EOS or spent its
            # budget; when the whole batch is finished the lock-step loop stops
            done |= (host_tok == eos) | (budget <= i + 1)
            if done.all():
                break
            # time-weighted occupancy: the still-live requests of this step
            self.stats.decode_steps += 1
            self.stats.occupancy_sum += float((~done).sum()) / self.max_batch
            keys = next_keys(keys)
            tok = self._draw(self._decode(params, tok, cache, blen + i), keys)
        gen_tokens = np.stack(outs, axis=1)  # (B, <= gen)
        self._decode_state = ()

        t_end = time.time()
        n_tok = 0
        for j, r in enumerate(batch):
            seq = gen_tokens[j, : r.max_new_tokens]
            if r.eos_id is not None:
                hits = np.nonzero(seq == r.eos_id)[0]
                if hits.size:
                    seq = seq[: hits[0] + 1]
            r.output = seq
            r.ttft_s = t_first - r.submit_s
            r.latency_s = t_end - r.submit_s
            self.stats.ttfts.append(r.ttft_s)
            self.stats.latencies.append(r.latency_s)
            n_tok += int(seq.size)
        self.stats.requests += b
        self.stats.batches += 1
        self.stats.tokens_generated += n_tok
        self.stats.wall_s += t_end - t0
        return batch

    def run(self) -> list[Request]:
        """Drain the queue; returns completed requests in completion order."""
        done = []
        while self._queue:
            done.extend(self._run_batch(self._next_batch()))
        return done


class ContinuousServer:
    """Continuous batching over a fixed slot pool (see the module docstring).

    The pool holds ``max_batch`` slots over one padded cache of
    ``buckets[-1] + gen_cap`` positions; every request decodes in its own
    slot with its own position row, so mixed prompt buckets, mixed budgets
    and mid-stream admissions share one decode program.  The run loop
    alternates admission boundaries (free slots filled from the queue: the
    only point where serving weights may change, see
    ``ContinuousFederatedServer``) with decode chunks of ``chunk_steps``
    steps, harvesting finished slots after each chunk.  ``graph`` as a
    scheduler's: None replays the chunk from a CUDA graph on the card and
    runs it eagerly on the CPU, False is the eager chunk.  ``share`` and
    ``own`` are a cluster mesh's (``ContinuousFederatedServer(mesh=)``,
    ``slots.build_slot_programs``)."""

    _stacked = False  # federated subclass: weights are a (D, ...) stack

    def __init__(self, model, params, *, max_batch: int = 8,
                 length_buckets: tuple[int, ...] = (32, 64, 128), gen_cap: int = 64,
                 chunk_steps: int = 8, temperature: float = 0.0, seed: int = 0,
                 graph: Optional[bool] = None, share=None, own: Optional[int] = None):
        self.model = model
        self.params = params
        self.max_batch = max_batch
        self.buckets = tuple(sorted(length_buckets))
        self.gen_cap = gen_cap
        self.chunk_steps = chunk_steps
        self.temperature = temperature
        self.cache_len = self.buckets[-1] + gen_cap
        self._queue: deque[Request] = deque()
        self._key = seed
        self._free: list[int] = list(range(max_batch))[::-1]  # pop() -> slot 0 first
        self._occupied: dict[int, Request] = {}
        device = _device_of(self._weights())
        self._state = init_slot_state(model, max_batch=max_batch, cache_len=self.cache_len,
                                      gen_cap=gen_cap, federated=self._stacked, seed=seed,
                                      device=device)
        self._prefill_p, self._admit_p, self._chunk_p = build_slot_programs(
            model, temperature=temperature, gen_cap=gen_cap, chunk_steps=chunk_steps,
            stacked=self._stacked, device=device, graph=graph, share=share, own=own)
        self._steps_seen = 0
        self._active_steps_seen = 0
        self.stats = ServeStats()

    # -- queue ---------------------------------------------------------------
    def submit(self, req: Request):
        _bucket_len(req.prompt.shape[-1], self.buckets)
        if req.max_new_tokens > self.gen_cap:
            raise ValueError(
                f"max_new_tokens {req.max_new_tokens} exceeds the slot pool's "
                f"gen_cap {self.gen_cap}; raise gen_cap at construction")
        req.submit_s = time.time()
        self._queue.append(req)

    def pending(self) -> int:
        return len(self._queue)

    # -- weight hooks (federated subclass overrides) --------------------------
    def _weights(self):
        return self.params

    def _cluster_index(self, req: Request):
        return None

    def _admission_open(self) -> bool:
        return True

    def _at_admission_boundary(self) -> None:
        """Hook: the only point where serving weights may change."""

    def _prefills(self, req: Request) -> bool:
        """Hook: whether this process prefills ``req`` (on a cluster mesh,
        only the rank of its cluster)."""
        return True

    def _replica(self, d):
        """Hook: the index of cluster ``d``'s replica in ``_weights()``."""
        return d

    # -- admission -----------------------------------------------------------
    def _admit_one(self, req: Request, slot: int) -> None:
        blen = _bucket_len(req.prompt.shape[-1], self.buckets)
        toks = torch.from_numpy(_pad_prompt(req, blen)[None]).to(self._state["tok"].device)
        d = self._cluster_index(req)
        logits = row_cache = None
        if self._prefills(req):
            logits, row_cache = self._prefill_p(self._weights(), self._replica(d), toks)
        key_row = initial_keys(self._key, 1, toks.device)
        self._key += 1
        eos = -1 if req.eos_id is None else req.eos_id
        self._admit_p(self._state, row_cache, logits, slot, blen, eos, req.max_new_tokens,
                      key_row, d)
        req.ttft_s = time.time() - req.submit_s  # the first token is drawn in admit
        self.stats.ttfts.append(req.ttft_s)
        self._occupied[slot] = req

    def _admit_available(self) -> None:
        while self._queue and self._free and self._admission_open():
            self._admit_one(self._queue.popleft(), self._free.pop())

    # -- harvest -------------------------------------------------------------
    def _finish_slot(self, slot: int, emitted: int) -> Request:
        req = self._occupied.pop(slot)
        # a copy: on the CPU ``.numpy()`` would share the pool's memory
        req.output = self._state["out"][slot, :emitted].cpu().numpy().copy()
        req.latency_s = time.time() - req.submit_s
        self.stats.latencies.append(req.latency_s)
        self.stats.requests += 1
        self.stats.tokens_generated += int(emitted)
        self._free.append(slot)
        return req

    def _sync_stats(self) -> None:
        steps = int(self._state["steps"])
        active = int(self._state["active_steps"])
        self.stats.decode_steps += steps - self._steps_seen
        self.stats.occupancy_sum += (active - self._active_steps_seen) / self.max_batch
        self._steps_seen, self._active_steps_seen = steps, active

    # -- execution -----------------------------------------------------------
    @torch.no_grad()
    def step(self) -> list[Request]:
        """One admission boundary + one decode chunk."""
        self._at_admission_boundary()
        self._admit_available()
        finished: list[Request] = []
        if not self._occupied:
            return finished
        self._chunk_p(self._weights(), self._state)
        self.stats.batches += 1
        done = self._state["done"].cpu().numpy()
        if done[list(self._occupied)].any():
            emitted = self._state["emitted"].cpu().numpy()
            for slot in [s for s in self._occupied if done[s]]:
                finished.append(self._finish_slot(slot, int(emitted[slot])))
        return finished

    def run(self) -> list[Request]:
        """Serve until queue and pool drain; returns requests as completed."""
        completed: list[Request] = []
        t0 = time.time()
        while self._queue or self._occupied:
            completed.extend(self.step())
        self._sync_stats()
        self.stats.wall_s += time.time() - t0
        return completed

    # -- introspection --------------------------------------------------------
    def compile_counts(self) -> dict:
        """Shapes the prefill and admission ran at, and the decode chunk's
        graph captures (its distinct keys where it runs eagerly): the gate
        that no admission pattern adds a program."""
        return {"prefill": compile_count(self._prefill_p),
                "admit": compile_count(self._admit_p),
                "decode": compile_count(self._chunk_p)}
