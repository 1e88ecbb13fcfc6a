"""Slot-pool machinery for the continuous-batching engine.

The port's ``repro.serving.slots``.  The pool is one fixed device
allocation reused for the server's life: a ``(max_batch,)``-slot KV/SSM
cache plus per-slot ``tok``/``pos``/``done``/``eos``/``budget`` vectors, read
and written in place by three programs:

* ``prefill``: one request's prompt at batch 1, eager (one shape a length
  bucket);
* ``admit``: an in-place scatter of that prefill row (cache, first drawn
  token, eos, budget, key, cluster) into a slot, eager;
* ``chunk``: ``chunk_steps`` decode steps in lock step over every slot
  (draw, append, done mask).  The reference's ``jax.jit(lax.while_loop)``
  stops once every slot is done; here that exit is a device-side mask,
  ``go = any(~done)`` at each step, which gates every write, so the state
  stops changing once every slot is done and ``steps`` counts the steps the
  reference runs.  On the card the chunk is one CUDA graph
  (``core.cuda_graph.GraphedStep``): the pool, the weights, ``tok``, ``pos``
  and ``cluster`` sit at fixed addresses, so one capture serves every
  admission pattern and length bucket.

Per-slot positions: every attention ``pos`` leaf carries a slot axis,
``(nblocks, max_batch, Sc)``, so slots at different prompt lengths and
decode depths share one program; a cache padded to the pool's length masks
its ``pos = -1`` entries out.  An empty or finished slot keeps decoding in
lock step, harmlessly: its frozen ``tok``/``pos`` rewrite the same k/v into
the same ring slot, and admission overwrites the slot's whole cache row.

Federated weights (``stacked``): the chunk reads a ``(D, ...)`` stack, and
``CausalLM.decode_hidden`` runs each op that reads weights once a cluster
over all slots, each slot keeping its own cluster's result: no slot gathers
a copy of its cluster's weights (a per-slot gather would copy the model per
slot).

On a cluster mesh (``share``, ``ContinuousFederatedServer(mesh=)``) each
rank holds one cluster's replica as a ``(1, ...)`` stack and the whole
pool: it prefills only its cluster's admissions, and its chunk runs every
slot on its replica, the same ops at the same shapes as the off-mesh
chunk's pass for that cluster, so its own slots' rows are those of the
off-mesh pool bit for bit and the others' are never read.  ``share(tok,
mine)`` then gives every rank the tokens each slot's own rank drew (one
collective a decode step and an admission), so every control vector, and
each rank's own cache rows, follow the off-mesh pool exactly.  On a CUDA
rank the decode steps' all-reduces are captured in the chunk's graph; its
key (the pool's and the replica row's addresses) is fixed for the server's
life on every rank, so all ranks warm up, capture and replay at the same
calls and the replays' collectives match.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.cuda_graph import GraphedStep, graph_key, resolve_graph
from ..launch.serve import initial_keys, next_keys, sample_tokens

__all__ = ["init_slot_state", "build_slot_programs", "compile_count"]


def _is_pos_leaf(name: str) -> bool:
    return name.endswith(".pos")


def init_slot_state(model, *, max_batch: int, cache_len: int, gen_cap: int,
                    federated: bool, seed: int, device=None) -> dict:
    """The pool: one padded cache plus per-slot control vectors, on ``device``.

    The cache is ``model.init_cache``'s with each attention ``pos`` leaf
    broadcast from ``(nblocks, Sc)`` to ``(nblocks, max_batch, Sc)``;
    ``done`` starts all True (empty slots)."""
    cache = model.init_cache(max_batch, cache_len, device)
    cache = {k: (v[:, None].expand(v.shape[0], max_batch, v.shape[1]).contiguous()
                 if _is_pos_leaf(k) else v) for k, v in cache.items()}
    i32, i64 = torch.int32, torch.int64
    state = {
        "cache": cache,
        "tok": torch.zeros(max_batch, dtype=i64, device=device),
        "pos": torch.zeros(max_batch, dtype=i32, device=device),
        "done": torch.ones(max_batch, dtype=torch.bool, device=device),
        "emitted": torch.zeros(max_batch, dtype=i32, device=device),
        "budget": torch.zeros(max_batch, dtype=i32, device=device),
        "eos": torch.full((max_batch,), -1, dtype=i32, device=device),
        "out": torch.zeros((max_batch, gen_cap), dtype=i64, device=device),
        "key": initial_keys(seed, max_batch, device),
        "steps": torch.zeros((), dtype=i32, device=device),
        "active_steps": torch.zeros((), dtype=i32, device=device),
    }
    if federated:
        state["cluster"] = torch.zeros(max_batch, dtype=i64, device=device)
    return state


def _cluster_params(stack: dict, d: int) -> dict:
    """Cluster ``d``'s leaves: views into the stack, no copy."""
    return {k: w[d] for k, w in stack.items()}


def _shapes(x):
    if isinstance(x, torch.Tensor):
        return tuple(x.shape)
    if isinstance(x, dict):
        return tuple((k, _shapes(v)) for k, v in x.items())
    return None


class _Eager:
    """An eager program that counts the shapes it ran at (the reference's
    compiles, one a length bucket)."""

    def __init__(self, fn):
        self._fn = fn
        self.shapes: set = set()

    def __call__(self, *args):
        self.shapes.add(tuple(_shapes(a) for a in args))
        return self._fn(*args)

    @property
    def count(self) -> int:
        return len(self.shapes)


class _Chunk:
    """The decode chunk, replayed from a ``GraphedStep`` (``graphed``) or
    run eagerly; ``graphed`` is None for the eager path, and a test may set
    it to ``_build_graph()`` to reach the captured body on the CPU."""

    def __init__(self, body, device, graph: Optional[bool]):
        self._body = body
        self.device = torch.device(device)
        self._args: tuple = ()
        self._keys: set = set()
        self.graphed = self._build_graph() if resolve_graph(graph, self.device) else None

    def _build_graph(self) -> GraphedStep:
        return GraphedStep(lambda _batch: self._body(*self._args), lambda: self._args,
                           self.device)

    def __call__(self, weights, state) -> None:
        self._args = (weights, state)
        self._keys.add(graph_key({}, self._args))
        if self.graphed is None:
            self._body(weights, state)
        else:
            self.graphed({})

    def eager(self, weights, state) -> None:
        """The chunk's body run eagerly, whatever the route (the graph's
        reference)."""
        self._body(weights, state)

    @property
    def count(self) -> int:
        if self.graphed is not None and self.device.type == "cuda":
            return self.graphed.captured
        return len(self._keys)


def build_slot_programs(model, *, temperature: float, gen_cap: int, chunk_steps: int,
                        stacked: bool, device=None, graph: Optional[bool] = None,
                        share=None, own: Optional[int] = None):
    """The three slot programs ``(prefill, admit, chunk)``.

    ``stacked=True`` is the federated variant: weights arrive as one ``(D,
    ...)`` stack and ``state["cluster"]`` routes each slot to its replica.
    On a cluster mesh ``share(tok, mine)`` makes the tokens of the slots
    where ``mine`` is True (cluster ``own``'s, this rank's) the same on
    every rank, and the stack is this rank's ``(1, ...)`` row; an admission
    of another rank's cluster comes with no prefill (``row_cache`` None)."""
    cfg = model.cfg
    if cfg.modality == "audio" and cfg.num_codebooks > 1:
        raise ValueError("continuous batching supports single-codebook token "
                         "streams; audio multi-codebook decode is not slotted")
    vocab = cfg.vocab_size

    def _prefill(weights, d, toks):
        params = _cluster_params(weights, d) if stacked else weights
        return model.prefill(params, {"tokens": toks})

    def _admit(state, row_cache, row_logits, slot, blen, eos, budget, key_row, cluster):
        for name, big in (state["cache"] if row_cache is not None else {}).items():
            row = row_cache[name]
            if _is_pos_leaf(name):  # (nblocks, Sc_row) -> the slot's row, -1 padded
                big[:, slot, :row.shape[-1]] = row
                big[:, slot, row.shape[-1]:] = -1
            else:                   # drop the batch-1 axis, zero padded
                r = row[:, 0]
                big[:, slot, :r.shape[1]] = r.to(big.dtype)
                big[:, slot, r.shape[1]:] = 0
        if row_logits is not None:
            tok0 = sample_tokens(row_logits[:, -1], vocab, temperature, key_row)
        else:
            tok0 = torch.zeros(1, dtype=torch.int64, device=key_row.device)
        if share is not None:
            tok0 = share(tok0, torch.tensor(row_logits is not None, device=tok0.device))
        state["tok"][slot] = tok0[0]
        state["pos"][slot] = blen
        state["done"][slot] = False
        state["emitted"][slot] = 0
        state["budget"][slot] = budget
        state["eos"][slot] = eos
        state["out"][slot] = 0
        state["key"][slot] = key_row[0]
        if cluster is not None:
            state["cluster"][slot] = cluster

    def _step(plist, st, rows) -> None:
        tok, pos, done = st["tok"], st["pos"], st["done"]
        active = ~done
        go = active.any()
        # append: inactive rows write back what they hold
        idx = torch.clamp(st["emitted"], max=gen_cap - 1).long()
        st["out"][rows, idx] = torch.where(active, tok, st["out"][rows, idx])
        emitted = st["emitted"] + active.to(torch.int32)
        done_now = done | (active & ((tok == st["eos"]) | (emitted >= st["budget"])))
        # each slot decodes as a batch of one, as the reference's per-slot vmap
        logits, _ = model.decode_step(plist, tok, st["cache"], pos, cluster=st.get("cluster"),
                                      gate=go, per_row=True)
        keys = next_keys(st["key"])
        new_tok = sample_tokens(logits[:, -1], vocab, temperature, keys)
        if share is not None:
            new_tok = share(new_tok, st["cluster"] == own)
        still = ~done_now
        # finished and empty slots freeze tok and pos: their next ring write
        # rewrites the same k/v at the same slot
        updates = {"tok": torch.where(still, new_tok, tok),
                   "pos": torch.where(still, pos + 1, pos),
                   "done": done_now, "emitted": emitted, "key": keys}
        for k, v in updates.items():
            st[k].copy_(torch.where(go, v, st[k]))
        st["steps"].add_(go.to(torch.int32))
        st["active_steps"].add_(active.sum().to(torch.int32))

    def _chunk(weights, state) -> None:
        plist = ([_cluster_params(weights, d) for d in range(next(iter(weights.values())).shape[0])]
                 if stacked else [weights])
        rows = torch.arange(state["done"].shape[0], device=state["done"].device)
        for _ in range(chunk_steps):
            _step(plist, state, rows)

    return _Eager(_prefill), _Eager(_admit), _Chunk(_chunk, device, graph)


def compile_count(program) -> int:
    """Shapes an eager slot program ran at, or the decode chunk's graph
    captures (its distinct keys when it runs eagerly)."""
    return program.count
