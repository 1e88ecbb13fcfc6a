"""Captured steps: the port's counterpart of the reference's donated ``jax.jit``.

The reference compiles one sync protocol iteration per event kind
(``jax.jit`` with ``donate_argnums``) and R whole rounds (``lax.scan``)
into single XLA programs.  The port's steps are Python loops of eager
launches; ``GraphedStep`` records one such step as a CUDA graph
(``torch.cuda.graph``) and replays it, so a step costs the host one graph
launch instead of hundreds of kernel launches.

A step is ``body(batch) -> output or None``: it reads its batch from the
dict it is given, leaves its results in the caller's state tensors (a
result the eager path returns as a new tensor is ``copy_``'d into its
state leaf, see ``copy_into``), and returns its output (the losses) or
None.  Per call of a ``GraphedStep``:

* **Key** (``graph_key``): the batch entries' shapes and dtypes, and every
  state leaf's shape, dtype and ``data_ptr``.  A graph bakes in the
  addresses it reads and writes, so a new key gets a graph of its own, as
  ``jax.jit`` retraces on new shapes; when the state tensors are replaced (a
  test loading weights after ``bind``), the graphs of the old addresses are
  dropped, so none ever writes tensors the caller let go.
* **Warm-up.** The first call of a key runs the body eagerly on a side
  stream.  It is a real step, not a thrown-away one, and it sets up the
  cuDNN and cuBLAS handles and workspaces and loads the kernel libraries
  before any capture.  No state is cloned.
* **Capture, then replay.** The second call captures the body over static
  input buffers into a graph, then replays it; every later call copies its
  batch into the static buffers and replays.  A failed capture raises: the
  step never carries on eagerly.  Cyclic garbage is collected before a
  capture and the collector is off during it: a dead run's captured graph
  freed mid-capture invalidates a global-mode capture
  (``core/capture_check.py`` shows which frees do).  When the body raises
  during its capture, the capture is ended and its graph discarded, the
  current stream restored, and the body's own error raised (an error of
  ending the capture rides along as a note); a capture that fails to end
  after its body returned raises ``CaptureError``, which says why.  Every
  graph of a ``GraphedStep``, and of the steps given the same ``pool``
  (``torch.cuda.graph_pool_handle()``), is captured into one private memory
  pool: they replay one at a time, and what outlives a replay is either the
  caller's state or cloned out at once.
* **Output.** Cloned out of the graph's static output, on the device,
  before a later replay can overwrite it.

A kernel wrapper counts its launch when it is captured and not when a
replay runs it (see ``kernels``): the replays' kernels are counted on the
device, ``kernels.device_launches``.

**On a mesh** (a client or cluster mesh over ``torch.distributed``) a body's
process-group exchanges are captured with it: ProcessGroupNCCL runs each
on its own stream, which the capture pulls in (its allocations then come
from the graph's pool), and ``wait()`` makes the current stream wait on
the exchange's event, no host synchronisation.  The NCCL communicators a
body uses are created lazily by its first exchange; the key's eager
warm-up is that first call, so no capture creates one.  Meshes capture in
the same default global mode: ``core/capture_check.py``'s
``nccl-outstanding`` case (an eager all-reduce left outstanding, then at
once a capture held open past the process group's watchdog polls of that
work's event) captured and replayed in every trial on torch 2.11 with
CUDA 12.8 and NCCL 2.28.9 on the H100, without a wait before the capture,
so neither draining the outstanding work nor the ``thread_local`` mode is
needed (see PERF.md for the card's line).  Every rank must warm up,
capture and replay at the same calls, so that the replays' collectives
match across ranks: a step's key changes only where every rank's does
when its state tensors are allocated alike on every rank.

On the CPU there are no graphs: a CPU ``GraphedStep`` copies its batch into
the same static buffers and runs the body eagerly, which is how the tests
reach the captured body without a card.
"""
from __future__ import annotations

import gc
from typing import Callable, Optional

import torch

__all__ = ["CaptureError", "GraphedStep", "copy_into", "graph_key", "resolve_graph"]


class CaptureError(RuntimeError):
    """A capture that could not be ended after its body returned: CUDA
    invalidated it.  Nothing of it is kept."""


def resolve_graph(graph: Optional[bool], device) -> bool:
    """Whether a scheduler captures its steps: ``None`` means on a CUDA
    device and off on the CPU, ``False`` is the eager reference path, and
    ``True`` off a CUDA device raises."""
    device = torch.device(device)
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, this run is on {device}")
    return bool(graph)


def _leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = tree.values()
    return [leaf for sub in tree for leaf in _leaves(sub)]


def copy_into(dst, src) -> None:
    """Write a step's results ``src`` into the state ``dst`` (dicts, tuples
    and lists of tensors, alike in structure); a leaf the step updated in
    place is left alone."""
    if isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, dict):
        for k, d in dst.items():
            copy_into(d, src[k])
    else:
        for d, s in zip(dst, src, strict=True):
            copy_into(d, s)


def graph_key(batch: dict, state) -> tuple:
    """``(batch entries' names, shapes and dtypes, state leaves' shapes,
    dtypes and addresses)``: what a captured graph bakes in."""
    return (tuple((k, tuple(v.shape), v.dtype) for k, v in batch.items()),
            tuple((tuple(t.shape), t.dtype, t.data_ptr()) for t in _leaves(state)))


class _Entry:
    """One key's static input buffers and, once captured, its graph."""

    def __init__(self, batch: dict, device: torch.device):
        self.static = {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                       for k, v in batch.items()}
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None

    def fill(self, batch: dict) -> dict:
        for k, v in batch.items():
            self.static[k].copy_(v)
        return self.static


class GraphedStep:
    """``body`` captured as a CUDA graph per key and replayed (see the module
    docstring).  ``state()`` returns the tensors ``body`` updates in place
    (any nesting of dicts, tuples and lists); ``device`` is the run's;
    ``pool`` a memory pool handle shared with other steps (default: one of
    its own)."""

    def __init__(self, body: Callable[[dict], Optional[torch.Tensor]], state: Callable,
                 device, pool=None):
        self._body = body
        self._state = state
        self.device = torch.device(device)
        self._pool = pool
        self._entries: dict[tuple, _Entry] = {}
        self._side: Optional[torch.cuda.Stream] = None
        self.replays = 0  # graph replays so far, over every key

    @property
    def captured(self) -> int:
        """Graphs held (one per key seen twice at the current state addresses)."""
        return sum(e.graph is not None for e in self._entries.values())

    def __call__(self, batch: dict) -> Optional[torch.Tensor]:
        key = graph_key(batch, self._state())
        entry = self._entries.get(key)
        first = entry is None
        if first:
            # graphs baked on other state addresses would write the old tensors
            self._entries = {k: e for k, e in self._entries.items() if k[1] == key[1]}
            entry = self._entries[key] = _Entry(batch, self.device)
        static = entry.fill(batch)
        if self.device.type != "cuda":
            return self._body(static)
        if first:
            return self._warm_up(static)
        if entry.graph is None:
            self._capture(entry)
        entry.graph.replay()
        self.replays += 1
        return None if entry.out is None else entry.out.clone()

    def _warm_up(self, static: dict) -> Optional[torch.Tensor]:
        """The key's first step, eagerly on a side stream."""
        compute = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(compute)
        with torch.cuda.stream(self._side):
            out = self._body(static)
        compute.wait_stream(self._side)
        return out

    def _capture(self, entry: _Entry) -> None:
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        capture = torch.cuda.graph(graph, pool=self._pool)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            capture.__enter__()
            try:
                out = self._body(entry.static)
            except BaseException as err:
                end_err = _end_capture(capture)
                if end_err is not None:
                    err.add_note(f"ending the failed capture raised too: {end_err}")
                graph.reset()  # its graph and pool go now, not when the traceback dies
                raise
            end_err = _end_capture(capture)
            if end_err is not None:
                graph.reset()
                raise CaptureError(
                    f"a step's capture could not end after its body returned ({end_err}): "
                    f"CUDA invalidates a global-mode capture when a call it forbids runs "
                    f"meanwhile on any thread (core/capture_check.py lists the calls the "
                    f"port has met); the graph is discarded") from end_err
        finally:
            if collecting:
                gc.enable()
        entry.out, entry.graph = out, graph


def _end_capture(capture: "torch.cuda.graph") -> Optional[RuntimeError]:
    """End ``capture`` and restore the stream it made current, whatever
    happened inside it; returns the error of ending it, or None.  A graph
    that could not end holds nothing to replay, and one that ended after a
    failed body is discarded by its caller."""
    try:
        capture.cuda_graph.capture_end()
    except RuntimeError as err:
        return err
    finally:
        capture.stream_ctx.__exit__(None, None, None)
    return None
