"""Counts of one rank's traced step: the counterpart of the reference's ``roofline/hlo.py``.

The reference compiles its step and parses the partitioned HLO text.  Torch
has no HLO and the port's program is eager, so ``hlo.py``'s parser has no
counterpart here; ``StepCounter``, a ``TorchDispatchMode``, watches the
step run once on tensors without data (``meta`` local shards of
``DTensor``s over a fake process group, ``launch.dryrun``) and counts what
one rank's ops would do:

* **product flops** by peak class (``analysis.PEAK_FLOPS``: ``bf16``,
  ``f32``, ``split_tf32``), from ``torch.utils.flop_counter``'s formulas,
  for ops on local tensors only.  A ``DTensor``-level op is not counted:
  the counter hands it to ``DTensor`` (``NotImplemented``, as
  ``CommDebugMode`` does) and counts the local ops and exchanges it runs
  (``FlopCounterMode`` counts both, the global product and the rank's).  The kernel wrappers' traced calls report their own
  work (``kernels._trace``): the flash kernels ``4 hd`` flops a live
  (query, key) pair forward, 2.5x that backward, at their route's class;
  the tree kernels their operand bytes;
* **HBM bytes**: the operand and result bytes of every op that is not a
  view (eager PyTorch fuses nothing, so every op reads its operands from
  and writes its result to device memory; a broadcast operand counts its
  storage once), a gather its result twice and a scatter its values twice
  (the reference's slice and update rules, so an in-place cache write
  counts the written row, not the cache).  This model is honest for the
  port's eager program as the reference's fusion-boundary model is for
  XLA's;
* **collective wire bytes** by kind, with the ring costs of
  ``analysis.wire_bytes`` and ``g`` the op's group size, for the functional
  collectives (``_c10d_functional.*``, what ``DTensor`` redistributes
  with) and the in-place ones (``c10d.*``, the hand-written exchanges);
  a ``send`` counts as a collective-permute (a ``batch_isend_irecv`` pair
  is one), its ``recv`` as nothing; each exchange keeps the slowest link
  its group crosses (``analysis.link_of``);
* **peak live bytes** of the storages the step creates (weak-reference
  finalizers on each new storage), beside which a caller puts the
  arguments' bytes.

Only ops on ``meta`` tensors count, and none while ``DTensor``'s sharding
propagation infers an op's global output shape by running it on fake
tensors (the counter pauses around ``ShardingPropagator``'s
``_propagate_tensor_meta_non_cached``); ``DTensor``'s placement
bookkeeping runs small ops on real host tensors.  Neither is the rank's
program.  Exchanges count on any tensor (a ``send`` needs a real one on a
fake group).
"""
from __future__ import annotations

import weakref
from collections import Counter
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from .analysis import link_of

__all__ = ["StepCounter", "local_bytes"]

_FUNCTIONAL = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "broadcast",
}
_INPLACE = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "broadcast", "send": "collective-permute",
}
# ops that move no bytes: bookkeeping, fresh uninitialised memory, waits
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "detach",
         "alias", "lift_fresh", "wait_tensor", "_wrap_tensor_autograd",
         "recv_", "barrier", "set_", "resize_", "_local_scalar_dense"}
_GATHERS = {"index", "index_select", "gather", "embedding", "take", "_unsafe_index"}
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter", "scatter_",
             "scatter_add", "scatter_add_", "index_add", "index_add_", "index_copy_",
             "_unsafe_index_put"}
_CLASSES = {torch.bfloat16: "bf16", torch.float16: "bf16", torch.float32: "f32",
            torch.float64: "f32"}


def _tensors(tree) -> list:
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def local_bytes(t: torch.Tensor) -> int:
    """Bytes a rank holds of ``t``: a ``DTensor``'s local shard, a view's
    elements (a broadcast one's storage once)."""
    if hasattr(t, "to_local"):
        t = t.to_local()
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(t, DTensor)


def _group_ranks(group) -> list:
    """The global ranks of a process group given as a name or an object."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d

    if isinstance(group, str):
        group = c10d._resolve_process_group(group)
    elif not isinstance(group, dist.ProcessGroup):
        group = dist.ProcessGroup.unbox(group)
    return dist.get_process_group_ranks(group)


def _pause_during_shape_inference(counter) -> callable:
    """Stop ``counter`` counting while ``DTensor``'s sharding propagation
    runs an op on global-shape fake tensors to learn its output's shape
    (not the rank's program); returns the undo."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    name = "_propagate_tensor_meta_non_cached"
    original = getattr(ShardingPropagator, name)

    def paused(self, *args, **kwargs):
        counter._paused += 1
        try:
            return original(self, *args, **kwargs)
        finally:
            counter._paused -= 1

    setattr(ShardingPropagator, name, paused)
    return lambda: setattr(ShardingPropagator, name, original)


class StepCounter(TorchDispatchMode):
    """Counts one rank's work while it is active (see the module
    docstring): ``flops`` by class (and ``products``, the counted products
    by class, result elements and contraction length), ``hbm_bytes``, ``collectives`` as
    ``(kind, size_bytes, g, link)``, ``kernels`` (traced kernel calls by
    name), ``peak_bytes`` and ``live_bytes`` of the storages created inside,
    and with ``keep_ops`` the list of local ops (``ops``)."""

    def __init__(self, keep_ops: bool = False):
        super().__init__()
        self.flops: Counter = Counter()
        self.products: Counter = Counter()
        self.hbm_bytes = 0.0
        self.collectives: list = []
        self.kernels: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self.ops: Optional[list] = [] if keep_ops else None
        self._seen: set = set()
        self._paused = 0

    # -- the kernel wrappers' traced calls -------------------------------------
    def kernel(self, name: str, flops: float, flop_class: str, nbytes: float) -> None:
        self.kernels[name] += 1
        if flops:
            self.flops[flop_class] += flops
        self.hbm_bytes += nbytes
        if self.ops is not None:
            self.ops.append(f"kernel {name} flops={flops:.6g} ({flop_class}) bytes={nbytes}")

    def __enter__(self):
        from ..kernels import _trace

        _trace.LISTENERS.append(self)
        self._unpatch = _pause_during_shape_inference(self)
        return super().__enter__()

    def __exit__(self, *exc):
        from ..kernels import _trace

        _trace.LISTENERS.remove(self)
        self._unpatch()
        return super().__exit__(*exc)

    # -- the ops ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor

        if any(issubclass(t, DTensor) for t in types):
            # the DTensor-level op: let DTensor run it, with this mode still
            # active, and count the local ops it runs
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._paused:
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        name = func._opname if hasattr(func, "_opname") else str(func)
        ns = func.namespace if hasattr(func, "namespace") else ""
        if ns == "_c10d_functional" and name in _FUNCTIONAL:
            self._collective(_FUNCTIONAL[name], func, args, out)
        elif ns == "c10d" and name in _INPLACE:
            self._collective(_INPLACE[name], func, args, out)
        if self.ops is not None:
            self.ops.append(f"{func} " + " ".join(
                f"{tuple(t.shape)}:{str(t.dtype)[6:]}" for t in _tensors(args)))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if name in _FREE or func.is_view or not any(t.is_meta for t in ins + outs):
            return
        self._track(outs, ins)
        if ns == "aten":
            self._flops(func, args, kwargs, out)
        if name in _GATHERS:
            self.hbm_bytes += 2 * sum(local_bytes(t) for t in outs)
        elif name in _SCATTERS:
            values = _tensors(args[2] if "index_put" in name else args[-1])
            self.hbm_bytes += 2 * sum(local_bytes(t) for t in values)
        else:
            self.hbm_bytes += sum(local_bytes(t) for t in ins + outs)

    def _flops(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry

        fn = flop_registry.get(func._overloadpacket)
        if fn is None:
            return
        tensors = _tensors(args)
        cls = _CLASSES.get(tensors[0].dtype if tensors else None)
        if cls is None:
            return
        flops = fn(*args, **kwargs, out_val=out)
        self.flops[cls] += flops
        n = out.numel() if isinstance(out, torch.Tensor) else 0
        if n:
            # (class, result elements, contraction length): the reference's
            # dots are keyed alike (tests/test_torch_dryrun.py)
            self.products[(cls, n, round(flops / (2 * n)))] += 1

    def _collective(self, kind: str, func, args, out) -> None:
        import torch.distributed as dist

        # the group: a functional collective's name (its last string), an
        # in-place one's process group (its first object)
        if func.namespace == "_c10d_functional":
            group = [a for a in args if isinstance(a, str)][-1]
        else:
            group = next(a for a in args if not isinstance(a, (torch.Tensor, list, tuple,
                                                               int, float, bool, str)))
        ranks = _group_ranks(group)
        if kind == "collective-permute":
            peer = ranks[int(args[2])]
            size = sum(local_bytes(t) for t in _tensors(args[0]))
            self.collectives.append((kind, size, 2, link_of((dist.get_rank(), peer))))
            return
        if kind in ("all-gather", "reduce-scatter"):
            size = sum(local_bytes(t) for t in _tensors(out if func.namespace ==
                                                        "_c10d_functional" else args[0]))
        else:
            size = sum(local_bytes(t) for t in _tensors(args[0]))
        self.collectives.append((kind, size, len(ranks), link_of(ranks)))

    # -- live storages ------------------------------------------------------------
    def _release(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live_bytes -= n

    @staticmethod
    def _storage(t):
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None

    def _track(self, outs: list, ins: list) -> None:
        """Count the new storages among ``outs`` (not one of ``ins``': an
        in-place op's result is its operand)."""
        held = {st._cdata for st in map(self._storage, ins) if st is not None}
        for t in outs:
            st = self._storage(t)
            if st is None:
                continue
            key, n = st._cdata, st.nbytes()
            if key in self._seen or key in held or n == 0:
                continue
            self._seen.add(key)
            self.live_bytes += n
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            weakref.finalize(st, self._release, key, n)
