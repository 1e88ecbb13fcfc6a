"""Hand-written CUDA kernels for Hopper (sm_90a), one per TPU kernel ported.

Each kernel ships as ``<name>/{csrc/*.cu, ops.py, ref.py}``: the CUDA source
(built with ``nvcc`` at first use and bound with ctypes, see ``_build.py``),
the wrapper that dispatches by device and counts launches, and the plain
PyTorch version that CPU tensors take and the card is checked against.

A wrapper counts on the host where it launches: ``<wrapper>.launches``,
and for the flash wrappers also ``<wrapper>.routes``.  Under CUDA-graph
capture (``core/cuda_graph.py``) a wrapper counts its launch into the graph
though nothing runs yet, and a replay runs the kernel without a host launch,
so these counters count host launches.  What ran on the device is counted
from the profiler's kernel records: ``device_launches(fn)`` runs ``fn``
under ``torch.profiler`` and ``count_kernels`` maps the device kernels'
names to the wrappers (keys ``<wrapper>`` and ``<wrapper>.<route>``);
``device_kernel_names(fn)`` gives every kernel's name, and raises
``EmptySessionError`` when a session lost its device records.  On an eager
run each host launch is one device run, so ``check_eager_session(ran,
host)`` raises ``ShortSessionError``, naming the kernels whose records are
missing, when a session counted fewer runs than the wrappers launched.
A session that kept some device records but lost every record of a graph
replay it launched (a ``cudaGraphLaunch`` whose CUPTI correlation id, which
the replay's kernels share, no CUDA record carries) appends those launches
to ``device_kernel_names.losses``, so a caller can tell a short count from
a lost record.
"""
import re

from .cluster_agg import cluster_agg, cluster_agg_ref, cluster_agg_tree
from .flash_attention import (
    flash_attention, flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
    flash_attention_fwd_ref,
)
from .fused_sgd import (
    normalized_update, normalized_update_ref, normalized_update_tree, sgd_update, sgd_update_ref,
    sgd_update_tree,
)
from .fused_transition import fused_transition, fused_transition_ref, fused_transition_tree
from .gossip_mix import gossip_mix, gossip_mix_ref, gossip_mix_tree

# the device kernel that runs once per launch of each wrapper, by the key its
# count goes under (a flash backward runs three kernels, its dQ kernel once)
DEVICE_KERNELS = {
    "fused_transition_kernel": "fused_transition",
    "sgd_update_kernel": "sgd_update",
    "normalized_update_kernel": "normalized_update",
    "cluster_agg_kernel": "cluster_agg",
    "gossip_mix_kernel": "gossip_mix",
    "flash_fwd_split_tf32_kernel": "flash_attention_fwd.split_tf32",
    "flash_fwd_sm90_kernel": "flash_attention_fwd.tensor_core",
    "flash_bwd_dq_kernel": "flash_attention_bwd.cuda_core",
    "flash_bwd_dq_sm90_kernel": "flash_attention_bwd.tensor_core",
}
_KERNEL_NAME = re.compile(r"\b(" + "|".join(DEVICE_KERNELS) + r")\b")


def count_kernels(names) -> dict:
    """Launches by wrapper, from the names of the device kernels that ran
    (one name per kernel run, demangled as the profiler gives them):
    ``{wrapper: n}``, and ``{"<wrapper>.<route>": n}`` for the flash
    wrappers; kernels of no wrapper are left out."""
    out: dict = {}
    for name in names:
        found = _KERNEL_NAME.search(name)
        if found:
            key = DEVICE_KERNELS[found.group(1)]
            for k in {key, key.partition(".")[0]}:
                out[k] = out.get(k, 0) + 1
    return out


class EmptySessionError(RuntimeError):
    """A profiler session that recorded the host's kernel launches but came
    back with no CUDA record at all: what ran on the device is unknown, and
    no count is made of it.  ``host_launches`` holds the launch calls the
    session did record, ``(name, ms from the session's start)``."""

    def __init__(self, host_launches: list):
        self.host_launches = host_launches
        super().__init__(
            f"the profiler session recorded {len(host_launches)} host launch calls "
            f"({host_launches[:8]}) and no CUDA record: the device's records were lost, "
            f"so the kernels that ran are not counted (ROADMAP.md §3)")


class ShortSessionError(RuntimeError):
    """A profiler session around an eager run that recorded fewer device runs
    of a wrapper's kernel than the wrapper launched from the host: the
    session lost some of its records, and no count is made of it.
    ``missing`` maps each such wrapper key to ``(device runs, host launches)``."""

    def __init__(self, missing: dict):
        self.missing = missing
        super().__init__(
            f"the profiler session recorded fewer device runs than the host launched "
            f"(key: (device runs, host launches)) for {missing}: the device's records of "
            f"these kernels were lost, so the run is not counted (ROADMAP.md §3)")


def check_eager_session(ran: dict, host: dict) -> None:
    """Raise ``ShortSessionError`` unless ``ran`` (device runs by wrapper key,
    ``count_kernels``) holds at least ``host`` (host launches by the same keys)
    for every key: on an eager run every host launch runs once on the device."""
    missing = {k: (ran.get(k, 0), n) for k, n in host.items() if ran.get(k, 0) < n}
    if missing:
        raise ShortSessionError(missing)


# the host calls that put kernels on the device, graph replays included
HOST_LAUNCH_CALLS = ("cudaGraphLaunch", "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernelEx")


def device_kernel_names(fn):
    """``(fn(), [name, ...])``: the device records of ``device_records``."""
    out, names, _ = device_records(fn)
    return out, names


def device_records(fn):
    """``(fn(), [name, ...], host)``: the device kernels ``fn`` ran, graph replays
    included, one demangled name per run, from ``torch.profiler``'s CUDA
    records (read raw, without building the event tree).

    The session idles ``MARGIN_S`` after it starts and again after ``fn``
    and a synchronize, before it stops.  On the H100 a session sometimes
    comes back with none of its kernel records though the host's launch is
    recorded; such a session raises ``EmptySessionError`` rather than
    return a short count.  A session that lost every record of some graph
    replays returns what it saw and appends ``[("cudaGraphLaunch", ms from
    the session's start), ...]`` of those replays to
    ``device_kernel_names.losses`` (an empty session appends its launches
    too).  A kernel launch without a record is not taken for a loss: a
    launch made while a stream captures a graph runs nothing, and on the
    H100 one to three others a session, at the same offsets run to run,
    have none where no count falls short.  ``kernels.session_check``
    counts how often, and ``ROADMAP.md`` §3 keeps the record.  ``host``
    counts the session's host calls that launch work or copy by name
    (``HOST_LAUNCH_CALLS``, ``cudaMemcpy*``, ``cudaMemset*``)."""
    import collections
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(MARGIN_S)
        out = fn()
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    res = prof.profiler.kineto_results
    events = list(res.events())
    cuda = [e for e in events if e.device_type() == DeviceType.CUDA]
    launches = [e for e in events
                if e.device_type() != DeviceType.CUDA and e.name() in HOST_LAUNCH_CALLS]
    t0 = res.trace_start_ns() if hasattr(res, "trace_start_ns") else 0
    at = lambda e: (e.name(), round((e.start_ns() - t0) / 1e6, 3))
    host = collections.Counter(
        e.name() for e in events if e.device_type() != DeviceType.CUDA
        and (e.name() in HOST_LAUNCH_CALLS or e.name().startswith(("cudaMemcpy", "cudaMemset"))))
    if not cuda:
        if launches:
            device_kernel_names.losses.append([at(e) for e in launches])
            raise EmptySessionError([at(e) for e in launches])
        return out, [], host
    ran = {e.correlation_id() for e in cuda}
    lost = [at(e) for e in launches
            if e.name() == "cudaGraphLaunch" and e.correlation_id() not in ran]
    if lost:
        device_kernel_names.losses.append(lost)
    return out, [e.name() for e in cuda], host


device_kernel_names.losses = []


def device_launches(fn):
    """``(fn(), count_kernels(...))`` of the kernels ``fn`` ran on the
    device, graph replays included (``device_kernel_names``)."""
    out, names = device_kernel_names(fn)
    return out, count_kernels(names)


MARGIN_S = 0.05  # device_launches's idle time at each end of a session


__all__ = [
    "DEVICE_KERNELS", "EmptySessionError", "HOST_LAUNCH_CALLS", "ShortSessionError",
    "check_eager_session", "count_kernels", "device_kernel_names", "device_launches",
    "device_records",
    "sgd_update", "sgd_update_ref", "sgd_update_tree",
    "normalized_update", "normalized_update_ref", "normalized_update_tree",
    "fused_transition", "fused_transition_ref", "fused_transition_tree",
    "gossip_mix", "gossip_mix_ref", "gossip_mix_tree",
    "cluster_agg", "cluster_agg_ref", "cluster_agg_tree",
    "flash_attention", "flash_attention_fwd", "flash_attention_bwd",
    "flash_attention_fwd_ref", "flash_attention_bwd_ref",
]
