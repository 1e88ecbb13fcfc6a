"""What invalidates a CUDA-graph capture, and whether a failed one leaves damage.

    python -m repro_torch.core.capture_check [--only NAME ...]

Each case runs in a process of its own (a case that breaks the process
breaks nothing else) and captures a small graph with ``torch.cuda.graph``
in its default, global capture mode:

* ``free-<object>``: an object made before the capture loses its last
  reference in the middle of it, as a dead run's objects do when Python's
  cyclic collector frees them mid-capture: a device tensor, a CUDA event
  (plain and timing), pinned host memory a copy read, a captured
  ``CUDAGraph`` and its pool, a ``GraphedStep`` with its graph, and a
  ``CopyStream`` that staged a batch;
* ``gc-dead-run``: a sync run on graphs (``mnist-noniid-ring``) fails
  mid-way, its traceback is kept as a failed smoke phase kept it, and
  ``gc.collect()`` runs in the middle of the next capture;
* ``call-<call>``: a call inside the body: a synchronize, a pageable host
  copy, an allocation of pinned memory;
* ``raise-then-capture`` and ``illegal-then-capture``: a ``GraphedStep``'s
  body raises on its capturing call (a Python error, then a call the
  capture forbids), and a fresh ``GraphedStep`` captures after it;
* ``nccl-outstanding``: one NCCL rank (a process group of world size 1 on a
  free local port); an eager all-reduce is left outstanding (no
  synchronize), and at once a graph captures an all-reduce and stays open
  for ``NCCL_HOLD_S`` on the host, past the process group's watchdog
  polls of the outstanding work's event.  Three trials each of a raw
  capture in the global mode, one in the ``thread_local`` mode, and a
  ``GraphedStep`` whose body all-reduces (its warm-up is the uncaptured
  work, its second call the capture), each replay held to the eager value.

Each case reports whether the capture ended and replayed, the error that
surfaced, and whether a fresh ``GraphedStep`` captures and replays right
after it in the same process.  Prints one line a case, writes
``chiprun_out/capture_check.json``; exits non-zero if a fresh capture
failed after any case.

``hold_mesh_exchanges`` is no case: it captures the exchanges of the mesh
steps' bodies on a mesh of one rank and holds each call to an eager run,
for ``chip_smoke.py``'s ``mesh`` phase and ``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import numpy as np


def _raw_capture(during, mode: str = "global") -> dict:
    """A small graph captured around ``during()`` in capture mode ``mode``;
    replayed once."""
    import torch

    x = torch.ones(1 << 16, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode=mode):
            x.add_(1.0)
            during()
            x.mul_(2.0)
    except Exception as err:  # reported: what surfaced, and what it masked
        return {"captured": False, "error": repr(err)[:300],
                "context": repr(err.__context__)[:300] if err.__context__ else None,
                "stream_restored":
                    torch.cuda.current_stream() != torch.cuda.graph.default_capture_stream}
    graph.replay()
    torch.cuda.synchronize()
    return {"captured": True, "value": float(x[0])}


def _fresh_step() -> dict:
    """A fresh ``GraphedStep``: warm-up, capture, two replays."""
    import torch

    from .cuda_graph import GraphedStep

    state = {"w": torch.zeros(256, device="cuda")}
    step = GraphedStep(lambda b: state["w"].add_(b["x"]), lambda: state, "cuda")
    try:
        for i in range(4):
            step({"x": torch.full((256,), float(i), device="cuda")})
        torch.cuda.synchronize()
    except Exception as err:
        return {"fresh_capture": False, "fresh_error": repr(err)[:300]}
    return {"fresh_capture": step.captured == 1 and step.replays == 3
            and float(state["w"][0]) == 6.0}


def _holder(kind: str) -> list:
    """``[object]`` of ``kind``, made and used before the capture."""
    import torch

    from .cuda_graph import GraphedStep
    from .pipeline import CopyStream

    dev = torch.device("cuda")
    if kind == "device-tensor":
        return [torch.empty(1 << 20, device=dev)]
    if kind in ("event", "timing-event"):
        ev = torch.cuda.Event(enable_timing=kind == "timing-event")
        ev.record()
        return [ev]
    if kind == "pinned":
        host = torch.empty(1 << 20).pin_memory()
        return [host, host.to(dev, non_blocking=True)]
    if kind == "graph":
        y = torch.zeros(1 << 10, device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            y.add_(1.0)
        graph.replay()
        return [graph]
    if kind == "graphed-step":
        state = {"w": torch.zeros(256, device=dev)}
        step = GraphedStep(lambda b: state["w"].add_(b["x"]), lambda: state, dev)
        for _ in range(3):
            step({"x": torch.ones(256, device=dev)})
        return [step]
    if kind == "copy-stream":
        copy = CopyStream(dev)
        staged = copy.stage({"x": np.ones((64, 64), np.float32)})
        copy.take(staged)
        return [copy, staged]
    raise KeyError(kind)


def _dead_run():
    """A sync run on graphs that fails mid-way; returns the kept traceback."""
    from ..scenarios import build_scenario

    run = build_scenario("mnist-noniid-ring", tau2=2, num_samples=400)
    sched, src = run.runtime.scheduler, run.batch_source()
    for _ in range(4):  # local events: warm-up, capture, two replays
        run.runtime.step(src)
    real = sched._update

    def failing(event, batch):
        real(event, batch)
        raise AssertionError("a check fails mid-step")

    sched._update = failing
    try:
        run.runtime.step(src)  # the intra event's warm-up runs the body, which fails
    except AssertionError:
        return sys.exc_info()  # what a failed phase keeps until it is collected
    raise AssertionError("the step did not fail")


NCCL_HOLD_S = 0.3  # how long a nccl-outstanding capture stays open (the watchdog polls each 0.1 s)


def _nccl_outstanding() -> dict:
    """The ``nccl-outstanding`` case's trials on one NCCL rank, and a fresh
    ``GraphedStep`` while the group lives; the group is destroyed after."""
    import datetime
    import socket
    import time

    import torch
    import torch.distributed as dist

    from .cuda_graph import GraphedStep

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0,
                            world_size=1, timeout=datetime.timedelta(seconds=60))
    try:
        x = torch.ones(1 << 20, device="cuda")
        dist.all_reduce(x)  # the communicator exists before any capture
        torch.cuda.synchronize()
        out: dict = {"torch": torch.__version__, "cuda": torch.version.cuda,
                     "nccl": str(torch.cuda.nccl.version())}

        def hold(y):
            dist.all_reduce(y)
            time.sleep(NCCL_HOLD_S)

        for mode in ("global", "global", "global", "thread_local"):
            y = torch.full((1 << 10,), 3.0, device="cuda")
            dist.all_reduce(x)  # left outstanding: no synchronize before the capture
            t0 = time.perf_counter()
            res = _raw_capture(lambda: hold(y), mode)
            res["seconds"] = time.perf_counter() - t0  # the hold, and any wait before capturing
            res["y"] = float(y[0]) if res["captured"] else None
            out.setdefault(mode, []).append(res)

        state = {"w": torch.zeros(1 << 10, device="cuda")}

        def body(batch):
            state["w"].add_(batch["x"])
            hold(state["w"])

        step = GraphedStep(body, lambda: state, "cuda")
        try:
            for i in range(4):  # warm-up, capture at once (its work outstanding), two replays
                step({"x": torch.full((1 << 10,), float(i), device="cuda")})
            torch.cuda.synchronize()
            out["graphed_step"] = {"captured": step.captured, "replays": step.replays,
                                   "value": float(state["w"][0])}
        except Exception as err:
            out["graphed_step"] = {"error": repr(err)[:300]}
        out.update(_fresh_step())
        return out
    finally:
        dist.destroy_process_group()


def hold_mesh_exchanges(tree: dict, mesh, calls: int) -> tuple:
    """The exchanges that the captured mesh steps call, in one
    ``GraphedStep`` on a mesh of one rank (the rank its own partner):
    ``gather_rows`` into a fixed buffer, ``fleet_weighted_sum``,
    ``cluster_sums_on_mesh``, ``dense_transition_on_mesh``, ``ppermute``
    and ``fleet_mean_losses``, over the ``(1, ...)`` ``tree``.  Called
    ``calls`` times (warm-up, capture, replays) with new inputs each call:
    the tree negated in place, a new weight and new losses through the
    static buffers.  Raises ``AssertionError`` unless every call is bitwise
    an eager run of the body on the same inputs and the gather, the
    permutation and the losses give back their inputs.  Returns ``(step,
    body, batch)``: the step, its body and the last call's batch."""
    import torch

    from .aggregation import (
        cluster_sums_on_mesh, dense_transition_on_mesh, fleet_mean_losses, fleet_weighted_sum,
        gather_rows, ppermute,
    )
    from .cuda_graph import GraphedStep, copy_into

    dev = mesh.device
    gathered = {k: torch.empty_like(v) for k, v in tree.items()}
    out = {"sum": {k: torch.empty(v.shape[1:], device=dev) for k, v in tree.items()},
           "clusters": {k: torch.empty(v.shape, device=dev) for k, v in tree.items()},
           "dense": {k: torch.empty_like(v) for k, v in tree.items()},
           "perm": {k: torch.empty_like(v) for k, v in tree.items()}}

    def body(batch):
        w = batch["w"]
        gather_rows(tree, mesh, out=gathered)
        copy_into(out, {"sum": fleet_weighted_sum(tree, mesh, w),
                        "clusters": cluster_sums_on_mesh(tree, mesh, 1, w),
                        "dense": dense_transition_on_mesh(tree, mesh, w.view(1, 1)),
                        "perm": ppermute(tree, mesh, [(0, 0)])})
        return fleet_mean_losses(batch["losses"], mesh)

    def results():
        return [v.clone() for v in (*gathered.values(),
                                    *(x for d in out.values() for x in d.values()))]

    step = GraphedStep(body, lambda: (tree, gathered, out), dev)
    for i in range(calls):
        for v in tree.values():
            v.neg_()
        batch = {"w": torch.full((1,), 0.5 + i, device=dev),
                 "losses": torch.arange(8, dtype=torch.float32, device=dev) * (i + 1)}
        got_losses, got = step(batch), results()
        want_losses = body(batch)
        if not (torch.equal(got_losses, want_losses) and all(
                torch.equal(a, b) for a, b in zip(got, results()))):
            raise AssertionError(f"the captured exchanges' call {i} differs from its eager run")
        if not (torch.equal(got_losses, batch["losses"]) and all(
                torch.equal(gathered[k], v) and torch.equal(out["perm"][k], v)
                for k, v in tree.items())):
            raise AssertionError(f"call {i}: a gather, permutation or mean changed its input")
    return step, body, batch


def _case(name: str) -> dict:
    import torch

    from .cuda_graph import GraphedStep

    torch.backends.cudnn.allow_tf32 = False
    out: dict = {"case": name}
    if name.startswith("free-"):
        held = _holder(name[len("free-"):])
        torch.cuda.synchronize()
        out.update(_raw_capture(held.clear))
    elif name == "gc-dead-run":
        kept = [_dead_run()]
        kept.append(kept)  # a cycle: only the collector frees it
        del kept
        torch.cuda.synchronize()
        out.update(_raw_capture(gc.collect))
    elif name.startswith("call-"):
        call = name[len("call-"):]
        static = torch.empty(1 << 10, device="cuda")
        host = torch.ones(1 << 10)
        out.update(_raw_capture({
            "synchronize": torch.cuda.synchronize,
            "pageable-copy": lambda: static.copy_(host),
            "pin-memory": lambda: torch.empty(1 << 20).pin_memory(),
        }[call]))
    elif name in ("raise-then-capture", "illegal-then-capture"):
        state = {"w": torch.zeros(256, device="cuda")}
        calls = []

        def body(batch):
            state["w"].add_(batch["x"])
            calls.append(1)
            if len(calls) == 2:  # the capturing call
                if name == "raise-then-capture":
                    raise ValueError("the body fails while it is captured")
                torch.cuda.synchronize()
            state["w"].mul_(1.0)

        step = GraphedStep(body, lambda: state, "cuda")
        try:
            for _ in range(3):
                step({"x": torch.ones(256, device="cuda")})
            out["raised"] = None
        except Exception as err:
            out["raised"] = repr(err)[:300]
            out["notes"] = [n[:300] for n in getattr(err, "__notes__", [])]
        out["stream_restored"] = torch.cuda.current_stream() == torch.cuda.default_stream()
        out["captured"] = step.captured
    elif name == "nccl-outstanding":
        return {**out, **_nccl_outstanding()}
    else:
        raise KeyError(name)
    out.update(_fresh_step())
    return out


CASES = ("free-device-tensor", "free-event", "free-timing-event", "free-pinned", "free-graph",
         "free-graphed-step", "free-copy-stream", "gc-dead-run", "call-synchronize",
         "call-pageable-copy", "call-pin-memory", "raise-then-capture", "illegal-then-capture",
         "nccl-outstanding")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None, choices=CASES)
    ap.add_argument("--case", default=None, help=argparse.SUPPRESS)  # one case, in this process
    args = ap.parse_args(argv)
    if args.case is not None:
        print(json.dumps(_case(args.case)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("capture_check: needs a CUDA device", file=sys.stderr)
        return 2
    results, failed = [], False
    for name in args.only or CASES:
        proc = subprocess.run([sys.executable, "-m", "repro_torch.core.capture_check",
                               "--case", name], capture_output=True, text=True, timeout=300)
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1])
        except (IndexError, json.JSONDecodeError):
            res = {"case": name, "exit": proc.returncode, "stderr": proc.stderr[-600:]}
        failed |= not res.get("fresh_capture", False)
        results.append(res)
        print(f"capture_check {json.dumps(res)}", flush=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "capture_check.json"), "w") as f:
        json.dump({"device": torch.cuda.get_device_name(0), "cases": results}, f, indent=1)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
