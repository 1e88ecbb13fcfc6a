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
  capture forbids), and a fresh ``GraphedStep`` captures after it.

Each case reports whether the capture ended and replayed, the error that
surfaced, and whether a fresh ``GraphedStep`` captures and replays right
after it in the same process.  Prints one line a case, writes
``chiprun_out/capture_check.json``; exits non-zero if a fresh capture
failed after any case.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys

import numpy as np


def _raw_capture(during) -> dict:
    """A small graph captured around ``during()``; replayed once."""
    import torch

    x = torch.ones(1 << 16, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        x.add_(1.0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
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
    else:
        raise KeyError(name)
    out.update(_fresh_step())
    return out


CASES = ("free-device-tensor", "free-event", "free-timing-event", "free-pinned", "free-graph",
         "free-graphed-step", "free-copy-stream", "gc-dead-run", "call-synchronize",
         "call-pageable-copy", "call-pin-memory", "raise-then-capture", "illegal-then-capture")


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
