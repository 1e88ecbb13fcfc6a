"""Repeated profiler sessions: does ``device_launches`` ever come back short?

    python -m repro_torch.kernels.session_check [--sessions 1000] [--runs 3] [--only async|cifar]

A session counts, from ``torch.profiler``'s CUDA records, the kernels of one
iteration of ``mnist-noniid-ring`` (``tau2=2``) replayed from the sync
scheduler's CUDA graphs, whose exact count is known (one ``sgd_update``, and
one ``fused_transition`` at an intra or inter event).  A session that sees
another count than ran is off.  Variants, each ``--sessions`` one-step
sessions, in turns of 100:

* ``sync``: a synchronize after the step, and the session stops;
* ``settle``: a synchronize and 0.05 s idle before it stops;
* ``margin``: 0.05 s idle after the session starts and before the step, a
  synchronize and 0.05 s idle before it stops (``kernels.device_launches``).

Then one session held open across ``--sessions`` steps and read once, and
``--runs`` fresh runs each of ``mnist-noniid-ring`` and of ``sampled-k-ring``
on a host-offload store of 8 slots, eager and on graphs, every step
(warm-ups and captures included) in a session of its own through
``device_launches``, as ``tests/test_torch_cuda.py`` counts them.

The ``async`` variant: ``straggler-bimodal-async`` on its CUDA graph (one
graph for its one cluster size, warmed up and captured first), then
``--sessions`` one-event sessions, each counting the event's
``normalized_update``, ``cluster_agg`` and ``gossip_mix`` runs (one each);
``empty`` counts the sessions that recorded the host's launches and no CUDA
record, the sessions ``device_kernel_names`` refuses to count.
``--only async`` runs that variant alone.

The ``cifar`` variant (``--only cifar``): ``--sessions`` fresh runs of
``cifar-dirichlet-torus`` on the sync scheduler's CUDA graphs, each built and
stepped 30 iterations inside one ``device_kernel_names`` session, as the
smoke's cifar phase counts them (an iteration's graph holds about a
thousand kernels): off sessions, and the sessions that lost every record of
some graph replay (``device_kernel_names.losses``), apart and together.

For an off session it keeps the CUDA records it did see and the launch
calls the host made (``cudaGraphLaunch``, ``cudaLaunchKernel``), with their
times from the session's start.  Prints one line a variant, writes
``chiprun_out/session_check.json``, and exits non-zero if any session was
off.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

from . import HOST_LAUNCH_CALLS, MARGIN_S


def _session(fn, before: float = 0.0, after: float = 0.0):
    """``(fn(), {wrapper: n}, detail)`` of one profiler session."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from . import count_kernels

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        if before:
            time.sleep(before)
        out = fn()
        torch.cuda.synchronize()
        if after:
            time.sleep(after)
    res = prof.profiler.kineto_results
    events = list(res.events())
    t0 = res.trace_start_ns() if hasattr(res, "trace_start_ns") else 0
    cuda = [e for e in events if e.device_type() == DeviceType.CUDA]
    launches = [e for e in events if e.device_type() != DeviceType.CUDA
                and e.name() in HOST_LAUNCH_CALLS]
    detail = {"cuda": [(e.name()[:50], (e.start_ns() - t0) / 1e6, (e.end_ns() - t0) / 1e6)
                       for e in cuda],
              "host_launches": [(e.name(), (e.start_ns() - t0) / 1e6) for e in launches]}
    return out, count_kernels(e.name() for e in cuda), detail


def _want(kind: str) -> dict:
    return {"sgd_update": 1, **({"fused_transition": 1} if kind != "local" else {})}


def _async_sessions(sessions: int) -> dict:
    """``sessions`` one-event sessions of the graphed async event (margins at
    both ends, as ``device_launches``): off and empty sessions."""
    import torch

    from repro_torch.scenarios import build_scenario

    run = build_scenario("straggler-bimodal-async")
    src = run.batch_source()
    sched = run.runtime.scheduler
    for _ in range(8):  # the cluster size's warm-up, capture and replays
        run.runtime.step(src)
    torch.cuda.synchronize()
    if sched._graph is None or sched._graph.captured != 1:
        raise AssertionError(f"async: not on one captured graph ({sched._graph})")
    want = {"normalized_update": 1, "cluster_agg": 1, "gossip_mix": 1}
    off, empty, t0 = [], 0, time.perf_counter()
    for i in range(sessions):
        ev, got, detail = _session(lambda: run.runtime.step(src), MARGIN_S, MARGIN_S)
        if got != (want if ev.kind == "cluster" else {}):
            empty += not detail["cuda"] and bool(detail["host_launches"])
            off.append({"session": i, "kind": ev.kind, "got": got, **detail})
    return {"sessions": sessions, "off_sessions": len(off), "empty_sessions": empty,
            "replays": sched._graph.replays, "off": off[:10],
            "seconds": time.perf_counter() - t0}


def _cifar_sessions(sessions: int, iters: int = 30) -> dict:
    """``sessions`` fresh graphed runs of ``cifar-dirichlet-torus``, each in
    one session: off sessions, lossy sessions, and both."""
    from repro_torch.scenarios import build_scenario

    from . import count_kernels, device_kernel_names

    def drive():
        run = build_scenario("cifar-dirichlet-torus", graph=True)
        src = run.batch_source()
        for _ in range(iters):
            run.runtime.step(src)
        return run

    rows, t0 = [], time.perf_counter()
    for i in range(sessions):
        seen = len(device_kernel_names.losses)
        run, names = device_kernel_names(drive)
        cfg = run.runtime.scheduler.cfg
        want = {"sgd_update": iters,
                "fused_transition": sum(cfg.event_at(k) != "local" for k in range(1, iters + 1))}
        got = count_kernels(names)
        lost = device_kernel_names.losses[seen:]
        rows.append({"session": i, "got": got, "want": want, "records": len(names),
                     "lost_launches": sum(map(len, lost)), "lost": [x[:5] for x in lost]})
        del run
    off = [r for r in rows if r["got"] != r["want"]]
    lossy = [r for r in rows if r["lost_launches"]]
    return {"sessions": sessions, "off_sessions": len(off), "lossy_sessions": len(lossy),
            "off_and_lossy": sum(1 for r in off if r["lost_launches"]),
            "records": [r["records"] for r in rows], "off": off[:10], "lossy": lossy[:10],
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sessions", type=int, default=1000)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--only", choices=["async", "cifar"], default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("session_check: needs a CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import device_launches
    from repro_torch.scenarios import build_scenario

    out = {"device": torch.cuda.get_device_name(0), "sessions": args.sessions}
    if args.only == "cifar":
        out["cifar"] = c = _cifar_sessions(args.sessions)
        print(f"session_check cifar: {args.sessions} fresh graphed 30-iteration runs, one "
              f"session each: {c['off_sessions']} off, {c['lossy_sessions']} lost records of "
              f"some graph replay, {c['off_and_lossy']} both; device records a session "
              f"{min(c['records'])}-{max(c['records'])}; first off: "
              f"{json.dumps(c['off'][:2])[:1500]}; first lossy: "
              f"{json.dumps(c['lossy'][:2])[:1500]}; {c['seconds']:.2f}s", flush=True)
        _write(out)
        return 1 if c["off_sessions"] else 0
    out["async"] = _async_sessions(args.sessions)
    off_any = bool(out["async"]["off_sessions"])
    print(f"session_check async: {args.sessions} one-event sessions of the graphed event, "
          f"{out['async']['off_sessions']} off, {out['async']['empty_sessions']} empty; first "
          f"off: {json.dumps(out['async']['off'][:2])[:1500]}; "
          f"{out['async']['seconds']:.2f}s", flush=True)
    if args.only == "async":
        _write(out)
        return 1 if off_any else 0
    run = build_scenario("mnist-noniid-ring", tau2=2)
    src = run.batch_source()
    for _ in range(30):  # every event kind warmed up, captured and replayed
        run.runtime.step(src)
    torch.cuda.synchronize()
    step = lambda: run.runtime.step(src)
    variants = {"sync": (0.0, 0.0), "settle": (0.0, MARGIN_S), "margin": (MARGIN_S, MARGIN_S)}
    seen = {name: {"off": [], "seconds": 0.0} for name in variants}
    for _ in range(max(1, args.sessions // 100)):
        for name, (before, after) in variants.items():
            t0 = time.perf_counter()
            for _ in range(min(100, args.sessions)):
                ev, got, detail = _session(step, before, after)
                if got != _want(ev.kind):
                    seen[name]["off"].append({"kind": ev.kind, "got": got, **detail})
            seen[name]["seconds"] += time.perf_counter() - t0
    for name, v in seen.items():
        off_any |= bool(v["off"])
        out[name] = {"off_sessions": len(v["off"]), "off": v["off"][:10],
                     "seconds": v["seconds"]}
        print(f"session_check {name}: {args.sessions} one-step sessions, {len(v['off'])} off; "
              f"first off: {json.dumps(v['off'][:2])[:1500]}; {v['seconds']:.2f}s", flush=True)
    kinds = []
    _, held, _ = _session(lambda: kinds.extend(step().kind for _ in range(args.sessions)))
    total = {"sgd_update": len(kinds), "fused_transition": sum(k != "local" for k in kinds)}
    off_any |= held != total
    out["open"] = {"counted": held, "expected": total}
    print(f"session_check open: one session over {args.sessions} steps counted "
          f"{json.dumps(held)}, expected {json.dumps(total)}", flush=True)
    lanes = {"mnist-noniid-ring": {"tau2": 2},
             "sampled-k-ring+offload": {"tau2": 2,
                                        "store": {"kind": "host-offload", "k_max": 8}}}
    off, sessions, t0 = [], 0, time.perf_counter()
    for lane, kw in lanes.items():
        for graph in (False, True):
            for r in range(args.runs):
                fresh = build_scenario(lane.split("+")[0], graph=graph, **kw)
                fsrc = fresh.batch_source()
                for k in range(1, 31):
                    ev, got = device_launches(lambda: fresh.runtime.step(fsrc))
                    sessions += 1
                    if got != _want(ev.kind):
                        off.append((lane, graph, r, k, got))
                del fresh, fsrc
    off_any |= bool(off)
    out["per-step"] = {"sessions": sessions, "off": off[:20], "seconds": time.perf_counter() - t0}
    print(f"session_check per-step (device_launches): {sessions} one-step sessions over fresh "
          f"runs, eager and graph, warm-ups and captures included, {len(off)} off: {off[:5]}",
          flush=True)
    _write(out)
    return 1 if off_any else 0


def _write(out: dict) -> None:
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "session_check.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


if __name__ == "__main__":
    sys.exit(main())
