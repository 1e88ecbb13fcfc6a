"""End-to-end SD-FEEL training CLI: the port's ``repro.launch.train``.

Runs federated training of a causal LM (reduced or full arch config) with
the SD-FEEL protocol: per-client local SGD, intra- and inter-cluster
aggregations, synthetic LM data per client.  Training is driven through
``repro_torch.core.make_run`` with the whole-round scheduler (one step = one
``tau1*tau2`` Algorithm-1 round, ``--rounds-per-step`` of them a dispatch),
which replays each superstep from a CUDA graph on the card.  ``--scenario``
drives a named scenario of ``repro_torch.scenarios`` instead (``list``
enumerates them).  Checkpoints are the reference's format
(``repro_torch.checkpoint``), so a run resumes from a checkpoint that
``repro.launch.train`` wrote, and the reverse.  Runs on the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b --reduced \\
        --steps 100 --clients 8 --clusters 4 --tau1 2 --alpha 2 [--device cpu]
    PYTHONPATH=src python -m repro_torch.launch.train --scenario federated-lm-ring \\
        --backend collective --mesh auto --steps 4

``--backend`` picks the aggregation backend (``auto``: the CUDA kernels on
the card, dense on the CPU; ``collective``: the reference's hypercube
all-reduce and ring gossip).  ``--mesh auto`` in one process resolves to no
mesh when the host has fewer CUDA devices than clients, as in the reference,
and says so.  Under ``torchrun`` (its ``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` in the environment) it
starts the process group, ``nccl`` on CUDA devices and ``gloo`` with
``--device cpu``, and trains on the client mesh, one client a rank, on the
collective backend, each rank replaying its steps from CUDA graphs with
the exchanges captured inside (eager with ``--device cpu``); rank 0 prints
and writes the checkpoints, and the group is destroyed at exit::

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --mesh auto \
        --backend collective --clients 8 --clusters 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np

__all__ = ["main", "run_scenario"]

_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
# how long a rank waits for its peers before the process group fails
_DIST_TIMEOUT = datetime.timedelta(minutes=10)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _say(*args) -> None:
    """``print`` on rank 0 only (every rank without a process group)."""
    if _rank() == 0:
        print(*args, flush=True)


def _start_process_group(args) -> bool:
    """Under torchrun's environment with ``--mesh auto``: start the default
    process group (``nccl`` on CUDA devices, ``gloo`` on the CPU, with a
    timeout so a missing peer fails instead of hanging) and return True."""
    import torch
    import torch.distributed as dist

    if args.mesh != "auto" or not all(k in os.environ for k in _TORCHRUN_ENV):
        return False
    if dist.is_initialized():
        return False
    cuda = torch.device(args.device).type == "cuda"
    if cuda:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    dist.init_process_group("nccl" if cuda else "gloo", init_method="env://",
                            timeout=_DIST_TIMEOUT)
    return True


def run_scenario(args) -> dict | None:
    """Drive a named scenario from ``repro_torch.scenarios`` (paper-task
    models); returns the consensus parameters (None for ``list``)."""
    from ..launch.mesh import describe_resolution
    from ..scenarios import get_scenario, list_scenarios

    if args.scenario == "list":
        for sc in list_scenarios():
            _say(f"{sc.name:28s} [{sc.scheduler:5s}] {sc.description}")
        return None
    sc = get_scenario(args.scenario)
    overrides = {"seed": args.seed, "backend": args.backend}
    if args.mesh != "none":
        overrides["mesh"] = args.mesh
    part = _participation_spec(args)
    if part is not None:
        overrides["participation"] = part
    store = _store_spec(args)
    if store is not None:
        overrides["store"] = store
    faults = _fault_spec(args)
    if faults is not None:
        overrides["faults"] = faults
    # every explicitly-set flag overrides the registered config (None = unset)
    for flag, key in (("clients", "num_clients"), ("clusters", "num_clusters"),
                      ("samples", "num_samples"), ("tau1", "tau1"),
                      ("tau2", "tau2"), ("alpha", "alpha"),
                      ("lr", "learning_rate"), ("batch", "batch_size"),
                      ("rounds_per_step", "rounds_per_step")):
        value = getattr(args, flag)
        if value is not None:
            overrides[key] = value
    run = sc.build(device=args.device, **overrides)
    sched = run.runtime.scheduler
    if args.mesh != "none":
        _say(describe_resolution(args.mesh, sched.backend.clusters.num_clients,
                                 device=sched.device))
    prof = getattr(sched, "profile", None) or getattr(getattr(sched, "cfg", None),
                                                      "profile", None)
    hline = f" H={prof.heterogeneity():.1f}" if prof is not None else ""
    _say(f"scenario={sc.name} scheduler={sc.scheduler} topology={sc.topology} "
         f"partition={sc.partition}{hline}")
    t0 = time.time()
    hist = run.run(args.steps, eval_every=max(1, args.steps // 4))
    acc = f" acc={hist.accuracy[-1]:.3f}" if hist.accuracy else ""
    _say(f"done: steps={args.steps} loss={hist.loss[-1]:.4f}{acc} "
         f"simulated_wallclock={hist.wallclock[-1]:.1f}s ({time.time() - t0:.1f}s real)")
    return run.runtime.global_params()


def _participation_spec(args):
    """Turn --participation/--participation-k into a participation spec."""
    if args.participation is None:
        return None
    if args.participation == "uniform-k":
        return {"strategy": "uniform-k", "k": args.participation_k}
    return args.participation


def _fault_spec(args):
    """Turn ``--faults <spec>`` into a ``repro_torch.faults`` spec.

    Accepts inline JSON (an event list or ``{"events": [...], "psi": ...}``)
    or ``@path/to/trace.json``; validation happens in ``RunConfig.validate``
    / ``FaultSchedule``, which report the malformed event by index.
    """
    if args.faults is None:
        return None
    spec = args.faults
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            spec = f.read()
    return spec


def _store_spec(args):
    """Turn --store/--k-max into a ``repro_torch.state`` store spec."""
    if args.store is None:
        return None
    if args.store == "host-offload":
        spec = {"kind": "host-offload"}
        if args.k_max is not None:
            spec["k_max"] = args.k_max
        return spec
    return args.store


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b")
    ap.add_argument("--scenario", default=None,
                    help="named scenario from repro_torch.scenarios ('list' to enumerate); "
                         "overrides the LM path")
    ap.add_argument("--samples", type=int, default=None,
                    help="dataset size for --scenario runs")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=50,
                    help="protocol iterations (rounded up to whole rounds)")
    ap.add_argument("--clients", type=int, default=None, help="default 8 (LM path)")
    ap.add_argument("--clusters", type=int, default=None, help="default 4 (LM path)")
    ap.add_argument("--tau1", type=int, default=None, help="default 2 (LM path)")
    ap.add_argument("--tau2", type=int, default=None, help="default 1 (LM path)")
    ap.add_argument("--alpha", type=int, default=None, help="default 2 (LM path)")
    ap.add_argument("--rounds-per-step", dest="rounds_per_step", type=int, default=None,
                    help="round scheduler only: full rounds a superstep dispatch (default 1)")
    ap.add_argument("--lr", type=float, default=None, help="default 0.05 (LM path)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "dense", "cuda", "collective"],
                    help="aggregation backend for the Lemma-1 transition")
    ap.add_argument("--mesh", default="none", choices=["none", "auto"],
                    help="client mesh: 'auto' under torchrun trains one client a rank; "
                         "in one process it resolves to none when there are fewer CUDA "
                         "devices than clients")
    ap.add_argument("--participation", default=None,
                    choices=["full", "uniform-k", "availability", "trace"],
                    help="per-round client participation strategy "
                         "(repro_torch.participation); 'full' is the default "
                         "everyone-aggregates behavior")
    ap.add_argument("--participation-k", dest="participation_k", type=int, default=1,
                    help="clients sampled per cluster per round for --participation uniform-k")
    ap.add_argument("--store", default=None, choices=["dense", "host-offload"],
                    help="client-state store (repro_torch.state): 'dense' keeps the stacked "
                         "(C, ...) tree on the device (default), 'host-offload' keeps only "
                         "k_max resident models and streams the rest through host memory")
    ap.add_argument("--k-max", dest="k_max", type=int, default=None,
                    help="resident client-model slots for --store host-offload "
                         "(default: one per cluster)")
    ap.add_argument("--faults", default=None,
                    help="fault-injection spec (repro_torch.faults): inline JSON event "
                         "list / {'events': ...} dict, or @file.json; events become "
                         "per-round mixing matrices and client masks, runtime operands")
    ap.add_argument("--batch", type=int, default=None, help="default 4 (LM path)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--save-dir", default=None, help="checkpoint directory")
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None):
    """Run the CLI; returns the consensus parameters (None for ``--scenario
    list``)."""
    args = _parser().parse_args(argv)
    started = _start_process_group(args)
    try:
        if args.scenario is not None:
            return run_scenario(args)
        return _train_lm(args)
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train_lm(args):
    """The LM path: federated training of a causal LM on the round scheduler."""

    from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
    from ..core.aggregation import gather_rows_to_host
    from ..configs import get_config
    from ..core.config import ExecSpec, FleetSpec, ModelSpec, RunConfig
    from ..core.runtime import make_run
    from ..data.synthetic import SyntheticLM
    from ..models import CausalLM
    from .mesh import describe_resolution

    for flag, default in (("clients", 8), ("clusters", 4), ("tau1", 2),
                          ("tau2", 1), ("alpha", 2), ("lr", 0.05), ("batch", 4),
                          ("rounds_per_step", 1)):
        if getattr(args, flag) is None:
            setattr(args, flag, default)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = CausalLM(cfg)
    rc = RunConfig(
        model=ModelSpec(kind="causal-lm", instance=model),
        fleet=FleetSpec(participation=_participation_spec(args),
                        store=_store_spec(args),
                        faults=_fault_spec(args)),
        exec=ExecSpec(
            scheduler="round",
            backend=args.backend,
            tau1=args.tau1,
            tau2=args.tau2,
            alpha=args.alpha,
            learning_rate=args.lr,
            mesh=None if args.mesh == "none" else args.mesh,
            extras={"rounds_per_step": args.rounds_per_step},
        ),
        num_clients=args.clients,
        num_clusters=args.clusters,
        seed=args.seed,
    )
    runtime = make_run(rc, device=args.device)
    sched = runtime.scheduler
    if args.mesh != "none":
        _say(describe_resolution(args.mesh, sched.backend.clusters.num_clients,
                                 device=sched.device))
    ipr = sched.iterations_per_round
    rps = sched.rounds_per_step
    steps = sched.steps_for(args.steps)
    # whole supersteps only: the trained-round count rounds up to R-multiples
    rounds = steps * rps

    resident = sched.store.resident
    start_round = 0
    if args.save_dir and args.resume:
        if not resident:
            raise SystemExit(
                "--resume is not supported with --store host-offload: the "
                "per-client state lives in the host store, not a stacked "
                "checkpointable tree"
            )
        if latest_step(args.save_dir) is not None:
            # on a mesh each rank reads its own row of the (C, ...) stack
            sched.params, manifest = restore_checkpoint(
                args.save_dir, sched.params, row=None if sched.mesh is None else sched.mesh.index)
            if (manifest.get("metadata") or {}).get("unit") == "round":
                start_round = manifest["step"]
            else:
                # pre-runtime checkpoints counted protocol iterations; round up
                # so no already-applied iteration is ever re-applied
                start_round = -(-manifest["step"] // ipr)
                _say(f"legacy checkpoint: step {manifest['step']} -> round {start_round}")
                if manifest["step"] % ipr:
                    _say(f"WARNING: checkpoint stopped mid-round; iterations "
                         f"{manifest['step'] + 1}..{start_round * ipr} (incl. the "
                         f"round-boundary aggregation) are skipped — resumed "
                         f"trajectory is inexact for the whole-round engine")
            _say(f"resumed from round {start_round}")
            if start_round >= rounds:
                _say(f"checkpoint already at round {start_round} >= target "
                     f"{rounds}; nothing to train")
    start_step = -(-start_round // rps)
    if start_round % rps:
        _say(f"WARNING: checkpoint round {start_round} does not align with "
             f"--rounds-per-step {rps}; resuming from superstep {start_step} "
             f"(rounds {start_round + 1}..{start_step * rps} are skipped)")
    if resident:
        n_params = sum(p[0].numel() for p in sched.params.values())
    else:
        n_params = sum(np.size(x) for x in sched.store.state_of(0))
    _say(f"arch={cfg.name} params/client={n_params:,} clients={args.clients} "
         f"clusters={args.clusters} tau1={args.tau1} tau2={args.tau2} "
         f"alpha={args.alpha} rounds={rounds} ({rounds * ipr} iterations, "
         f"{steps} dispatches of {rps} round(s))")

    # per-client non-IID-ish token streams (different seeds = different stats)
    streams = [
        SyntheticLM.generate(256, args.seq, cfg.vocab_size, seed=args.seed + 31 * i)
        for i in range(args.clients)
    ]
    iters = [s.batches(args.batch, seed=args.seed + i) for i, s in enumerate(streams)]

    def batch_fn(k):
        draws = [next(it) for it in iters]
        return {key: np.stack([b[key] for b in draws]) for key in draws[0]}

    t0 = time.time()
    for s in range(start_step + 1, steps + 1):
        ev = runtime.step(batch_fn)
        r = s * rps  # rounds completed
        # reading a loss waits for the device: only on the logging steps, so
        # supersteps dispatch back-to-back
        if r % args.log_every == 0 or s == steps or s == start_step + 1:
            _say(f"round {r:4d} (iter {r * ipr:5d}) "
                 f"loss={float(ev.losses[-1]):.4f} ({time.time() - t0:.1f}s)")
        if args.save_dir and (r % args.save_every == 0 or s == steps):
            meta = {"arch": cfg.name, "unit": "round", "run_config": rc.describe()}
            # on a mesh the rows go to rank 0's host, which writes
            if resident:
                state = (sched.params if sched.mesh is None
                         else gather_rows_to_host(sched.params, sched.mesh))
            else:
                # offload stores checkpoint the consensus model: the stacked
                # per-client tree never exists on the device to snapshot
                state, meta = runtime.global_params(), meta | {"consensus": True}
            if _rank() == 0:
                save_checkpoint(args.save_dir, state, step=r, metadata=meta)
    # consensus phase: weighted global model
    global_params = runtime.global_params()
    _say("done; consensus model extracted.")
    return global_params


if __name__ == "__main__":
    main()
