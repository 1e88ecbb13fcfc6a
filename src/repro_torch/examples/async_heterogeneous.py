"""Asynchronous SD-FEEL under device heterogeneity (paper Fig. 10).

    PYTHONPATH=src python -m repro_torch.examples.async_heterogeneous [--H 10] [--device cuda]

The port's ``examples/async_heterogeneous.py``: synchronous SD-FEEL, vanilla
async (constant mixing) and the staleness-aware async algorithm at
heterogeneity gap H, on the same fleet; only the scheduler differs.  On a
CUDA device every async cluster event replays from a CUDA graph (one per
cluster size), its operands staged in one copy from pinned memory.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--H", type=float, default=10.0, help="heterogeneity gap")
    ap.add_argument("--profile", default="uniform",
                    choices=["uniform", "bimodal-straggler", "exponential"],
                    help="device-heterogeneity fleet sampler (repro_torch.hetero)")
    ap.add_argument("--events", type=int, default=60)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=16)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--samples", type=int, default=2500)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--theta-max", type=int, default=8)
    args = ap.parse_args(argv)

    from repro_torch.core import MNIST_LATENCY, ClusterSpec, make_run
    from repro_torch.data import (ClientBatcher, FederatedDataset, mnist_like,
                                  skewed_label_partition)
    from repro_torch.hetero import sample_profile
    from repro_torch.models import MnistCNN

    clients, clusters = args.clients, args.clusters
    data = mnist_like(args.samples, seed=0)
    train, test = data.split(0.85)
    parts = skewed_label_partition(train.y, clients, classes_per_client=2, seed=0)
    ds = FederatedDataset(train, parts)
    eval_batch = {"x": test.x[:512], "y": test.y[:512]}
    spec = ClusterSpec(clients, tuple(i * clusters // clients for i in range(clients)),
                       ds.data_sizes())
    profile_spec = {"kind": args.profile}
    if args.profile == "uniform":
        profile_spec["heterogeneity"] = args.H
    elif args.profile == "bimodal-straggler":
        profile_spec["speedup"] = args.H
    fleet = sample_profile(profile_spec, clients, seed=1)
    print(f"{fleet.name} fleet: H = {fleet.heterogeneity():.1f}, "
          f"min uplink = {fleet.bandwidths.min():.2f}x")

    # synchronous baseline: with the same fleet attached, every iteration waits
    # for the slowest device (the straggler effect the async regime removes)
    sync = make_run({
        "scheduler": "sync", "model": MnistCNN(), "clusters": spec, "topology": "ring",
        "tau1": 2, "tau2": 1, "alpha": 1, "learning_rate": 0.05,
        "latency": MNIST_LATENCY, "profile": fleet, "seed": 0,
    }, device=args.device)
    rng = np.random.default_rng(0)
    h_sync = sync.run(args.events, lambda k: ds.stacked_batch(args.batch, rng), eval_batch,
                      eval_every=args.events)

    out = {"synchronous": h_sync}
    for name, psi in (("vanilla-async", "constant"), ("staleness-aware", "staleness")):
        runtime = make_run({
            "scheduler": "async", "model": MnistCNN(), "clusters": spec,
            "topology": "ring", "profile": fleet, "learning_rate": 0.05,
            "min_batches": 2, "theta_max": args.theta_max, "psi": psi,
            "latency": MNIST_LATENCY, "seed": 0,
        }, device=args.device)
        batcher = ClientBatcher(ds, args.batch, seed=0)
        h = runtime.run(args.events, batcher, eval_batch, eval_every=args.events)
        out[name] = h
        print(f"{name:18s}: acc={h.accuracy[-1]:.3f} loss={h.loss[-1]:.4f} "
              f"wallclock={h.wallclock[-1]:.1f}s (gaps bounded, t={runtime.scheduler.t})")

    print(f"{'synchronous':18s}: acc={h_sync.accuracy[-1]:.3f} loss={h_sync.loss[-1]:.4f} "
          f"wallclock={h_sync.wallclock[-1]:.1f}s")
    return out


if __name__ == "__main__":
    main()
