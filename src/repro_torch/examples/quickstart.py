"""Quickstart: train the paper's MNIST CNN with SD-FEEL.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda] [--iters 120]

The port's ``examples/quickstart.py``: a ring of edge servers (the paper's
§V-A layout, scaled down from its 50 clients and 10 servers), skewed non-IID
labels (2 classes per client), tau1=5, tau2=1, alpha=1, built through
``make_run``.  On a CUDA device the sync steps replay from CUDA graphs and
aggregate with the hand-written kernels.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--clients", type=int, default=20)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--iters", type=int, default=120)
    ap.add_argument("--samples", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=10)
    ap.add_argument("--eval-every", type=int, default=20)
    args = ap.parse_args(argv)

    from repro_torch.core import MNIST_LATENCY, ClusterSpec, make_run
    from repro_torch.data import FederatedDataset, mnist_like, skewed_label_partition
    from repro_torch.models import MnistCNN

    clients, clusters = args.clients, args.clusters
    data = mnist_like(args.samples, seed=0)
    train, test = data.split(0.85)
    parts = skewed_label_partition(train.y, clients, classes_per_client=2, seed=0)
    ds = FederatedDataset(train, parts)

    runtime = make_run({
        "scheduler": "sync",
        "model": MnistCNN(),
        "clusters": ClusterSpec(clients, tuple(i * clusters // clients for i in range(clients)),
                                ds.data_sizes()),
        "topology": "ring",
        "tau1": 5, "tau2": 1, "alpha": 1,
        "learning_rate": 0.05,
        "latency": MNIST_LATENCY,
        "seed": 0,
    }, device=args.device)
    cfg = runtime.scheduler.cfg
    print(f"SD-FEEL: {clients} clients, {clusters} edge servers (ring, zeta={cfg.zeta():.3f}) "
          f"on {runtime.device}")

    rng = np.random.default_rng(0)
    eval_batch = {"x": test.x[:512], "y": test.y[:512]}
    hist = runtime.run(args.iters, lambda k: ds.stacked_batch(args.batch, rng), eval_batch,
                       eval_every=args.eval_every)
    for k, t, l, a in zip(hist.iterations, hist.wallclock, hist.loss, hist.accuracy):
        print(f"iter {k:4d}  t={t:7.1f}s  loss={l:.4f}  acc={a:.3f}")
    print(f"final accuracy: {hist.accuracy[-1]:.3f}")
    return hist


if __name__ == "__main__":
    main()
