"""Non-IID partitioners (paper §V-A).

* ``skewed_label_partition`` — each client receives samples from ``c`` random
  classes (MNIST setting; default c=2).
* ``dirichlet_partition`` — class proportions per client drawn from
  Dir(beta); smaller beta = more skew (CIFAR-10 setting; default beta=0.5).
* ``iid_partition`` — uniform shuffle (kappa = 0 case).

A numpy copy of ``repro.data.partition``: the same seed gives the same
partition in both packages.
"""
from __future__ import annotations

import numpy as np

__all__ = ["iid_partition", "skewed_label_partition", "dirichlet_partition"]


def iid_partition(labels: np.ndarray, num_clients: int, seed: int = 0) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(labels))
    return [np.sort(part) for part in np.array_split(idx, num_clients)]


def skewed_label_partition(
    labels: np.ndarray,
    num_clients: int,
    classes_per_client: int = 2,
    seed: int = 0,
) -> list[np.ndarray]:
    """Each client gets shards from ``classes_per_client`` random classes."""
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    by_class = [np.nonzero(labels == c)[0] for c in range(num_classes)]
    for arr in by_class:
        rng.shuffle(arr)
    # Total shards per class proportional to demand.
    demand = np.zeros(num_classes, dtype=np.int64)
    choices = []
    for _ in range(num_clients):
        cls = rng.choice(num_classes, size=classes_per_client, replace=False)
        choices.append(cls)
        demand[cls] += 1
    # Split every chosen class fully among its takers: the first
    # ``len % demand`` takers receive one extra sample, so no per-class tail
    # is dropped.  (Classes no client chose remain unassigned by design —
    # callers can detect them via ``demand == 0``.)
    cursors = np.zeros(num_classes, dtype=np.int64)
    served = np.zeros(num_classes, dtype=np.int64)
    out = []
    for cls in choices:
        take = []
        for c in cls:
            per, rem = divmod(len(by_class[c]), demand[c])
            size = per + (1 if served[c] < rem else 0)
            lo = cursors[c]
            take.append(by_class[c][lo : lo + size])
            cursors[c] += size
            served[c] += 1
        out.append(np.sort(np.concatenate(take)))
    return out


def dirichlet_partition(
    labels: np.ndarray,
    num_clients: int,
    beta: float = 0.5,
    seed: int = 0,
    min_samples: int = 2,
    max_retries: int = 1000,
) -> list[np.ndarray]:
    """Dir(beta) label-proportion sampling (Yurochkin et al. / paper §V-A).

    Resamples until every client holds at least ``min_samples`` indices;
    raises ``ValueError`` after ``max_retries`` attempts (or immediately when
    the demand is infeasible) instead of spinning forever.
    """
    if min_samples * num_clients > len(labels):
        raise ValueError(
            f"min_samples={min_samples} x {num_clients} clients exceeds "
            f"{len(labels)} samples: partition is infeasible"
        )
    rng = np.random.default_rng(seed)
    num_classes = int(labels.max()) + 1
    for _ in range(max_retries):
        buckets: list[list[np.ndarray]] = [[] for _ in range(num_clients)]
        for c in range(num_classes):
            idx = np.nonzero(labels == c)[0]
            rng.shuffle(idx)
            props = rng.dirichlet(np.full(num_clients, beta))
            cuts = (np.cumsum(props) * len(idx)).astype(np.int64)[:-1]
            for client, part in enumerate(np.split(idx, cuts)):
                buckets[client].append(part)
        parts = [np.sort(np.concatenate(b)) for b in buckets]
        if min(len(p) for p in parts) >= min_samples:
            return parts
    raise ValueError(
        f"dirichlet_partition failed to satisfy min_samples={min_samples} for "
        f"{num_clients} clients within {max_retries} retries (beta={beta}); "
        "lower min_samples or raise beta"
    )
