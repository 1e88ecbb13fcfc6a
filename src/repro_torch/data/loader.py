"""Federated batching: per-client mini-batch streams over a partition.

Numpy, like ``repro.data.loader``: batches stay host arrays until
``core.pipeline`` stages them on the run's device.  ``ClientBatcher`` is the
async scheduler's per-client iterator, with the reference's per-client rng
streams (``seed + 7919 * i``), so both packages draw identical batches.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticClassification

__all__ = ["FederatedDataset", "ClientBatcher"]


@dataclasses.dataclass
class FederatedDataset:
    """A dataset + client partition; yields stacked per-client batches."""

    data: SyntheticClassification
    parts: list[np.ndarray]

    @property
    def num_clients(self) -> int:
        return len(self.parts)

    def data_sizes(self) -> tuple[float, ...]:
        return tuple(float(len(p)) for p in self.parts)

    def stacked_batch(self, batch_size: int, rng: np.random.Generator,
                      clients=None) -> dict:
        """One mini-batch per client, stacked: x (C, b, ...), y (C, b).

        ``clients`` restricts (and orders) the stacked rows to the given
        fleet indices.  The rng stream advances once per *returned* row, so
        sliced and full draws are different streams.
        """
        parts = (self.parts if clients is None
                 else [self.parts[int(c)] for c in clients])
        xs, ys = [], []
        for p in parts:
            idx = p[rng.integers(0, len(p), size=batch_size)]
            xs.append(self.data.x[idx])
            ys.append(self.data.y[idx])
        return {"x": np.stack(xs), "y": np.stack(ys)}

    def client_batch(self, client: int, batch_size: int, rng: np.random.Generator) -> dict:
        p = self.parts[client]
        idx = p[rng.integers(0, len(p), size=batch_size)]
        return {"x": self.data.x[idx], "y": self.data.y[idx]}


class ClientBatcher:
    """Stateful per-client mini-batch streams (the async scheduler's source)."""

    def __init__(self, dataset: FederatedDataset, batch_size: int, seed: int = 0):
        self.ds = dataset
        self.batch_size = batch_size
        self.rngs = [np.random.default_rng(seed + 7919 * i) for i in range(dataset.num_clients)]

    def next_batch(self, client: int) -> dict:
        return self.ds.client_batch(client, self.batch_size, self.rngs[client])

    def next_batches(self, clients: list[int], count: int) -> dict:
        """Bulk draw: ``count`` batches per client, entries (len(clients), count, b, ...).

        One rng call per client and one fancy-index into the dataset; the
        draws are stream-identical to calling ``next_batch`` ``count`` times
        per client (numpy fills integer draws from the bit stream in C
        order), so bulk and per-call consumers interleave safely.
        """
        idx = np.stack([
            self.ds.parts[c][
                self.rngs[c].integers(0, len(self.ds.parts[c]), size=(count, self.batch_size))
            ]
            for c in clients
        ])  # (len(clients), count, batch_size)
        return {"x": self.ds.data.x[idx], "y": self.ds.data.y[idx]}

    def next_stacked(self, clients: list[int] | None = None) -> dict:
        """One batch per client, stacked: x (len(clients), b, ...)."""
        clients = clients if clients is not None else list(range(self.ds.num_clients))
        draws = [self.next_batch(c) for c in clients]
        return {k: np.stack([b[k] for b in draws]) for k in ("x", "y")}
