"""Federated batching: per-client mini-batch streams over a partition.

Numpy, like ``repro.data.loader``: batches stay host arrays until
``core.pipeline`` stages them on the run's device.  ``ClientBatcher`` is the
async scheduler's per-client iterator, with the reference's per-client rng
streams (``seed + 7919 * i``), so both packages draw identical batches.
``ProceduralFederated`` makes batches on demand for fleets too large to
materialize, from the reference's per-(seed, client, iteration) streams.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticClassification

__all__ = ["FederatedDataset", "ClientBatcher", "ProceduralFederated"]


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

    def eval_batch(self, test: SyntheticClassification, max_samples: int = 2048) -> dict:
        """The first ``max_samples`` examples of ``test`` (all, if fewer)."""
        n = min(max_samples, len(test))
        return {"x": test.x[:n], "y": test.y[:n]}


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


class ProceduralFederated:
    """On-demand federated data for fleets too large to materialize.

    Nothing is stored per client: batch ``(client c, iteration k)`` is a pure
    function of ``(seed, c, k)`` (``default_rng([seed, c, k])``, the
    reference's stream), so any subset of clients can be drawn for any
    iteration, in any order, any number of times: the contract sparse
    residency needs (``supports_clients`` advertises the ``clients=``
    keyword to ``repro_torch.core.runtime``).

    The task is class-conditional Gaussian images (one prototype per class,
    drawn once from ``seed``) under label skew: client ``c`` sees
    ``classes_per_client`` consecutive classes from a per-client hash.
    """

    supports_clients = True

    def __init__(self, num_clients: int, batch_size: int = 4, num_classes: int = 10,
                 shape: tuple = (28, 28, 1), classes_per_client: int = 2, seed: int = 0):
        self.num_clients = int(num_clients)
        self.batch_size = int(batch_size)
        self.num_classes = int(num_classes)
        self.shape = tuple(shape)
        self.classes_per_client = int(classes_per_client)
        self.seed = int(seed)
        rng = np.random.default_rng([self.seed, 0x9E3779B9])
        self.prototypes = rng.normal(size=(num_classes,) + self.shape).astype(np.float32)
        self._counters: dict[int, int] = {}

    def data_sizes(self) -> tuple[float, ...]:
        return (1.0,) * self.num_clients

    def _client_batch(self, c: int, k: int) -> tuple[np.ndarray, np.ndarray]:
        rng = np.random.default_rng(
            [self.seed & 0xFFFFFFFF, int(c) & 0xFFFFFFFF, int(k) & 0xFFFFFFFF])
        lo = int(c) * 2654435761 % self.num_classes
        ys = (lo + rng.integers(0, self.classes_per_client, size=self.batch_size)) \
            % self.num_classes
        xs = self.prototypes[ys] + 0.25 * rng.normal(
            size=(self.batch_size,) + self.shape).astype(np.float32)
        return xs.astype(np.float32), ys.astype(np.int32)

    def __call__(self, k: int, clients=None) -> dict:
        cs = range(self.num_clients) if clients is None else np.asarray(clients).tolist()
        xs, ys = zip(*(self._client_batch(c, k) for c in cs))
        return {"x": np.stack(xs), "y": np.stack(ys)}

    def stacked_batch(self, batch_size: int, rng=None, clients=None) -> dict:
        """``FederatedDataset``-shaped alias; the draw index comes from ``rng``
        when given (one integer per call), so repeated calls differ."""
        k = int(rng.integers(0, 2**31 - 1)) if rng is not None else 0
        if batch_size != self.batch_size:
            raise ValueError(f"ProceduralFederated is fixed at batch_size={self.batch_size}, "
                             f"got {batch_size}")
        return self(k, clients=clients)

    def next_batch(self, client: int) -> dict:
        """The async per-client contract: each call advances that client's stream."""
        c = int(client)
        k = self._counters.get(c, 0)
        self._counters[c] = k + 1
        xs, ys = self._client_batch(c, k)
        return {"x": xs, "y": ys}

    def eval_batch(self, max_samples: int = 512) -> dict:
        rng = np.random.default_rng([self.seed, 0xE7A1])
        ys = rng.integers(0, self.num_classes, size=max_samples)
        xs = self.prototypes[ys] + 0.25 * rng.normal(
            size=(max_samples,) + self.shape).astype(np.float32)
        return {"x": xs.astype(np.float32), "y": ys.astype(np.int32)}
