"""Federated batching: per-client mini-batch streams over a partition.

Numpy, like ``repro.data.loader``: batches stay host arrays until
``core.pipeline`` stages them on the run's device.  ``ClientBatcher`` (the
async per-client iterator) waits for the async slice.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .synthetic import SyntheticClassification

__all__ = ["FederatedDataset"]


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
