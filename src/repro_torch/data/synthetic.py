"""Synthetic datasets standing in for MNIST / CIFAR-10 (offline substitute).

Gaussian-mixture classification tasks with the paper's label structure (10
classes) and image shapes, so the paper's CNNs and non-IID partitioners run
unchanged.  A numpy copy of ``repro.data.synthetic``'s classification part:
the same seed draws the same rng stream, so both packages see the same data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SyntheticClassification", "mnist_like", "cifar_like"]


@dataclasses.dataclass
class SyntheticClassification:
    """Gaussian-mixture images: class c has mean pattern mu_c, noise sigma."""

    x: np.ndarray  # (N, H, W, C) float32 in [0, 1]-ish
    y: np.ndarray  # (N,) int32 labels
    num_classes: int

    @staticmethod
    def generate(
        num_samples: int,
        image_shape: tuple[int, int, int],
        num_classes: int = 10,
        noise: float = 0.35,
        seed: int = 0,
    ) -> "SyntheticClassification":
        rng = np.random.default_rng(seed)
        h, w, c = image_shape
        # Low-frequency class prototypes: random smooth patterns per class.
        freq = rng.normal(size=(num_classes, 4, 4, c)).astype(np.float32)
        protos = np.stack(
            [
                np.kron(freq[k], np.ones((h // 4 + 1, w // 4 + 1, 1), np.float32))[
                    :h, :w, :
                ]
                for k in range(num_classes)
            ]
        )
        y = rng.integers(0, num_classes, size=num_samples).astype(np.int32)
        x = protos[y] + noise * rng.normal(size=(num_samples, h, w, c)).astype(np.float32)
        return SyntheticClassification(x=x.astype(np.float32), y=y, num_classes=num_classes)

    def split(self, frac: float = 0.8) -> tuple["SyntheticClassification", "SyntheticClassification"]:
        n = int(len(self.y) * frac)
        return (
            SyntheticClassification(self.x[:n], self.y[:n], self.num_classes),
            SyntheticClassification(self.x[n:], self.y[n:], self.num_classes),
        )

    def __len__(self) -> int:
        return len(self.y)


def mnist_like(num_samples: int = 6000, seed: int = 0) -> SyntheticClassification:
    return SyntheticClassification.generate(num_samples, (28, 28, 1), seed=seed)


def cifar_like(num_samples: int = 6000, seed: int = 0) -> SyntheticClassification:
    return SyntheticClassification.generate(num_samples, (32, 32, 3), seed=seed)
