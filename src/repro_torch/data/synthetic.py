"""Synthetic datasets standing in for MNIST / CIFAR-10 (offline substitute).

Gaussian-mixture classification tasks with the paper's label structure (10
classes) and image shapes, so the paper's CNNs and non-IID partitioners run
unchanged, and Markov-chain token streams for the federated-LM scenarios.
A numpy copy of ``repro.data.synthetic``: the same seed draws the same rng
stream, so both packages see the same data and batches.
"""
from __future__ import annotations

import dataclasses

from typing import Optional

import numpy as np

__all__ = ["SyntheticClassification", "mnist_like", "cifar_like", "SyntheticLM", "FederatedLM"]


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


@dataclasses.dataclass
class SyntheticLM:
    """Markov-chain token streams for language-model training/serving tests."""

    tokens: np.ndarray  # (N, S+1) int32
    vocab_size: int

    @staticmethod
    def generate(
        num_sequences: int,
        seq_len: int,
        vocab_size: int,
        order_mix: float = 0.7,
        seed: int = 0,
    ) -> "SyntheticLM":
        rng = np.random.default_rng(seed)
        # Sparse bigram transition structure -> learnable statistics.
        hot = rng.integers(0, vocab_size, size=(vocab_size, 4))
        seqs = np.empty((num_sequences, seq_len + 1), dtype=np.int32)
        state = rng.integers(0, vocab_size, size=num_sequences)
        for t in range(seq_len + 1):
            seqs[:, t] = state
            nxt_hot = hot[state, rng.integers(0, 4, size=num_sequences)]
            nxt_rand = rng.integers(0, vocab_size, size=num_sequences)
            state = np.where(rng.random(num_sequences) < order_mix, nxt_hot, nxt_rand)
        return SyntheticLM(tokens=seqs, vocab_size=vocab_size)


@dataclasses.dataclass
class FederatedLM:
    """Per-client Markov LM corpora for the federated-LM scenarios.

    Each client holds its own ``SyntheticLM`` corpus drawn with a distinct
    seed (distinct bigram structure -> non-IID across clients, the paper's
    data-heterogeneity setting for token streams).  ``stacked_batch``
    vectorizes the whole fleet's draw into one ``(C, b, S)`` gather — no
    per-client Python loop — which is the contract
    ``ScenarioRun.batch_source`` and the round/sync schedulers consume.
    """

    tokens: np.ndarray  # (C, N, S+1) int32
    vocab_size: int
    # set by generate_clustered: the per-cluster ground-truth successor
    # tables and the client -> cluster map the corpora were drawn under
    cluster_succ: Optional[np.ndarray] = None          # (D, V) int32
    cluster_assignments: Optional[np.ndarray] = None   # (C,) int64

    @staticmethod
    def generate(
        num_clients: int,
        num_sequences: int,
        seq_len: int,
        vocab_size: int,
        order_mix: float = 0.7,
        seed: int = 0,
    ) -> "FederatedLM":
        corpora = [
            SyntheticLM.generate(
                num_sequences, seq_len, vocab_size, order_mix, seed=seed + 11 * i
            ).tokens
            for i in range(num_clients)
        ]
        return FederatedLM(tokens=np.stack(corpora), vocab_size=vocab_size)

    @staticmethod
    def generate_clustered(
        num_clients: int,
        num_sequences: int,
        seq_len: int,
        vocab_size: int,
        num_clusters: int,
        noise: float = 0.05,
        seed: int = 0,
    ) -> "FederatedLM":
        """Per-cluster corpora with *conflicting* successor permutations.

        Every cluster gets its own permutation of the FULL vocabulary as a
        successor table; a client's sequences follow its cluster's table
        (with ``noise`` probability of a uniform token).  Because the
        clusters disagree about the successor of the *same* states — not
        merely occupy disjoint token ranges — no single consensus model can
        satisfy them all: the personalization gap is structural, which is
        what the federated-serving lane measures.  Client ``i`` belongs to
        cluster ``i * D // C`` — the same contiguous layout ``ClusterSpec``
        and the scenario registry use, so per-cluster models trained on
        these corpora line up with ``cluster_assignments`` index-for-index.
        """
        if num_clients % num_clusters:
            raise ValueError(
                f"{num_clients} clients do not divide into {num_clusters} clusters"
            )
        rng = np.random.default_rng(seed)
        succ = np.stack(
            [rng.permutation(vocab_size) for _ in range(num_clusters)]
        ).astype(np.int32)
        assign = np.arange(num_clients) * num_clusters // num_clients
        tokens = np.empty((num_clients, num_sequences, seq_len + 1), np.int32)
        for i in range(num_clients):
            d = int(assign[i])
            state = rng.integers(0, vocab_size, size=num_sequences)
            for t in range(seq_len + 1):
                tokens[i, :, t] = state
                nxt = succ[d, state]
                rand = rng.integers(0, vocab_size, size=num_sequences)
                state = np.where(rng.random(num_sequences) < noise, rand, nxt)
        return FederatedLM(
            tokens=tokens, vocab_size=vocab_size,
            cluster_succ=succ, cluster_assignments=assign,
        )

    @property
    def num_clients(self) -> int:
        return self.tokens.shape[0]

    def data_sizes(self) -> np.ndarray:
        return np.full(self.num_clients, self.tokens.shape[1], dtype=np.float64)

    def stacked_batch(self, batch_size: int, rng) -> dict:
        """One bulk draw for every client: leaves (C, batch_size, S)."""
        c, n = self.tokens.shape[:2]
        idx = rng.integers(0, n, size=(c, batch_size))
        chunk = self.tokens[np.arange(c)[:, None], idx]
        return {"tokens": chunk[:, :, :-1], "labels": chunk[:, :, 1:]}

    def eval_batch(self, batch_size: int = 64, seed: int = 0) -> dict:
        """Flat (B, S) batch mixing sequences from every client's corpus."""
        rng = np.random.default_rng(seed)
        c, n = self.tokens.shape[:2]
        who = rng.integers(0, c, size=batch_size)
        idx = rng.integers(0, n, size=batch_size)
        chunk = self.tokens[who, idx]
        return {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
