"""Synthetic heavy-traffic request traces for the federated serving lane.

The port's ``repro.serving.traffic``, numpy alone, so a seed gives the same
trace in both packages.

An MLPerf-offline-style harness needs a replayable query set.  This module
draws one from a clustered ``repro_torch.data.FederatedLM`` corpus:

* request *cluster ids* follow a Zipf mix over the edge clusters (a few hot
  clusters dominate, the long tail trickles — the standard skew of
  geo-sharded traffic);
* each request's *prompt* is a real sequence prefix from one of that
  cluster's client corpora, so a served model is being asked to continue
  text from the distribution it trained on;
* each request's ``eos_id`` is the token the cluster's own Markov chain
  emits ``eos_horizon`` steps after the prompt — a model that has actually
  learned its cluster's transition structure reaches it almost immediately
  and the batch early-exits, while a mismatched model burns its whole token
  budget.  That is how personalization quality becomes queries/sec.

The trace is deterministic in ``seed``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .engine import Request

__all__ = ["zipf_cluster_ids", "heavy_tail_ints", "synthetic_trace"]


def zipf_cluster_ids(
    num_clusters: int, num_requests: int, *, exponent: float = 1.1, seed: int = 0
) -> np.ndarray:
    """Zipf-mixed cluster ids: rank r's share is proportional to r^-exponent.

    Which cluster gets which rank is shuffled by ``seed`` so the hot cluster
    is not always cluster 0.
    """
    if num_clusters < 1:
        raise ValueError("need at least one cluster")
    rng = np.random.default_rng(seed)
    weights = np.arange(1, num_clusters + 1, dtype=np.float64) ** -float(exponent)
    weights /= weights.sum()
    ranked = rng.permutation(num_clusters)
    return ranked[rng.choice(num_clusters, size=num_requests, p=weights)]


def heavy_tail_ints(
    rng: np.random.Generator, lo: int, hi: int, size: int, *, exponent: float = 1.1
) -> np.ndarray:
    """Power-law integers on [lo, hi]: P(k) ∝ k^-exponent.

    The decode-budget analogue of the Zipf cluster mix — most requests want
    a few tokens, a heavy tail wants many.  This is the regime where static
    batch drain pays ``max(budget)`` straggler steps per batch and
    continuous admission reclaims the idle slots.
    """
    if not 1 <= lo <= hi:
        raise ValueError(f"need 1 <= lo <= hi, got [{lo}, {hi}]")
    ks = np.arange(lo, hi + 1, dtype=np.float64)
    p = ks ** -float(exponent)
    p /= p.sum()
    return rng.choice(np.arange(lo, hi + 1), size=size, p=p)


def synthetic_trace(
    dataset,
    *,
    num_requests: int,
    prompt_lens: Sequence[int] = (8, 16),
    max_new_tokens=16,
    eos_horizon: int = 2,
    exponent: float = 1.1,
    gen_exponent: float = 1.1,
    seed: int = 0,
) -> list[Request]:
    """Replayable per-cluster request trace from a clustered LM corpus.

    ``dataset`` must be a ``FederatedLM`` built by ``generate_clustered``
    (``repro_torch.data``; it carries ``cluster_succ`` — the per-cluster successor tables — and
    ``cluster_assignments``).  Prompts are sequence prefixes from the
    request's cluster; ``eos_id`` is the chain's token ``eos_horizon``
    steps past the prompt.

    ``max_new_tokens`` is either one int (every request gets that budget)
    or a ``(lo, hi)`` pair: per-request budgets drawn heavy-tailed from
    ``[lo, hi]`` with :func:`heavy_tail_ints` (``gen_exponent``), still
    deterministic in ``seed``.
    """
    succ = getattr(dataset, "cluster_succ", None)
    assign = getattr(dataset, "cluster_assignments", None)
    if succ is None or assign is None:
        raise ValueError(
            "synthetic_trace needs a clustered corpus "
            "(FederatedLM.generate_clustered)"
        )
    if eos_horizon < 1:
        raise ValueError("eos_horizon must be >= 1")
    assign = np.asarray(assign)
    num_clusters = int(succ.shape[0])
    rng = np.random.default_rng(seed)
    ids = zipf_cluster_ids(num_clusters, num_requests, exponent=exponent, seed=seed)
    n_seq, seq_len = dataset.tokens.shape[1], dataset.tokens.shape[2] - 1
    if max(prompt_lens) > seq_len:
        raise ValueError(
            f"prompt_lens {tuple(prompt_lens)} exceed the corpus seq_len {seq_len}"
        )
    if isinstance(max_new_tokens, (tuple, list)):
        lo, hi = map(int, max_new_tokens)
        budgets = heavy_tail_ints(rng, lo, hi, num_requests, exponent=gen_exponent)
    else:
        budgets = np.full(num_requests, int(max_new_tokens))
    reqs = []
    for uid, d in enumerate(ids.tolist()):
        members = np.flatnonzero(assign == d)
        client = int(rng.choice(members))
        row = int(rng.integers(n_seq))
        plen = int(rng.choice(np.asarray(prompt_lens)))
        prompt = dataset.tokens[client, row, :plen].astype(np.int32)
        eos = int(prompt[-1])
        for _ in range(eos_horizon):
            eos = int(succ[d, eos])
        reqs.append(Request(
            uid=uid, prompt=prompt, max_new_tokens=int(budgets[uid]),
            eos_id=eos, cluster_id=int(d),
        ))
    return reqs
