"""Baseline FL systems the paper compares against (Table I, Figs. 4-6).

The port's ``repro.core.baselines``:

* ``FedAvgTrainer``  — clients <-> Cloud PS, aggregation every ``tau``
  iterations over all clients (McMahan et al.).  Slow client-cloud links.
* ``HierFAVGTrainer``— client-edge-cloud hierarchy (Liu et al.): intra-cluster
  aggregation every ``tau1``, *perfect* global (cloud) aggregation every
  ``tau1*tau2`` — the zeta^alpha = 0 limit of SD-FEEL (Remark 3), but paying
  the edge<->cloud latency.
* ``FEELTrainer``    — a single edge server with limited coverage, randomly
  scheduling ``schedule_size`` of its accessible clients per round.

All three are special cases of the Lemma-1 transition, applied as the dense
``apply_transition_dense`` product, and report wall-clock via the §V-B
latency model.  The local step is ``core.local_update``'s batched SGD step,
on the route ``backend`` names: ``"cuda"`` runs the ``sgd_update`` kernel
over the stacked client tree, in place, ``"dense"`` the plain expression,
and ``"auto"`` (the default) the kernel on a CUDA device.
Entry points take ``device=None``, which means ``"cuda"``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .aggregation import apply_transition_dense
from .backends import _f32
from .latency import LatencyModel
from .protocol import ClusterSpec
from .runtime import TrainHistory

__all__ = ["FedAvgTrainer", "HierFAVGTrainer", "FEELTrainer"]


class _StackedTrainer:
    """Shared machinery: stacked client params + vmapped local SGD.

    ``params`` start from ``runtime.stacked_init`` (a CPU generator seeded
    with ``seed``); a test that compares with the reference assigns the
    reference's weights, carried through ``repro_torch.convert``.
    """

    def __init__(self, model, num_clients: int, lr: float, seed: int = 0, device=None,
                 backend="auto"):
        from .. import optim
        from .device import resolve_device
        from .local_update import build_local_update
        from .runtime import stacked_init

        self.model = model
        self.num_clients = num_clients
        self.device = resolve_device(device)
        self.params = stacked_init(model, num_clients, seed, self.device)
        if backend == "auto":
            backend = "cuda" if self.device.type == "cuda" else "dense"
        if backend not in ("cuda", "dense"):
            raise KeyError(f"unknown local-step route {backend!r}; use 'auto', 'cuda' or 'dense'")
        # the route of the local step only: the aggregations are dense
        # products, as in the reference
        self.route = backend
        self._local = build_local_update(model, optim.sgd(lr), backend=backend)

    def _mean_transition(self, weights: np.ndarray) -> torch.Tensor:
        """T = w 1^T (every client receives the weighted global mean)."""
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        return _f32(np.tile(w[:, None], (1, self.num_clients)), self.device)

    def _apply_t(self, t: torch.Tensor) -> None:
        self.params = apply_transition_dense(self.params, t)

    def _run(self, num_iterations, batch_fn, iter_time_fn, agg_fn, eval_batch, eval_every):
        from .pipeline import device_batch

        hist = TrainHistory([], [], [], [])
        clock = 0.0
        if eval_batch is not None:
            eval_batch = device_batch(eval_batch, self.device)
        for k in range(1, num_iterations + 1):
            self.params, _, _ = self._local(self.params, (), device_batch(batch_fn(k),
                                                                          self.device))
            agg_fn(k)
            clock += iter_time_fn(k)
            if eval_batch is not None and (k % eval_every == 0 or k == num_iterations):
                g = self.global_params()
                hist.iterations.append(k)
                hist.wallclock.append(clock)
                with torch.no_grad():
                    hist.loss.append(float(self.model.loss(g, eval_batch)))
                    if hasattr(self.model, "accuracy"):
                        hist.accuracy.append(float(self.model.accuracy(g, eval_batch)))
        return hist

    def _weighted(self, m: np.ndarray) -> dict:
        mt = _f32(m, self.device)
        return {k: torch.tensordot(mt, w.float(), dims=([0], [0])) for k, w in self.params.items()}

    def global_params(self) -> dict:
        return self._weighted(np.full(self.num_clients, 1.0 / self.num_clients))


class FedAvgTrainer(_StackedTrainer):
    def __init__(self, model, num_clients: int, tau: int = 5, lr: float = 0.01,
                 latency: Optional[LatencyModel] = None, seed: int = 0,
                 data_sizes: Optional[np.ndarray] = None, device=None, backend="auto"):
        super().__init__(model, num_clients, lr, seed, device, backend)
        self.tau = tau
        self.latency = latency
        sizes = data_sizes if data_sizes is not None else np.ones(num_clients)
        self._t_global = self._mean_transition(sizes)

    def run(self, num_iterations, batch_fn, eval_batch=None, eval_every=50):
        def agg(k):
            if k % self.tau == 0:
                self._apply_t(self._t_global)

        def t_iter(k):
            if self.latency is None:
                return 1.0
            t = self.latency.t_comp()
            if k % self.tau == 0:
                t += self.latency.t_comm_client_cloud()
            return t

        return self._run(num_iterations, batch_fn, t_iter, agg, eval_batch, eval_every)


class HierFAVGTrainer(_StackedTrainer):
    def __init__(self, model, clusters: ClusterSpec, tau1: int = 5, tau2: int = 2,
                 lr: float = 0.01, latency: Optional[LatencyModel] = None, seed: int = 0,
                 device=None, backend="auto"):
        super().__init__(model, clusters.num_clients, lr, seed, device, backend)
        self.clusters = clusters
        self.tau1, self.tau2 = tau1, tau2
        self.latency = latency
        self._t_intra = _f32(clusters.V() @ clusters.B(), self.device)
        self._t_global = self._mean_transition(np.asarray(clusters.data_sizes))

    def run(self, num_iterations, batch_fn, eval_batch=None, eval_every=50):
        def agg(k):
            if k % (self.tau1 * self.tau2) == 0:
                self._apply_t(self._t_global)
            elif k % self.tau1 == 0:
                self._apply_t(self._t_intra)

        def t_iter(k):
            if self.latency is None:
                return 1.0
            t = self.latency.t_comp()
            if k % self.tau1 == 0:
                t += self.latency.t_comm_client_server()
            if k % (self.tau1 * self.tau2) == 0:
                t += self.latency.t_comm_server_cloud()
            return t

        return self._run(num_iterations, batch_fn, t_iter, agg, eval_batch, eval_every)


class FEELTrainer(_StackedTrainer):
    """Single edge server, limited coverage, random schedule per round.

    Only ``pool`` clients are reachable; each aggregation round schedules
    ``schedule_size`` of them uniformly at random (numpy
    ``default_rng(seed + 1)``, the reference's stream).  Unscheduled clients
    are overwritten with the broadcast model (they do not contribute
    gradients — their local training this round is discarded, matching
    partial participation)."""

    def __init__(self, model, num_clients: int, pool: Optional[list[int]] = None,
                 schedule_size: int = 5, tau: int = 5, lr: float = 0.01,
                 latency: Optional[LatencyModel] = None, seed: int = 0, device=None,
                 backend="auto"):
        super().__init__(model, num_clients, lr, seed, device, backend)
        self.pool = pool if pool is not None else list(range(min(num_clients, 10)))
        self.schedule_size = min(schedule_size, len(self.pool))
        self.tau = tau
        self.latency = latency
        self._rng = np.random.default_rng(seed + 1)

    def run(self, num_iterations, batch_fn, eval_batch=None, eval_every=50):
        def agg(k):
            if k % self.tau == 0:
                sched = self._rng.choice(self.pool, size=self.schedule_size, replace=False)
                t = np.zeros((self.num_clients, self.num_clients))
                # every client receives the mean of the scheduled clients' models
                t[sched, :] = 1.0 / self.schedule_size
                self._apply_t(_f32(t, self.device))

        def t_iter(k):
            if self.latency is None:
                return 1.0
            t = self.latency.t_comp()
            if k % self.tau == 0:
                t += self.latency.t_comm_client_server()
            return t

        return self._run(num_iterations, batch_fn, t_iter, agg, eval_batch, eval_every)

    def global_params(self) -> dict:
        m = np.zeros(self.num_clients)
        m[self.pool] = 1.0 / len(self.pool)
        return self._weighted(m)
