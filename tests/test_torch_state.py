"""Port parity: client-state stores (``repro_torch.state``) against the reference.

* Planning: ``plan_residency``, ``sub_weights``, ``identity_residency`` and
  the participant mask equal the reference's exactly, for random masks, and
  refuse what it refuses.
* Host rows: ``HostArrayStore`` round trips in RAM and spilled, and a
  spilled row is a record the reference's checkpoint layer reads.
* Identity offload (``k_max == N``) against the port's dense store, on the
  sync, round and async schedulers, the dense and ``cuda`` backends and (sync
  and round) the collective one: 0.0.  The same
  operations run on the same shapes (on the round engine the offload run
  takes the weights variant, whose ``V(w)`` carries the bound ``m^``
  verbatim).
* Sparse offload (uniform-k, ``k_max < N``) against the reference's sparse
  offload after 10 iterations, from the reference's initial models carried
  over (``convert.store_from_numpy``): 1e-4 max abs on the cluster models
  and the consensus, as the other 10-iteration parity tests.
* Client mode persists exactly the participants and leaves everyone else.
* ``million-client-ring`` at its registered 10^6 clients for one superstep:
  the store's device bytes do not depend on N.
* On the CPU the captured step's body runs over the same static buffers
  (``core/cuda_graph.py``): the offload buffer keeps its addresses, so one
  graph key serves every residency.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.models as jmodels
import repro.scenarios as jscenarios
import repro.state as jstate
from repro.checkpoint import load_leaves as jload_leaves
from repro.data import FederatedDataset, iid_partition, mnist_like
import repro_torch.core as tcore
import repro_torch.scenarios as tscenarios
import repro_torch.state as tstate
from repro_torch.convert import params_to_numpy, store_from_numpy
from repro_torch.models import MnistCNN

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

C, D = 8, 4
UNIFORM_K = {"strategy": "uniform-k", "k": 1}


@pytest.fixture(scope="module")
def fed_data():
    data = mnist_like(600, seed=0)
    train, _ = data.split(0.8)
    return FederatedDataset(train, iid_partition(train.y, C))


def _spec(ds, ns):
    return ns.ClusterSpec(C, tuple(i // (C // D) for i in range(C)), ds.data_sizes())


def _config(ds, scheduler, store=None, participation=None, **kw):
    cfg = {"scheduler": scheduler, "model": MnistCNN(), "seed": 0, "store": store,
           "participation": participation, "learning_rate": 0.05, **kw}
    if scheduler == "round":
        cfg.update(num_clients=C, num_clusters=D)
    else:
        cfg["clusters"] = _spec(ds, tcore)
    return cfg


def _batches(ds, n, seed=0):
    rng = np.random.default_rng(seed)
    return [ds.stacked_batch(4, rng) for _ in range(n)]


# ---------------------------------------------------------------------------
# Residency planning
# ---------------------------------------------------------------------------

def _random_spec(rng):
    d = int(rng.integers(1, 6))
    g = int(rng.integers(1, 5))
    c = d * g
    sizes = tuple(float(x) for x in rng.uniform(0.5, 3.0, c))
    assign = tuple(i // g for i in range(c))
    return (jcore.ClusterSpec(c, assign, sizes), tcore.ClusterSpec(c, assign, sizes), g)


@pytest.mark.parametrize("seed", range(4))
def test_planning_equals_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        jspec, tspec, g = _random_spec(rng)
        mask = rng.random(tspec.num_clients) < 0.5
        slots = int(rng.integers(1, g + 1))
        try:
            want = jstate.plan_residency(jspec, mask, slots)
        except ValueError as err:
            with pytest.raises(ValueError, match=str(err).split(";")[0][:30]):
                tstate.plan_residency(tspec, mask, slots)
            continue
        got = tstate.plan_residency(tspec, mask, slots)
        for f in ("clients", "valid", "slot_cluster"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
        np.testing.assert_array_equal(got.participant_mask(tspec.num_clients),
                                      want.participant_mask(jspec.num_clients))
        w = rng.uniform(0.0, 1.0, tspec.num_clients)
        np.testing.assert_array_equal(tstate.sub_weights(w, got), jstate.sub_weights(w, want))
        ident_j, ident_t = jstate.identity_residency(jspec), tstate.identity_residency(tspec)
        assert ident_t.identity and ident_t.k_max == tspec.num_clients
        for f in ("clients", "valid", "slot_cluster"):
            np.testing.assert_array_equal(getattr(ident_t, f), getattr(ident_j, f))


def test_planning_refuses_what_the_reference_refuses():
    spec = tcore.ClusterSpec.uniform(8, 2)
    with pytest.raises(ValueError, match="no participants"):
        tstate.plan_residency(spec, np.array([True] * 4 + [False] * 4), 2)
    with pytest.raises(ValueError, match="slots"):
        tstate.plan_residency(spec, np.array([1, 1, 1, 0, 1, 0, 0, 0], bool), 2)
    with pytest.raises(ValueError, match="shape"):
        tstate.plan_residency(spec, np.ones(5, dtype=bool), 2)
    with pytest.raises(ValueError, match="k_max"):
        tstate.HostOffloadStore(8, k_max=9)
    with pytest.raises(ValueError, match="mode"):
        tstate.HostOffloadStore(8, mode="gpu")
    with pytest.raises(ValueError, match="cold_init"):
        tstate.HostOffloadStore(8, cold_init="zeros")
    with pytest.raises(ValueError, match="multiple"):
        tstate.HostOffloadStore(8, k_max=6).bind(tcore.ClusterSpec.uniform(8, 4), MnistCNN(),
                                                 0, "cpu")
    sparse = tstate.HostOffloadStore(8, k_max=4)
    sparse.bind(tcore.ClusterSpec.uniform(8, 4), MnistCNN(), 0, "cpu")
    with pytest.raises(ValueError, match="participation"):
        sparse.residency()
    with pytest.raises(KeyError, match="unknown state store"):
        tstate.resolve_store({"kind": "quantum"}, 8)
    with pytest.raises(ValueError, match="covers"):
        tstate.resolve_store(tstate.HostOffloadStore(4), 8)
    assert isinstance(tstate.resolve_store(None, 8), tstate.DenseResidentStore)


# ---------------------------------------------------------------------------
# Host rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spill", [False, True])
def test_host_array_store_roundtrip(tmp_path, spill):
    template = {"w": torch.zeros(3, 2), "b": torch.zeros(5)}
    store = tstate.HostArrayStore(template, spill_dir=str(tmp_path / "s") if spill else None)
    assert store.names == ["b", "w"]  # the checkpoint layer's (JAX's) order
    rng = np.random.default_rng(0)
    rows = {i: [rng.normal(size=5).astype(np.float32), rng.normal(size=(3, 2)).astype(np.float32)]
            for i in (3, 11)}
    for i, leaves in rows.items():
        store.put(i, leaves)
    assert store.keys() == [3, 11] and len(store) == 2
    assert 3 in store and 7 not in store and store.get(7) is None
    for i, leaves in rows.items():
        for a, b in zip(store.get(i), leaves):
            np.testing.assert_array_equal(a, b)
    if spill:  # a spilled row is a record of the reference's checkpoint layer
        for a, b in zip(jload_leaves(os.path.join(str(tmp_path / "s"), "client_00000003.npz")),
                        rows[3]):
            np.testing.assert_array_equal(a, b)
    else:
        assert store.nbytes() == sum(x.nbytes for ls in rows.values() for x in ls)


# ---------------------------------------------------------------------------
# Identity offload against the port's dense store
# ---------------------------------------------------------------------------

def _client_rows(sched, c):
    """Client ``c``'s leaves in the store's (checkpoint) order."""
    if sched.store.resident:
        names = sorted(sched.params)
        return [sched.params[k][c].numpy() for k in names]
    return sched.store.state_of(c)


@pytest.mark.parametrize("scheduler,backend", [
    ("sync", "cuda"), ("sync", "dense"), ("sync", "collective"), ("round", "cuda"),
    ("round", "dense"), ("round", "collective")])
def test_identity_offload_equals_dense_store(fed_data, scheduler, backend):
    batches = _batches(fed_data, 8)
    kw = dict(tau1=2, tau2=1, alpha=1, backend=backend)
    if scheduler == "round":
        kw["rounds_per_step"] = 2
    steps = 4 if scheduler == "sync" else 2
    scheds = []
    for store in (None, {"kind": "host-offload"}):
        rt = tcore.make_run(_config(fed_data, scheduler, store=store,
                                    latency=tcore.MNIST_LATENCY, **kw), device="cpu")
        assert (store is not None) == (rt.scheduler.params is getattr(rt.scheduler.store,
                                                                      "buffer", None))
        for _ in range(steps):
            rt.step(lambda k: batches[(k - 1) % len(batches)])
        scheds.append(rt.scheduler)
    dense, off = scheds
    assert isinstance(dense.store, tstate.DenseResidentStore)
    assert off.store.kind == "host-offload" and off.store.k_max == C
    for c in range(C):
        for a, b in zip(_client_rows(dense, c), _client_rows(off, c)):
            np.testing.assert_array_equal(a, b)
    gd, go = dense.global_params(), off.global_params()
    for k in gd:
        np.testing.assert_allclose(gd[k].float().numpy(), go[k].numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_identity_offload_equals_dense_store_async(fed_data, backend):
    from repro_torch.data import ClientBatcher

    ys = []
    for store in (None, {"kind": "host-offload"}):
        rt = tcore.make_run(_config(fed_data, "async", store=store, backend=backend,
                                    theta_max=3), device="cpu")
        batcher = ClientBatcher(fed_data, 4, seed=0)
        for _ in range(4):
            rt.step(batcher)
        ys.append(rt.scheduler)
    dense, off = ys
    assert off.store.kind == "host-offload"
    for k, y in dense.y.items():
        assert torch.equal(y, off.y[k]), k
        assert torch.equal(y, off.store.cluster_models[k]), k
    for k, g in dense.global_params().items():
        np.testing.assert_allclose(g.numpy(), off.global_params()[k].numpy(), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# Sparse offload against the reference's sparse offload
# ---------------------------------------------------------------------------

def _jax_run(ds, scheduler, store, participation, **kw):
    cfg = {"scheduler": scheduler, "model": jmodels.MnistCNN(),
           "seed": 0, "store": store, "participation": participation,
           "learning_rate": 0.05, **kw}
    if scheduler == "round":
        cfg.update(num_clients=C, num_clusters=D)
    else:
        cfg["clusters"] = _spec(ds, jcore)
    return jcore.make_run(cfg)


def _carry_store(jsched, tsched):
    st = jsched.store
    rows = {c: st._host.get(c) for c in st._host.keys()} if st.mode == "client" else None
    store_from_numpy(tsched.store, jax.tree.map(np.asarray, st.cluster_models), rows)


def _hold_stores(jsched, tsched, tol):
    jst, tst = jsched.store, tsched.store
    for k, y in tst.cluster_models.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jst.cluster_models[k]), atol=tol, rtol=0)
    for c in range(C):
        for a, b in zip(tst.state_of(c), jst.state_of(c)):
            np.testing.assert_allclose(a, np.asarray(b), atol=tol, rtol=0)
    jg, tg = jsched.global_params(), tsched.global_params()
    for k, v in tg.items():
        np.testing.assert_allclose(v.numpy(), np.asarray(jg[k]), atol=tol, rtol=0)


@pytest.mark.parametrize("scheduler", ["sync", "round"])
@pytest.mark.parametrize("mode", ["cluster", "client"])
def test_sparse_offload_matches_reference(fed_data, scheduler, mode):
    """10 iterations of uniform-k (k = 1 of each cluster's 2) on 4 slots.

    The reference runs without prefetch: with it, a client-mode round
    scheduler stages a client's stored row two supersteps ahead, before the
    superstep between has scattered it, and trains on the stale row (a
    reference fault, ``ROADMAP.md`` §3).  The port stages ahead (its
    default) and leaves every client of a superstep not yet scattered to
    ``gather``, so it matches the reference's unstaged run."""
    batches = _batches(fed_data, 10)
    store = {"kind": "host-offload", "k_max": 4, "mode": mode}
    kw = dict(tau1=2, tau2=1, alpha=1, latency=jcore.MNIST_LATENCY)
    jr = _jax_run(fed_data, scheduler, store, UNIFORM_K, prefetch=False, **kw)
    tr = tcore.make_run(_config(fed_data, scheduler, store=dict(store), participation=UNIFORM_K,
                                backend="cuda", **dict(kw, latency=tcore.MNIST_LATENCY)),
                        device="cpu")
    _carry_store(jr.scheduler, tr.scheduler)
    src = lambda k: batches[(k - 1) % len(batches)]
    steps = 10 if scheduler == "sync" else 5
    for _ in range(steps):
        je, te = jr.step(src), tr.step(src)
        assert (je.kind, je.iteration) == (te.kind, te.iteration)
        assert abs(je.dt - te.dt) <= 1e-9
        if scheduler == "sync" and te.kind == "local":
            # mid-round: the consensus from the residents' live buffer
            jg, tg = jr.global_params(), tr.global_params()
            for k, v in tg.items():
                np.testing.assert_allclose(v.numpy(), np.asarray(jg[k]), atol=1e-4, rtol=0)
    assert abs(jr.clock - tr.clock) <= 1e-9
    _hold_stores(jr.scheduler, tr.scheduler, 1e-4)
    if mode == "client":
        assert tr.scheduler.store._host.keys() == jr.scheduler.store._host.keys()


def test_sync_advance_equals_step_under_offload(fed_data):
    """``advance`` (a given full-fleet batch, no prefetch) slices the resident
    slots' rows and stages the round's weights as ``step`` does."""
    batches = _batches(fed_data, 6)
    runs = [tcore.make_run(_config(fed_data, "sync", store={"kind": "host-offload", "k_max": 4},
                                   participation=UNIFORM_K, tau1=2, backend="cuda"),
                           device="cpu") for _ in range(2)]
    for k in range(1, 7):
        runs[0].step(lambda i: batches[i - 1])
        assert runs[1].scheduler.advance(k, batches[k - 1]) == runs[0].scheduler.cfg.event_at(k)
    for k, y in runs[0].scheduler.store.cluster_models.items():
        assert torch.equal(y, runs[1].scheduler.store.cluster_models[k]), k


def test_million_client_ring_matches_reference_at_a_thousand_clients():
    """The registered scenario cut to 10^3 clients (k_max 32 of them), 5
    supersteps of round (2 iterations each) on the procedural batches."""
    kw = dict(num_clients=1000)
    jr = jscenarios.build_scenario("million-client-ring", **kw)
    tr = tscenarios.build_scenario("million-client-ring", device="cpu", backend="cuda", **kw)
    _carry_store(jr.runtime.scheduler, tr.runtime.scheduler)
    jsrc, tsrc = jr.batch_source(), tr.batch_source()
    for _ in range(5):
        je, te = jr.runtime.step(jsrc), tr.runtime.step(tsrc)
        np.testing.assert_allclose(te.losses.numpy(), np.asarray(je.losses), atol=1e-4, rtol=0)
        assert abs(je.dt - te.dt) <= 1e-9
        np.testing.assert_array_equal(tr.runtime.scheduler._residency_for_step(te.iteration // 2)
                                      .clients, jr.runtime.scheduler._res_cache[1].clients)
    for k, y in tr.runtime.scheduler.store.cluster_models.items():
        np.testing.assert_allclose(
            y.numpy(), np.asarray(jr.runtime.scheduler.store.cluster_models[k]), atol=1e-4, rtol=0)
    jl, _ = jr.runtime.evaluate(jr.eval_batch)
    tl, _ = tr.runtime.evaluate(tr.eval_batch)
    assert abs(jl - tl) <= 1e-4 * abs(jl)


def test_procedural_batches_equal_reference():
    from repro.data import ProceduralFederated as J
    from repro_torch.data import ProceduralFederated as T

    j, t = J(1000, batch_size=4, seed=3), T(1000, batch_size=4, seed=3)
    clients = np.array([5, 999, 0, 5])
    for got, want in [(t(k, clients=clients), j(k, clients=clients)) for k in (0, 7)] + [
            (t.next_batch(17), j.next_batch(17)), (t.next_batch(17), j.next_batch(17)),
            (t.eval_batch(64), j.eval_batch(64))]:
        for key, v in got.items():
            np.testing.assert_array_equal(v, want[key])
    assert t.supports_clients and len(t.data_sizes()) == 1000


# ---------------------------------------------------------------------------
# Client mode
# ---------------------------------------------------------------------------

def test_client_mode_persists_participants_and_spills(fed_data, tmp_path):
    rt = tcore.make_run(_config(
        fed_data, "round", participation=UNIFORM_K, tau1=2, tau2=1, backend="cuda",
        store={"kind": "host-offload", "k_max": 4, "mode": "client",
               "spill_dir": str(tmp_path / "state")}), device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        rt.step(lambda k: fed_data.stacked_batch(4, rng))
    sched = rt.scheduler
    store = sched.store
    warm = store._host.keys()
    drawn = set()
    for k in (1, 2, 3):
        res = sched._residency_for_step(k)
        drawn |= set(res.clients[res.valid].tolist())
    assert warm == sorted(drawn)  # exactly the participants were persisted
    assert sorted(os.listdir(tmp_path / "state")) == [f"client_{c:08d}.npz" for c in warm]
    last = sched._residency_for_step(3)
    for s in np.flatnonzero(last.valid):  # the last superstep's rows are the buffer's
        c = int(last.clients[s])
        for name, leaf in zip(store._names, store._host.get(c)):
            np.testing.assert_array_equal(leaf, store.buffer[name][s].numpy())
    for v in store.global_params().values():
        assert bool(torch.isfinite(v).all())


@pytest.mark.parametrize("cold_init", ["cluster", "initial"])
def test_scatter_keeps_non_participants(cold_init):
    """For random masks with 1..g participants a cluster: gather, "train"
    (+1), scatter writes exactly the participants' host rows."""
    n, d, g = 8, 2, 2
    store = tstate.HostOffloadStore(n, k_max=d * g, mode="client", cold_init=cold_init)
    store.bind(tcore.ClusterSpec.uniform(n, d), MnistCNN(), 0, "cpu")
    rng = np.random.default_rng(0)
    shapes = [store.buffer[k].shape[1:] for k in store._names]
    for c in range(n):
        store._host.put(c, [rng.normal(size=s).astype(np.float32) for s in shapes])
    for _ in range(10):
        before = {c: [x.copy() for x in store._host.get(c)] for c in range(n)}
        mask = np.zeros(n, dtype=bool)
        for j in range(d):
            members = rng.permutation(np.arange(j * n // d, (j + 1) * n // d))
            mask[members[:rng.integers(1, g + 1)]] = True
        res = store.residency(mask)
        staged = store.stage(res)
        buf = store.gather(res, {k: torch.as_tensor(v) for k, v in staged.items()})
        for v in buf.values():
            v.add_(1.0)
        store.scatter(res, buf)
        for c in range(n):
            for a, b in zip(store._host.get(c), before[c]):
                np.testing.assert_array_equal(a, b + 1.0 if mask[c] else b)


# ---------------------------------------------------------------------------
# Refusals, the million-client lane, and the captured body
# ---------------------------------------------------------------------------

def test_offload_refuses_faults_short_async_stores_and_cluster_params(fed_data):
    faults = [{"kind": "link-down", "round": 1, "link": [0, 1]}]
    for scheduler in ("sync", "round"):
        with pytest.raises(ValueError, match="fault injection requires a resident"):
            tcore.make_run(_config(fed_data, scheduler, store="host-offload", faults=faults),
                           device="cpu")
        run = tcore.make_run(_config(fed_data, scheduler, store="host-offload"), device="cpu")
        with pytest.raises(NotImplementedError, match="resident client-state store"):
            run.cluster_params()
    with pytest.raises(ValueError, match="must cover all 4 clusters"):
        tcore.make_run(_config(fed_data, "async", store={"kind": "host-offload", "k_max": 2}),
                       device="cpu")


def test_million_client_ring_at_its_registered_size():
    """One superstep at N = 10^6 on the CPU; the store's device bytes are
    those of N = 10^3 (32 slots and 8 cluster models)."""
    stores = {}
    for n in (1000, None):
        kw = {} if n is None else {"num_clients": n}
        run = tscenarios.build_scenario("million-client-ring", device="cpu", **kw)
        ev = run.runtime.step(run.batch_source())
        assert ev.kind == "round" and ev.losses.shape == (2,)
        assert bool(torch.isfinite(ev.losses).all())
        stores[n] = run.runtime.scheduler.store
    big = stores[None]
    assert big.num_clients == 1_000_000 and big.k_max == 32
    assert big.sub_clusters.num_clients == 32
    assert tstate.live_device_bytes(big) == big.device_bytes() == stores[1000].device_bytes()
    mnist = sum(p.numel() for p in MnistCNN().init(torch.Generator()).values())
    assert big.device_bytes() == (32 + 8) * mnist * 4


@pytest.mark.parametrize("scheduler,kw", [
    ("sync", {}),                                   # 10^6 clients, 32 slots
    ("round", {"num_clients": 64}),
    ("async", {"num_clients": 64, "theta_max": 2, "store": "host-offload"}),
])
def test_million_client_ring_runs_every_scheduler(scheduler, kw):
    """The scenario's store on every scheduler: sync at the registered 10^6
    clients (an inter event at iteration 2), round, and async, whose state
    is per cluster (a store of D pseudo-clients)."""
    run = tscenarios.build_scenario("million-client-ring", device="cpu", scheduler=scheduler,
                                    **kw)
    sched, src = run.runtime.scheduler, run.batch_source()
    assert sched.name == scheduler and sched.store.kind == "host-offload"
    kinds = [run.runtime.step(src).kind for _ in range(2)]
    assert kinds == {"sync": ["local", "inter"], "round": ["round", "round"],
                     "async": ["cluster", "cluster"]}[scheduler]
    for v in run.runtime.global_params().values():
        assert bool(torch.isfinite(v).all())
    assert sched.store.device_bytes() <= 40 * 21840 * 4


def test_offload_graph_body_keeps_one_key(fed_data):
    """The captured step's body on the CPU: the round and sync schedulers
    step the store's buffer in place through the graphs' static buffers; its
    addresses never change, so one graph key serves every residency, and the
    run equals the eager run bit for bit."""
    batches = _batches(fed_data, 12)
    src = lambda k: batches[(k - 1) % len(batches)]
    store = {"kind": "host-offload", "k_max": 4}
    for scheduler, steps in (("round", 4), ("sync", 8)):
        runs = []
        for graphed in (False, True):
            rt = tcore.make_run(_config(fed_data, scheduler, store=dict(store), tau1=2,
                                        participation=UNIFORM_K, backend="cuda"), device="cpu")
            sched = rt.scheduler
            if graphed:
                if scheduler == "round":
                    sched._graph = sched._build_graph()
                else:
                    sched._graphs = sched._build_graphs()
            ptrs = {k: v.data_ptr() for k, v in sched.params.items()}
            for _ in range(steps):
                rt.step(src)
            assert {k: v.data_ptr() for k, v in sched.params.items()} == ptrs
            runs.append(sched)
        eager, graphed = runs
        res_of = (eager._residency_for_step if scheduler == "round"
                  else eager._residency_for_round)
        drawn = {tuple(res_of(i).clients) for i in range(1, 5)}
        assert len(drawn) > 1  # the residents changed
        graphs = [graphed._graph] if scheduler == "round" else graphed._graphs.values()
        assert sorted(len(g._entries) for g in graphs)[-1] == 1  # one key a graph used
        assert all(len(g._entries) <= 1 for g in graphs)
        for k, y in eager.store.cluster_models.items():
            assert torch.equal(y, graphed.store.cluster_models[k]), (scheduler, k)
