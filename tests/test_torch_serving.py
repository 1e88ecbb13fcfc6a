"""Port parity: the serving engines (``repro_torch.serving``).

* **Scenarios.** ``federated-lm-serving`` and ``lm-serving-continuous`` at a
  tiny width (2 layers, d_model 32, f32), trained two round supersteps by
  the reference and by the port from the reference's initial weights, then
  served a Zipf per-cluster trace (numpy, the same in both packages) at
  temperature 0 by each of the four servers (``BatchServer`` and
  ``ContinuousServer`` on the consensus model, ``FederatedServer`` and
  ``ContinuousFederatedServer`` on the clusters' models): token for token
  the reference's, completion order included, and so are ``ServeStats``'
  deterministic counts (requests, batches, tokens, decode steps, occupancy
  sum).
* **The chunk's captured body** (``_chunk_p.graphed = _build_graph()``, run
  eagerly over the graph's static state on the CPU) equals the eager chunk,
  with one program for every admission pattern and length bucket; so does
  the static engine's per-batch decode step through a ``GraphedStep``.
* **Behaviour.** Hot swap (in-flight requests finish on the old weights,
  new ones match a fresh server on the published weights; the static engine
  flips at the batch boundary), non-finite and misshapen publishes rejected,
  the ``gen_cap`` and prompt-length guards, the reorder window, freed slots
  never leaking stale KV (each request's tokens are its solo run's),
  sampling at temperature > 0 following the seed.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import repro.scenarios as jscenarios
import repro.serving as jserving
import repro_torch.scenarios as tscenarios
import repro_torch.serving as tserving
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.models import CausalLM
from repro_torch.models.config import ArchConfig
from repro_torch.serving import (
    BatchServer, ContinuousFederatedServer, ContinuousServer, FederatedServer, Request,
)

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16,
            dtype="float32", remat=False)
BUCKETS = (16, 32, 64)
GEN = 12
STATS = ("requests", "batches", "tokens_generated", "decode_steps", "occupancy_sum")


# -- the scenarios, against the reference -------------------------------------------

@functools.lru_cache(maxsize=None)
def _trained(name):
    """(reference run, port run), both trained 2 supersteps from the
    reference's initial weights."""
    jrun = jscenarios.build_scenario(name, arch_overrides=TINY, seed=0)
    init = flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))
    jrun.run(2)
    trun = tscenarios.build_scenario(name, device="cpu", backend="cuda", seed=0,
                                     arch_overrides=dict(TINY, attn_impl="cuda"))
    trun.runtime.scheduler.params = params_from_numpy(init, "cpu")
    trun.run(2)
    return jrun, trun


def _server(package, kind, run):
    mod = jserving if package == "jax" else tserving
    model = run.runtime.model
    if kind == "static":
        return mod.BatchServer(model, _consensus(package, run), max_batch=8,
                               length_buckets=BUCKETS)
    if kind == "continuous":
        return mod.ContinuousServer(model, _consensus(package, run), max_batch=8,
                                    length_buckets=BUCKETS, gen_cap=GEN)
    if kind == "federated":
        return mod.FederatedServer(model, runtime=run.runtime, max_batch=8,
                                   length_buckets=BUCKETS)
    return mod.ContinuousFederatedServer(model, runtime=run.runtime, max_batch=8,
                                         length_buckets=BUCKETS, gen_cap=GEN)


def _consensus(package, run):
    g = run.runtime.global_params()
    return g if package == "jax" else {k: v.clone() for k, v in g.items()}


def _trace(package, run, continuous):
    mod = jserving if package == "jax" else tserving
    budgets = (1, GEN) if continuous else GEN
    return mod.synthetic_trace(run.dataset, num_requests=16, prompt_lens=(8, 16),
                               max_new_tokens=budgets, seed=0)


@pytest.mark.parametrize("kind", ["static", "continuous", "federated", "continuous-federated"])
@pytest.mark.parametrize("name", ["federated-lm-serving", "lm-serving-continuous"])
def test_servers_token_for_token_the_reference(name, kind):
    jrun, trun = _trained(name)
    continuous = kind.startswith("continuous")
    out = {}
    for package, run in (("jax", jrun), ("torch", trun)):
        srv = _server(package, kind, run)
        for req in _trace(package, run, continuous):
            srv.submit(req)
        done = srv.run()
        out[package] = ([(r.uid, np.asarray(r.output).tolist()) for r in done],
                        {f: getattr(srv.stats, f) for f in STATS})
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == pytest.approx(out["jax"][1], abs=1e-9)
    assert out["torch"][1]["decode_steps"] > 0


def test_serve_scenario_runs_both_engines():
    from repro_torch.launch.serve import serve_scenario

    for continuous in (False, True):
        name = "lm-serving-continuous" if continuous else "federated-lm-serving"
        srv, done, hist = serve_scenario(name, train_steps=1, requests=6, gen=4,
                                         arch_overrides=TINY, device="cpu",
                                         continuous=continuous)
        assert len(done) == 6 and srv.stats.requests == 6 and len(hist.loss) == 1
        assert all(1 <= r.output.size <= 4 and int(r.output.max()) < 32 for r in done)
        assert isinstance(srv, ContinuousFederatedServer if continuous else FederatedServer)


# -- a tiny model for the engine's behaviour ------------------------------------------

CACHE_BUCKETS = (8, 16)
GEN_CAP = 10


@functools.lru_cache(maxsize=None)
def _tiny():
    cfg = ArchConfig(name="test-cont", family="dense", num_layers=2, d_model=32, d_ff=64,
                     vocab_size=64, num_heads=2, num_kv_heads=1, head_dim=16,
                     dtype="float32", remat=False, attn_chunk=16, tie_embeddings=True)
    model = CausalLM(cfg)
    replicas = [model.init(torch.Generator().manual_seed(s)) for s in range(3)]
    stack = {k: torch.stack([r[k] for r in replicas]) for k in replicas[0]}
    return cfg, model, replicas, stack


def _reqs(n, *, base=0, clusters=None, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(3, CACHE_BUCKETS[-1] + 1))
        out.append(Request(uid=base + i, prompt=rng.integers(0, 64, plen).astype(np.int32),
                           max_new_tokens=int(rng.integers(1, GEN_CAP + 1)),
                           eos_id=int(rng.integers(0, 64)),
                           cluster_id=None if clusters is None else int(rng.integers(0, clusters))))
    return out


def _fresh(reqs):
    return [dataclasses.replace(r, output=None) for r in reqs]


def _serve(server, reqs):
    for r in reqs:
        server.submit(r)
    server.run()
    return {r.uid: r.output.tolist() for r in reqs}


def _solo(model, params, reqs):
    """Each request served alone at the slot pool's cache length."""
    out = {}
    for r in _fresh(reqs):
        srv = BatchServer(model, params, max_batch=1, length_buckets=CACHE_BUCKETS,
                          cache_len=CACHE_BUCKETS[-1] + GEN_CAP)
        out.update(_serve(srv, [r]))
    return out


def test_freed_slots_never_leak_stale_kv():
    """More requests than slots, mixed buckets and budgets, mid-decode
    admission into freed slots: every request's tokens are its solo run's."""
    _, model, replicas, _ = _tiny()
    reqs = _reqs(11, seed=1)
    srv = ContinuousServer(model, replicas[0], max_batch=3, length_buckets=CACHE_BUCKETS,
                           gen_cap=GEN_CAP, chunk_steps=3)
    got = _serve(srv, _fresh(reqs))
    assert got == _solo(model, replicas[0], reqs)
    assert srv.compile_counts() == {"prefill": 2, "admit": 2, "decode": 1}
    assert srv.stats.requests == 11 and 0 < srv.stats.mean_occupancy <= 1


def test_chunk_graph_body_equals_eager():
    """The decode chunk through ``GraphedStep`` (its captured body, eager on
    the CPU over the same state) against the eager chunk: the same tokens,
    counts and pool, one program across admissions and buckets."""
    _, model, _, stack = _tiny()
    reqs = _reqs(9, clusters=3, seed=2)
    runs = {}
    for graphed in (False, True):
        srv = ContinuousFederatedServer(model, stack, max_batch=4,
                                        length_buckets=CACHE_BUCKETS, gen_cap=GEN_CAP,
                                        chunk_steps=4)
        if graphed:
            srv._chunk_p.graphed = srv._chunk_p._build_graph()
        runs[graphed] = (_serve(srv, _fresh(reqs)), srv)
    assert runs[True][0] == runs[False][0]
    eager, graph = runs[False][1], runs[True][1]
    for k, v in eager._state["cache"].items():
        assert torch.equal(v, graph._state["cache"][k]), k
    assert graph._chunk_p.graphed is not None and graph.compile_counts()["decode"] == 1
    assert {f: getattr(graph.stats, f) for f in STATS} == {f: getattr(eager.stats, f)
                                                           for f in STATS}


def test_static_decode_graph_body_equals_eager():
    """The static engine's per-batch decode step through ``GraphedStep`` (its
    captured body, eager on the CPU over static buffers) against the plain
    eager step: the same tokens and counts."""
    from repro_torch.core.cuda_graph import GraphedStep

    _, model, _, stack = _tiny()
    reqs = _reqs(9, clusters=3, seed=8)
    runs = []
    for graphed in (False, True):
        srv = FederatedServer(model, stack, max_batch=3, length_buckets=CACHE_BUCKETS)
        assert srv._decode_graph is None  # off on the CPU
        if graphed:
            srv._decode_graph = GraphedStep(srv._decode_body, lambda s=srv: s._decode_state,
                                            "cpu")
        runs.append((_serve(srv, _fresh(reqs)), {f: getattr(srv.stats, f) for f in STATS}))
        if graphed:
            assert len(srv._decode_graph._entries) == 1  # the last batch's key alone
    assert runs[0] == runs[1]


def test_state_stops_changing_once_every_slot_is_done():
    _, model, replicas, _ = _tiny()
    srv = ContinuousServer(model, replicas[0], max_batch=2, length_buckets=CACHE_BUCKETS,
                           gen_cap=GEN_CAP, chunk_steps=8)
    srv.submit(Request(uid=0, prompt=np.arange(5, dtype=np.int32), max_new_tokens=2))
    srv.step()  # the request finishes in the chunk's second step
    assert int(srv._state["steps"]) == 2 and int(srv._state["active_steps"]) == 2
    before = {k: v.clone() for k, v in srv._state["cache"].items()}
    srv._chunk_p(srv._weights(), srv._state)
    assert int(srv._state["steps"]) == 2
    assert all(torch.equal(v, before[k]) for k, v in srv._state["cache"].items())


def test_continuous_hot_swap_keeps_in_flight_tokens():
    _, model, replicas, stack = _tiny()
    new_stack = {k: v.flip(0).clone() for k, v in stack.items()}
    first = _reqs(3, clusters=3, seed=3)
    later = _reqs(4, base=100, clusters=3, seed=4)
    for r in first:
        r.max_new_tokens, r.eos_id = GEN_CAP, None  # still decoding at the publish
    srv = ContinuousFederatedServer(model, stack, max_batch=4, length_buckets=CACHE_BUCKETS,
                                    gen_cap=GEN_CAP, chunk_steps=2)
    inflight = _fresh(first)
    for r in inflight:
        srv.submit(r)
    srv.step()
    srv.publish(new_stack)
    fresh_later = _fresh(later)
    for r in fresh_later:
        srv.submit(r)
    srv.run()
    assert srv.swaps == 1
    old = ContinuousFederatedServer(model, stack, max_batch=4, length_buckets=CACHE_BUCKETS,
                                    gen_cap=GEN_CAP, chunk_steps=2)
    assert {r.uid: r.output.tolist() for r in inflight} == _serve(old, _fresh(first))
    new = ContinuousFederatedServer(model, new_stack, max_batch=4,
                                    length_buckets=CACHE_BUCKETS, gen_cap=GEN_CAP,
                                    chunk_steps=2)
    assert {r.uid: r.output.tolist() for r in fresh_later} == _serve(new, _fresh(later))
    for k, v in srv.active_params.items():
        assert torch.equal(v, new_stack[k])


def test_static_hot_swap_at_the_batch_boundary():
    _, model, replicas, stack = _tiny()
    srv = FederatedServer(model, stack, max_batch=4, length_buckets=CACHE_BUCKETS)
    reqs = _reqs(4, clusters=3, seed=5)
    before = _serve(srv, _fresh(reqs))
    ptrs = {k: v.data_ptr() for k, v in srv.active_params.items()}
    new_stack = {k: v.flip(0).clone() for k, v in stack.items()}
    srv.publish(new_stack)
    assert srv.swaps == 0  # staged, not yet flipped
    after = _serve(srv, _fresh(reqs))
    assert srv.swaps == 1 and after != before
    assert after == _serve(FederatedServer(model, new_stack, max_batch=4,
                                           length_buckets=CACHE_BUCKETS), _fresh(reqs))
    # the flip copied into the served tensors: their addresses never change
    assert {k: v.data_ptr() for k, v in srv.active_params.items()} == ptrs


def test_rejected_publishes_keep_last_good_weights():
    _, model, _, stack = _tiny()
    srv = ContinuousFederatedServer(model, stack, max_batch=2, length_buckets=CACHE_BUCKETS,
                                    gen_cap=GEN_CAP)
    bad = {k: v.clone() for k, v in stack.items()}
    bad["embed"][1, 0, 0] = float("nan")
    with pytest.raises(ValueError, match="non-finite"):
        srv.publish(bad)
    with pytest.raises(ValueError, match="clusters"):
        srv.publish({k: v[:2] for k, v in stack.items()})

    class Dying:
        def cluster_params(self):
            raise RuntimeError("training source died mid-round")

    class Poisoned:
        def cluster_params(self):
            return bad

    assert not srv.sync_from(Dying()) and not srv.sync_from(Poisoned())
    assert srv.rejected == 2 and not srv._buf.pending and srv.swaps == 0
    for k, v in srv.active_params.items():
        assert torch.equal(v, stack[k])
    with pytest.raises(ValueError, match="no runtime"):
        srv.sync_from()


def test_guards_at_submit():
    _, model, replicas, stack = _tiny()
    cont = ContinuousServer(model, replicas[0], max_batch=2, length_buckets=CACHE_BUCKETS,
                            gen_cap=GEN_CAP)
    with pytest.raises(ValueError, match="gen_cap"):
        cont.submit(Request(uid=0, prompt=np.arange(4, dtype=np.int32),
                            max_new_tokens=GEN_CAP + 1))
    with pytest.raises(ValueError, match="largest length bucket"):
        cont.submit(Request(uid=1, prompt=np.arange(17, dtype=np.int32), max_new_tokens=2))
    fed = FederatedServer(model, stack, length_buckets=CACHE_BUCKETS)
    with pytest.raises(ValueError, match="cluster_id"):
        fed.submit(Request(uid=2, prompt=np.arange(4, dtype=np.int32)))
    with pytest.raises(ValueError, match="out of range"):
        fed.submit(Request(uid=3, prompt=np.arange(4, dtype=np.int32), cluster_id=3))
    with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
        ContinuousFederatedServer(model, stack, mesh="everywhere")
    assert cont.pending() == 0


def test_reorder_window_serves_the_fuller_bucket_first():
    _, model, replicas, _ = _tiny()
    srv = BatchServer(model, replicas[0], max_batch=3, length_buckets=CACHE_BUCKETS,
                      max_head_skips=1)
    long = Request(uid=0, prompt=np.arange(14, dtype=np.int32), max_new_tokens=1)
    shorts = [Request(uid=i, prompt=np.arange(5, dtype=np.int32) + i, max_new_tokens=1)
              for i in range(1, 7)]
    for r in [long] + shorts:
        srv.submit(r)
    order = [[r.uid for r in srv._run_batch(srv._next_batch())] for _ in range(3)]
    # the short bucket fills a batch first; after one skip the head is forced
    assert order == [[1, 2, 3], [0], [4, 5, 6]]


def test_sampling_follows_the_seed():
    _, model, replicas, _ = _tiny()
    reqs = [dataclasses.replace(r, eos_id=None) for r in _reqs(5, seed=6)]
    outs = []
    for seed in (7, 7, 8):
        srv = ContinuousServer(model, replicas[0], max_batch=2, length_buckets=CACHE_BUCKETS,
                               gen_cap=GEN_CAP, temperature=1.0, seed=seed)
        outs.append(_serve(srv, _fresh(reqs)))
    assert outs[0] == outs[1] and outs[0] != outs[2]
    static = [_serve(BatchServer(model, replicas[0], max_batch=2, length_buckets=CACHE_BUCKETS,
                                 temperature=1.0, seed=s), _fresh(reqs)) for s in (7, 7)]
    assert static[0] == static[1]
