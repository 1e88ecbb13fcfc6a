"""Port parity: CUDA graphs on a client mesh and a cluster mesh ('graphs on a mesh').

On a mesh ``graph`` resolves as off it, by the rank's device: a CUDA rank
replays the sync scheduler's event steps, the round scheduler's superstep
and the mesh server's decode chunk from CUDA graphs, their process-group
exchanges captured inside.  On the CPU a ``GraphedStep`` runs its body
eagerly over its static input buffers, so the captured bodies are reached
as ``tests/test_torch_graph.py`` reaches them (``sched._graphs =
sched._build_graphs()``, ``sched._graph = sched._build_graph()``, the
server's ``_chunk_p.graphed = _chunk_p._build_graph()``) and held in
``gloo`` worlds started with ``tests/test_torch_mesh.py``'s launcher (one
intra-op thread a rank, timeouts on the group's init and on every process):

* ``graphs8`` (8 ranks, one client a rank, the collective backend): the
  captured sync body over 10 iterations and the round body over 2
  supersteps, then both again with participation (uniform-k) and faults
  (``chaos-ring``), so that the weights and mixing operands flow through
  the static buffers; each bitwise the eager mesh run on the same rank and
  within 1e-4 of JAX's run from JAX's initial weights (carried to each
  rank's row by ``repro_torch.convert``).  Then a host-offload store
  sampled over 16 clients into 8 slots, sync and round, 4 rounds each:
  every rank's ``params`` leaves keep their ``data_ptr()`` in every round,
  each step keeps one graph key, and the results are bitwise the eager
  mesh run's and within 1e-6 of the same run off the mesh (the one-process
  emulation on the stacked slot axis, whose gather is the store's buffer
  itself): each rank's row against its slot of that buffer, the loss trace
  and the consensus.  The residents change from round to round, so a load
  that copies nothing, or the wrong slot, fails there.
* ``serve4`` (D = 4 ranks, one cluster replica a rank, the reference's
  ``check_continuous_mesh_serving`` setting of
  ``tests/test_torch_serving_mesh.py``, a hot swap between two request
  waves): the graphed chunk body is bitwise the eager chunk (tokens and
  the whole slot pool), its tokens equal JAX's, and every rank warms up,
  captures and replays at the same calls: its chunk keys have the same
  shapes and change at the same calls as every other rank's.

Past one rank only these CPU bodies are held; on the card one NCCL rank
captures the exchanges (``tests/test_torch_cuda.py -k mesh``,
``chip_smoke.py``'s ``mesh`` and ``mesh-serve`` phases).
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh import _rank_main, _results, _start_world  # noqa: E402
from test_torch_serving_mesh import (  # noqa: E402
    ARCH, SERVER, _jax_stacks, _requests, _serve_jax, _stacks,
)

C, D = 8, 4
_SYNC = dict(num_clients=C, num_clusters=D, tau1=2, tau2=1)
# a 16-client fleet sampled 2 a cluster into an 8-slot store: the mesh spans the slots
_OFFLOAD = dict(num_clients=16, num_clusters=D, participation={"strategy": "uniform-k", "k": 2},
                store={"kind": "host-offload", "k_max": C})
# (scenario, overrides, steps)
RUNS = {
    "sync": ("mnist-iid-ring", _SYNC, 10),
    "round": ("round-compiled-ring", dict(tau2=1, rounds_per_step=2), 2),
    "sync-participation": ("mnist-iid-ring", dict(
        _SYNC, participation={"strategy": "uniform-k", "k": 1}), 10),
    "round-faults": ("chaos-ring", dict(rounds_per_step=2), 3),
    "sync-offload": ("mnist-iid-ring", dict(_SYNC, **_OFFLOAD), 8),
    "round-offload": ("round-compiled-ring", dict(tau2=1, **_OFFLOAD), 4),
}
OFFLOAD = ("sync-offload", "round-offload")
RUN_KW = dict(num_samples=400, batch_size=2)


# -- the ranks ------------------------------------------------------------------

def _mesh_run(name: str, graphed: bool, init, mesh="auto") -> dict:
    """One ``RUNS`` case on this rank's client mesh (``mesh=None``: off the
    mesh, the stacked emulation), eager or through the captured body: its
    loss trace, the rank's row (off the mesh the whole stack), the
    consensus, the ``params`` leaves' addresses after every step and the
    graph keys held."""
    import repro_torch.scenarios as tscenarios
    from repro_torch.convert import params_from_numpy, params_to_numpy

    scenario, kw, steps = RUNS[name]
    run = tscenarios.build_scenario(scenario, device="cpu", backend="collective", mesh=mesh,
                                    **RUN_KW, **kw)
    sched = run.runtime.scheduler
    assert sched.backend.name == "collective"
    assert sched.mesh is None if mesh is None else sched.mesh.size == C
    if init is not None:  # JAX's initial weights: this rank's row
        i = sched.mesh.index
        sched.params = params_from_numpy({k: v[i:i + 1] for k, v in init.items()}, "cpu")
    if graphed:
        if sched.name == "sync":
            sched._graphs = sched._build_graphs()
        else:
            sched._graph = sched._build_graph()
    src, trace, addresses, residents = run.batch_source(), [], [], []
    for k in range(1, steps + 1):
        ev = run.runtime.step(src)
        if ev.losses is not None:
            trace.append(ev.losses.numpy().copy())
        if sched.name == "sync" and k % 5 == 0:
            trace.append(np.asarray([run.runtime.evaluate(run.eval_batch)[0]]))
        addresses.append(tuple(v.data_ptr() for v in sched.params.values()))
        if not sched.store.resident:  # the clients in the store's slots
            res = sched._res if sched.name == "sync" else sched._residency_for_step(k)
            residents.append(tuple(res.clients.tolist()))
    if not graphed:
        keys = None
    elif sched.name == "sync":
        keys = {e: len(g._entries) for e, g in sched._graphs.items()}
    else:
        keys = len(sched._graph._entries)
    return {"trace": np.concatenate(trace), "row": params_to_numpy(sched.params),
            "global": params_to_numpy(run.runtime.global_params()),
            "addresses": addresses, "residents": residents, "keys": keys}


def _graphs8(rank: int, size: int, out: Path) -> dict:
    with np.load(out.parent / "inits.npz") as z:
        flat = dict(z)
    res = {}
    for name in RUNS:
        init = {k[len(name) + 1:]: v for k, v in flat.items() if k.startswith(f"{name}:")}
        res[name] = {g: _mesh_run(name, g, init or None) for g in (False, True)}
    return res


class _KeyLog:
    """A ``GraphedStep`` whose every call's graph key is kept, in order."""

    def __init__(self, step):
        self.step, self.keys = step, []

    def __call__(self, batch):
        from repro_torch.core.cuda_graph import graph_key

        key = graph_key(batch, self.step._state())
        # shapes and dtypes, and the addresses apart (they are each rank's own)
        self.keys.append(((key[0], tuple((s, str(d)) for s, d, _ in key[1])),
                          tuple(p for *_, p in key[1])))
        return self.step(batch)


def _serve(stacks: tuple, mesh, graphed: bool) -> dict:
    """The 12 requests on the first stack, a swap, the 12 again: tokens, the
    final slot pool and (graphed) the chunk's keys."""
    from repro_torch.models import CausalLM
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving import ContinuousFederatedServer, Request

    srv = ContinuousFederatedServer(CausalLM(ArchConfig(**ARCH)), stacks[0], mesh=mesh,
                                    graph=False, **SERVER)
    log = None
    if graphed:
        log = srv._chunk_p.graphed = _KeyLog(srv._chunk_p._build_graph())
    res = {}
    for phase in ("before", "after"):
        reqs = _requests(Request)
        for r in reqs:
            srv.submit(r)
        srv.run()
        res[phase] = [r.output.copy() for r in reqs]
        srv.publish(stacks[1])
    res["pool"] = {k: v.clone() for k, v in srv._state.items() if k != "cache"}
    res["cache"] = {k: v.clone() for k, v in srv._state["cache"].items()}
    res["keys"] = None if log is None else log.keys
    return res


def _serve4(rank: int, size: int, out: Path) -> dict:
    from repro_torch.launch.mesh import make_cluster_mesh

    mesh = make_cluster_mesh(D, device="cpu")
    stacks = _stacks(out.parent)
    return {"index": mesh.index, **{g: _serve(stacks, mesh, g) for g in (False, True)}}


WORLDS = {"graphs8": _graphs8, "serve4": _serve4}


# -- the references, in the test process -----------------------------------------

def _flat_np(tree) -> dict:
    import jax

    from repro_torch.convert import flatten_params

    return flatten_params(jax.tree.map(np.asarray, tree))


def _jax_runs() -> dict:
    """Each non-offload case's JAX run (dense): its initial weights (built
    first), then its trace and final stacked params, as ``_mesh_run`` reads
    them."""
    import repro.scenarios as jscenarios

    runs = {}
    for name, (scenario, kw, steps) in RUNS.items():
        if name in OFFLOAD:
            continue
        jrun = jscenarios.build_scenario(scenario, backend="dense", **RUN_KW, **kw)
        runs[name] = (jrun, _flat_np(jrun.runtime.scheduler.params), steps)
    return runs


def _jax_results(runs: dict) -> dict:
    out = {}
    for name, (jrun, _, steps) in runs.items():
        src, trace = jrun.batch_source(), []
        for k in range(1, steps + 1):
            ev = jrun.runtime.step(src)
            if ev.losses is not None:
                trace.append(np.asarray(ev.losses))
            if jrun.runtime.scheduler.name == "sync" and k % 5 == 0:
                trace.append(np.asarray([jrun.runtime.evaluate(jrun.eval_batch)[0]]))
        out[name] = {"trace": np.concatenate(trace),
                     "params": _flat_np(jrun.runtime.scheduler.params),
                     "global": _flat_np(jrun.runtime.global_params())}
    return out


@pytest.fixture(scope="module")
def graphs8(tmp_path_factory):
    out = tmp_path_factory.mktemp("graphs8")
    world = out / "world"
    world.mkdir()
    runs = _jax_runs()
    np.savez(out / "inits.npz", **{f"{name}:{k}": v for name, (_, init, _) in runs.items()
                                   for k, v in init.items()})
    procs = _start_world("graphs8", C, world, script=__file__)
    try:
        refs = _jax_results(runs)
        # the offloaded cases off the mesh, eagerly, while the ranks run
        for name in OFFLOAD:
            refs[name] = _mesh_run(name, False, None, mesh=None)
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _results(procs, world), refs


@pytest.fixture(scope="module")
def serve4(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve4")
    world = out / "world"
    world.mkdir()
    stacks = _jax_stacks(out)
    procs = _start_world("serve4", D, world, script=__file__)
    try:
        refs = [_serve_jax(s) for s in stacks]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _results(procs, world), refs


# -- the tests --------------------------------------------------------------------

@pytest.mark.parametrize("name", [n for n in RUNS if n not in OFFLOAD])
def test_captured_body_on_a_client_mesh_matches_eager_bitwise_and_jax(graphs8, name):
    ranks, refs = graphs8
    ref = refs[name]
    for r, got in enumerate(ranks):
        eager, graphed = got[name][False], got[name][True]
        np.testing.assert_array_equal(graphed["trace"], eager["trace"])
        for part in ("row", "global"):
            for k, v in graphed[part].items():
                np.testing.assert_array_equal(v, eager[part][k], err_msg=f"{part} {k} rank {r}")
        # every rank reports the fleet's losses and consensus, as one process does
        np.testing.assert_allclose(graphed["trace"], ref["trace"], atol=1e-4)
        for k, v in graphed["row"].items():
            np.testing.assert_allclose(v, ref["params"][k][r:r + 1], atol=1e-4,
                                       err_msg=f"{k} rank {r}")
        for k, v in graphed["global"].items():
            np.testing.assert_allclose(v, ref["global"][k], atol=1e-4, err_msg=k)
        # one set of static buffers a step: the operands' shapes are fixed
        want = {"local": 1, "intra": 0, "inter": 1} if name.startswith("sync") else 1
        assert graphed["keys"] == want


@pytest.mark.parametrize("name", OFFLOAD)
def test_offloaded_mesh_keeps_its_row_tensors_and_one_graph(graphs8, name):
    ranks, refs = graphs8
    emu = refs[name]
    for r, got in enumerate(ranks):
        eager, graphed = got[name][False], got[name][True]
        # the gathered rows are copied into the tensors bind allocated (the
        # eager loop rebinds them to each step's new tensors)
        assert len(graphed["addresses"]) == RUNS[name][2]
        assert len(set(graphed["addresses"])) == 1, f"rank {r}: the row tensors moved"
        assert graphed["keys"] == ({"local": 1, "intra": 0, "inter": 1}
                                   if name.startswith("sync") else 1)
        np.testing.assert_array_equal(graphed["trace"], eager["trace"])
        for part in ("row", "global"):
            for k, v in graphed[part].items():
                np.testing.assert_array_equal(v, eager[part][k], err_msg=f"{part} {k} rank {r}")
        assert np.isfinite(graphed["trace"]).all()
        for k, v in graphed["global"].items():
            np.testing.assert_array_equal(v, ranks[0][name][True]["global"][k], err_msg=k)
        # the same run off the mesh, whose residents change from round to
        # round: this rank's slot of the store's buffer
        assert graphed["residents"] == emu["residents"]
        assert len(set(emu["residents"])) > 1
        np.testing.assert_allclose(graphed["trace"], emu["trace"], atol=1e-6)
        for k, v in graphed["row"].items():
            assert v.shape == (1,) + emu["row"][k].shape[1:]
            np.testing.assert_allclose(v, emu["row"][k][r:r + 1], atol=1e-6,
                                       err_msg=f"{k} rank {r}")
        for k, v in graphed["global"].items():
            np.testing.assert_allclose(v, emu["global"][k], atol=1e-6, err_msg=k)


def test_mesh_chunk_body_matches_eager_bitwise_and_jax(serve4):
    ranks, refs = serve4
    assert [r["index"] for r in ranks] == list(range(D))
    for rank in ranks:
        eager, graphed = rank[False], rank[True]
        for phase, ref in zip(("before", "after"), refs):
            for got, want, jax_tokens in zip(graphed[phase], eager[phase], ref):
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(got, jax_tokens)
        for part in ("pool", "cache"):
            for k, v in graphed[part].items():
                assert torch.equal(v, eager[part][k]), f"{part} {k}"


def _actions(keys: list) -> list:
    """What a CUDA ``GraphedStep`` does at each call of these keys: the first
    call of a key warms up, its second captures (and replays), later calls
    replay; new state addresses drop the keys of the old ones."""
    held, out = {}, []
    for shape, addr in keys:
        key = (shape, addr)
        if key not in held:
            held = {k: n for k, n in held.items() if k[1] == addr}
            held[key] = 0
            out.append("warm-up")
        elif held[key] == 0:
            held[key] = 1
            out.append("capture")
        else:
            out.append("replay")
    return out


def test_every_rank_warms_up_captures_and_replays_at_the_same_calls(serve4):
    ranks, _ = serve4
    logs = [rank[True]["keys"] for rank in ranks]
    first = logs[0]
    assert len(first) > 2
    for log in logs:
        assert [s for s, _ in log] == [s for s, _ in first]
        changes = [i for i in range(1, len(log)) if log[i] != log[i - 1]]
        assert changes == [i for i in range(1, len(first)) if first[i] != first[i - 1]]
        # the pool and the replica row never move, the swap included: one key
        assert changes == []
        assert _actions(log) == ["warm-up", "capture"] + ["replay"] * (len(log) - 2)


if __name__ == "__main__":
    _rank_main({k: (lambda rank, size, _n=k: WORLDS[_n](rank, size, Path(sys.argv[5])))
                for k in WORLDS}, sys.argv[1:6])
