"""Port parity: process-group collectives, one client a rank (``launch.mesh``).

Each world is a set of rank processes started from this file (``python
tests/test_torch_mesh.py <world> <rank> <size> <port> <out>``) over ``gloo``
on ``tcp://127.0.0.1:<free port>``, one intra-op thread each, with a timeout
on the group's init and on every process.  A rank writes what it computed to
``<out>/<rank>.pt``; the test process computes the references while the
ranks run: the port's one-process run on the stacked client axis (PR 25's
emulation) and the JAX package's.

* ``world4`` (4 ranks): ``ppermute`` of a random permutation, bitwise, of a
  tensor and of a tree; a rank that no pair names gets zeros, a rank its own
  partner copies; the schedulers' reductions (``fleet_weighted_sum``,
  ``cluster_sums_on_mesh``, ``gather_rows_to_host``) against the stack; and
  the resolution rules of ``launch.mesh`` under a group.
* ``world8`` (8 ranks, C = 8 clients in D = 4 clusters, g = 2):
  ``CollectiveBackend(mesh=)``'s transition on a MnistCNN tree (intra and
  inter, per-call weights, a faulted ``p``, one bf16 leaf); the round step
  and the gossip train step at the reduced LM of
  ``tests/spmd_check.py::check_lm_collective_mesh`` (2 layers, d_model 32,
  S = 16, 2 rounds); and ``make_run`` with ``backend="collective"`` and
  ``mesh="auto"``: sync and round, 10 iterations, with participation, with
  faults and with a host-offload store.  Every rank's row is held within 1e-6 of the emulation's
  (the transition's rows bitwise) and within 1e-4 of JAX (1e-5 for one
  transition), and every rank reports the same consensus and cluster models.

``launch.train`` under torchrun's environment is
``tests/test_torch_mesh_launch.py``'s.
"""
import datetime
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

SRC = Path(__file__).resolve().parents[1] / "src"
INIT_TIMEOUT = 90     # seconds a rank waits for its peers
WORLD_TIMEOUT = 240   # seconds a world may run before it is killed
C, D = 8, 4

# the reduced LM of tests/spmd_check.py::check_lm_collective_mesh
LM = dict(name="spmd-lm", family="dense", num_layers=2, d_model=32, d_ff=64, vocab_size=128,
          num_heads=2, num_kv_heads=1, head_dim=16, dtype="float32", remat=False,
          attn_chunk=16, tie_embeddings=True)
LM_SEQ, LM_B = 16, 2
FAULTED = [{"kind": "link-down", "round": 0, "link": [0, 3], "until": 4}]
# make_run cases: (scenario, overrides, steps); 10 protocol iterations each
RUNS = {
    "sync": ("mnist-iid-ring", dict(num_clients=C, num_clusters=D, tau1=2, tau2=1), 10),
    "round": ("round-compiled-ring", dict(tau2=1), 5),
    "sync-participation": ("mnist-iid-ring", dict(
        num_clients=C, num_clusters=D, tau1=2, tau2=1,
        participation={"strategy": "uniform-k", "k": 1}), 10),
    "round-faults": ("chaos-ring", dict(rounds_per_step=1), 5),
    # a host-offload store in identity residency: the mesh spans its 8 slots
    "round-offload": ("round-compiled-ring", dict(tau2=1, store="host-offload"), 5),
}
# held against the emulation only: an offloaded run's JAX parity is
# tests/test_torch_state.py's
NO_JAX = ("round-offload",)
RUN_KW = dict(num_samples=400, batch_size=2)


# -- shared by the ranks and the references ------------------------------------

def _transition_inputs():
    """A MnistCNN-shaped stacked tree (the fc bias in bf16), weights and a
    faulted ring matrix, all from numpy seeds."""
    from repro_torch.core import ClusterSpec, ring
    from repro_torch.faults import resolve_faults
    from repro_torch.models import MnistCNN

    rng = np.random.default_rng(0)
    shapes = {k: tuple(v.shape) for k, v in MnistCNN().init(torch.Generator()).items()}
    tree = {k: rng.standard_normal((C,) + s).astype(np.float32) for k, s in shapes.items()}
    sizes = tuple(float(x) for x in rng.uniform(0.5, 2.0, C))
    spec = ClusterSpec(C, tuple(i // (C // D) for i in range(C)), sizes)
    w = rng.uniform(0.2, 1.0, C)
    w = (w / np.bincount(np.asarray(spec.assignments), weights=w)[list(spec.assignments)])
    p_fault = resolve_faults({"events": FAULTED}, ring(D), spec).mixing_at(0)
    return tree, spec, w.astype(np.float32), p_fault.astype(np.float32)


TRANSITIONS = [("intra", False, False), ("inter", False, False), ("intra", True, False),
               ("inter", True, False), ("inter", True, True)]


def _transitions(backend, tree, w, p_fault):
    """Every case of ``TRANSITIONS`` through ``backend`` on ``tree``."""
    out = []
    for event, use_w, use_p in TRANSITIONS:
        kw = {}
        if use_w:
            kw["weights"] = torch.tensor(w)
        if use_p:
            kw["p"] = torch.tensor(p_fault)
        got = backend.transition({k: v.clone() for k, v in tree.items()}, event, **kw)
        out.append({k: v.float().numpy().copy() for k, v in got.items()})
    return out


def _bf16(tree: dict) -> dict:
    """``tree`` as tensors with the fc bias in bf16."""
    t = {k: torch.tensor(v) for k, v in tree.items()}
    last = sorted(t)[-1]
    t[last] = t[last].to(torch.bfloat16)
    return t


def _lm_setup():
    """The reduced LM, its FLSpec, optimizer, initial params and 2-iteration window."""
    from repro_torch import optim
    from repro_torch.core import FLSpec
    from repro_torch.data import FederatedLM
    from repro_torch.models import CausalLM
    from repro_torch.models.config import ArchConfig

    model = CausalLM(ArchConfig(**LM))
    fl = FLSpec(num_clients=C, num_clusters=D, tau1=2, tau2=1, alpha=1, learning_rate=0.1,
                topology="ring", impl="gossip")
    params0 = model.init(torch.Generator().manual_seed(0))
    ds = FederatedLM.generate(C, 64, LM_SEQ, 128, seed=0)
    rng = np.random.default_rng(0)
    draws = [ds.stacked_batch(LM_B, rng) for _ in range(fl.tau1 * fl.tau2)]
    window = {k: np.stack([d[k] for d in draws]) for k in draws[0]}
    return model, fl, optim.sgd(fl.learning_rate), params0, window


def _lm_runs(model, fl, opt, params, window, backend, mesh=None):
    """Two round steps on ``window`` and then an intra and an inter gossip
    train step on its two iterations: (round losses, round params, train
    losses, train params)."""
    from repro_torch.core import build_fl_train_step
    from repro_torch.core.round_engine import build_fl_round_step

    batches = {k: torch.tensor(v) for k, v in window.items()}
    step = build_fl_round_step(model, opt, fl, backend=backend)
    p, losses = dict(params), []
    for _ in range(2):
        p, _, l = step(p, (), batches)
        losses.append(l.numpy().copy())
    round_p = {k: v.numpy().copy() for k, v in p.items()}
    p, train_losses = dict(params), []
    for i, event in enumerate(("intra", "inter")):
        ts = build_fl_train_step(model, opt, fl, event=event, mesh=mesh, device="cpu")
        p, _, l = ts(p, (), {k: v[i] for k, v in batches.items()})
        train_losses.append(float(l))
    return (np.stack(losses), round_p, np.asarray(train_losses),
            {k: v.numpy().copy() for k, v in p.items()})


def _make_run(name, mesh):
    """One ``RUNS`` case on the collective backend: (history or losses,
    consensus, initial stacked params) on this rank."""
    import repro_torch.scenarios as tscenarios
    from repro_torch.convert import params_to_numpy
    from repro_torch.core.aggregation import gather_rows

    scenario, kw, steps = RUNS[name]
    run = tscenarios.build_scenario(scenario, device="cpu", backend="collective", mesh=mesh,
                                    **RUN_KW, **kw)
    sched = run.runtime.scheduler
    # an offloaded run's buffer holds nothing before its first gather
    init = {}
    if sched.store.resident:
        mesh_ = sched.mesh
        init = params_to_numpy(sched.params if mesh_ is None else gather_rows(sched.params, mesh_))
    if sched.name == "sync":
        hist = run.runtime.run(steps, run.batch_source(), run.eval_batch, eval_every=5)
        trace = np.asarray(hist.loss)
    else:
        src = run.batch_source()
        trace = np.concatenate([run.runtime.step(src).losses.numpy() for _ in range(steps)])
    clusters = params_to_numpy(run.runtime.cluster_params()) if sched.store.resident else {}
    return {"trace": trace, "global": params_to_numpy(run.runtime.global_params()),
            "clusters": clusters, "init": init, "mesh": sched.mesh}


# -- the ranks ------------------------------------------------------------------

def _rows4(rank: int) -> dict:
    """Rank ``rank``'s ``(1, ...)`` row of a two-leaf tree, one leaf bf16."""
    rng = np.random.default_rng(100 + rank)
    return {"w": torch.tensor(rng.standard_normal((1, 3, 4)).astype(np.float32)),
            "b": torch.tensor(rng.standard_normal((1, 5)).astype(np.float32)).to(torch.bfloat16)}


REDUCE_W = np.array([0.5, 0.25, 0.125, 1.5], dtype=np.float32)


def _world4(rank: int, size: int) -> dict:
    from repro_torch.core.aggregation import (
        cluster_sums_on_mesh, fleet_weighted_sum, gather_rows_to_host, ppermute,
    )
    from repro_torch.launch import mesh as tmesh

    mesh = tmesh.resolve_client_mesh("auto", size, device="cpu")
    out = {"index": mesh.index, "size": mesh.size, "device": str(mesh.device),
           "backend": mesh.backend}
    perm = np.random.default_rng(7).permutation(size)
    x = torch.tensor(np.random.default_rng(rank).standard_normal((3, 5)).astype(np.float32))
    tree = {"a": x, "b": (x[0] * 2).to(torch.bfloat16), "c": torch.arange(4) + 10 * rank}
    out["perm"] = ppermute(x, mesh, [(i, int(perm[i])) for i in range(size)])
    out["perm_tree"] = ppermute(tree, mesh, [(i, int(perm[i])) for i in range(size)])
    # ranks 0 and 1 swap, 2 keeps its own, nobody sends to 3
    out["partial"] = ppermute(x, mesh, [(0, 1), (1, 0), (2, 2)])
    # the schedulers' reductions: consensus, cluster models (g = 2), checkpoint
    rows, w = _rows4(rank), torch.tensor(REDUCE_W)
    out["weighted_sum"] = fleet_weighted_sum(rows, mesh, w)
    out["cluster_sums"] = cluster_sums_on_mesh(rows, mesh, 2, w)
    out["to_host"] = gather_rows_to_host(rows, mesh)
    # the resolution rules under a group
    assert tmesh.resolve_client_mesh(None, size) is None
    assert tmesh.resolve_client_mesh(mesh, size) is mesh
    assert tmesh.resolve_cluster_mesh("auto", size, device="cpu").axis_name == "cluster"
    errors = {}
    for key, call in (("world", lambda: tmesh.resolve_client_mesh("auto", 2 * size,
                                                                   device="cpu")),
                      ("size", lambda: tmesh.resolve_client_mesh(mesh, size + 1)),
                      ("make", lambda: tmesh.make_client_mesh(size - 1, device="cpu"))):
        try:
            call()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    out["describe"] = tmesh.describe_resolution("auto", size, device="cpu")
    return out


def _world8(rank: int, size: int) -> dict:
    from repro_torch.core import CollectiveBackend, resolve_backend
    from repro_torch.core.aggregation import mesh_rows
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(size, device="cpu")
    out = {}
    # (b) the transition on this rank's row
    tree, spec, w, p_fault = _transition_inputs()
    backend = CollectiveBackend(spec, _p_of(spec), 2, device="cpu", mesh=mesh)
    rows = mesh_rows({k: torch.tensor(v) for k, v in tree.items()}, mesh)
    out["transitions"] = _transitions(backend, rows, w, p_fault)
    out["bf16"] = _transitions(backend, mesh_rows(_bf16(tree), mesh), w, p_fault)
    # (c) the LM round step and gossip train step
    model, fl, opt, params0, window = _lm_setup()
    proto = fl.protocol()
    lm_backend = resolve_backend("collective", proto.clusters, proto.P(), fl.alpha,
                                 device="cpu", mesh=mesh)
    row0 = {k: v[None].clone() for k, v in params0.items()}
    out["lm"] = _lm_runs(model, fl, opt, row0, window, lm_backend, mesh=mesh)
    # (d) make_run on the mesh
    out["runs"] = {}
    for name in RUNS:
        res = _make_run(name, "auto")
        assert res["mesh"] is not None and res["mesh"].size == size
        res.pop("mesh")
        out["runs"][name] = res
    return out


def _p_of(spec):
    from repro_torch.core import mixing_matrix, ring

    return mixing_matrix(ring(D), spec.m_tilde())


WORLDS = {"world4": _world4, "world8": _world8}


def _rank_main(worlds: dict, argv: list) -> None:
    """One rank of ``worlds[name]``: ``argv`` is ``name rank size port out``."""
    import torch.distributed as dist

    name, rank, size, port, out = argv[0], int(argv[1]), int(argv[2]), int(argv[3]), argv[4]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
                            world_size=size,
                            timeout=datetime.timedelta(seconds=INIT_TIMEOUT))
    try:
        torch.save(worlds[name](rank, size), Path(out) / f"{rank}.pt")
    finally:
        dist.destroy_process_group()


# -- starting and joining a world ------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**extra) -> dict:
    path = os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH")) if p)
    return dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1", **extra)


def _start(argvs: list, envs: list, out: Path) -> list:
    """One process a rank, each writing its output to ``<out>/<rank>.log``."""
    procs = []
    for r, (argv, env) in enumerate(zip(argvs, envs)):
        with open(out / f"{r}.log", "wb") as log:
            procs.append(subprocess.Popen(argv, env=env, stdout=log, stderr=subprocess.STDOUT))
    return procs


def _join(procs: list, out: Path, timeout: float = WORLD_TIMEOUT) -> list:
    """Wait for every rank (killing all at the deadline); their logs."""
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [(out / f"{r}.log").read_text(errors="replace") for r in range(len(procs))]
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    assert not bad, f"ranks {bad} failed or timed out:\n" + logs[bad[0]][-6000:]
    return logs


def _start_world(name: str, size: int, out: Path, script: str = __file__) -> list:
    """``size`` ranks of ``script``'s world ``name`` (its ``__main__`` runs
    ``_rank_main`` over its own ``WORLDS``)."""
    port = _free_port()
    argvs = [[sys.executable, str(Path(script).resolve()), name, str(r), str(size),
              str(port), str(out)] for r in range(size)]
    return _start(argvs, [_env()] * size, out)


def _results(procs, out: Path) -> list:
    _join(procs, out)
    return [torch.load(out / f"{r}.pt", weights_only=False) for r in range(len(procs))]


# -- world4: ppermute and the resolution rules ----------------------------------

@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    return _results(_start_world("world4", 4, out), out)


def test_ppermute_moves_each_rank_to_its_destination_bitwise(world4):
    size = len(world4)
    perm = np.random.default_rng(7).permutation(size)
    xs = [torch.tensor(np.random.default_rng(r).standard_normal((3, 5)).astype(np.float32))
          for r in range(size)]
    for src in range(size):
        got = world4[int(perm[src])]
        assert torch.equal(got["perm"], xs[src])
        assert torch.equal(got["perm_tree"]["a"], xs[src])
        assert torch.equal(got["perm_tree"]["b"], (xs[src][0] * 2).to(torch.bfloat16))
        assert got["perm_tree"]["b"].dtype == torch.bfloat16
        assert torch.equal(got["perm_tree"]["c"], torch.arange(4) + 10 * src)
    assert torch.equal(world4[0]["partial"], xs[1]) and torch.equal(world4[1]["partial"], xs[0])
    assert torch.equal(world4[2]["partial"], xs[2])
    assert torch.equal(world4[3]["partial"], torch.zeros(3, 5))


def test_mesh_reductions_match_the_stack(world4):
    size = len(world4)
    stack = {k: torch.cat([_rows4(r)[k] for r in range(size)]) for k in _rows4(0)}
    w = torch.tensor(REDUCE_W)
    v = torch.tensor([[1.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.0, 1.0]]) * w[:, None]
    for r, got in enumerate(world4):
        for k, x in stack.items():
            want = torch.tensordot(w, x.float(), dims=([0], [0]))
            np.testing.assert_allclose(got["weighted_sum"][k], want, atol=1e-6, err_msg=k)
            assert got["weighted_sum"][k].dtype == torch.float32
            # every rank holds what rank 0 holds, bitwise
            assert torch.equal(got["weighted_sum"][k], world4[0]["weighted_sum"][k])
            want = torch.tensordot(v, x.float(), dims=([0], [0]))
            np.testing.assert_allclose(got["cluster_sums"][k], want, atol=1e-6, err_msg=k)
            assert torch.equal(got["cluster_sums"][k], world4[0]["cluster_sums"][k])
        # the rows reach rank 0's host in their dtype; the others get None
        if r:
            assert got["to_host"] is None
    for k, x in stack.items():
        host = world4[0]["to_host"][k]
        assert host.device.type == "cpu" and host.dtype == x.dtype and torch.equal(host, x)


def test_mesh_resolution_under_a_process_group(world4):
    for r, got in enumerate(world4):
        assert (got["index"], got["size"], got["device"], got["backend"]) == (r, 4, "cpu",
                                                                               "gloo")
        errors = got["errors"]
        assert "has 4 rank(s) for 8 clients" in errors["world"]
        assert "torchrun --nproc-per-node 8" in errors["world"]
        assert "has size 4, need one rank a client (5)" in errors["size"]
        assert "has 4 rank(s) for 3 clients" in errors["make"]
        assert f"4 ranks over gloo, one client a rank (rank {r} on cpu)" in got["describe"]


def test_mesh_resolution_without_a_process_group(monkeypatch):
    from repro_torch.launch import mesh as tmesh

    n = torch.cuda.device_count()
    assert tmesh.resolve_client_mesh("auto", n + 1) is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    with pytest.raises(ValueError, match="needs a process group.*torchrun --nproc-per-node 8"):
        tmesh.resolve_client_mesh("auto", 8)
    with pytest.raises(ValueError, match="have none; launch one process a client"):
        tmesh.make_client_mesh(8, device="cpu")


# -- world8: the backend, the steps and make_run --------------------------------

@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    """The ranks' results, and the references computed while they ran."""
    out = tmp_path_factory.mktemp("world8")
    procs = _start_world("world8", C, out)
    try:
        refs = _references()
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _results(procs, out), refs


def _references() -> dict:
    import jax
    import jax.numpy as jnp

    import repro.core as jcore
    import repro.scenarios as jscenarios
    from repro import optim as joptim
    from repro.core.round_engine import build_fl_round_step as j_round_step
    from repro.models import CausalLM as JCausalLM
    from repro.models.config import ArchConfig as JArchConfig
    from repro_torch.convert import params_from_numpy, unflatten_params
    from repro_torch.core import CollectiveBackend, resolve_backend

    refs = {}
    tree, spec, w, p_fault = _transition_inputs()
    emu = CollectiveBackend(spec, _p_of(spec), 2, device="cpu")
    refs["transitions"] = _transitions(emu, {k: torch.tensor(v) for k, v in tree.items()},
                                       w, p_fault)
    refs["bf16"] = _transitions(emu, _bf16(tree), w, p_fault)
    jspec = jcore.ClusterSpec(spec.num_clients, spec.assignments, spec.data_sizes)
    jback = jcore.CollectiveBackend(jspec, np.asarray(_p_of(spec)), 2)
    jt = {k: jnp.asarray(v) for k, v in tree.items()}
    refs["jax_transitions"] = []
    for event, use_w, use_p in TRANSITIONS:
        got = jback.transition(jt, event, weights=jnp.asarray(w) if use_w else None,
                               p=jnp.asarray(p_fault) if use_p else None)
        refs["jax_transitions"].append({k: np.asarray(v) for k, v in got.items()})

    # the LM steps: the port on the stacked axis, then JAX's collective
    # emulation from the same initial weights (round) and its dense step (train)
    model, fl, opt, params0, window = _lm_setup()
    proto = fl.protocol()
    stacked0 = {k: v[None].expand((C,) + v.shape).clone() for k, v in params0.items()}
    backend = resolve_backend("collective", proto.clusters, proto.P(), fl.alpha, device="cpu")
    refs["lm"] = _lm_runs(model, fl, opt, stacked0, window, backend)
    jmodel = JCausalLM(JArchConfig(**LM))
    jfl = jcore.FLSpec(num_clients=C, num_clusters=D, tau1=2, tau2=1, alpha=1,
                       learning_rate=0.1, topology="ring")
    jproto = jfl.protocol()
    jopt = joptim.sgd(jfl.learning_rate)
    jp0 = jax.tree.map(jnp.asarray, unflatten_params({k: v.numpy() for k, v in
                                                      stacked0.items()}))
    jwin = {k: jnp.asarray(v) for k, v in window.items()}
    jemu = jcore.resolve_backend("collective", jproto.clusters, jproto.P(), jfl.alpha)
    jstep = jax.jit(j_round_step(jmodel, jopt, jfl, backend=jemu))
    p, losses = jp0, []
    for _ in range(2):
        p, _, l = jstep(p, (), jwin)
        losses.append(np.asarray(l))
    refs["jax_lm_round"] = (np.stack(losses), _flat_np(p))
    p, train_losses = jp0, []
    for i, event in enumerate(("intra", "inter")):
        ts = jax.jit(jcore.build_fl_train_step(jmodel, jopt, jfl, event=event))
        p, _, l = ts(p, (), {k: v[i] for k, v in jwin.items()})
        train_losses.append(float(l))
    refs["jax_lm_train"] = (np.asarray(train_losses), _flat_np(p))

    # make_run: the port's one-process collective run, and JAX's dense run
    # from its initial weights
    refs["runs"], refs["jax_runs"] = {}, {}
    for name, (scenario, kw, steps) in RUNS.items():
        res = _make_run(name, None)
        refs["runs"][name] = res
        if name in NO_JAX:
            continue
        jrun = jscenarios.build_scenario(scenario, backend="dense", **RUN_KW, **kw)
        jrun.runtime.scheduler.params = jax.tree.map(
            jnp.asarray, _nest_like(jrun.runtime.scheduler.params,
                                    params_from_numpy(res["init"], "cpu")))
        if jrun.runtime.scheduler.name == "sync":
            hist = jrun.runtime.run(steps, jrun.batch_source(), jrun.eval_batch, eval_every=5)
            trace = np.asarray(hist.loss)
        else:
            src = jrun.batch_source()
            trace = np.concatenate([np.asarray(jrun.runtime.step(src).losses)
                                    for _ in range(steps)])
        refs["jax_runs"][name] = {"trace": trace,
                                  "global": _flat_np(jrun.runtime.global_params())}
    return refs


def _flat_np(tree) -> dict:
    import jax

    from repro_torch.convert import flatten_params

    return flatten_params(jax.tree.map(np.asarray, tree))


def _nest_like(jtree, flat: dict):
    """``flat`` (the port's dotted names) in the layout of the JAX tree ``jtree``."""
    from repro_torch.convert import unflatten_params

    nested = unflatten_params({k: v.numpy() for k, v in flat.items()})
    return nested if isinstance(next(iter(jtree.values())), dict) else {
        k: v.numpy() for k, v in flat.items()}


def test_collective_transition_on_a_mesh(world8):
    ranks, refs = world8
    for case, (event, use_w, use_p) in enumerate(TRANSITIONS):
        for r, got in enumerate(ranks):
            for k, v in got["transitions"][case].items():
                emu = refs["transitions"][case][k][r:r + 1]
                # elementwise f32 arithmetic in the emulation's order: bitwise
                np.testing.assert_array_equal(v, emu, err_msg=f"{event} {case} {k} rank {r}")
                np.testing.assert_allclose(v, refs["jax_transitions"][case][k][r:r + 1],
                                           atol=1e-5, err_msg=f"{event} {case} {k} rank {r}")
            for k, v in got["bf16"][case].items():
                np.testing.assert_array_equal(v, refs["bf16"][case][k][r:r + 1], err_msg=k)


def test_round_and_train_steps_on_a_mesh(world8):
    ranks, refs = world8
    round_l, round_p, train_l, train_p = refs["lm"]
    jround_l, jround_p = refs["jax_lm_round"]
    jtrain_l, jtrain_p = refs["jax_lm_train"]
    for r, got in enumerate(ranks):
        g_round_l, g_round_p, g_train_l, g_train_p = got["lm"]
        # every rank returns the fleet's losses, as one process does
        np.testing.assert_allclose(g_round_l, round_l, atol=1e-6)
        np.testing.assert_allclose(g_round_l, jround_l, atol=1e-4)
        np.testing.assert_allclose(g_train_l, train_l, atol=1e-6)
        np.testing.assert_allclose(g_train_l, jtrain_l, atol=1e-4)
        for k, v in g_round_p.items():
            assert v.shape == (1,) + round_p[k].shape[1:]
            np.testing.assert_allclose(v, round_p[k][r:r + 1], atol=1e-6, err_msg=k)
            np.testing.assert_allclose(v, jround_p[k][r:r + 1], atol=1e-4, err_msg=k)
        for k, v in g_train_p.items():
            np.testing.assert_allclose(v, train_p[k][r:r + 1], atol=1e-6, err_msg=k)
            np.testing.assert_allclose(v, jtrain_p[k][r:r + 1], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", list(RUNS))
def test_make_run_on_a_mesh(world8, name):
    ranks, refs = world8
    emu, jax_ref = refs["runs"][name], refs["jax_runs"].get(name)
    for r, got in enumerate(ranks):
        run = got["runs"][name]
        for k, v in run["init"].items():
            np.testing.assert_array_equal(v, emu["init"][k], err_msg=k)
        # every rank reports what the first reports, bitwise
        for part in ("global", "clusters"):
            for k, v in run[part].items():
                np.testing.assert_array_equal(v, ranks[0]["runs"][name][part][k],
                                              err_msg=f"{part} {k}")
        np.testing.assert_array_equal(run["trace"], ranks[0]["runs"][name]["trace"])
    run = ranks[0]["runs"][name]
    assert (jax_ref is None) == (name in NO_JAX)
    np.testing.assert_allclose(run["trace"], emu["trace"], atol=1e-6)
    for k, v in run["global"].items():
        np.testing.assert_allclose(v, emu["global"][k], atol=1e-6, err_msg=k)
    assert run["clusters"].keys() == emu["clusters"].keys()
    for k, v in run["clusters"].items():
        assert v.shape == emu["clusters"][k].shape
        np.testing.assert_allclose(v, emu["clusters"][k], atol=1e-6, err_msg=k)
    if jax_ref is not None:
        np.testing.assert_allclose(run["trace"], jax_ref["trace"], atol=1e-4)
        for k, v in run["global"].items():
            np.testing.assert_allclose(v, jax_ref["global"][k], atol=1e-4, err_msg=k)


if __name__ == "__main__":
    _rank_main(WORLDS, sys.argv[1:])
