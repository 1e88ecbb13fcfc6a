"""The port's captured steps (``core/cuda_graph.py``) on the CPU.

A CUDA graph needs a card, so these tests reach what surrounds it: how the
schedulers resolve ``graph``, how a replay's kernels are counted on the
device, the graph key, and the captured body itself.  A CPU
``GraphedStep`` copies each batch into its static input buffers and runs
the body eagerly, the ``dense`` backend's new tensors copied into the
scheduler's parameters, so the body is held bitwise to the eager loop (the
same operations on the same values) and within 1e-4 of the reference after
10 sync iterations or 2 round supersteps, the tolerance of the port's other
parity tests (JAX's weights carried across with ``repro_torch.convert``).
The card tests (``test_torch_cuda.py``) hold the replays themselves.
"""
import dataclasses
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.scenarios as jscenarios
import repro_torch.kernels as tkernels
import repro_torch.scenarios as tscenarios
from repro_torch.convert import flatten_params, params_from_numpy, params_to_numpy
from repro_torch.core import make_run
from repro_torch.core.cuda_graph import GraphedStep, copy_into, graph_key, resolve_graph

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

LM_SMALL = dict(arch_overrides=dict(d_model=64, d_ff=128), seq_len=16, num_samples=64)


def _flat(tree):
    return flatten_params(jax.tree.map(np.asarray, tree))


# -- (a) resolving ``graph`` -------------------------------------------------

def test_resolve_graph():
    assert resolve_graph(None, "cpu") is False
    assert resolve_graph(False, "cpu") is False
    assert resolve_graph(None, torch.device("cuda")) is True
    assert resolve_graph(False, "cuda") is False
    assert resolve_graph(True, "cuda") is True
    with pytest.raises(ValueError, match="needs a CUDA device"):
        resolve_graph(True, "cpu")


@pytest.mark.parametrize("name,attr,extra", [
    ("mnist-noniid-ring", "_graphs", {"num_samples": 400}),
    ("round-compiled-ring", "_graph", {"num_samples": 400}),
    ("federated-lm-ring", "_graph", LM_SMALL),
    ("straggler-bimodal-async", "_graph", {"num_samples": 400}),
])
def test_schedulers_resolve_graph_on_the_cpu(name, attr, extra):
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        tscenarios.build_scenario(name, device="cpu", graph=True, **extra)
    for graph in (None, False):  # None is eager on the CPU, False everywhere
        sched = tscenarios.build_scenario(name, device="cpu", graph=graph,
                                          **extra).runtime.scheduler
        assert getattr(sched, attr) is None
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        make_run({"scenario": name, "graph": True, **extra}, device="cpu")


def test_graph_is_no_scenario_field_and_async_takes_none():
    # the registered scenarios keep the reference's fields (see
    # test_torch_runtime.py::test_registered_scenarios_match_reference)
    assert "graph" not in {f.name for f in dataclasses.fields(tscenarios.Scenario)}
    # async takes the key now, as sync and round do: its event is a captured step
    for graph in (None, False):
        sched = make_run({"scenario": "straggler-bimodal-async", "num_samples": 400,
                          "graph": graph}, device="cpu").scheduler
        assert sched._graph is None and sched._graph_spec is graph
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        make_run({"scenario": "straggler-bimodal-async", "num_samples": 400, "graph": True},
                 device="cpu")


# -- (b) counting launches on the device ------------------------------------

def test_count_kernels_maps_device_kernels_to_wrappers():
    names = ["void (anonymous namespace)::sgd_update_kernel<float>(LeafTable, float)"] * 3 + [
        "void fused_transition_kernel<4>(LeafTable, float const*, float const*)",
        "void flash_fwd_split_tf32_kernel<float, 64>(float const*)",
        "void flash_bwd_delta_split_tf32_kernel<float>(float const*)",  # the backward's
        "void flash_bwd_dkdv_split_tf32_kernel<float, 64>(float const*)",  # other two
        "void flash_bwd_dq_split_tf32_kernel<float, 64>(float const*)",
        "flash_bwd_dq_sm90_kernel(CUtensorMap)",
        "void flash_bwd_dkdv_wide_sm90_kernel<256, 2>(CUtensorMap)",  # hd > 128: dK/dV,
        "void flash_bwd_dq_sm90_kernel<256, 3, 32>(CUtensorMap)",     # then dQ once
        "void at::native::elementwise_kernel<128, 2>(int)", "Memcpy HtoD (Pinned -> Device)",
    ]
    assert tkernels.count_kernels(names) == {
        "sgd_update": 3, "fused_transition": 1, "flash_attention_fwd": 1,
        "flash_attention_fwd.split_tf32": 1, "flash_attention_bwd": 3,
        "flash_attention_bwd.split_tf32": 1, "flash_attention_bwd.tensor_core": 2}
    assert tkernels.count_kernels([]) == {}


def test_device_kernels_name_the_sources_kernels_and_the_wrappers():
    # every name is a __global__ of the kernels' sources, every key a
    # launch-counting wrapper (and a route of its ``.routes``)
    sources = "".join(p.read_text() for p in
                      Path(tkernels.__file__).parent.glob("*/csrc/*.cu"))
    for name, key in tkernels.DEVICE_KERNELS.items():
        assert re.search(r"__global__[^;{]*\b" + name + r"\(", sources), name
        wrapper, _, r = key.partition(".")
        fn = getattr(tkernels, wrapper)
        assert isinstance(fn.launches, int)
        assert not r or r in fn.routes, key


# -- (c) the graph key -------------------------------------------------------

def test_graph_key_follows_batch_shapes_and_state_addresses():
    params = {"w": torch.zeros(4, 3), "b": torch.zeros(4)}
    batch = {"x": torch.ones(4, 2, 5), "y": torch.zeros(4, 2, dtype=torch.int32)}
    key = graph_key(batch, params)
    # new values at the same shapes, and the same state tensors: same key
    assert graph_key({"x": torch.zeros(4, 2, 5), "y": batch["y"] + 1}, params) == key
    assert graph_key(batch, (params, ())) == key  # an empty optimizer state adds nothing
    # a batch shape or dtype changes the key
    assert graph_key({"x": torch.ones(4, 3, 5), "y": batch["y"]}, params) != key
    assert graph_key({"x": batch["x"].double(), "y": batch["y"]}, params) != key
    # a replaced parameter leaf changes the key, even at the same shape
    assert graph_key(batch, {"w": torch.zeros(4, 3), "b": params["b"]}) != key


def test_graphed_step_on_the_cpu_keeps_static_buffers_per_key():
    state = {"w": torch.zeros(3)}

    def body(batch):
        state["w"].add_(batch["x"].sum(0))
        return batch["x"].sum()

    step = GraphedStep(body, lambda: state, "cpu")
    outs = [step({"x": torch.full((2, 3), float(i))}) for i in range(3)]
    assert [float(o) for o in outs] == [0.0, 6.0, 12.0]
    assert torch.equal(state["w"], torch.full((3,), 6.0))
    assert len(step._entries) == 1 and step.captured == 0 and step.replays == 0
    step({"x": torch.ones(4, 3)})  # a new shape: a second set of buffers
    assert len(step._entries) == 2
    state["w"] = torch.zeros(3)  # replaced state: the old addresses' entries go
    step({"x": torch.ones(4, 3)})
    assert len(step._entries) == 1


def test_copy_into_writes_new_tensors_and_skips_updated_ones():
    a, b = torch.zeros(2), torch.zeros(3)
    dst = ({"a": a, "b": b}, ())
    copy_into(dst, ({"a": torch.ones(2), "b": b}, ()))
    assert dst[0]["a"] is a and torch.equal(a, torch.ones(2)) and torch.equal(b, torch.zeros(3))


# -- (d) the captured body against the eager loop and the reference ---------

@pytest.fixture(scope="module")
def jax_sync():
    """Ten iterations of the reference on mnist-noniid-ring, tau2=2."""
    jrun = jscenarios.build_scenario("mnist-noniid-ring", tau2=2, backend="dense")
    init = jax.tree.map(np.asarray, jrun.runtime.scheduler.params)
    hist = jrun.runtime.run(10, jrun.batch_source(), jrun.eval_batch, eval_every=10)
    return {"init": init, "params": jax.tree.map(np.asarray, jrun.runtime.scheduler.params),
            "eval": hist.loss[-1]}


def _body_run(name, init, steps, graphed, **kw):
    """``steps`` steps from ``init``: the eager loop, or the captured body."""
    run = tscenarios.build_scenario(name, device="cpu", **kw)
    sched = run.runtime.scheduler
    sched.params = params_from_numpy(init, "cpu")
    if graphed:
        if hasattr(sched, "_graphs"):
            sched._graphs = sched._build_graphs()
        else:
            sched._graph = sched._build_graph()
    leaves = dict(sched.params)
    src = run.batch_source()
    events = [run.runtime.step(src) for _ in range(steps)]
    if graphed:  # the body writes into the same tensors
        assert all(sched.params[k] is v for k, v in leaves.items())
    losses = [e.losses for e in events if e.losses is not None]
    return run, sched, (torch.cat(losses) if losses else None)


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_sync_body_matches_eager_bitwise_and_tracks_jax(jax_sync, backend):
    ref = jax_sync
    got = {}
    for graphed in (False, True):
        run, sched, _ = _body_run("mnist-noniid-ring", ref["init"], 10, graphed, tau2=2,
                                  backend=backend)
        assert sched.backend.name == backend
        got[graphed] = (params_to_numpy(sched.params), run.runtime.evaluate(run.eval_batch)[0])
        if graphed:  # one set of static buffers per event kind, reused
            assert {e: len(g._entries) for e, g in sched._graphs.items()} == {
                "local": 1, "intra": 1, "inter": 1}
    for k, v in got[True][0].items():
        np.testing.assert_array_equal(v, got[False][0][k], err_msg=k)
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)
    assert got[True][1] == got[False][1]
    np.testing.assert_allclose(got[True][1], ref["eval"], rtol=1e-4)


@pytest.fixture(scope="module")
def jax_superstep():
    """Two supersteps (2 x 4 rounds) of the reference's round-superstep-ring."""
    jrun = jscenarios.build_scenario("round-superstep-ring", num_samples=400)
    init = _flat(jrun.runtime.scheduler.params)
    src = jrun.batch_source()
    losses = np.concatenate([np.asarray(jrun.runtime.step(src).losses) for _ in range(2)])
    return {"init": init, "losses": losses, "params": _flat(jrun.runtime.scheduler.params)}


def test_round_body_matches_eager_bitwise_and_tracks_jax(jax_superstep):
    # the scenario's own backend on the CPU, dense: the body copies every
    # new leaf into the state (the cuda backend's in-place path is the sync
    # test's, and the card tests replay it)
    ref = jax_superstep
    got = {}
    for graphed in (False, True):
        _, sched, losses = _body_run("round-superstep-ring", ref["init"], 2, graphed,
                                     num_samples=400)
        assert sched.backend.name == "dense" and sched.rounds_per_step == 4
        got[graphed] = (params_to_numpy(sched.params), losses.numpy())
    np.testing.assert_array_equal(got[True][1], got[False][1])
    np.testing.assert_allclose(got[True][1], ref["losses"], atol=1e-4)
    for k, v in got[True][0].items():
        np.testing.assert_array_equal(v, got[False][0][k], err_msg=k)
        np.testing.assert_allclose(v, ref["params"][k], atol=1e-4, err_msg=k)


# -- (e) the fleet axes' operands through the captured body ---------------------

@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name,steps,kw", [
    # 12 iterations of 4: three rounds, each with its own uniform-k draw
    ("sampled-k-ring", 12, {"tau1": 2, "tau2": 2, "num_samples": 400, "batch_size": 2}),
    # 6 supersteps of 2 rounds: past every fault event and server 2's rejoin
    ("chaos-ring", 6, {"num_samples": 400, "batch_size": 2}),
])
def test_fleet_body_matches_eager_bitwise(name, steps, kw, backend):
    """A round's weights (and mixing matrix) reach the captured body as
    batch entries copied into its static buffers, so one set of buffers per
    event kind (per superstep) serves every round's values: the body moves
    bitwise as the eager loop, round after round."""
    from repro_torch.core.runtime import MIXING, WEIGHTS

    got = {}
    for graphed in (False, True):
        run = tscenarios.build_scenario(name, device="cpu", backend=backend, **kw)
        sched = run.runtime.scheduler
        if graphed:
            if hasattr(sched, "_graphs"):
                sched._graphs = sched._build_graphs()
            else:
                sched._graph = sched._build_graph()
        src = run.batch_source()
        events = [run.runtime.step(src) for _ in range(steps)]
        losses = [e.losses for e in events if e.losses is not None]
        got[graphed] = (params_to_numpy(sched.params), [e.dt for e in events],
                        torch.cat(losses).numpy() if losses else None)
        if graphed:
            steps_ = (sched._graphs.values() if hasattr(sched, "_graphs") else [sched._graph])
            for g in steps_:
                (entry,) = g._entries.values()  # one key: the operands' shapes are fixed
                want = {WEIGHTS, MIXING} if sched.axes.faults is not None else {WEIGHTS}
                assert want <= set(entry.static)
    assert got[True][1] == got[False][1]
    if got[True][2] is not None:
        np.testing.assert_array_equal(got[True][2], got[False][2])
    for k, v in got[True][0].items():
        np.testing.assert_array_equal(v, got[False][0][k], err_msg=k)
