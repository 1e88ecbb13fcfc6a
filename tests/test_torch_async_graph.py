"""The async event as a captured step, the port's examples and the public API they call.

A CUDA graph needs a card, so on the CPU a ``GraphedStep`` copies each
event's batch (client batches and operands: the cluster index, ``1 /
theta_i``, ``theta_i``, ``m^``, the step mask and ``P_t``) into its static
buffers and runs the event body ``AsyncScheduler._event`` over them.  The
body is held bitwise to the ``graph=False`` path (the same operations on the
same values) and within 1e-4 of the reference after 8 events, the tolerance
of the port's other async parity tests (``test_torch_async.py``), with JAX's
cluster models carried in through ``repro_torch.convert`` and the reference's
exact event sequence: on ``straggler-bimodal-async``,
``dropout-participation-async`` (masked ``m^``) and on a ``host-offload``
store.  Tiny runs: ``batch_size=2``, ``theta_max=3``.  The card tests
(``test_torch_cuda.py``) replay the graph itself.

The eight public names the examples call (``RoundScheduler.rounds_for``,
``steps_for``, ``round_time``, ``SyncScheduler.iteration_time``,
``RunConfig.describe``, ``FleetSpec.is_default``,
``scenarios.list_scenarios``, ``data.partition.partition_stats``) are held
equal to the reference's on the same inputs, and each example's ``main``
runs on the CPU at a small size.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.core.config as jconfig
import repro.data.partition as jpartition
import repro.scenarios as jscenarios
import repro_torch.core.config as tconfig
import repro_torch.data.partition as tpartition
import repro_torch.scenarios as tscenarios
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core import ClusterSpec
from repro_torch.core.cuda_graph import copy_into
from repro_torch.core.runtime import (
    CLUSTER, INV_THETA, M_HAT, MIXING, STEP_MASK, THETA,
)

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

TINY = {"num_clients": 8, "num_clusters": 4, "num_samples": 400, "theta_max": 3,
        "batch_size": 2}
EVENTS = 8
CASES = {
    "straggler-bimodal-async": ("straggler-bimodal-async", {}),
    "dropout-participation-async": ("dropout-participation-async", {}),
    "host-offload": ("straggler-bimodal-async", {"store": "host-offload"}),
}


def _recording(runtime):
    events, step = [], runtime.scheduler.step

    def rec(k, src):
        ev = step(k, src)
        events.append((ev.kind, ev.cluster, ev.iteration))
        return ev

    runtime.scheduler.step = rec
    return events


@pytest.fixture(scope="module")
def jax_async():
    out = {}
    for case, (name, kw) in CASES.items():
        jrun = jscenarios.build_scenario(name, backend="dense", **TINY, **kw)
        init = jax.tree.map(lambda a: np.array(a, copy=True), jrun.runtime.scheduler.y)
        events = _recording(jrun.runtime)
        src = jrun.batch_source()
        for _ in range(EVENTS):
            jrun.runtime.step(src)
        out[case] = {"init": init, "events": events, "clock": jrun.runtime.scheduler.clock,
                     "y": jax.tree.map(np.asarray, jrun.runtime.scheduler.y),
                     "global": jax.tree.map(np.asarray, jrun.runtime.global_params())}
    return out


def _torch_async(case, init, backend, graphed):
    name, kw = CASES[case]
    run = tscenarios.build_scenario(name, device="cpu", backend=backend, graph=False,
                                    **TINY, **kw)
    sched = run.runtime.scheduler
    assert sched._graph is None and sched.backend.name == backend
    copy_into(sched.y, params_from_numpy(init, "cpu"))  # the state keeps its tensors
    if graphed:
        sched._graph = sched._build_graph()
    leaves = dict(sched.y)
    events = _recording(run.runtime)
    src = run.batch_source()
    for _ in range(EVENTS):
        run.runtime.step(src)
    assert all(sched.y[k] is v for k, v in leaves.items())
    return run, sched, events


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("case", list(CASES))
def test_event_body_matches_eager_bitwise_and_tracks_jax(jax_async, case, backend):
    ref = jax_async[case]
    got = {}
    for graphed in (False, True):
        run, sched, events = _torch_async(case, ref["init"], backend, graphed)
        assert events == ref["events"]
        assert sched.clock == pytest.approx(ref["clock"], rel=1e-12)
        got[graphed] = (params_to_numpy(sched.y), params_to_numpy(run.runtime.global_params()))
        if graphed:
            # one key: every cluster has g = 2 members, whichever fires
            (entry,) = sched._graph._entries.values()
            assert {CLUSTER, INV_THETA, THETA, M_HAT, STEP_MASK, MIXING} <= set(entry.static)
            assert entry.static[CLUSTER].dtype == torch.int64
            assert tuple(entry.static[MIXING].shape) == (4, 4)
            assert tuple(entry.static[STEP_MASK].shape) == (3, 2)
        if case == "host-offload":
            assert sched.store.kind == "host-offload"
            for k, v in params_to_numpy(sched.store.cluster_models).items():
                np.testing.assert_array_equal(v, got[graphed][0][k], err_msg=k)
    if case == "dropout-participation-async":
        assert {k for k, _, _ in ref["events"]} == {"cluster", "skipped"}
    for label, i in (("y", 0), ("global", 1)):
        for k, v in got[True][i].items():
            np.testing.assert_array_equal(v, got[False][i][k], err_msg=f"{label}/{k}")
            np.testing.assert_allclose(v, ref[label][k], atol=1e-4, err_msg=f"{label}/{k}")


def test_one_graph_per_cluster_size():
    """Uneven clusters (3, 2, 2, 1 members): the body's key is the batch
    shapes, so the captured step keeps one set of static buffers per
    cluster size that fired, and moves bitwise as the eager path."""
    spec = ClusterSpec(8, (0, 0, 0, 1, 1, 2, 2, 3), (1.0,) * 8)
    got, sizes = {}, None
    for graphed in (False, True):
        run = tscenarios.build_scenario("straggler-bimodal-async", device="cpu",
                                        backend="dense", clusters=spec, **TINY)
        sched = run.runtime.scheduler
        if graphed:
            sched._graph = sched._build_graph()
        src = run.batch_source()
        fired = [run.runtime.step(src).cluster for _ in range(EVENTS)]
        got[graphed] = params_to_numpy(sched.y)
        if graphed:
            sizes = {len(sched._members[d]) for d in fired}
            keys = {entry.static[THETA].shape[0] for entry in sched._graph._entries.values()}
            assert keys == sizes and len(sched._graph._entries) == len(sizes) >= 2
    for k, v in got[True].items():
        np.testing.assert_array_equal(v, got[False][k], err_msg=k)


def test_gossip_mix_refuses_p_on_another_device():
    from repro_torch.kernels import gossip_mix, gossip_mix_tree

    y = torch.ones(4, 16)
    p = torch.eye(4, device="meta")
    with pytest.raises(ValueError, match="leaves' device"):
        gossip_mix(y, p)
    with pytest.raises(ValueError, match="leaves' device"):
        gossip_mix_tree({"w": y}, p, inplace=True)
    assert bool((y == 1).all())


class _Event:
    """A profiler record as ``device_kernel_names`` reads it."""

    def __init__(self, name, device, correlation=0):
        self._name, self._device, self._correlation = name, device, correlation

    def name(self):
        return self._name

    def device_type(self):
        return self._device

    def start_ns(self):
        return 2_500_000

    def correlation_id(self):
        return self._correlation


class _Session:
    """A profiler session that comes back with ``events``."""

    def __init__(self, events, **_):
        self.profiler = type("P", (), {})()
        self.profiler.kineto_results = type("R", (), {"events": lambda s: events,
                                                      "trace_start_ns": lambda s: 0})()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_device_kernel_names_refuses_a_session_without_device_records(monkeypatch):
    """A session that recorded the host's launches and no CUDA record raises
    ``EmptySessionError`` (carrying what it saw) instead of counting none."""
    import torch.profiler
    from torch.autograd import DeviceType

    from repro_torch import kernels

    host = [_Event("cudaGraphLaunch", DeviceType.CPU), _Event("aten::add_", DeviceType.CPU)]
    monkeypatch.setattr(kernels, "MARGIN_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(host, **kw))
    with pytest.raises(kernels.EmptySessionError, match="no CUDA record") as err:
        kernels.device_launches(lambda: 7)
    assert err.value.host_launches == [("cudaGraphLaunch", 2.5)]
    # device records: counted; nothing launched at all: an empty count
    ran = host + [_Event("void gossip_mix_kernel<float, 4>(LeafTable)", DeviceType.CUDA)]
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(ran, **kw))
    assert kernels.device_launches(lambda: 7) == (7, {"gossip_mix": 1})
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(host[1:], **kw))
    assert kernels.device_launches(lambda: 7) == (7, {})


def test_device_kernel_names_records_launches_whose_device_records_were_lost(monkeypatch):
    """A session that kept some CUDA records but none of a graph replay's
    (matched by the ``cudaGraphLaunch``'s correlation id) still counts what
    it saw, and appends that replay to ``device_kernel_names.losses``; a
    session whose every replay has its records appends nothing, nor does a
    kernel launch without a record; an empty one appends its launches
    before it raises."""
    import torch.profiler
    from torch.autograd import DeviceType

    from repro_torch import kernels

    monkeypatch.setattr(kernels, "MARGIN_S", 0.0)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(kernels.device_kernel_names, "losses", [])
    cpu, dev = DeviceType.CPU, DeviceType.CUDA
    sgd, tr = "void sgd_update_kernel<float>(LeafTable)", "void fused_transition_kernel<float>"
    kept = [_Event("cudaGraphLaunch", cpu, 1), _Event(sgd, dev, 1), _Event(tr, dev, 1),
            _Event("cudaGraphLaunch", cpu, 2), _Event(sgd, dev, 2),
            _Event("cudaLaunchKernel", cpu, 3), _Event(sgd, dev, 3)]
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(kept, **kw))
    assert kernels.device_launches(lambda: 7) == (7, {"sgd_update": 3, "fused_transition": 1})
    assert kernels.device_kernel_names.losses == []
    lost = kept[:4] + kept[5:]  # the second replay's only record is gone
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(lost, **kw))
    assert kernels.device_launches(lambda: 7) == (7, {"sgd_update": 2, "fused_transition": 1})
    assert kernels.device_kernel_names.losses == [[("cudaGraphLaunch", 2.5)]]
    unmatched = kept[:6]  # a kernel launch whose record is missing
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(unmatched, **kw))
    assert kernels.device_launches(lambda: 7) == (7, {"sgd_update": 2, "fused_transition": 1})
    assert len(kernels.device_kernel_names.losses) == 1
    empty = [_Event("cudaLaunchKernel", cpu, 4)]
    monkeypatch.setattr(torch.profiler, "profile", lambda **kw: _Session(empty, **kw))
    with pytest.raises(kernels.EmptySessionError):
        kernels.device_launches(lambda: 7)
    assert kernels.device_kernel_names.losses[1:] == [[("cudaLaunchKernel", 2.5)]]


def test_check_eager_session_names_the_kernels_whose_records_are_missing():
    """An eager run's device runs short of its host launches raise
    ``ShortSessionError`` naming each short kernel; a whole session passes."""
    from repro_torch import kernels

    host = {"sgd_update": 32, "fused_transition": 12, "flash_attention_fwd": 66,
            "flash_attention_fwd.split_tf32": 66}
    kernels.check_eager_session(dict(host), host)
    short = dict(host, sgd_update=31, **{"flash_attention_fwd.split_tf32": 0})
    with pytest.raises(kernels.ShortSessionError, match="records of these kernels") as err:
        kernels.check_eager_session(short, host)
    assert err.value.missing == {"sgd_update": (31, 32), "flash_attention_fwd.split_tf32": (0, 66)}


# -- the public API the examples call ---------------------------------------------

def test_round_scheduler_rounds_steps_and_round_time_equal_reference():
    jsched = jscenarios.build_scenario("round-superstep-ring", num_samples=400).runtime.scheduler
    tsched = tscenarios.build_scenario("round-superstep-ring", device="cpu",
                                       num_samples=400).runtime.scheduler
    for it in (1, 3, 4, 5, 8, 17, 100, 1000):
        assert tsched.rounds_for(it) == jsched.rounds_for(it), it
        assert tsched.steps_for(it) == jsched.steps_for(it), it
    assert tsched.round_time() == jsched.round_time()


@pytest.mark.parametrize("kw", [{}, {"profile": {"kind": "bimodal-straggler", "speedup": 5.0}}])
def test_sync_iteration_time_equals_reference(kw):
    jsched = jscenarios.build_scenario("mnist-noniid-ring", num_samples=400, tau2=2,
                                       **kw).runtime.scheduler
    tsched = tscenarios.build_scenario("mnist-noniid-ring", device="cpu", num_samples=400,
                                       tau2=2, **kw).runtime.scheduler
    for event in ("local", "intra", "inter"):
        assert tsched.iteration_time(event) == jsched.iteration_time(event), event


@pytest.mark.parametrize("cfg", [
    {"scheduler": "sync", "model": "mnist-cnn", "num_clients": 8, "num_clusters": 4,
     "tau2": 2, "faults": [{"kind": "link-down", "round": 1, "link": [0, 1], "until": 3}]},
    {"scheduler": "round", "model": "mnist-cnn", "num_clients": 8, "num_clusters": 4,
     "rounds_per_step": 2, "prefetch": False, "store": {"kind": "host-offload", "k_max": 4},
     "participation": {"strategy": "uniform-k", "k": 1}, "seed": 3, "num_samples": 400},
    {"scheduler": "async", "model": "mnist-cnn", "num_clients": 8, "num_clusters": 4,
     "psi": "constant", "theta_max": 3, "profile": {"kind": "uniform", "heterogeneity": 4.0},
     "profile_seed": 2, "graph": False},
])
def test_run_config_describe_equals_reference(cfg):
    got = tconfig.RunConfig.from_dict(dict(cfg)).describe()
    assert got == jconfig.RunConfig.from_dict(dict(cfg)).describe()


@pytest.mark.parametrize("kw", [{}, {"profile": "uniform"}, {"profile_seed": 0},
                                {"participation": "full"}, {"store": "dense"},
                                {"faults": []}])
def test_fleet_spec_is_default_equals_reference(kw):
    assert tconfig.FleetSpec(**kw).is_default() == jconfig.FleetSpec(**kw).is_default()


def test_list_scenarios_equals_reference_on_the_ported_names():
    got = tscenarios.list_scenarios()
    assert [s.name for s in got] == sorted(tscenarios.SCENARIOS)
    assert [s.name for s in got] == [s.name for s in jscenarios.list_scenarios()
                                     if s.name in tscenarios.SCENARIOS]
    fields = ("scheduler", "dataset", "partition", "topology", "num_clients", "num_clusters",
              "tau1", "tau2", "alpha", "learning_rate", "profile", "participation", "store",
              "faults", "theta_max")
    for s in got:
        ref = jscenarios.get_scenario(s.name)
        assert [getattr(s, f) for f in fields] == [getattr(ref, f) for f in fields], s.name


@pytest.mark.parametrize("partition", ["iid", "label_skew", "dirichlet"])
def test_partition_stats_equals_reference(partition):
    labels = np.random.default_rng(0).integers(0, 10, 600)
    parts = {
        "iid": lambda: tpartition.iid_partition(labels, 8, seed=1),
        "label_skew": lambda: tpartition.skewed_label_partition(labels, 8, seed=1),
        "dirichlet": lambda: tpartition.dirichlet_partition(labels, 8, seed=1),
    }[partition]()
    got = tpartition.partition_stats(labels, parts)
    ref = jpartition.partition_stats(labels, parts)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


# -- the examples ---------------------------------------------------------------------

def test_quickstart_example_runs_on_the_cpu():
    from repro_torch.examples import quickstart

    hist = quickstart.main(["--device", "cpu", "--clients", "8", "--iters", "6",
                            "--eval-every", "3", "--samples", "600", "--batch", "2"])
    assert hist.iterations == [3, 6] and np.isfinite(hist.loss).all()
    assert 0.0 <= hist.accuracy[-1] <= 1.0


def test_async_heterogeneous_example_runs_on_the_cpu():
    from repro_torch.examples import async_heterogeneous

    out = async_heterogeneous.main(["--device", "cpu", "--clients", "8", "--events", "4",
                                    "--samples", "600", "--batch", "2", "--theta-max", "2"])
    assert set(out) == {"synchronous", "vanilla-async", "staleness-aware"}
    assert all(np.isfinite(h.loss).all() for h in out.values())
    # the same fleet and queue: the two async runs end at the same wall-clock
    assert out["vanilla-async"].wallclock == out["staleness-aware"].wallclock


def test_train_federated_lm_example_runs_on_the_cpu_and_refuses_a_mesh(monkeypatch, capsys):
    from repro_torch.examples import train_federated_lm

    small = ["--device", "cpu", "--steps", "8", "--layers", "1", "--d-model", "32", "--seq",
             "16", "--batch", "1", "--clients", "4", "--heads", "2", "--kv-heads", "1",
             "--head-dim", "16", "--vocab", "128", "--samples", "16"]
    # "auto" is no mesh on a host with fewer devices than clients, and says so
    out = train_federated_lm.main(small + ["--mesh", "auto"])
    assert "mesh=auto resolved to none" in capsys.readouterr().out
    assert (out["rounds"], out["steps"]) == (2, 1)
    assert np.isfinite(out["losses"]).all() and np.isfinite(out["eval_loss"])
    # with a device a client it would be a mesh, which needs one process a
    # client: the port names the launch that starts them
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        train_federated_lm.main(small + ["--mesh", "auto"])
