"""Port parity: the batched local step and the synchronous runtime end to end.

Both packages start from the same weights (JAX init, carried through numpy)
and draw the same batches (numpy rng streams).  The local step agrees within
1e-5; ten iterations of ``mnist-noniid-ring`` with ``tau2=2`` (local, intra
and inter events) agree within 1e-4 max abs on the parameters and 1e-4
relative on the eval loss — XLA and oneDNN reduce convolutions in different
orders, and the difference compounds over the steps.
"""
import ast
import dataclasses
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.models as jmodels
import repro.optim as joptim
import repro.scenarios as jscenarios
import repro_torch.core as tcore
import repro_torch.models as tmodels
import repro_torch.optim as toptim
import repro_torch.scenarios as tscenarios
from repro_torch.convert import params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _batch(c, b, seed=0):
    rng = np.random.default_rng(seed)
    return {"x": rng.normal(size=(c, b, 28, 28, 1)).astype(np.float32),
            "y": rng.integers(0, 10, size=(c, b)).astype(np.int32)}


@pytest.mark.parametrize("route", ["batched", "fused", "sequential"])
def test_local_step_matches_jax(route):
    c = 4
    jparams = jcore.stacked_init(jmodels.MnistCNN(), c, 3)
    batch = _batch(c, 6)
    jnew, _, jlosses = jcore.build_local_update(jmodels.MnistCNN(), joptim.sgd(0.05))(
        jparams, (), {k: jnp.asarray(v) for k, v in batch.items()}
    )
    model, opt = tmodels.MnistCNN(), toptim.sgd(0.05)
    if route == "sequential":
        step = tcore.build_sequential_local_update(model, opt)
    else:
        backend = tcore.resolve_backend("cuda" if route == "fused" else "dense",
                                        tcore.ClusterSpec.uniform(c, 2), np.eye(2), 1,
                                        device="cpu")
        assert tcore.fused_sgd_applicable(opt, backend) == (route == "fused")
        step = tcore.build_local_update(model, opt, backend=backend)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    new, _, losses = step(tparams, (), {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-5)
    for k, v in params_to_numpy(new).items():
        np.testing.assert_allclose(v, np.asarray(jnew[k]), atol=1e-5, err_msg=k)
    if route == "fused":  # the kernel route writes the stacked params in place
        assert all(new[k] is tparams[k] for k in new)


@pytest.fixture(scope="module")
def jax_reference():
    """Ten iterations of the reference on mnist-noniid-ring, tau2=2, dense."""
    jrun = jscenarios.build_scenario("mnist-noniid-ring", tau2=2, backend="dense")
    init = jax.tree.map(np.asarray, jrun.runtime.scheduler.params)
    hist = jrun.runtime.run(10, jrun.batch_source(), jrun.eval_batch, eval_every=5)
    events = [jrun.runtime.scheduler.cfg.event_at(k) for k in range(1, 11)]
    return {
        "init": init, "hist": hist, "events": events,
        "params": jax.tree.map(np.asarray, jrun.runtime.scheduler.params),
        "global": jax.tree.map(np.asarray, jrun.runtime.global_params()),
        "clusters": jax.tree.map(np.asarray, jrun.runtime.cluster_params()),
    }


@pytest.mark.parametrize("backend", ["dense", "cuda"])
def test_mnist_noniid_ring_tracks_jax(jax_reference, backend):
    ref = jax_reference
    assert {"local", "intra", "inter"} <= set(ref["events"])
    trun = tscenarios.build_scenario("mnist-noniid-ring", device="cpu", tau2=2, backend=backend)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend
    sched.params = params_from_numpy(ref["init"], "cpu")
    hist = trun.runtime.run(10, trun.batch_source(), trun.eval_batch, eval_every=5)
    assert hist.iterations == ref["hist"].iterations
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-12)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    np.testing.assert_allclose(hist.accuracy, ref["hist"].accuracy, atol=1e-6)
    for name, got in (("params", sched.params), ("global", trun.runtime.global_params()),
                      ("clusters", trun.runtime.cluster_params())):
        for k, v in params_to_numpy(got).items():
            np.testing.assert_allclose(v, ref[name][k], atol=1e-4, err_msg=f"{name}/{k}")


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        assert tcore.resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.make_run("mnist-noniid-ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscenarios.build_scenario("mnist-noniid-ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.FederationRuntime(tmodels.MnistCNN(), None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tscenarios.build_scenario("federated-lm-ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.build_fl_round_step(tmodels.MnistCNN(), toptim.sgd(0.1), tcore.FLSpec(4, 2))


@pytest.mark.parametrize("entry", ["DenseBackend", "CudaBackend", "resolve_backend"])
def test_backends_default_to_cuda(entry):
    clusters, p = tcore.ClusterSpec.uniform(8, 4), tcore.mixing_matrix(tcore.ring(4))
    if entry == "resolve_backend":
        def build(dev):
            return tcore.resolve_backend("cuda", clusters, p, 1, device=dev)
    else:
        def build(dev):
            return getattr(tcore, entry)(clusters, p, 1, device=dev)
    assert build("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert build(None).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(None)


@pytest.mark.parametrize("override,error", [
    # client-state stores run on every scheduler, or raise the reference's own
    # ValueError (a sparse store with no participation plan); mesh "auto" is no
    # mesh on a host with fewer devices than clients, as in the reference, an
    # object that is no mesh raises, and the async scheduler takes no mesh
    # (the reference's refuses the key)
    ({"store": {"kind": "host-offload", "k_max": 4}}, ValueError),
    ({"store": "host-offload", "participation": {"strategy": "uniform-k", "k": 2}}, None),
    ({"mesh": "auto"}, "no mesh"),
    ({"mesh": "auto", "faults": [{"kind": "link-down", "round": 1, "link": [0, 1]}]},
     "no mesh"),
    ({"mesh": object()}, "not a mesh"),
    ({"scenario": "round-compiled-ring", "store": {"kind": "host-offload", "k_max": 4}},
     ValueError),
    ({"scenario": "dropout-participation-async", "num_clients": 8, "theta_max": 2,
      "store": "host-offload"}, None),
    ({"scheduler": "async", "mesh": "auto", "psi": "staleness"}, TypeError),
])
def test_non_default_fleet_raises(override, error):
    override = dict(override)
    name = override.pop("scenario", "mnist-iid-ring")

    def build_and_step():
        run = tscenarios.build_scenario(name, device="cpu", num_samples=400, batch_size=2,
                                        **override)
        run.runtime.step(run.batch_source())
        return run.runtime

    if error is NotImplementedError:
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            build_and_step()
    elif error == "no mesh":
        assert build_and_step().scheduler.mesh is None
    elif error == "not a mesh":
        with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
            build_and_step()
    elif error is TypeError:
        with pytest.raises(TypeError, match="unused scenario keys"):
            build_and_step()
    elif error is ValueError:
        with pytest.raises(ValueError, match="needs a participation mask"):
            build_and_step()
    else:
        run = build_and_step()
        assert run.scheduler.store.kind == "host-offload"
        assert run.scheduler.store.device_bytes() > 0


@pytest.mark.parametrize("scenario,extra", [
    ("mnist-iid-ring", {}), ("round-compiled-ring", {}),
    ("straggler-bimodal-async", {"num_clients": 8, "profile": None})])
@pytest.mark.parametrize("axis", [
    {"profile": {"kind": "uniform", "heterogeneity": 2.0}, "profile_seed": 3},
    {"participation": {"strategy": "uniform-k", "k": 2}},
    {"faults": [{"kind": "link-down", "round": 1, "link": [0, 1]}]},
])
def test_fleet_axes_are_taken_by_every_scheduler(scenario, extra, axis):
    run = tcore.make_run({"scenario": scenario, "num_samples": 400, **extra, **axis},
                         device="cpu")
    sched = run.scheduler
    assert (sched.fleet.profile, sched.fleet.participation, sched.fleet.faults) == (
        axis.get("profile"), axis.get("participation"), axis.get("faults"))
    assert (sched.axes.plan is not None) == ("participation" in axis)
    assert (sched.axes.faults is not None) == ("faults" in axis)


@pytest.mark.parametrize("owner", ["SyncScheduler", "RoundScheduler", "AsyncScheduler"])
def test_deprecated_fleet_keywords_warn_and_fold_into_the_fleet_spec(owner):
    legacy = {"participation": {"strategy": "uniform-k", "k": 2}}
    if owner != "AsyncScheduler":  # the reference's async scheduler takes no profile
        legacy["profile"] = {"kind": "uniform", "heterogeneity": 2.0}

    def make(mod, **kw):
        first = (mod.FLSpec(8, 4) if owner == "RoundScheduler"
                 else mod.SDFEELConfig(mod.ClusterSpec.uniform(8, 4), mod.ring(4)))
        return getattr(mod, owner)(first, **legacy, **kw)

    with pytest.warns(DeprecationWarning, match="keywords are deprecated") as jw:
        jsched = make(jcore)
    with pytest.warns(DeprecationWarning, match="keywords are deprecated") as tw:
        tsched = make(tcore)
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]
    assert tsched.fleet == tcore.FleetSpec(**legacy)
    assert dataclasses.asdict(tsched.fleet) == dataclasses.asdict(jsched.fleet)
    # folded into a given fleet, whose other axes stay
    fleet = tcore.FleetSpec(store="host-offload")
    with pytest.warns(DeprecationWarning):
        assert make(tcore, fleet=fleet).fleet == dataclasses.replace(fleet, **legacy)


def test_store_refusal_names_its_roadmap_item():
    # a store is ported: what it refuses is the reference's (faults need
    # resident state); a mesh that is none of None, "auto" and a ClientMesh
    # is refused by name
    with pytest.raises(ValueError, match="fault injection requires a resident"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400,
                        "store": "host-offload",
                        "faults": [{"kind": "link-down", "round": 1, "link": [0, 1]}]},
                       device="cpu")
    with pytest.raises(ValueError, match="exec.mesh must be None, 'auto', or a ClientMesh"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400, "mesh": object()},
                       device="cpu")
    with pytest.raises(TypeError, match="fleet.participation must be"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400,
                        "participation": 3}, device="cpu")


def test_unknown_keys_and_scenarios_raise():
    with pytest.raises(TypeError, match="unused scenario keys"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400, "tua1": 3},
                       device="cpu")
    with pytest.raises(KeyError, match="unknown scenario"):
        tcore.make_run("no-such-scenario", device="cpu")


def test_registered_scenarios_match_reference():
    for name, sc in tscenarios.SCENARIOS.items():
        ref = jscenarios.get_scenario(name)
        for field in ("scheduler", "dataset", "partition", "partition_params", "topology",
                      "backend", "num_clients", "num_clusters", "tau1", "tau2", "alpha",
                      "learning_rate", "batch_size", "num_samples", "profile",
                      "participation", "store", "faults", "psi",
                      "min_batches", "theta_max", "rounds_per_step", "arch",
                      "arch_overrides", "seq_len", "vocab_size"):
            assert getattr(sc, field) == getattr(ref, field), (name, field)
    assert set(tscenarios.SCENARIOS) == {
        "mnist-iid-ring", "mnist-noniid-ring", "mnist-noniid-star", "cifar-dirichlet-torus",
        "round-compiled-ring", "round-superstep-ring", "federated-lm-ring",
        "straggler-bimodal-async", "straggler-bimodal-vanilla", "dropout-heavy",
        "exponential-hetero-async", "sampled-k-ring", "chaos-ring",
        "dropout-participation-async", "million-client-ring", "federated-lm-serving",
        "lm-serving-continuous",
    }


def _imports(path: pathlib.Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_port_imports_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    assert {"profiles.py", "timing.py"} <= {f.name for f in files if f.parent.name == "hetero"}
    assert {"cuda_graph.py", "pipeline.py", "baselines.py", "theory.py"} <= {
        f.name for f in files if f.parent.name == "core"}
    assert {"participation", "faults", "state", "checkpoint", "examples", "serving",
            "launch"} <= {f.parent.name for f in files if f.name == "__init__.py"}
    assert {"engine.py", "slots.py", "federated.py", "traffic.py"} <= {
        f.name for f in files if f.parent.name == "serving"}
    assert {"serve.py", "train.py", "mesh.py"} <= {
        f.name for f in files if f.parent.name == "launch"}
    assert "rules.py" in {f.name for f in files if f.parent.name == "sharding"}
    assert "shapes.py" in {f.name for f in files if f.parent.name == "configs"}
    assert {"quickstart.py", "async_heterogeneous.py", "train_federated_lm.py",
            "serve_batched.py", "serve_decode.py", "serve_federated.py"} <= {
        f.name for f in files if f.parent.name == "examples"}
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
