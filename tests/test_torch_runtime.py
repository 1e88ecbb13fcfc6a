"""Port parity: the batched local step and the synchronous runtime end to end.

Both packages start from the same weights (JAX init, carried through numpy)
and draw the same batches (numpy rng streams).  The local step agrees within
1e-5; ten iterations of ``mnist-noniid-ring`` with ``tau2=2`` (local, intra
and inter events) agree within 1e-4 max abs on the parameters and 1e-4
relative on the eval loss — XLA and oneDNN reduce convolutions in different
orders, and the difference compounds over the steps.
"""
import ast
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


@pytest.mark.parametrize("override", [
    {"participation": {"strategy": "uniform-k", "k": 2}},
    {"profile": {"kind": "uniform"}},
    {"store": {"kind": "host-offload", "k_max": 4}},
    {"faults": [{"kind": "link-down", "round": 1, "link": [0, 1]}]},
    {"mesh": "auto"},
    # the round scheduler is ported for the default fleet only
    {"scheduler": "round", "store": {"kind": "host-offload", "k_max": 4}},
    # the reference's dropout-participation-async: async with availability sampling
    {"scheduler": "async", "participation": "availability", "psi": "staleness",
     "profile": {"kind": "uniform", "heterogeneity": 4.0, "availability": 0.7}},
])
def test_non_default_fleet_raises(override):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400, **override},
                       device="cpu")


def test_unknown_keys_and_scenarios_raise():
    with pytest.raises(TypeError, match="unused scenario keys"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 400, "tua1": 3},
                       device="cpu")
    with pytest.raises(KeyError, match="unknown scenario"):
        tcore.make_run("sampled-k-ring", device="cpu")


def test_registered_scenarios_match_reference():
    for name, sc in tscenarios.SCENARIOS.items():
        ref = jscenarios.get_scenario(name)
        for field in ("scheduler", "dataset", "partition", "partition_params", "topology",
                      "backend", "num_clients", "num_clusters", "tau1", "tau2", "alpha",
                      "learning_rate", "batch_size", "num_samples", "profile", "psi",
                      "min_batches", "theta_max", "rounds_per_step", "arch",
                      "arch_overrides", "seq_len", "vocab_size"):
            assert getattr(sc, field) == getattr(ref, field), (name, field)
    assert set(tscenarios.SCENARIOS) == {
        "mnist-iid-ring", "mnist-noniid-ring", "mnist-noniid-star", "cifar-dirichlet-torus",
        "round-compiled-ring", "round-superstep-ring", "federated-lm-ring",
        "straggler-bimodal-async", "straggler-bimodal-vanilla", "dropout-heavy",
        "exponential-hetero-async",
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
    for path in files:
        bad = _imports(path) & {"jax", "jaxlib", "repro"}
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"
