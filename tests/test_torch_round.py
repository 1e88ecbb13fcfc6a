"""Port parity: the round engine and ``RoundScheduler``.

``build_fl_round_step`` with two rounds per call against the reference's on
a tiny ``CausalLM`` and on ``MnistCNN``, from carried weights and identical
batches; then ``federated-lm-ring`` (tiny widths, S = 16) through
``build_scenario`` against the reference's ``RoundScheduler``, on the
``dense`` backend with the plain attention and on the ``cuda`` backend with
the flash op (CPU tensors take the kernels' plain versions): per-iteration
losses and parameters within 1e-4, eval loss within 1e-4 relative, after 16
protocol iterations — the two packages reduce in different orders and the
difference compounds over the steps.  The MNIST round scenarios are held
to the reference the same way, wall-clock included; their eval losses fall
to about 0.02, so they are compared within 1e-5 absolute.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.core as jcore
import repro.models as jmodels
import repro.optim as joptim
import repro.scenarios as jscenarios
from repro.core.round_engine import build_fl_round_step
import repro_torch.configs as tconfigs
import repro_torch.core as tcore
import repro_torch.models as tmodels
import repro_torch.optim as toptim
import repro_torch.scenarios as tscenarios
from repro_torch.convert import flatten_params, params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

TINY_LM = dict(d_model=64, d_ff=128, num_kv_heads=2, head_dim=16, vocab_size=64)


def _models(kind):
    if kind == "mnist":
        return jmodels.MnistCNN(), tmodels.MnistCNN()
    jcfg = dataclasses.replace(jconfigs.get_config("granite-8b").reduced(), **TINY_LM)
    tcfg = dataclasses.replace(tconfigs.get_config("granite-8b").reduced(), **TINY_LM)
    return jmodels.CausalLM(jcfg), tmodels.CausalLM(tcfg)


def _batches(kind, n, c, rng):
    if kind == "mnist":
        return {"x": rng.normal(size=(n, c, 3, 28, 28, 1)).astype(np.float32),
                "y": rng.integers(0, 10, size=(n, c, 3)).astype(np.int32)}
    tok = rng.integers(0, 64, size=(n, c, 2, 17)).astype(np.int32)
    return {"tokens": tok[..., :-1], "labels": tok[..., 1:]}


def _flat(tree):
    return flatten_params(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("kind", ["lm", "mnist"])
def test_round_step_matches_jax(kind, backend):
    fl = jcore.FLSpec(num_clients=4, num_clusters=2, tau1=2, tau2=2, alpha=2,
                      learning_rate=0.05)
    tfl = tcore.FLSpec(**dataclasses.asdict(fl))
    jmodel, tmodel = _models(kind)
    jparams = jcore.init_stacked(jmodel, 4, jax.random.PRNGKey(1))
    batches = _batches(kind, 2 * 4, 4, np.random.default_rng(0))
    step = build_fl_round_step(jmodel, joptim.sgd(0.05), fl, rounds_per_step=2)
    jnew, _, jlosses = jax.jit(step)(jparams, (), jax.tree.map(jnp.asarray, batches))

    proto = tfl.protocol()
    tb = tcore.resolve_backend(backend, proto.clusters, proto.P(), 2, device="cpu")
    tstep = tcore.build_fl_round_step(tmodel, toptim.sgd(0.05), tfl, backend=tb,
                                      rounds_per_step=2)
    params = params_from_numpy(_flat(jparams), "cpu")
    new, _, losses = tstep(params, (), {k: torch.from_numpy(v) for k, v in batches.items()})
    assert losses.shape == (8,)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses), atol=1e-5)
    ref = _flat(jnew)
    for k, v in params_to_numpy(new).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-5, err_msg=k)
    if backend == "cuda":  # the kernel route updates the stacked params in place
        assert all(new[k] is params[k] for k in new)


def test_round_engine_refuses_unported_variants():
    # the participation and mixing operands are ported (test_torch_participation.py,
    # test_torch_faults.py) and so are client-state stores (test_torch_state.py);
    # a mixing stack without weights has no caller, as in the reference; the
    # gossip engine is ported (the collective backend), and so are a client mesh
    # (test_torch_mesh.py) and graphs on it (test_torch_mesh_graphs.py)
    fl = tcore.FLSpec(num_clients=4, num_clusters=2)
    with pytest.raises(ValueError, match="requires participation=True"):
        tcore.build_fl_round_step(tmodels.MnistCNN(), toptim.sgd(0.1), fl,
                                  mixing=True, device="cpu")
    run = tscenarios.build_scenario("round-compiled-ring", device="cpu", num_samples=400,
                                    participation={"strategy": "uniform-k", "k": 1},
                                    store={"kind": "host-offload", "k_max": 4})
    ev = run.runtime.step(run.batch_source())
    assert run.runtime.scheduler.store.k_max == 4 and bool(torch.isfinite(ev.losses).all())
    rt = tcore.make_run({"scenario": "round-compiled-ring", "num_samples": 400,
                         "backend": None, "impl": "gossip"}, device="cpu")
    assert rt.scheduler.backend.name == "collective"
    with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
        tcore.make_run({"scenario": "round-compiled-ring", "num_samples": 400,
                        "backend": None, "impl": "gossip", "mesh": object()}, device="cpu")
    # binding exchanges nothing, so a mesh without its group reaches the graph
    # rule: on a mesh `graph` resolves by the rank's device, as off it, so a
    # CPU rank's graph=True raises and graph=None is eager
    from repro_torch.launch.mesh import ClientMesh

    mesh = ClientMesh(group=None, axis_name="data", size=8, index=0, device=torch.device("cpu"))
    spec = {"scenario": "round-compiled-ring", "num_samples": 400, "backend": None,
            "impl": "gossip", "mesh": mesh}
    with pytest.raises(ValueError, match="graph=True needs a CUDA device"):
        tcore.make_run({**spec, "graph": True}, device="cpu")
    rt = tcore.make_run({**spec, "graph": None}, device="cpu")
    assert rt.scheduler.mesh is mesh and rt.scheduler._graph is None


LM_SMALL = dict(arch_overrides=dict(d_model=64, d_ff=128), seq_len=16, num_samples=64)


@pytest.fixture(scope="module")
def jax_lm_reference():
    """Two supersteps (16 iterations) of the reference's federated-lm-ring."""
    jrun = jscenarios.build_scenario("federated-lm-ring", **LM_SMALL)
    init = _flat(jrun.runtime.scheduler.params)
    src = jrun.batch_source()
    losses = [np.asarray(jrun.runtime.step(src).losses) for _ in range(2)]
    return {"init": init, "losses": np.concatenate(losses),
            "params": _flat(jrun.runtime.scheduler.params),
            "clusters": _flat(jrun.runtime.cluster_params()),
            "eval": jrun.runtime.evaluate(jrun.eval_batch)[0]}


@pytest.mark.parametrize("backend,impl", [("dense", "plain"), ("cuda", "cuda")])
def test_federated_lm_ring_tracks_jax(jax_lm_reference, backend, impl):
    ref = jax_lm_reference
    small = dict(LM_SMALL, arch_overrides=dict(LM_SMALL["arch_overrides"], attn_impl=impl))
    trun = tscenarios.build_scenario("federated-lm-ring", device="cpu", backend=backend,
                                     **small)
    sched = trun.runtime.scheduler
    assert sched.backend.name == backend and trun.runtime.model.cfg.attn_impl == impl
    assert (sched.rounds_per_step, sched.iterations_per_step) == (2, 8)
    sched.params = params_from_numpy(ref["init"], "cpu")
    src = trun.batch_source()
    events = [trun.runtime.step(src) for _ in range(2)]
    assert [(e.kind, e.iteration, e.dt) for e in events] == [("round", 8, 0.0),
                                                              ("round", 16, 0.0)]
    losses = torch.cat([e.losses for e in events]).numpy()
    np.testing.assert_allclose(losses, ref["losses"], atol=1e-4)
    for name, got in (("params", sched.params), ("clusters", trun.runtime.cluster_params())):
        for k, v in params_to_numpy(got).items():
            np.testing.assert_allclose(v, ref[name][k], atol=1e-4, err_msg=f"{name}/{k}")
    loss, acc = trun.runtime.evaluate(trun.eval_batch)
    assert acc is None
    np.testing.assert_allclose(loss, ref["eval"], rtol=1e-4)


@pytest.mark.parametrize("name", ["round-compiled-ring", "round-superstep-ring"])
def test_mnist_round_scenarios_track_jax(name):
    jrun = jscenarios.build_scenario(name, num_samples=400)
    init = _flat(jrun.runtime.scheduler.params)
    jhist = jrun.runtime.run(2, jrun.batch_source(), jrun.eval_batch, eval_every=1)
    trun = tscenarios.build_scenario(name, device="cpu", num_samples=400)
    assert trun.runtime.scheduler.backend.name == "dense"
    trun.runtime.scheduler.params = params_from_numpy(init, "cpu")
    hist = trun.runtime.run(2, trun.batch_source(), trun.eval_batch, eval_every=1)
    assert hist.iterations == jhist.iterations
    np.testing.assert_allclose(hist.wallclock, jhist.wallclock, rtol=1e-12)
    np.testing.assert_allclose(hist.loss, jhist.loss, atol=1e-5)
    np.testing.assert_allclose(hist.accuracy, jhist.accuracy, atol=1e-6)
    ref = _flat(jrun.runtime.global_params())
    for k, v in params_to_numpy(trun.runtime.global_params()).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-4, err_msg=k)
