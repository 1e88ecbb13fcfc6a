"""Port parity: the stateful optimizers (``repro_torch.optim``) and each
client's optimizer state on every path that takes an optimizer.

Every case draws its inputs from numpy seeds, passes them through the JAX
package and the port, and holds the port to JAX:

* ``sgd``, ``momentum`` and ``adam`` leaf by leaf (parameters and state,
  named as the checkpoints name them) over 10 steps, f32 and bf16
  parameters, f32 and bf16 ``state_dtype``: f32 leaves within 1e-6, bf16
  leaves within one bf16 ulp at the scale of the reference's leaf (its
  largest entry; SGD's bf16 rounding, which this port keeps, is a few ulps
  of the smaller entries after 10 steps; momentum's and Adam's bf16 leaves
  come out bitwise here);
  ``clip_by_global_norm`` within 1e-6; the reference's three
  ``tests/test_optim.py`` cases, mirrored.
* ``core.build_local_update`` on MnistCNN, C = 4, 10 micro-steps: momentum
  on ``opt.init`` of the stack, Adam on ``torch.func.vmap(opt.init)``
  (``jax.vmap`` on JAX's side), within 1e-5; Adam's scalar step over a
  stack refused, as the reference refuses it; the sequential stage with
  momentum within 1e-6 of the batched stage over 3 micro-steps (relative to
  a leaf's largest entry where that is above 1, and the losses, near 5,
  relative: the per-client convolution gradients round apart).
* ``round-superstep-ring`` with ``optimizer=momentum`` through
  ``build_scenario`` within 1e-4 of JAX's after 10 iterations, and
  ``million-client-ring`` (10^3 clients) with momentum, whose state restarts
  every superstep under offload, within 1e-4 of JAX's over 3 supersteps.
* the ``microbatch`` train step with momentum within 1e-5.
* the ``DeviceMesh`` train step with momentum and the whole stack on every
  rank (a ``(data=1, model=2)`` mesh of 2 gloo ranks started from this file
  through ``tests/test_torch_mesh.py``'s launcher), within 1e-5 of JAX's
  step without a mesh after 3 steps.
* a checkpoint holding ``adam(0.1).init(...)`` crossing both ways, by name
  (``opt/.step``, ``opt/.m/w``, ...) and leaf for leaf.
"""
import dataclasses
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

C, D, B, LR, STEPS = 4, 2, 2, 0.05, 10
SHAPES = {"w": (4, 3, 5), "b": (4, 7), "s": (2,)}
MESH_STEPS = 3
# the DeviceMesh case's model: one block of a reduced dense config
MESH_LM = dict(num_heads=4, num_kv_heads=2, head_dim=16, d_model=64, d_ff=128, vocab_size=256,
               attn_chunk=16, num_layers=1)
MESH_SEQ = 16


def _jax():
    import jax
    import jax.numpy as jnp

    return jax, jnp


def _np(x) -> np.ndarray:
    """A JAX array or a torch tensor as a float numpy array (bf16 widened)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x.astype("float32") if x.dtype.name == "bfloat16" else x)


def _named(tree, package) -> dict:
    """``{checkpoint name: float array}`` of a tree of ``package``'s."""
    if package == "jax":
        from repro.checkpoint import flatten_with_names
    else:
        from repro_torch.checkpoint import flatten_with_names
    return {n: _np(x) for n, x in flatten_with_names(tree)}


def _bf16_ulp(x: np.ndarray) -> float:
    """One bf16 ulp (8 significand bits) at the scale of ``x``: its largest
    magnitude."""
    return float(np.exp2(np.floor(np.log2(max(np.abs(x).max(), 1e-30))) - 7))


def _hold_named(got: dict, want: dict, bf16: set) -> None:
    assert got.keys() == want.keys()
    for k, v in got.items():
        if k in bf16:
            np.testing.assert_allclose(v, want[k], atol=_bf16_ulp(want[k]), rtol=0, err_msg=k)
        else:
            np.testing.assert_allclose(v, want[k], atol=1e-6, rtol=0, err_msg=k)


def _make(name, package, state_dtype):
    if package == "jax":
        import jax.numpy as jnp
        from repro import optim

        sd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[state_dtype]
    else:
        from repro_torch import optim

        sd = {"f32": torch.float32, "bf16": torch.bfloat16}[state_dtype]
    if name == "sgd":
        return optim.sgd(0.1)
    if name == "momentum":
        return optim.momentum(0.1, state_dtype=sd)
    return optim.adam(0.05, weight_decay=0.01, state_dtype=sd)


CASES = [("sgd", pd, "f32") for pd in ("f32", "bf16")] + [
    (name, pd, sd) for name in ("momentum", "adam") for pd in ("f32", "bf16")
    for sd in ("f32", "bf16")]


@pytest.mark.parametrize("name,param_dtype,state_dtype", CASES)
def test_optimizer_matches_jax_leaf_by_leaf(name, param_dtype, state_dtype):
    jax, jnp = _jax()
    jopt, topt = _make(name, "jax", state_dtype), _make(name, "torch", state_dtype)
    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}[param_dtype]
    td = {"f32": torch.float32, "bf16": torch.bfloat16}[param_dtype]
    rng = np.random.default_rng(0)
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    jp = {k: jnp.asarray(v).astype(jd) for k, v in p0.items()}
    tp = {k: torch.tensor(v).to(td) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    update = jax.jit(jopt.update)
    for _ in range(STEPS):
        g = {k: rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
        jp, js = update(jp, {k: jnp.asarray(v).astype(jd) for k, v in g.items()}, js)
        tp, ts = topt.update(tp, {k: torch.tensor(v).to(td) for k, v in g.items()}, ts)
    from repro_torch.checkpoint import flatten_with_names

    got, want = _named({"p": tp, "s": ts}, "torch"), _named({"p": jp, "s": js}, "jax")
    bf16 = {n for n, x in flatten_with_names({"p": tp, "s": ts}) if x.dtype == torch.bfloat16}
    assert all(x.dtype == td for x in tp.values())
    if name == "adam":
        assert ts.step.dtype == torch.int32 and int(ts.step) == STEPS
    _hold_named(got, want, bf16)


def test_clip_by_global_norm_matches_jax():
    jax, jnp = _jax()
    from repro import optim as joptim
    from repro_torch import optim as toptim

    rng = np.random.default_rng(1)
    g = {k: 3 * rng.standard_normal(s).astype(np.float32) for k, s in SHAPES.items()}
    for max_norm in (1.0, 1e4):  # clipped, and left as it is
        want = joptim.clip_by_global_norm({k: jnp.asarray(v) for k, v in g.items()}, max_norm)
        got = toptim.clip_by_global_norm({k: torch.tensor(v) for k, v in g.items()}, max_norm)
        for k, v in got.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(want[k]), atol=1e-6, rtol=0)
    bf = toptim.clip_by_global_norm({"a": torch.full((4,), 10.0, dtype=torch.bfloat16)}, 1.0)
    assert bf["a"].dtype == torch.bfloat16


# -- the reference's tests/test_optim.py, mirrored --------------------------------------

def _quad_loss(p):
    return torch.sum((p["w"] - 3.0) ** 2) + torch.sum((p["b"] + 1.0) ** 2)


@pytest.mark.parametrize("make", ["sgd", "momentum", "adam"])
def test_optimizers_minimize_quadratic(make):
    from repro_torch import optim

    opt = {"sgd": lambda: optim.sgd(0.1), "momentum": lambda: optim.momentum(0.05),
           "adam": lambda: optim.adam(0.2)}[make]()
    params = {"w": torch.zeros(4), "b": torch.ones(3)}
    state = opt.init(params)
    grad = torch.func.grad(_quad_loss)
    for _ in range(150):
        params, state = opt.update(params, grad(params), state)
    assert float(_quad_loss(params)) < 1e-2


def test_adam_bf16_state_dtype():
    from repro_torch import optim

    opt = optim.adam(0.1, state_dtype=torch.bfloat16)
    params = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    state = opt.init(params)
    assert state.m["w"].dtype == torch.bfloat16
    params2, state2 = opt.update(params, {"w": torch.ones(4, dtype=torch.bfloat16)}, state)
    assert params2["w"].dtype == torch.bfloat16
    assert float(params2["w"][0]) < 0


def test_clip_by_global_norm():
    from repro_torch import optim

    clipped = optim.clip_by_global_norm({"a": torch.full((4,), 10.0)}, 1.0)
    norm = torch.sqrt(sum(torch.sum(x ** 2) for x in clipped.values()))
    assert float(norm) == pytest.approx(1.0, rel=1e-5)


# -- the local-update stages ---------------------------------------------------------------

@pytest.fixture(scope="module")
def mnist():
    """A stacked MnistCNN of C clients (each its own weights, 1/sqrt(fan-in)
    normal draws) and 10 micro-batches, from numpy seeds."""
    from repro_torch.models import MnistCNN

    rng = np.random.default_rng(0)
    init = {}
    for k, v in MnistCNN().init(torch.Generator()).items():
        fan_in = int(np.prod(v.shape[:-1])) if v.ndim > 1 else 1
        init[k] = (rng.standard_normal((C,) + tuple(v.shape)) / np.sqrt(fan_in)).astype(
            np.float32)
    batches = [{"x": rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32),
                "y": rng.integers(0, 10, (C, B)).astype(np.int32)} for _ in range(STEPS)]
    return init, batches


def _tensors(tree: dict) -> dict:
    from repro_torch.convert import params_from_numpy

    return params_from_numpy(tree, "cpu")


def _jax_local(name, init, batches):
    """The reference's batched local stage, ``len(batches)`` micro-steps."""
    jax, jnp = _jax()
    import repro.models as jmodels
    from repro import optim as joptim
    from repro.core.local_update import build_local_update

    opt = joptim.momentum(LR) if name == "momentum" else joptim.adam(1e-3)
    params = jax.tree.map(jnp.asarray, init)
    state = opt.init(params) if name == "momentum" else jax.vmap(opt.init)(params)
    step = jax.jit(build_local_update(jmodels.MnistCNN(), opt))
    losses = []
    for b in batches:
        params, state, loss = step(params, state, jax.tree.map(jnp.asarray, b))
        losses.append(np.asarray(loss))
    return params, state, np.stack(losses)


@pytest.mark.parametrize("name", ["momentum", "adam"])
def test_local_update_keeps_each_clients_state(mnist, name):
    from repro_torch import optim as toptim
    from repro_torch.core.local_update import build_local_update
    from repro_torch.models import MnistCNN

    init, batches = mnist
    jp, js, jl = _jax_local(name, init, batches)
    opt = toptim.momentum(LR) if name == "momentum" else toptim.adam(1e-3)
    params = _tensors(init)
    # momentum's buffers over the stack are each client's rows already; Adam's
    # step needs the per-client init, as in the reference
    state = opt.init(params) if name == "momentum" else torch.func.vmap(opt.init)(params)
    if name == "adam":
        assert state.step.shape == (C,) and state.step.is_contiguous()
    step = build_local_update(MnistCNN(), opt)
    losses = []
    for b in batches:
        params, state, loss = step(params, state, _tensors(b))
        losses.append(loss.numpy())
    np.testing.assert_allclose(np.stack(losses), jl, atol=1e-5, rtol=0)
    got, want = _named({"p": params, "s": state}, "torch"), _named({"p": jp, "s": js}, "jax")
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=0, err_msg=k)


def test_adam_with_one_step_over_the_stack_is_refused_as_in_jax(mnist):
    jax, jnp = _jax()
    import repro.models as jmodels
    from repro import optim as joptim
    from repro.core.local_update import build_local_update as j_build
    from repro_torch import optim as toptim
    from repro_torch.core.local_update import build_local_update
    from repro_torch.models import MnistCNN

    init, batches = mnist
    jparams = jax.tree.map(jnp.asarray, init)
    jopt = joptim.adam(1e-3)
    with pytest.raises(ValueError):
        jax.jit(j_build(jmodels.MnistCNN(), jopt))(jparams, jopt.init(jparams),
                                                   jax.tree.map(jnp.asarray, batches[0]))
    opt = toptim.adam(1e-3)
    params = _tensors(init)
    state = opt.init(params)
    assert state.step.shape == ()
    with pytest.raises(ValueError, match="dimensionality 0"):
        build_local_update(MnistCNN(), opt)(params, state, _tensors(batches[0]))


def test_sequential_local_update_matches_the_batched_stage(mnist):
    from repro_torch import optim as toptim
    from repro_torch.core.local_update import (
        build_local_update, build_sequential_local_update,
    )
    from repro_torch.models import MnistCNN

    init, batches = mnist
    opt = toptim.momentum(LR)
    outs = []
    for build in (build_local_update, build_sequential_local_update):
        params = _tensors(init)
        state = opt.init(params)
        step = build(MnistCNN(), opt)
        for b in batches[:3]:  # the state carried through two updates
            params, state, loss = step(params, state, _tensors(b))
        outs.append((params, state, loss))
    (bp, bs, bl), (sp, ss, sl) = outs
    np.testing.assert_allclose(sl.numpy(), bl.numpy(), atol=0, rtol=1e-6)  # losses near 5
    for got, want in ((sp, bp), (ss, bs)):
        assert got.keys() == want.keys()
        for k, v in got.items():
            assert v.shape == want[k].shape
            w = want[k].numpy()
            np.testing.assert_allclose(v.numpy(), w, atol=1e-6 * max(1.0, np.abs(w).max()),
                                       rtol=0, err_msg=k)


def test_microbatch_train_step_with_momentum_matches_jax(mnist):
    jax, jnp = _jax()
    import repro.core as jcore
    import repro.models as jmodels
    from repro import optim as joptim
    import repro_torch.core as tcore
    from repro_torch import optim as toptim
    from repro_torch.models import MnistCNN

    init, batches = mnist
    fl = dict(num_clients=C, num_clusters=D, alpha=2, learning_rate=LR)
    jopt = joptim.momentum(LR)
    jstep = jax.jit(jcore.build_fl_train_step(jmodels.MnistCNN(), jopt, jcore.FLSpec(**fl),
                                              event="inter", microbatch=2))
    topt = toptim.momentum(LR)
    tstep = tcore.build_fl_train_step(MnistCNN(), topt, tcore.FLSpec(**fl), event="inter",
                                      microbatch=2, device="cpu")
    jp = jax.tree.map(jnp.asarray, init)
    js = jopt.init(jp)
    tp = _tensors(init)
    ts = topt.init(tp)
    for b in batches[:3]:
        jp, js, jl = jstep(jp, js, jax.tree.map(jnp.asarray, b))
        tp, ts, tl = tstep(tp, ts, _tensors(b))
        np.testing.assert_allclose(float(tl), float(jl), atol=1e-5, rtol=0)
    got, want = _named({"p": tp, "s": ts}, "torch"), _named({"p": jp, "s": js}, "jax")
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=0, err_msg=k)


# -- the schedulers --------------------------------------------------------------------------

def test_round_superstep_ring_with_momentum_tracks_jax():
    jax, _ = _jax()
    import repro.scenarios as jscenarios
    from repro import optim as joptim
    import repro_torch.scenarios as tscenarios
    from repro_torch import optim as toptim
    from repro_torch.convert import flatten_params

    jrun = jscenarios.build_scenario("round-superstep-ring", num_samples=400,
                                     optimizer=joptim.momentum(LR))
    init = flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))
    jhist = jrun.runtime.run(10, jrun.batch_source(), jrun.eval_batch, eval_every=1)
    trun = tscenarios.build_scenario("round-superstep-ring", device="cpu", num_samples=400,
                                     optimizer=toptim.momentum(LR))
    sched = trun.runtime.scheduler
    assert sched.optimizer.name == "momentum" and sched.opt_state.keys() == sched.params.keys()
    sched.params = _tensors(init)
    hist = trun.runtime.run(10, trun.batch_source(), trun.eval_batch, eval_every=1)
    assert hist.iterations == jhist.iterations
    np.testing.assert_allclose(hist.loss, jhist.loss, atol=1e-4, rtol=0)
    want = _named({"p": jrun.runtime.scheduler.params, "s": jrun.runtime.scheduler.opt_state},
                  "jax")
    got = _named({"p": sched.params, "s": sched.opt_state}, "torch")
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-4, rtol=0, err_msg=k)


def test_offloaded_momentum_restarts_every_superstep_as_in_jax():
    jax, _ = _jax()
    import repro.scenarios as jscenarios
    from repro import optim as joptim
    import repro_torch.scenarios as tscenarios
    from repro_torch import optim as toptim
    from repro_torch.convert import store_from_numpy

    kw = dict(num_clients=1000)
    jrun = jscenarios.build_scenario("million-client-ring", optimizer=joptim.momentum(LR), **kw)
    trun = tscenarios.build_scenario("million-client-ring", device="cpu", backend="cuda",
                                     optimizer=toptim.momentum(LR), **kw)
    jst, sched = jrun.runtime.scheduler.store, trun.runtime.scheduler
    store_from_numpy(sched.store, jax.tree.map(np.asarray, jst.cluster_models))
    jsrc, tsrc = jrun.batch_source(), trun.batch_source()
    for _ in range(3):
        je, te = jrun.runtime.step(jsrc), trun.runtime.step(tsrc)
        np.testing.assert_allclose(te.losses.numpy(), np.asarray(je.losses), atol=1e-4, rtol=0)
    for k, y in sched.store.cluster_models.items():
        np.testing.assert_allclose(y.numpy(), np.asarray(jst.cluster_models[k]), atol=1e-4,
                                   rtol=0, err_msg=k)
    # the state moved within each superstep (a restart zeroes it before the next)
    assert all(float(v.abs().max()) > 0 for v in sched.opt_state.values())


# -- the DeviceMesh step, in a gloo world ------------------------------------------------------

def _mesh_cfg(configs):
    return dataclasses.replace(configs.get_config("qwen2.5-3b").reduced(), **MESH_LM)


def _mesh_batch(cfg, it: int) -> dict:
    rng = np.random.default_rng(2000 + it)
    return {k: rng.integers(0, cfg.vocab_size, size=(C, 2, MESH_SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


def _mesh_fl():
    return dict(num_clients=C, num_clusters=D, tau1=1, tau2=1, alpha=1, learning_rate=LR)


def _w2(rank: int, size: int, out: Path) -> dict:
    """``build_fl_train_step`` with momentum on a ``(data=1, model=2)``
    ``DeviceMesh``: every rank holds the whole client stack."""
    import repro_torch.configs as tconfigs
    from repro_torch import optim
    from repro_torch.core import FLSpec, build_fl_train_step
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.mesh import mesh_axes_for
    from repro_torch.launch.steps import _stacked_shapes
    from repro_torch.models import CausalLM
    from repro_torch.sharding import activation_sharding, distribute_params
    from repro_torch.sharding.rules import batch_pspecs, param_pspecs
    from repro_torch.configs.shapes import input_specs, InputShape

    cfg = _mesh_cfg(tconfigs)
    mesh = make_test_mesh(1, size, device="cpu")
    ax = mesh_axes_for(mesh)
    model = CausalLM(cfg)
    with np.load(out / "params.npz") as z:
        stack = _tensors(dict(z))
    pspecs = param_pspecs(cfg, _stacked_shapes(model, C), ax, client_axis=ax.data)
    bspecs = batch_pspecs(cfg, input_specs(cfg, InputShape("t", MESH_SEQ, 2 * C, "train"),
                                           num_clients=C), ax, "train", federated=True)
    opt = optim.momentum(LR)
    step = build_fl_train_step(model, opt, FLSpec(**_mesh_fl()), event="inter", mesh=mesh,
                               client_axis=ax.data)
    params = distribute_params(stack, pspecs, mesh)
    state = opt.init(params)
    losses = []
    for it in range(MESH_STEPS):
        batch = distribute_params(_tensors(_mesh_batch(cfg, it)), bspecs, mesh)
        with activation_sharding(mesh, (), ax.model, moe_shard_map=False):
            params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    full = lambda t: {k: v.full_tensor().float().numpy().copy() for k, v in t.items()}
    return {"params": full(params), "state": full(state), "losses": np.asarray(losses),
            "placements": {k: str(v.placements) for k, v in state.items()},
            "param_placements": {k: str(v.placements) for k, v in params.items()}}


WORLDS = {"w2": lambda rank, size: _w2(rank, size, Path(sys.argv[5]))}


@pytest.fixture(scope="module")
def mesh_world(tmp_path_factory):
    """The ranks' results and JAX's step without a mesh, 3 steps with
    momentum from the same stack."""
    jax, jnp = _jax()
    import repro.configs as jconfigs
    import repro.core as jcore
    from repro import optim as joptim
    from repro.models import CausalLM as JCausalLM
    from repro_torch.convert import flatten_params, unflatten_params

    import repro_torch.configs as tconfigs
    from repro_torch.models import CausalLM

    out = tmp_path_factory.mktemp("optim_w2")
    # the stack from a numpy seed, one client's leaves replicated (norm scales
    # near 1), saved before the ranks start; JAX steps while they run
    rng = np.random.default_rng(5)
    flat = {}
    for k, v in CausalLM(_mesh_cfg(tconfigs)).param_shapes().items():
        x = rng.standard_normal(tuple(v.shape)).astype(np.float32)
        x = 1 + 0.1 * x if "norm" in k else 0.05 * x
        flat[k] = np.ascontiguousarray(np.broadcast_to(x, (C,) + x.shape))
    np.savez(out / "params.npz", **flat)
    procs = _start_world("w2", 2, out, script=__file__)
    jmodel = JCausalLM(_mesh_cfg(jconfigs))
    opt = joptim.momentum(LR)
    step = jax.jit(jcore.build_fl_train_step(jmodel, opt, jcore.FLSpec(**_mesh_fl()),
                                             event="inter"))
    params = jax.tree.map(jnp.asarray, unflatten_params(flat))
    state, losses = opt.init(params), []
    for it in range(MESH_STEPS):
        params, state, loss = step(params, state,
                                   jax.tree.map(jnp.asarray, _mesh_batch(jmodel.cfg, it)))
        losses.append(float(loss))
    ref = {"params": flatten_params(jax.tree.map(np.asarray, params)),
           "state": flatten_params(jax.tree.map(np.asarray, state)),
           "losses": np.asarray(losses)}
    return _results(procs, out), ref


def test_device_mesh_step_with_momentum_matches_jax(mesh_world):
    ranks, ref = mesh_world
    for r, got in enumerate(ranks):
        np.testing.assert_allclose(got["losses"], ref["losses"], atol=1e-5, rtol=0)
        for part in ("params", "state"):
            assert got[part].keys() == ref[part].keys()
            for k, v in got[part].items():
                np.testing.assert_allclose(v, ref[part][k], atol=1e-5, rtol=0,
                                           err_msg=f"rank {r} {part} {k}")
        # the state is laid out as its parameter
        assert got["placements"] == got["param_placements"]


# -- checkpoints -----------------------------------------------------------------------------

def test_adam_state_checkpoint_crosses_both_ways_by_name(tmp_path):
    jax, jnp = _jax()
    from repro import optim as joptim
    from repro.checkpoint import flatten_with_names as j_names
    from repro.checkpoint import restore_checkpoint as j_restore
    from repro.checkpoint import save_checkpoint as j_save
    from repro_torch import optim as toptim
    from repro_torch.checkpoint import flatten_with_names, restore_checkpoint, save_checkpoint
    from repro_torch.convert import opt_state_from_numpy

    rng = np.random.default_rng(4)
    p = {"w": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal((4,)).astype(np.float32)}
    jopt, topt = joptim.adam(0.1), toptim.adam(0.1)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    js = jopt.init(jp)
    g = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32)) for k, v in p.items()}
    jp, js = jopt.update(jp, g, js)  # a moved state: step 1, nonzero moments
    jstate = {"params": jp, "opt": js}
    names = [n for n, _ in j_names(jstate)]
    assert names == ["opt/.step", "opt/.m/b", "opt/.m/w", "opt/.v/b", "opt/.v/w",
                     "params/b", "params/w"]
    tp = _tensors(p)
    tmpl = {"params": tp, "opt": topt.init(tp)}
    assert [n for n, _ in flatten_with_names(tmpl)] == names
    # JAX writes, the port restores by name into its AdamState
    j_save(str(tmp_path / "j"), jstate, step=1)
    got, manifest = restore_checkpoint(str(tmp_path / "j"), tmpl)
    assert isinstance(got["opt"], toptim.AdamState) and got["opt"].step.dtype == torch.int32
    assert [e["name"] for e in manifest["leaves"]] == names
    want = dict(_named(jstate, "jax"))
    for n, v in flatten_with_names(got):
        np.testing.assert_array_equal(_np(v), want[n], err_msg=n)
    # the same state carried through numpy is the same AdamState
    carried = opt_state_from_numpy(jax.tree.map(np.asarray, js), "cpu")
    assert isinstance(carried, toptim.AdamState)
    for n, v in flatten_with_names(carried):
        np.testing.assert_array_equal(_np(v), want["opt/" + n], err_msg=n)
    # the port writes, JAX restores
    save_checkpoint(str(tmp_path / "t"), got, step=2)
    back, _ = j_restore(str(tmp_path / "t"), jstate)
    assert type(back["opt"]) is type(js)
    for (n, a), (m, b) in zip(j_names(back), j_names(jstate)):
        assert n == m and a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=n)


if __name__ == "__main__":
    # argv: world rank size port out; a world reads its folder ``out``
    _rank_main(WORLDS, sys.argv[1:6])
