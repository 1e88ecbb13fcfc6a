"""Port parity: ``build_fl_train_step``, the single SD-FEEL iteration.

MnistCNN, C = 8 clients in D = 4 ring clusters, per-client batch 2, from
the reference's initial model (JAX init, carried through numpy).  Both
``impl`` values (dense, gossip) at every event (local, intra, inter), each
event at ``microbatch`` 1 and 2 and intra and inter with participation
(the round's weights) on, are held within 1e-5 against the reference: its
own ``build_fl_train_step`` for the
local step of each ``microbatch``, followed by its ``DenseBackend`` (dense)
or its mesh-free ``CollectiveBackend`` (gossip) transition, which is what
its step applies (its gossip step runs only under ``shard_map`` on a mesh of
one device a client).  A whole step of the reference's own (inter,
``microbatch`` 2, with the round's weights) is held directly too.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.models as jmodels
import repro.optim as joptim
import repro_torch.core as tcore
import repro_torch.models as tmodels
import repro_torch.optim as toptim
from repro_torch.convert import params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

C, D, B, LR, ATOL = 8, 4, 2, 0.1, 1e-5


def _weights():
    spec = jcore.ClusterSpec.uniform(C, D)
    mask = np.ones(C, bool)
    mask[[1, 4, 7]] = False
    w = np.where(mask, spec.m_hat(), 0.0)
    assign = np.asarray(spec.assignments)
    totals = np.bincount(assign, weights=w, minlength=D)
    return (w / totals[assign]).astype(np.float32)


@pytest.fixture(scope="module")
def ref():
    """The reference's local steps (microbatch 1 and 2) and a whole step."""
    model = jmodels.MnistCNN()
    init = jcore.init_stacked(model, C, jax.random.PRNGKey(3))
    rng = np.random.default_rng(0)
    batch = {"x": rng.normal(size=(C, B, 28, 28, 1)).astype(np.float32),
             "y": rng.integers(0, 10, (C, B)).astype(np.int32)}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    fl = jcore.FLSpec(C, D, alpha=2, learning_rate=LR)
    out = {"init": jax.tree.map(np.asarray, init), "batch": batch, "weights": _weights()}
    for mb in (1, 2):
        step = jax.jit(jcore.build_fl_train_step(model, joptim.sgd(LR), fl, event="local",
                                                 microbatch=mb))
        out[("local", mb)] = step(init, (), jb)
    whole = jax.jit(jcore.build_fl_train_step(model, joptim.sgd(LR), fl, event="inter",
                                              microbatch=2, participation=True))
    out["inter-2-weights"] = whole(init, (), jb, jnp.asarray(out["weights"]))
    proto = fl.protocol()
    out["backends"] = {"dense": jcore.DenseBackend(proto.clusters, proto.P(), 2),
                       "gossip": jcore.CollectiveBackend(proto.clusters, proto.P(), 2)}
    return out


def _port_step(ref, impl, event, microbatch, participation):
    fl = tcore.FLSpec(C, D, alpha=2, learning_rate=LR, impl=impl)
    step = tcore.build_fl_train_step(tmodels.MnistCNN(), toptim.sgd(LR), fl, event=event,
                                     microbatch=microbatch, participation=participation,
                                     device="cpu")
    ops = (torch.from_numpy(ref["weights"]),) if participation else ()
    return step(params_from_numpy(ref["init"], "cpu"), (),
                params_from_numpy(ref["batch"], "cpu"), *ops)


def _hold(got, want_params, want_loss):
    params, opt_state, loss = got
    assert opt_state == () and loss.shape == ()
    np.testing.assert_allclose(float(loss), float(want_loss), atol=ATOL, rtol=0)
    for k, v in params_to_numpy(params).items():
        np.testing.assert_allclose(v, np.asarray(want_params[k]), atol=ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("event,microbatch,participation", [
    ("local", 1, False), ("local", 2, False), ("intra", 1, False), ("intra", 2, True),
    ("inter", 1, True), ("inter", 2, False)])
@pytest.mark.parametrize("impl", ["dense", "gossip"])
def test_step_matches_the_reference(ref, impl, event, microbatch, participation):
    local, _, loss = ref[("local", microbatch)]
    want = local
    if event != "local":
        kw = {"weights": jnp.asarray(ref["weights"])} if participation else {}
        want = ref["backends"][impl].transition(local, event, **kw)
    _hold(_port_step(ref, impl, event, microbatch, participation), want, loss.mean())


@pytest.mark.parametrize("impl", ["dense", "gossip"])
def test_whole_step_matches_the_reference_step(ref, impl):
    params, _, loss = ref["inter-2-weights"]
    _hold(_port_step(ref, impl, "inter", 2, True), params, loss)


def test_step_checks_and_mesh():
    model, opt = tmodels.MnistCNN(), toptim.sgd(LR)
    with pytest.raises(ValueError, match="ring topologies with >= 3 clusters"):
        tcore.build_fl_train_step(model, opt, tcore.FLSpec(4, 2, impl="gossip"), device="cpu")
    with pytest.raises(ValueError, match="ring topologies"):
        tcore.build_fl_train_step(model, opt, tcore.FLSpec(8, 4, impl="gossip",
                                                           topology="star"), device="cpu")
    # a local step needs no collective, as in the reference
    tcore.build_fl_train_step(model, opt, tcore.FLSpec(4, 2, impl="gossip"), event="local",
                              device="cpu")
    # "auto" is no mesh here (fewer devices than clients, no process group);
    # an object that is not a ClientMesh raises
    tcore.build_fl_train_step(model, opt, tcore.FLSpec(C, D, impl="gossip"), mesh="auto",
                              device="cpu")
    with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
        tcore.build_fl_train_step(model, opt, tcore.FLSpec(C, D, impl="gossip"),
                                  mesh=object(), device="cpu")
