"""Port parity: the checkpoint layer (``repro_torch.checkpoint``) against the reference.

Both packages write the same format (``step_<8 digits>/manifest.json`` and
one ``leaf_<5 digits>.npy`` per leaf, bf16 widened to f32), with the same
leaf names in the same order, so a checkpoint either side writes restores
on the other leaf for leaf, bf16 included (exactly: the widening is exact
and the narrowing rounds the widened value back to itself).  A sync run
resumed from a port checkpoint equals the run it was cut from, bit for bit.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.checkpoint as jckpt
import repro.models as jmodels
import repro_torch.checkpoint as tckpt
import repro_torch.core as tcore
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.data import FederatedDataset, iid_partition, mnist_like
from repro_torch.models import MnistCNN

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)


def _jax_state(seed=0):
    """A JAX training state: stacked MnistCNN params (one leaf in bf16), an
    LM-style nested subtree, an optimizer-state tuple and a step counter."""
    params = jax.tree.map(lambda x: jnp.stack([x, 2 * x]),
                          jmodels.MnistCNN().init(jax.random.PRNGKey(seed)))
    params["b1"] = params["b1"].astype(jnp.bfloat16)
    rng = np.random.default_rng(seed)
    blocks = {"pos0": {"attn": {"wq": jnp.asarray(rng.normal(size=(4, 3)), jnp.bfloat16),
                                "wk": jnp.asarray(rng.normal(size=(4, 3)), jnp.float32)},
                       "mlp": {"w_in": jnp.asarray(rng.normal(size=(3, 5)), jnp.float32)}}}
    return {"params": params, "lm": {"blocks": blocks, "embed": jnp.ones((6, 2))},
            "opt": (jnp.zeros(3), jnp.full((2,), 7.0)), "round": jnp.int32(5)}


def _as_port(jstate):
    """The same state in the port's layout: dicts of tensors, the LM subtree
    flattened to dotted names (``convert.flatten_params``)."""
    def tensors(tree):
        return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")

    return {"params": tensors(jstate["params"]),
            "lm": tensors(flatten_params(jstate["lm"])),
            "opt": tuple(torch.from_numpy(np.asarray(x)) for x in jstate["opt"]),
            "round": torch.tensor(int(jstate["round"]), dtype=torch.int32)}


def _port_leaves(state):
    return [(n, np.asarray(tckpt.host_leaf(x))) for n, x in tckpt.flatten_with_names(state)]


def _jax_leaves(state):
    return [(n, np.asarray(jckpt.host_leaf(x))) for n, x in jckpt.flatten_with_names(state)]


def test_names_and_order_equal_the_reference():
    jstate = _jax_state()
    got, want = _port_leaves(_as_port(jstate)), _jax_leaves(jstate)
    assert [n for n, _ in got] == [n for n, _ in want]
    assert "lm/blocks/pos0/attn/wq" in dict(got)
    for (n, a), (_, b) in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, n
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_jax_checkpoint_restores_into_the_port(tmp_path):
    jstate = _jax_state(1)
    jckpt.save_checkpoint(str(tmp_path), jstate, step=3, metadata={"lr": 0.1})
    like = _as_port(_jax_state(2))  # another state of the same structure
    restored, manifest = tckpt.restore_checkpoint(str(tmp_path), like)
    assert manifest["step"] == 3 and manifest["metadata"] == {"lr": 0.1}
    assert restored["params"]["b1"].dtype == torch.bfloat16
    assert list(restored["lm"]) == list(like["lm"])  # the port's dotted keys, in order
    assert isinstance(restored["opt"], tuple)
    for (n, a), (_, b) in zip(_port_leaves(restored), _jax_leaves(jstate)):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_port_checkpoint_restores_in_jax(tmp_path):
    tstate = _as_port(_jax_state(1))
    tckpt.save_checkpoint(str(tmp_path), tstate, step=12)
    assert tckpt.latest_step(str(tmp_path)) == jckpt.latest_step(str(tmp_path)) == 12
    restored, manifest = jckpt.restore_checkpoint(str(tmp_path), _jax_state(2))
    assert manifest["step"] == 12
    assert restored["params"]["b1"].dtype == jnp.bfloat16
    for (n, a), (_, b) in zip(_jax_leaves(restored), _port_leaves(tstate)):
        np.testing.assert_array_equal(a, b, err_msg=n)


def test_leaf_records_cross_both_ways(tmp_path):
    tstate = _as_port(_jax_state(3))
    named = tckpt.flatten_with_names(tstate)
    tckpt.save_leaves(str(tmp_path / "t.npz"), named)
    jckpt.save_leaves(str(tmp_path / "j.npz"), jckpt.flatten_with_names(_jax_state(3)))
    for a, b in zip(jckpt.load_leaves(str(tmp_path / "t.npz")),
                    tckpt.load_leaves(str(tmp_path / "j.npz"))):
        np.testing.assert_array_equal(a, b)
    with np.load(str(tmp_path / "t.npz")) as t, np.load(str(tmp_path / "j.npz")) as j:
        assert sorted(t.files) == sorted(j.files)


def test_save_is_atomic_and_restore_refuses_mismatches(tmp_path):
    state = {"x": torch.zeros(2, 2), "y": torch.ones(3)}
    assert tckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        tckpt.restore_checkpoint(str(tmp_path), state)
    for step in (1, 10, 5):
        tckpt.save_checkpoint(str(tmp_path), state, step=step)
    assert sorted(os.listdir(tmp_path)) == ["step_00000001", "step_00000005", "step_00000010"]
    assert tckpt.latest_step(str(tmp_path)) == 10
    with open(tmp_path / "step_00000010" / "manifest.json") as f:
        assert [e["name"] for e in json.load(f)["leaves"]] == ["x", "y"]
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(3, 3), "y": torch.ones(3)})
    with pytest.raises(ValueError, match="leaves"):
        tckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="template has 'z'"):
        tckpt.restore_checkpoint(str(tmp_path), {"x": torch.zeros(2, 2), "z": torch.ones(3)})


def test_sync_resume_from_a_port_checkpoint_equals_the_uninterrupted_run(tmp_path):
    data = mnist_like(400, seed=5)
    ds = FederatedDataset(data, iid_partition(data.y, 8))
    rng = np.random.default_rng(0)
    batches = [ds.stacked_batch(4, rng) for _ in range(8)]
    src = lambda k: batches[k - 1]
    cfg = {"scheduler": "sync", "model": MnistCNN(), "clusters": tcore.ClusterSpec.uniform(8, 4),
           "tau1": 2, "tau2": 1, "alpha": 1, "learning_rate": 0.05, "backend": "cuda"}
    full = tcore.make_run(cfg, device="cpu")
    for _ in range(8):
        full.step(src)
    cut = tcore.make_run(cfg, device="cpu")
    for _ in range(4):
        cut.step(src)
    tckpt.save_checkpoint(str(tmp_path), {"params": cut.scheduler.params,
                                          "iteration": cut.iteration}, step=4)
    resumed = tcore.make_run(dict(cfg, seed=1), device="cpu")  # other initial weights
    state, _ = tckpt.restore_checkpoint(
        str(tmp_path), {"params": resumed.scheduler.params, "iteration": 0})
    for k, v in state["params"].items():
        resumed.scheduler.params[k].copy_(v)
    resumed._k = resumed.iteration = state["iteration"]
    for _ in range(4):
        resumed.step(src)
    assert resumed.iteration == full.iteration == 8
    for k, v in full.scheduler.params.items():
        assert torch.equal(v, resumed.scheduler.params[k]), k
