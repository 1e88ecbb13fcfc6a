"""Port parity: the paper's CNNs from converted JAX weights.

Logits, loss and gradients agree within 1e-5 (f32; XLA and oneDNN reduce
convolutions in different orders).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models as jmodels
import repro_torch.models as tmodels
from repro_torch.convert import params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ATOL = 1e-5


@pytest.mark.parametrize("name,count,leaves", [
    ("MnistCNN", 21_840, 8),
    ("CifarCNN", 2_205_258, 16),
])
def test_param_counts(name, count, leaves):
    p = getattr(tmodels, name)().init(torch.Generator().manual_seed(0))
    assert tmodels.param_count(p) == count
    assert len(p) == leaves
    jp = getattr(jmodels, name)().init(jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in p.items()} == {k: v.shape for k, v in jp.items()}


@pytest.mark.parametrize("name,shape", [("MnistCNN", (6, 28, 28, 1)), ("CifarCNN", (2, 32, 32, 3))])
def test_logits_loss_grads_agree(name, shape):
    jm, tm = getattr(jmodels, name)(), getattr(tmodels, name)()
    jp = jm.init(jax.random.PRNGKey(1))
    np_params = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(0)
    x = rng.normal(size=shape).astype(np.float32)
    y = rng.integers(0, 10, size=shape[0]).astype(np.int32)
    tp = params_from_numpy(np_params, "cpu")
    tb = {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}
    jb = {"x": jnp.asarray(x), "y": jnp.asarray(y)}

    np.testing.assert_allclose(tm.apply(tp, tb["x"]).numpy(), np.asarray(jm.apply(jp, jb["x"])),
                               atol=ATOL)
    jloss, jgrads = jax.value_and_grad(jm.loss)(jp, jb)
    tgrads, tloss = torch.func.grad_and_value(tm.loss)(tp, tb)
    np.testing.assert_allclose(float(tloss), float(jloss), atol=ATOL)
    for k, g in params_to_numpy(tgrads).items():
        np.testing.assert_allclose(g, np.asarray(jgrads[k]), atol=ATOL, err_msg=k)
    assert float(tm.accuracy(tp, tb)) == pytest.approx(float(jm.accuracy(jp, jb)))


def test_convert_roundtrip_bf16():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    t = params_from_numpy(tree, "cpu")
    np.testing.assert_array_equal(params_to_numpy(t)["a"], tree["a"])
    jb = {"a": np.asarray(jnp.asarray(tree["a"], jnp.bfloat16))}
    tb = params_from_numpy(jb, "cpu")
    assert tb["a"].dtype == torch.bfloat16
    np.testing.assert_array_equal(params_to_numpy(tb)["a"], tree["a"])
