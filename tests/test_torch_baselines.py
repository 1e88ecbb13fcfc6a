"""Port parity: the paper's §V baselines (``core/baselines.py``) against JAX.

FedAvg, HierFAVG and FEEL run 10 iterations in both packages from the same
stacked weights (JAX init, carried through numpy) on the same batches
(numpy streams), with the §V-B latency model.  Parameters, eval losses and
the consensus model stay within 1e-4 of the reference (1e-4 relative on the
losses), the wall-clock equals it to 1e-9, on the plain path (``dense``)
and on the ``cuda`` backend's, whose local step is the ``sgd_update``
kernel's plain version on CPU tensors.  FEEL's schedule is the reference's
numpy stream (``default_rng(seed + 1)``).
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.data as jdata
import repro.models as jmodels
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.models as tmodels
from repro_torch.convert import params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

C, ITERS = 8, 10


def _env(data, core):
    train, test = data.mnist_like(400, seed=0).split(0.85)
    ds = data.FederatedDataset(train, data.iid_partition(train.y, C, seed=0))
    return ds, {"x": test.x[:64], "y": test.y[:64]}, core.ClusterSpec(
        C, tuple(i // 2 for i in range(C)), ds.data_sizes())


def _trainers(core, models, clusters, **kw):
    lat = core.MNIST_LATENCY
    return {
        "fedavg": lambda: core.FedAvgTrainer(models.MnistCNN(), C, tau=3, lr=0.05, latency=lat,
                                             data_sizes=np.asarray(clusters.data_sizes), **kw),
        "hierfavg": lambda: core.HierFAVGTrainer(models.MnistCNN(), clusters, tau1=2, tau2=2,
                                                 lr=0.05, latency=lat, **kw),
        "feel": lambda: core.FEELTrainer(models.MnistCNN(), C, pool=[0, 2, 3, 5, 6],
                                         schedule_size=3, tau=2, lr=0.05, latency=lat, seed=4,
                                         **kw),
    }


@pytest.fixture(scope="module")
def jax_runs():
    ds, ev, clusters = _env(jdata, jcore)
    out = {}
    for name, make in _trainers(jcore, jmodels, clusters).items():
        tr = make()
        init = jax.tree.map(np.asarray, tr.params)
        hist = tr.run(ITERS, lambda k: ds.stacked_batch(4, np.random.default_rng(100 + k)),
                      ev, eval_every=5)
        out[name] = {"init": init, "hist": hist,
                     "params": jax.tree.map(np.asarray, tr.params),
                     "global": jax.tree.map(np.asarray, tr.global_params())}
    return out


@pytest.mark.parametrize("backend", ["dense", "cuda"])
@pytest.mark.parametrize("name", ["fedavg", "hierfavg", "feel"])
def test_baseline_tracks_jax(jax_runs, name, backend):
    ref = jax_runs[name]
    ds, ev, clusters = _env(tdata, tcore)
    tr = _trainers(tcore, tmodels, clusters, device="cpu", backend=backend)[name]()
    assert tr.route == backend
    tr.params = params_from_numpy(ref["init"], "cpu")
    hist = tr.run(ITERS, lambda k: ds.stacked_batch(4, np.random.default_rng(100 + k)),
                  ev, eval_every=5)
    assert hist.iterations == ref["hist"].iterations == [5, 10]
    np.testing.assert_allclose(hist.wallclock, ref["hist"].wallclock, rtol=1e-9)
    np.testing.assert_allclose(hist.loss, ref["hist"].loss, rtol=1e-4)
    np.testing.assert_allclose(hist.accuracy, ref["hist"].accuracy, atol=1e-6)
    for what, got in (("params", tr.params), ("global", tr.global_params())):
        for k, v in params_to_numpy(got).items():
            np.testing.assert_allclose(v, ref[what][k], atol=1e-4, err_msg=f"{what}/{k}")


def test_baselines_default_to_cuda():
    import torch

    if torch.cuda.is_available():
        tr = tcore.FedAvgTrainer(tmodels.MnistCNN(), 4)
        assert tr.device.type == "cuda" and tr.route == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.FedAvgTrainer(tmodels.MnistCNN(), 4)
    assert tcore.FEELTrainer(tmodels.MnistCNN(), 4, device="cpu").route == "dense"
