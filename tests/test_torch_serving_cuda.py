"""Serving and activation checkpointing on the card (skip without one).

Imports torch and ``repro_torch`` only, so it also runs on a machine without
JAX: ``PYTHONPATH=src python3 -m pytest -q tests/test_torch_serving_cuda.py``.
TF32 off; f32 tiny models:

* the continuous engine's decode chunk replayed from its CUDA graph equals
  the eager chunk (``graph=False``) at 0.0, tokens, counts and pool, under
  deterministic algorithms, and the static engine's per-batch decode graph
  its eager steps' tokens;
* one capture serves a trace that mixes length buckets, budgets, clusters
  and mid-stream admissions, and a hot swap (the flip copies into the
  captured addresses);
* the card's tokens equal the CPU's for the same weights and trace;
* remat's gradients on the card (the flash kernels inside the recomputed
  block, vmapped over clients) equal remat off within 1e-6 of each leaf's
  largest entry.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro_torch.models import CausalLM
from repro_torch.models.config import ArchConfig
from repro_torch.serving import ContinuousFederatedServer, Request

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

BUCKETS = (8, 16)
GEN_CAP = 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the CUDA graphs and kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture
def deterministic(cuda):
    before = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True, warn_only=True)
    yield cuda
    torch.use_deterministic_algorithms(False)
    if before is None:
        del os.environ["CUBLAS_WORKSPACE_CONFIG"]
    else:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = before


def _model(**extra):
    cfg = ArchConfig(name="test-serve", family="dense", num_layers=2, d_model=64, d_ff=128,
                     vocab_size=64, num_heads=4, num_kv_heads=2, head_dim=16,
                     dtype="float32", remat=False, attn_chunk=16, **extra)
    model = CausalLM(cfg)
    replicas = [model.init(torch.Generator().manual_seed(s)) for s in range(3)]
    stack = {k: torch.stack([r[k] for r in replicas]) for k in replicas[0]}
    return model, stack


def _reqs(n, seed=0, base=0):
    rng = np.random.default_rng(seed)
    return [Request(uid=base + i,
                    prompt=rng.integers(0, 64, int(rng.integers(3, BUCKETS[-1] + 1))).astype(
                        np.int32),
                    max_new_tokens=int(rng.integers(1, GEN_CAP + 1)),
                    eos_id=int(rng.integers(0, 64)), cluster_id=int(rng.integers(0, 3)))
            for i in range(n)]


def _serve(srv, reqs):
    reqs = [dataclasses.replace(r, output=None) for r in reqs]
    for r in reqs:
        srv.submit(r)
    srv.run()
    return {r.uid: r.output.tolist() for r in reqs}


def _server(stack, device, graph=None):
    return ContinuousFederatedServer(
        _model()[0], {k: v.to(device) for k, v in stack.items()}, max_batch=4,
        length_buckets=BUCKETS, gen_cap=GEN_CAP, chunk_steps=3, graph=graph)


@pytest.mark.cuda
def test_chunk_graph_equals_eager_chunk(deterministic):
    _, stack = _model()
    reqs = _reqs(11, seed=1)
    graphed, eager = _server(stack, deterministic), _server(stack, deterministic, graph=False)
    assert _serve(graphed, reqs) == _serve(eager, reqs)
    assert graphed._chunk_p.graphed is not None and eager._chunk_p.graphed is None
    assert graphed._chunk_p.graphed.replays >= 2
    for k, v in eager._state["cache"].items():
        assert torch.equal(v, graphed._state["cache"][k]), k
    for k in ("steps", "active_steps", "out", "emitted", "tok", "pos"):
        assert torch.equal(eager._state[k], graphed._state[k]), k


@pytest.mark.cuda
def test_static_decode_graph_equals_eager(deterministic):
    from repro_torch.serving import FederatedServer

    model, stack = _model()
    dev = {k: v.to(deterministic) for k, v in stack.items()}
    reqs = _reqs(9, seed=5)
    graphed = FederatedServer(model, dev, max_batch=3, length_buckets=BUCKETS)
    eager = FederatedServer(model, dev, max_batch=3, length_buckets=BUCKETS, graph=False)
    assert _serve(graphed, reqs) == _serve(eager, reqs)
    assert graphed._decode_graph.replays > 0 and eager._decode_graph is None


@pytest.mark.cuda
def test_one_capture_across_admissions_and_a_swap(cuda):
    _, stack = _model()
    srv = _server(stack, cuda)
    first = _serve(srv, _reqs(9, seed=2))
    new = {k: v.flip(0).clone().to(cuda) for k, v in stack.items()}
    srv.publish(new)
    later = _serve(srv, _reqs(9, seed=3, base=100))
    assert srv.swaps == 1 and first and later
    assert srv.compile_counts()["decode"] == 1 and srv._chunk_p.graphed.captured == 1
    fresh = _server({k: v.cpu() for k, v in new.items()}, cuda)
    assert later == _serve(fresh, _reqs(9, seed=3, base=100))


@pytest.mark.cuda
def test_card_tokens_equal_cpu(cuda):
    _, stack = _model()
    reqs = _reqs(10, seed=4)
    assert _serve(_server(stack, cuda), reqs) == _serve(_server(stack, "cpu"), reqs)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-8b", "mamba2-780m"])
def test_remat_grads_on_the_card(cuda, arch):
    from repro_torch.configs import get_config

    base = dataclasses.replace(get_config(arch).reduced(), d_model=64, d_ff=128 if arch ==
                               "granite-8b" else 0, vocab_size=100, ssm_chunk=16)
    params = CausalLM(base).init(torch.Generator().manual_seed(0))
    stacked = {k: torch.stack([v, v * 1.05]).to(cuda) for k, v in params.items()}
    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, 100, (2, 2, 64))).to(cuda)
    batch = {"tokens": tok, "labels": tok}
    out = {}
    for remat in (False, True):
        model = CausalLM(dataclasses.replace(base, remat=remat))
        out[remat] = torch.func.vmap(torch.func.grad_and_value(model.loss))(stacked, batch)
    torch.testing.assert_close(out[True][1], out[False][1], atol=1e-6, rtol=0)
    for k, g in out[False][0].items():
        scale = max(1.0, g.abs().max().item())
        assert (out[True][0][k] - g).abs().max().item() <= 1e-6 * scale, k
