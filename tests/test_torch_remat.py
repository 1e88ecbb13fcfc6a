"""Port parity: activation checkpointing (``ArchConfig.remat``) under torch.func.

The port's ``CausalLM`` with ``remat=True`` (policy ``"full"``) runs each
block through ``models.transformer._Remat``, which keeps only the block's
input and recomputes the block in its backward.  Inputs made from a seed
with numpy, the reference's weights through ``convert.params_from_numpy``,
TF32 off (the CPU has none):

* loss and gradients under ``vmap(grad_and_value)`` over two clients with
  remat on equal remat off bit for bit (the recomputing backward
  differentiates detached operands with the formulas the whole model's
  backward takes) and the reference's remat run
  (``jax.checkpoint``) within 1e-5 (of a leaf's largest entry where that is
  above 1), on a dense model, MoE (the router aux loss through the stack,
  carried out of the block as its second output), mamba2 and the jamba
  hybrid, on both attention paths;
* one federated superstep of ``federated-lm-ring`` on the round's captured
  body (``sched._graph = sched._build_graph()``) with remat on, bit for bit
  the eager superstep with remat off and within 1e-4 of the reference's
  remat superstep;
* the memory remat saves: a trace of live tensors (``LiveBytes``) over one
  client's ``grad_and_value`` at two depths gives the bytes a block adds,
  which remat cuts to a small share of remat off's;
* ``remat_policy="dots"``, and a gated decode through a ``decode_impl``
  (the slot pool's), raise, naming the queue item; every published config
  (remat on by default) now builds.

``peak_grad_bytes`` also takes a published config at full width, for the
card's depth plan (bf16, S = 2048)::

    PYTHONPATH=src python -c "import dataclasses as d, sys; sys.path.insert(0, 'tests');
    from test_torch_remat import peak_grad_bytes; from repro_torch.configs import get_config;
    c = get_config('mamba2-780m'); print([peak_grad_bytes(d.replace(c, num_layers=n,
    remat=r), 2048) for r in (False, True) for n in (1, 2)])"
"""
import dataclasses
import functools
import os
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.scenarios as jscenarios
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.scenarios as tscenarios
from repro_torch.convert import (
    flatten_params, params_from_numpy, params_to_numpy, unflatten_params,
)
from torch.utils._python_dispatch import TorchDispatchMode

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


TINY = dict(d_model=64, d_ff=128, vocab_size=100, attn_chunk=8, ssm_chunk=8)
ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=16)
SSM = dict(ssm_state=16, ssm_head_dim=16)
# name -> (arch, overrides, sequence length)
VARIANTS = {
    "dense": ("granite-8b", dict(ATTN), 16),
    "moe": ("mixtral-8x7b", dict(ATTN, sliding_window=12), 16),
    "mamba2": ("mamba2-780m", dict(SSM, d_ff=0), 16),
    "hybrid": ("jamba-1.5-large-398b", dict(ATTN, **SSM, num_layers=8), 16),
}


def _cfg(package_configs, variant, remat, **extra):
    name, over, _ = VARIANTS[variant]
    return dataclasses.replace(package_configs.get_config(name).reduced(),
                               **{**TINY, **over, **extra}, remat=remat)


def _batch(s, c=2, b=2, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, TINY["vocab_size"], size=(c, b, s)).astype(np.int32),
            "labels": rng.integers(0, TINY["vocab_size"], size=(c, b, s)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_remat(variant):
    """Two clients' (params, batch, losses, grads) of the reference with
    remat on, flat numpy."""
    model = jmodels.CausalLM(_cfg(jconfigs, variant, True))
    flat = flatten_params(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if k.split(".")[-1].startswith(("ln_", "bias_", "dt_bias", "D", "norm_scale")):
            flat[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    stacked = {k: np.stack([v, v * 1.05]) for k, v in flat.items()}
    batch = _batch(VARIANTS[variant][2])

    def grad_and_loss(p, b):
        loss, g = jax.value_and_grad(model.loss)(p, b)
        return g, loss

    grads, losses = jax.jit(jax.vmap(grad_and_loss))(
        jax.tree.map(jnp.asarray, unflatten_params(stacked)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return stacked, batch, np.asarray(losses), flatten_params(jax.tree.map(np.asarray, grads))


def _port(variant, remat, impl):
    stacked, batch, _, _ = _jax_remat(variant)
    model = tmodels.CausalLM(_cfg(tconfigs, variant, remat, attn_impl=impl))
    grads, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        params_from_numpy(stacked, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()})
    return losses.detach().numpy(), params_to_numpy(grads)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_remat_grads_equal_no_remat_and_jax(variant, impl):
    _, _, jlosses, jgrads = _jax_remat(variant)
    losses, grads = _port(variant, True, impl)
    losses0, grads0 = _port(variant, False, impl)
    np.testing.assert_array_equal(losses, losses0)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    assert set(grads) == set(jgrads)
    for k, ref in jgrads.items():
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_array_equal(grads[k], grads0[k], err_msg=k)
        np.testing.assert_allclose(grads[k], ref, atol=1e-5 * scale, err_msg=k)


def test_remat_carries_the_moe_aux_loss():
    """The router aux loss leaves each block as its second output: the MoE
    model's loss with remat equals the loss without, aux included, and the
    router's gradient (which only the aux loss and routing reach) agrees."""
    stacked, batch, _, _ = _jax_remat("moe")
    out = {}
    for remat in (False, True):
        model = tmodels.CausalLM(_cfg(tconfigs, "moe", remat, attn_impl="plain"))
        p = {k: v[0] for k, v in params_from_numpy(stacked, "cpu").items()}
        b = {k: torch.from_numpy(v[0]) for k, v in batch.items()}
        _, aux = model.forward(p, b)
        out[remat] = (aux.item(), torch.func.grad(model.loss)(p, b))
    assert out[True][0] == out[False][0] and out[True][0] > 0
    for k, g in out[True][1].items():
        if "w_router" in k:
            np.testing.assert_array_equal(g.numpy(), out[False][1][k].numpy())


def _fed_kw(package, remat, **extra):
    models, configs = (jmodels, jconfigs) if package == "jax" else (tmodels, tconfigs)
    model = models.CausalLM(_cfg(configs, "dense", remat, vocab_size=64, **extra))
    return dict(model=model, seq_len=16, vocab_size=64, num_samples=32)


@functools.lru_cache(maxsize=None)
def _jax_fed():
    jrun = jscenarios.build_scenario("federated-lm-ring", **_fed_kw("jax", True))
    init = flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))
    losses = np.asarray(jrun.runtime.step(jrun.batch_source()).losses)
    return init, losses, flatten_params(jax.tree.map(np.asarray, jrun.runtime.scheduler.params))


def _port_fed(remat, graphed):
    init = _jax_fed()[0]
    run = tscenarios.build_scenario("federated-lm-ring", device="cpu", backend="cuda",
                                    **_fed_kw("torch", remat, attn_impl="cuda"))
    sched = run.runtime.scheduler
    sched.params = params_from_numpy(init, "cpu")
    if graphed:
        sched._graph = sched._build_graph()
    losses = run.runtime.step(run.batch_source()).losses
    return losses.numpy(), params_to_numpy(sched.params)


def test_remat_superstep_on_the_round_graph_body():
    _, jlosses, jparams = _jax_fed()
    losses, params = _port_fed(True, graphed=True)
    losses0, params0 = _port_fed(False, graphed=False)
    np.testing.assert_array_equal(losses, losses0)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    for k, v in params.items():
        np.testing.assert_array_equal(v, params0[k], err_msg=k)
        np.testing.assert_allclose(v, jparams[k], atol=1e-4, err_msg=k)


def test_dots_policy_and_decode_impl_raise():
    cfg = _cfg(tconfigs, "dense", True)
    with pytest.raises(NotImplementedError, match="Multi-device and launch"):
        tmodels.CausalLM(dataclasses.replace(cfg, remat_policy="dots"))
    # a decode_impl builds (the sequence-sharded decode, sharding/decode.py);
    # a gated decode through one is 'mesh serving''s
    model = tmodels.CausalLM(cfg, decode_impl=object())
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(2, 8)
    with pytest.raises(NotImplementedError, match="Multi-device and launch.*'mesh serving'"):
        model.decode_step(params, torch.zeros(2, dtype=torch.int32), cache, 0,
                          gate=torch.tensor(True))


@pytest.mark.parametrize("name", tconfigs.ARCH_NAMES)
def test_published_configs_build_with_remat(name):
    cfg = tconfigs.get_config(name)
    assert cfg.remat and cfg.remat_policy == "full"
    assert tmodels.CausalLM(cfg).cfg is cfg
    assert not cfg.reduced().remat


# -- the memory remat saves ---------------------------------------------------

class LiveBytes(TorchDispatchMode):
    """Live and peak bytes of the storages the traced ops create, each
    counted from its creation until Python frees it."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0
        self._seen: set = set()

    def _release(self, key: int, n: int) -> None:
        self._seen.discard(key)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if not isinstance(t, torch.Tensor):
                continue
            storage = t.untyped_storage()
            key, n = storage.data_ptr(), storage.nbytes()
            if key in self._seen or n == 0:
                continue
            self._seen.add(key)
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(storage, self._release, key, n)
        return out


def peak_grad_bytes(cfg, seq: int) -> int:
    """Peak live bytes of one client's ``grad_and_value(loss)`` at batch 1:
    the parameters and batch are made before the trace and not counted, the
    gradients are."""
    model = tmodels.CausalLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (1, seq), generator=torch.Generator().manual_seed(1))
    mode = LiveBytes()
    with mode:
        grads, loss = torch.func.grad_and_value(model.loss)(
            params, {"tokens": tokens, "labels": tokens})
        del grads, loss
    return mode.peak


@pytest.mark.parametrize("variant", ["dense", "mamba2"])
def test_remat_cuts_the_bytes_a_block_adds(variant):
    """The bytes one more block adds to the peak (two depths' difference):
    with remat only the block's input and its gradients stay, far below
    what remat off keeps."""
    slope = {}
    for remat in (False, True):
        peaks = [peak_grad_bytes(_cfg(tconfigs, variant, remat, num_layers=n), 64)
                 for n in (2, 4)]
        slope[remat] = (peaks[1] - peaks[0]) / 2
    assert 0 < slope[True] < 0.5 * slope[False], slope
