"""Port parity: the model families (MoE, Mamba2 SSD, hybrid, VLM, audio).

Inputs made from a seed with numpy go through the reference's function and
the port's (weights carried with ``convert.params_from_numpy``):

* ``models/moe.py``: ``router_topk`` within 1e-6; ``moe_mlp`` on the
  per-example (``S > 1``) and flat (``S == 1``) paths, at capacity factor
  1.0 (assignments dropped, checked) and at ``E`` (dropless), outputs and
  aux within 1e-6 and gradients within 1e-5;
* ``models/mamba.py``: ``_causal_conv`` with its tail, ``ssd_chunked`` from
  a non-zero state with ``h_final``, ``mamba_forward`` with its tails, and
  their gradients, within 1e-5;
* ``CausalLM`` loss and gradients within 1e-5 (of a gradient leaf's largest
  entry, where that is above 1) on both attention paths for
  tiny variants (d_model 64, S 16-32, SSD chunk 8) of mixtral (window 12),
  grok (attention softcap 30), mamba2, jamba (one block of 8 layers),
  pixtral (``frontend_embeds`` and its loss mask) and musicgen (``(B, 4,
  S)`` codebook tokens);
* ``CausalLM.init``: the reference's leaf names, shapes and dtypes for all
  ten architectures at ``reduced()``, in f32 and bf16 (where the MoE
  router and the mamba ``A_log``, ``D``, ``dt_bias`` stay f32);
* ``federated-lm-ring`` with tiny mixtral and mamba2 on the ``cuda``
  backend (CPU tensors: the kernels' plain versions), within 1e-4 of the
  reference over two supersteps, and the round's captured body
  (``sched._graph = sched._build_graph()``, eager on the CPU) bitwise the
  eager loop.
"""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.models.mamba as jmamba
import repro.models.moe as jmoe
import repro.scenarios as jscenarios
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.models.mamba as tmamba
import repro_torch.models.moe as tmoe
import repro_torch.scenarios as tscenarios
from repro_torch.convert import (
    flatten_params, params_from_numpy, params_to_numpy, unflatten_params,
)

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU runs here are thousands of tiny ops: one intra-op
    thread runs them faster than many, and keeps a test worker that shares
    the cores with others from oversubscribing them."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


# -- MoE ------------------------------------------------------------------------

D, DFF, E, K = 16, 32, 4, 2


def _moe_inputs(b, s, seed=0):
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)
    params = {"w_router": f32(D, E, scale=0.5), "w_gate": f32(E, D, DFF, scale=D ** -0.5),
              "w_up": f32(E, D, DFF, scale=D ** -0.5), "w_down": f32(E, DFF, D, scale=DFF ** -0.5)}
    # a bias toward expert 0 in the inputs makes its capacity bite at cf 1.0
    x = f32(b, s, D) + 0.8 * params["w_router"][:, 0] / np.linalg.norm(params["w_router"][:, 0])
    return params, x.astype(np.float32), f32(b, s, D)


def test_router_topk_matches_jax():
    params, x, _ = _moe_inputs(1, 64)
    xt = x.reshape(64, D)
    ref = jmoe.router_topk(jnp.asarray(xt), jnp.asarray(params["w_router"]), K)
    got = tmoe.router_topk(torch.from_numpy(xt), torch.from_numpy(params["w_router"]), K)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


@pytest.mark.parametrize("cf", [1.0, float(E)], ids=["drops", "dropless"])
@pytest.mark.parametrize("b,s", [(2, 64), (64, 1)], ids=["per-example", "flat"])
def test_moe_mlp_matches_jax(b, s, cf):
    params, x, ct = _moe_inputs(b, s)
    k = dict(num_experts_per_tok=K, capacity_factor=cf)

    def jfn(p, xx):
        out, aux = jmoe.moe_mlp(xx, p, **k)
        return jnp.sum(out * ct) + aux, (out, aux)

    def tfn(p, xx):
        out, aux = tmoe.moe_mlp(xx, p, **k)
        return torch.sum(out * torch.from_numpy(ct)) + aux, (out, aux)

    (jg, jgx), (jout, jaux) = jax.jit(jax.grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    (tg, tgx), (tout, taux) = torch.func.grad(tfn, argnums=(0, 1), has_aux=True)(
        _t(params), torch.from_numpy(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), atol=1e-6)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5)
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[name]), atol=1e-5, err_msg=name)
    # capacity factor 1.0 drops assignments here; E keeps them all
    tokens = s if s > 1 else b
    cap = tmoe.moe_capacity(tokens, K, E, cf)
    ids = tmoe.router_topk(torch.from_numpy(x.reshape(-1, tokens, D)[0]),
                           torch.from_numpy(params["w_router"]), K)[0]
    most = int(torch.bincount(ids.reshape(-1), minlength=E).max())
    assert (most > cap) == (cf == 1.0), (most, cap)


# -- Mamba2 / SSD -------------------------------------------------------------------

def _ssm_cfg(package):
    return dataclasses.replace(package.get_config("mamba2-780m").reduced(), d_model=32,
                               ssm_state=8, ssm_head_dim=16, ssm_chunk=8)


def _mamba_params(seed=0):
    """The reference's init (a JAX key) with the ones and zeros perturbed."""
    p = _np(jmamba.init_mamba_params(jax.random.PRNGKey(seed), _ssm_cfg(jconfigs)))
    rng = np.random.default_rng(seed)
    for k in ("bias_x", "bias_b", "bias_c", "D", "dt_bias", "norm_scale"):
        p[k] = (p[k] + 0.1 * rng.normal(size=p[k].shape)).astype(np.float32)
    return p


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(2)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((2, 8, 6), (4, 6), (6,)))
    tail = rng.normal(size=(2, 3, 6)).astype(np.float32)
    for tl, s in ((None, 8), (tail, 8), (tail, 2)):
        ry, rt = jmamba._causal_conv(*(jnp.asarray(a) for a in (x[:, :s], w, b)),
                                     None if tl is None else jnp.asarray(tl))
        gy, gt = tmamba._causal_conv(*(torch.from_numpy(a) for a in (x[:, :s], w, b)),
                                     None if tl is None else torch.from_numpy(tl))
        np.testing.assert_allclose(gy.numpy(), np.asarray(ry), atol=1e-6)
        np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))


def test_ssd_chunked_matches_jax():
    rng = np.random.default_rng(3)
    bsz, s, h, p, n = 2, 32, 3, 4, 5
    x = rng.normal(size=(bsz, s, h, p)).astype(np.float32)
    bm, cm = (rng.normal(size=(bsz, s, n)).astype(np.float32) for _ in range(2))
    dt = rng.uniform(0.05, 0.5, size=(bsz, s, h)).astype(np.float32)
    a_inc = (-dt * rng.uniform(1.0, 4.0, size=h)).astype(np.float32)
    h0 = rng.normal(size=(bsz, h, n, p)).astype(np.float32)
    args = (x, bm, cm, a_inc, dt, h0)
    cy = (0.1 * rng.normal(size=x.shape)).astype(np.float32)
    ch = (0.1 * rng.normal(size=h0.shape)).astype(np.float32)

    def jfn(*a):
        y, hf = jmamba.ssd_chunked(*a, chunk=8)
        return jnp.sum(y * cy) + jnp.sum(hf * ch), (y, hf)

    def tfn(*a):
        y, hf = tmamba.ssd_chunked(*a, chunk=8)
        return torch.sum(y * torch.from_numpy(cy)) + torch.sum(hf * torch.from_numpy(ch)), (y, hf)

    jg, (jy, jh) = jax.jit(jax.grad(jfn, argnums=tuple(range(6)), has_aux=True))(
        *(jnp.asarray(a) for a in args))
    tg, (ty, th) = torch.func.grad(tfn, argnums=tuple(range(6)), has_aux=True)(
        *(torch.from_numpy(a) for a in args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    for i, (g, r) in enumerate(zip(tg, jg)):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-5, err_msg=str(i))


def test_mamba_forward_matches_jax():
    params = _mamba_params()
    x = np.random.default_rng(4).normal(size=(2, 16, 32)).astype(np.float32)

    cy = (0.1 * np.random.default_rng(5).normal(size=x.shape)).astype(np.float32)

    def jfn(p, xx):
        y, (hf, tails) = jmamba.mamba_forward(p, xx, _ssm_cfg(jconfigs))
        return jnp.sum(y * cy), (y, hf, tails)

    def tfn(p, xx):
        y, (hf, tails) = tmamba.mamba_forward(p, xx, _ssm_cfg(tconfigs))
        return torch.sum(y * torch.from_numpy(cy)), (y, hf, tails)

    (jg, jgx), (jy, jh, jt) = jax.jit(jax.grad(jfn, argnums=(0, 1), has_aux=True))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    (tg, tgx), (ty, th, tt) = torch.func.grad(tfn, argnums=(0, 1), has_aux=True)(
        _t(params), torch.from_numpy(x))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-5)
    for k in ("x", "b", "c"):
        np.testing.assert_allclose(tt[k].numpy(), np.asarray(jt[k]), atol=1e-6, err_msg=k)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), atol=1e-5)
    for k, g in tg.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[k]), atol=1e-5, err_msg=k)


# -- CausalLM -------------------------------------------------------------------------

TINY = dict(d_model=64, d_ff=128, vocab_size=100, attn_chunk=8, ssm_chunk=8)
ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=16)
SSM = dict(ssm_state=16, ssm_head_dim=16)
# name -> (arch, overrides, sequence length)
VARIANTS = {
    "mixtral-window": ("mixtral-8x7b", dict(ATTN, sliding_window=12), 32),
    "grok-softcap": ("grok-1-314b", dict(ATTN), 16),
    "mamba2": ("mamba2-780m", dict(SSM, d_ff=0), 32),
    "jamba-one-block": ("jamba-1.5-large-398b", dict(ATTN, **SSM, num_layers=8), 16),
    "pixtral-frontend": ("pixtral-12b", dict(ATTN), 32),
    "musicgen-codebooks": ("musicgen-large", dict(ATTN, num_kv_heads=4), 16),
}


def _tiny(package_configs, variant, **extra):
    name, over, _ = VARIANTS[variant]
    return dataclasses.replace(package_configs.get_config(name).reduced(),
                               **{**TINY, **over, **extra})


def _batch(cfg, s, b=2, seed=1):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, s) if cfg.modality == "audio" else (b, s)
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)}
    if cfg.frontend_tokens:
        out["frontend_embeds"] = rng.normal(size=(b, cfg.frontend_tokens, cfg.d_model)
                                            ).astype(np.float32)
    return out


@functools.lru_cache(maxsize=None)
def _jax_reference(variant):
    """(params, batch, loss, grads) of the reference, flat numpy, once per variant."""
    cfg = _tiny(jconfigs, variant)
    model = jmodels.CausalLM(cfg)
    flat = flatten_params(_np(model.init(jax.random.PRNGKey(0))))
    # perturb the norm scales and biases (ones and zeros at init), so their
    # gradients and paths are exercised
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if k.split(".")[-1].startswith(("ln_", "bias_", "dt_bias", "D", "norm_scale")):
            flat[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    batch = _batch(cfg, VARIANTS[variant][2])
    loss, grads = jax.jit(jax.value_and_grad(model.loss))(
        jax.tree.map(jnp.asarray, unflatten_params(flat)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return flat, batch, float(loss), flatten_params(_np(grads))


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_causal_lm_loss_and_grads_match_jax(variant, impl):
    jparams, batch, jloss, ref = _jax_reference(variant)
    model = tmodels.CausalLM(_tiny(tconfigs, variant, attn_impl=impl))
    params = params_from_numpy(jparams, "cpu")
    grads, loss = torch.func.grad_and_value(model.loss)(params, _t(batch))
    np.testing.assert_allclose(loss.item(), jloss, atol=1e-5)
    got = params_to_numpy(grads)
    assert set(got) == set(ref)
    for k in ref:
        # 1e-5 of the leaf's largest entry where that is above 1: the embed
        # gradient reaches ~5 through the first norm of an 8-layer stack
        tol = 1e-5 * max(1.0, float(np.abs(ref[k]).max()))
        np.testing.assert_allclose(got[k], ref[k], atol=tol, err_msg=k)


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_init_matches_reference_leaves(name):
    for dtype in ("float32", "bfloat16"):
        jcfg = dataclasses.replace(jconfigs.get_config(name).reduced(), dtype=dtype)
        tcfg = dataclasses.replace(tconfigs.get_config(name).reduced(), dtype=dtype)
        shapes = flatten_params(jax.eval_shape(jmodels.CausalLM(jcfg).init,
                                               jax.random.PRNGKey(0)))
        ref = {k: (tuple(v.shape), str(v.dtype)) for k, v in shapes.items()}
        got = {k: (tuple(v.shape), str(v.dtype).removeprefix("torch."))
               for k, v in tmodels.CausalLM(tcfg).init(torch.Generator().manual_seed(0)).items()}
        assert got == ref, (name, dtype)


# -- federated-lm-ring ---------------------------------------------------------------

FED = {"mixtral": ("mixtral-window", 32), "mamba2": ("mamba2", 16)}


def _fed_kw(package_configs, lane, **extra):
    variant, s = FED[lane]
    model = (jmodels if package_configs is jconfigs else tmodels).CausalLM(
        _tiny(package_configs, variant, vocab_size=64, **extra))
    return dict(model=model, seq_len=s, vocab_size=64, num_samples=32)


@functools.lru_cache(maxsize=None)
def _jax_fed(lane):
    """Two supersteps (16 iterations) of the reference's federated-lm-ring."""
    jrun = jscenarios.build_scenario("federated-lm-ring", **_fed_kw(jconfigs, lane))
    init = flatten_params(_np(jrun.runtime.scheduler.params))
    src = jrun.batch_source()
    losses = np.concatenate([np.asarray(jrun.runtime.step(src).losses) for _ in range(2)])
    return init, losses, flatten_params(_np(jrun.runtime.scheduler.params))


@functools.lru_cache(maxsize=None)
def _port_fed(lane, graphed):
    """Two supersteps of the port's federated-lm-ring from the reference's
    initial state: (losses, params) as numpy, once per (lane, graphed)."""
    init = _jax_fed(lane)[0]
    run = tscenarios.build_scenario("federated-lm-ring", device="cpu", backend="cuda",
                                    **_fed_kw(tconfigs, lane, attn_impl="cuda"))
    sched = run.runtime.scheduler
    assert sched.backend.name == "cuda"
    sched.params = params_from_numpy(init, "cpu")
    if graphed:
        sched._graph = sched._build_graph()
    src = run.batch_source()
    losses = torch.cat([run.runtime.step(src).losses for _ in range(2)])
    return losses.numpy(), params_to_numpy(sched.params)


@pytest.mark.parametrize("lane", list(FED))
def test_federated_lm_ring_tracks_jax(lane):
    _, jlosses, jparams = _jax_fed(lane)
    losses, params = _port_fed(lane, graphed=False)
    np.testing.assert_allclose(losses, jlosses, atol=1e-4)
    for k, v in params.items():
        np.testing.assert_allclose(v, jparams[k], atol=1e-4, err_msg=k)


@pytest.mark.parametrize("lane", list(FED))
def test_round_graph_body_equals_eager_bitwise(lane):
    eager, graphed = (_port_fed(lane, graphed=g) for g in (False, True))
    np.testing.assert_array_equal(graphed[0], eager[0])
    for k, v in graphed[1].items():
        np.testing.assert_array_equal(v, eager[1][k], err_msg=k)
