"""Port parity: architecture configs, the causal LM and the LM corpora.

``ArchConfig`` fields and derived sizes against the reference's for all ten
configs (the model families' ``CausalLM`` is held in
``test_torch_families.py``); ``CausalLM`` loss and gradients against JAX's from the same
(carried) weights and tokens for a granite-like GQA config, a gemma2-like
config (both softcaps, a local window shorter than the sequence, post
norms, embed scale, tied embeddings) and a qwen-like config with QKV
biases, each on both attention paths (``plain``; ``cuda``, whose CPU
tensors take the flash kernels' plain versions), within 1e-5; and the
federated LM corpora and batches bitwise equal to the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.data as jdata
import repro.models as jmodels
import repro_torch.configs as tconfigs
import repro_torch.data as tdata
import repro_torch.models as tmodels
from repro_torch.convert import (
    flatten_params, params_from_numpy, params_to_numpy, unflatten_params,
)


@pytest.mark.parametrize("name", jconfigs.ARCH_NAMES)
def test_arch_config_matches_reference(name):
    ref, got = jconfigs.get_config(name), tconfigs.get_config(name)
    for cfg_ref, cfg in ((ref, got), (ref.reduced(), got.reduced())):
        for f in dataclasses.fields(cfg_ref):
            if f.name == "attn_impl":
                # the reference's "xla"/"pallas" name its executions; the
                # port's "plain"/"cuda" name its own (and nothing reads the
                # reference's field)
                continue
            assert getattr(cfg, f.name) == getattr(cfg_ref, f.name), (name, f.name)
        for prop in ("padded_vocab", "scan_period", "num_scan_blocks", "d_inner"):
            assert getattr(cfg, prop) == getattr(cfg_ref, prop), (name, prop)
        assert cfg.param_count() == cfg_ref.param_count()
        assert cfg.active_param_count() == cfg_ref.active_param_count()
        for i in range(4):
            for long_context in (False, True):
                assert (cfg.window_for_layer(i, long_context)
                        == cfg_ref.window_for_layer(i, long_context))
            assert cfg.layer_kind(i) == cfg_ref.layer_kind(i)
        assert cfg.param_dtype == getattr(torch, cfg_ref.dtype)
    assert got.attn_impl == "cuda"


def test_remat_and_unported_layers_raise():
    # every layer kind is ported; activation checkpointing is not
    with pytest.raises(NotImplementedError, match="remat"):
        tmodels.CausalLM(tconfigs.get_config("granite-8b"))


# tiny variants: S = 16, two attention chunks of 8 on the plain path
TINY = dict(d_model=64, d_ff=128, vocab_size=100, num_heads=4, head_dim=16, attn_chunk=8)
VARIANTS = {
    "granite-gqa": ("granite-8b", dict(num_kv_heads=2)),
    "gemma2-local-global": ("gemma2-2b", dict(num_kv_heads=2, local_window=6)),
    "qwen-qkv-bias": ("qwen2.5-3b", dict(num_kv_heads=2)),
}


def _tiny(package_configs, variant, **extra):
    name, over = VARIANTS[variant]
    return dataclasses.replace(package_configs.get_config(name).reduced(), **TINY, **over,
                               **extra)


def _jax_setup(variant, seed=0):
    cfg = _tiny(jconfigs, variant)
    model = jmodels.CausalLM(cfg)
    flat = flatten_params(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed))))
    # perturb the norm scales and biases (ones and zeros at init), so that
    # their gradients and the bias path are exercised
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.split(".")[-1].startswith(("ln_", "bq", "bk", "bv")):
            flat[k] = v + 0.1 * rng.normal(size=v.shape).astype(v.dtype)
    return cfg, model, jax.tree.map(jnp.asarray, unflatten_params(flat))


def _tokens(b=2, s=16, v=100, seed=1):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, v, size=(b, s)).astype(np.int32),
            "labels": rng.integers(0, v, size=(b, s)).astype(np.int32)}


@functools.lru_cache(maxsize=None)
def _jax_reference(variant):
    """(params, loss, grads, logits) of the reference, flat numpy, once per variant."""
    _, jmodel, jparams = _jax_setup(variant)
    batch = {k: jnp.asarray(v) for k, v in _tokens().items()}
    jloss, jgrads = jax.jit(jax.value_and_grad(jmodel.loss))(jparams, batch)
    jlogits, _ = jax.jit(jmodel.forward)(jparams, {"tokens": batch["tokens"]})
    flat = lambda t: flatten_params(jax.tree.map(np.asarray, t))
    return flat(jparams), float(jloss), flat(jgrads), np.asarray(jlogits)


@pytest.mark.parametrize("impl", ["plain", "cuda"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_causal_lm_loss_and_grads_match_jax(variant, impl):
    jparams, jloss, ref, jlogits = _jax_reference(variant)
    batch = _tokens()
    model = tmodels.CausalLM(_tiny(tconfigs, variant, attn_impl=impl))
    params = params_from_numpy(jparams, "cpu")
    fresh = model.init(torch.Generator().manual_seed(0))
    assert {k: (tuple(v.shape), v.dtype) for k, v in fresh.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in params.items()}
    grads, loss = torch.func.grad_and_value(model.loss)(
        params, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss.item(), jloss, atol=1e-5)
    got = params_to_numpy(grads)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], atol=1e-5, err_msg=k)
    # the forward's logits too (softcapped f32, padded vocabulary)
    logits, aux = model.forward(params, {"tokens": torch.from_numpy(batch["tokens"])})
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5)
    assert aux.item() == 0.0  # no MoE layer


def test_embed_scale_matches_jax_in_bf16():
    """gemma2's embedding scale, sqrt(d_model) rounded to the activations'
    dtype, bitwise the reference's in bf16 at a d_model whose root bf16
    does not hold (the port applies it as a Python number: a CUDA graph's
    capture refuses the copy of a host tensor)."""
    cfg_j, cfg_t = (dataclasses.replace(_tiny(pkg, "gemma2-local-global"), d_model=72,
                                        dtype="bfloat16") for pkg in (jconfigs, tconfigs))
    assert cfg_t.embed_scale and float(torch.tensor(72 ** 0.5, dtype=torch.bfloat16)) != 72 ** 0.5
    embed = np.random.default_rng(5).normal(size=(cfg_t.padded_vocab, 72)).astype(np.float32)
    tokens = _tokens()["tokens"]
    want = jmodels.CausalLM(cfg_j).embed_tokens(
        {"embed": jnp.asarray(embed, jnp.bfloat16)}, jnp.asarray(tokens))
    got = tmodels.CausalLM(cfg_t).embed_tokens(
        {"embed": torch.from_numpy(embed).to(torch.bfloat16)}, torch.from_numpy(tokens))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_vmapped_clients_match_per_client_loss():
    """The round engine's ``vmap(grad_and_value)`` over stacked clients."""
    model = tmodels.CausalLM(_tiny(tconfigs, "gemma2-local-global"))
    w0 = model.init(torch.Generator().manual_seed(3))
    c = 3
    params = {k: torch.stack([v * (1 + 0.01 * i) for i in range(c)]) for k, v in w0.items()}
    batches = [_tokens(seed=10 + i) for i in range(c)]
    stacked = {k: torch.from_numpy(np.stack([b[k] for b in batches])) for k in batches[0]}
    grads, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(params, stacked)
    for i in range(c):
        g, loss = torch.func.grad_and_value(model.loss)(
            {k: v[i] for k, v in params.items()},
            {k: torch.from_numpy(v) for k, v in batches[i].items()})
        np.testing.assert_allclose(losses[i].item(), loss.item(), rtol=1e-6)
        for k in g:
            np.testing.assert_allclose(grads[k][i].numpy(), g[k].numpy(), atol=1e-6, err_msg=k)


def test_flatten_roundtrip_and_bf16_carry():
    cfg = dataclasses.replace(_tiny(jconfigs, "granite-gqa"), dtype="bfloat16")
    tree = jax.tree.map(np.asarray, jmodels.CausalLM(cfg).init(jax.random.PRNGKey(0)))
    flat = flatten_params(tree)
    assert "blocks.pos0.attn.wq" in flat and flat["blocks.pos0.attn.wq"].shape[0] == 2
    back = unflatten_params(flat)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    params = params_from_numpy(flat, "cpu")
    assert all(v.dtype == torch.bfloat16 for v in params.values())
    for k, v in params_to_numpy(params).items():
        np.testing.assert_array_equal(v, flat[k].astype(np.float32))


def test_lm_corpora_and_batches_match_reference():
    ref = jdata.SyntheticLM.generate(32, 12, 50, seed=4)
    got = tdata.SyntheticLM.generate(32, 12, 50, seed=4)
    np.testing.assert_array_equal(got.tokens, ref.tokens)
    for make in ("generate", "generate_clustered"):
        args = (6, 20, 12, 50) + ((3,) if make == "generate_clustered" else ())
        ref = getattr(jdata.FederatedLM, make)(*args, seed=5)
        got = getattr(tdata.FederatedLM, make)(*args, seed=5)
        np.testing.assert_array_equal(got.tokens, ref.tokens)
        np.testing.assert_array_equal(got.data_sizes(), ref.data_sizes())
        if make == "generate_clustered":
            np.testing.assert_array_equal(got.cluster_succ, ref.cluster_succ)
            np.testing.assert_array_equal(got.cluster_assignments, ref.cluster_assignments)
        rrng, grng = np.random.default_rng(7), np.random.default_rng(7)
        for _ in range(3):
            rb, gb = ref.stacked_batch(2, rrng), got.stacked_batch(2, grng)
            for k in rb:
                np.testing.assert_array_equal(gb[k], rb[k])
        for k, v in ref.eval_batch(8, seed=1).items():
            np.testing.assert_array_equal(got.eval_batch(8, seed=1)[k], v)
