"""Port parity: decode (``CausalLM`` caches) and ``launch/serve.py``.

Inputs made from a seed with numpy go through the reference's function and
the port's, the reference's weights carried with
``convert.params_from_numpy``, TF32 off (the CPU has none):

* ``decode_attention`` (shared and per-row slot positions, window, softcap,
  empty slots) and ``mamba_decode_step`` within 1e-6;
* ``CausalLM.prefill``'s last logits and caches, ``grow_caches``, and then
  each ``decode_step``'s logits stepping on the reference's greedy tokens,
  within 1e-5, for every family: dense, MoE with mixtral's reduced window of
  64 and gemma2's local window of 64 with prompt + generation past them (the
  ring buffer evicts), mamba2, the jamba hybrid, pixtral (VLM) and
  musicgen's four codebooks;
* the decode writes its cache in place, and ``per_row`` decodes each row of
  an MoE batch as its own batch of one;
* a row-positioned decode (``pos`` (B,), per-row ``pos`` leaves, as the slot
  pool keeps them) bitwise the shared-position decode at equal positions,
  and each row its own batch-1 decode within 1e-5 at unequal ones;
* ``generate`` at temperature 0 token for token the reference's; at
  temperature > 0 reproducible from its seed.

``launch.serve.main`` and the serving examples: ``test_torch_serve_examples.py``.
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
import repro.models.layers as jlayers
import repro.models.mamba as jmamba
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.models.layers as tlayers
import repro_torch.models.mamba as tmamba
from repro.launch.serve import generate as jgenerate
from repro.launch.serve import grow_caches as jgrow
from repro_torch.convert import flatten_params, params_from_numpy
from repro_torch.launch import serve as tserve

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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# -- decode attention and the mamba step -----------------------------------------

@pytest.mark.parametrize("window,cap", [(None, None), (5, None), (None, 2.0)],
                         ids=["full", "window", "softcap"])
def test_decode_attention_matches_jax(window, cap):
    rng = np.random.default_rng(0)
    b, sc, hq, hkv, hd = 3, 12, 4, 2, 8
    q = rng.normal(size=(b, hq, hd)).astype(np.float32)
    k = rng.normal(size=(b, sc, hkv, hd)).astype(np.float32)
    v = rng.normal(size=(b, sc, hkv, hd)).astype(np.float32)
    slot_pos = np.arange(sc, dtype=np.int32) + 3
    slot_pos[[2, 7]] = -1  # empty slots
    kw = dict(window=window, logit_cap=cap)
    ref = jlayers.decode_attention(*map(jnp.asarray, (q, k, v, slot_pos)), jnp.int32(11), **kw)
    t = [torch.from_numpy(a) for a in (q, k, v, slot_pos)]
    got = tlayers.decode_attention(*t, torch.tensor(11), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6)
    # per-row positions: row r at its own query position, its own slot row
    rows = np.stack([slot_pos, slot_pos - 2, slot_pos + 1])
    qp = np.array([11, 6, 14], np.int32)
    got = tlayers.decode_attention(*t[:3], torch.from_numpy(rows), torch.from_numpy(qp), **kw)
    for r in range(b):
        ref = jlayers.decode_attention(jnp.asarray(q[r:r + 1]), jnp.asarray(k[r:r + 1]),
                                       jnp.asarray(v[r:r + 1]), jnp.asarray(rows[r]),
                                       jnp.int32(qp[r]), **kw)
        np.testing.assert_allclose(got[r:r + 1].numpy(), np.asarray(ref), atol=1e-6)
    acc, l, m = tlayers.decode_attention_stats(*t, torch.tensor(11), **kw)
    jacc, jl, jm = jlayers.decode_attention_stats(*map(jnp.asarray, (q, k, v, slot_pos)),
                                                  jnp.int32(11), **kw)
    for g, r in ((acc, jacc), (l, jl), (m, jm)):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_mamba_decode_step_matches_jax():
    cfg = dataclasses.replace(tconfigs.get_config("mamba2-780m").reduced(), d_model=32,
                              ssm_state=8, ssm_head_dim=16)
    jcfg = dataclasses.replace(jconfigs.get_config("mamba2-780m").reduced(), d_model=32,
                               ssm_state=8, ssm_head_dim=16)
    p = _np(jmamba.init_mamba_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 1, 32)).astype(np.float32)
    cache = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in _np(jmamba.init_mamba_cache(jcfg, 2, jnp.float32)).items()}
    step = jax.jit(lambda pp, xx, cc: jmamba.mamba_decode_step(pp, xx, jcfg, cc))
    ref_y, ref_c = step(jax.tree.map(jnp.asarray, p), jnp.asarray(x),
                        jax.tree.map(jnp.asarray, cache))
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    y, c = tmamba.mamba_decode_step(params_from_numpy(p, "cpu"), torch.from_numpy(x), cfg,
                                    tcache)
    np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), atol=1e-6)
    for k in ref_c:
        np.testing.assert_allclose(c[k].numpy(), np.asarray(ref_c[k]), atol=1e-6, err_msg=k)
    assert all(torch.equal(tcache[k], torch.from_numpy(v)) for k, v in cache.items())
    empty = tmamba.init_mamba_cache(cfg, 2, torch.float32)
    assert {k: tuple(v.shape) for k, v in empty.items()} == {k: v.shape for k, v in cache.items()}


# -- CausalLM prefill and decode, every family -------------------------------------

TINY = dict(d_model=64, d_ff=128, vocab_size=100, attn_chunk=8, ssm_chunk=8)
ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=16)
SSM = dict(ssm_state=16, ssm_head_dim=16)
# name -> (arch, overrides, prompt length, generated tokens); the windows are
# reduced()'s 64, passed by prompt + generation
FAMILIES = {
    "dense": ("granite-8b", dict(ATTN), 16, 4),
    "mixtral-ring": ("mixtral-8x7b", dict(ATTN), 64, 6),
    "gemma2-ring": ("gemma2-2b", dict(ATTN), 64, 6),
    "mamba2": ("mamba2-780m", dict(SSM, d_ff=0), 16, 4),
    "jamba": ("jamba-1.5-large-398b", dict(ATTN, **SSM, num_layers=8), 16, 3),
    "pixtral": ("pixtral-12b", dict(ATTN), 24, 3),
    "musicgen": ("musicgen-large", dict(ATTN, num_kv_heads=4), 8, 3),
}


def _cfg(package_configs, family, **extra):
    name, over, _, _ = FAMILIES[family]
    return dataclasses.replace(package_configs.get_config(name).reduced(),
                               **{**TINY, **over, **extra})


def _prompts(cfg, s, b=2, seed=0):
    rng = np.random.default_rng(seed)
    shape = (b, cfg.num_codebooks, s) if cfg.modality == "audio" else (b, s)
    return rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _jax_decode(family):
    """The reference's params, prompts, prefill (logits, cache), grown cache
    and per-step (token fed, logits), flat numpy."""
    jcfg = _cfg(jconfigs, family)
    _, _, s, gen = FAMILIES[family]
    model = jmodels.CausalLM(jcfg)
    params = model.init(jax.random.PRNGKey(0))
    prompts = _prompts(jcfg, s)
    logits, cache = jax.jit(model.prefill)(params, {"tokens": jnp.asarray(prompts)})
    pre = (np.asarray(logits), flatten_params(_np(cache)))
    cache = jgrow(model, cache, s + gen)
    grown = flatten_params(_np(cache))
    step = jax.jit(model.decode_step)
    steps = []
    for i in range(gen):
        tok = np.array(jnp.argmax(logits[:, -1, ..., :jcfg.vocab_size], axis=-1))
        logits, cache = step(params, jnp.asarray(tok), cache, jnp.int32(s + i))
        steps.append((tok, np.asarray(logits)))
    return flatten_params(_np(params)), prompts, pre, grown, steps


@pytest.mark.parametrize("impl", ["cuda", "plain"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_prefill_and_decode_match_jax(family, impl):
    jparams, prompts, (jlogits, jcache), jgrown, steps = _jax_decode(family)
    model = tmodels.CausalLM(_cfg(tconfigs, family, attn_impl=impl))
    params = params_from_numpy(jparams, "cpu")
    logits, cache = model.prefill(params, {"tokens": torch.from_numpy(prompts)})
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5)
    assert set(cache) == set(jcache)
    for k, v in jcache.items():
        assert cache[k].dtype != torch.int32 or v.dtype == np.int32
        np.testing.assert_allclose(cache[k].numpy(), v, atol=1e-5, err_msg=k)
    s = prompts.shape[-1]
    cache = tserve.grow_caches(model, cache, s + len(steps))
    assert {k: tuple(v.shape) for k, v in cache.items()} == {k: v.shape for k, v in
                                                              jgrown.items()}
    for i, (tok, jl) in enumerate(steps):
        logits, cache = model.decode_step(params, torch.from_numpy(tok), cache, s + i)
        np.testing.assert_allclose(logits.numpy(), jl, atol=1e-5, err_msg=f"step {i}")


def _clone(cache):
    return {k: v.clone() for k, v in cache.items()}


def test_decode_writes_the_cache_in_place():
    model = tmodels.CausalLM(_cfg(tconfigs, "dense"))
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_prompts(model.cfg, 8))
    _, cache = model.prefill(params, {"tokens": prompts})
    cache = tserve.grow_caches(model, cache, 12)
    before = _clone(cache)
    tok = torch.tensor([3, 4])
    _, same = model.decode_step(params, tok, cache, 8)
    assert all(same[k] is cache[k] for k in cache)
    assert not all(torch.equal(cache[k], before[k]) for k in cache)
    # a gate of False writes the old values back
    again = _clone(before)
    model.decode_step(params, tok, again, 8, gate=torch.tensor(False))
    assert all(torch.equal(again[k], before[k]) for k in cache)


def test_per_row_decode_is_each_rows_own():
    """24 rows of an MoE model (past the capacity floor of 16), half of them
    one repeated prompt and token: with ``per_row`` each row's logits are its batch-1
    decode's; routed as one token set, the repeated rows crowd the experts
    they choose and later rows lose their choices."""
    model = tmodels.CausalLM(_cfg(tconfigs, "mixtral-ring", attn_impl="plain"))
    params = model.init(torch.Generator().manual_seed(2))
    s, b = 8, 24
    prompts = torch.from_numpy(_prompts(model.cfg, s, b=b, seed=3))
    prompts[:12] = prompts[0]
    _, cache = model.prefill(params, {"tokens": prompts})
    cache = tserve.grow_caches(model, cache, s + 1)
    tok = torch.from_numpy(_prompts(model.cfg, 1, b=b, seed=4)[:, 0].astype(np.int64))
    tok[:12] = 7
    got, _ = model.decode_step(params, tok, _clone(cache), s, per_row=True)
    flat, _ = model.decode_step(params, tok, _clone(cache), s)
    for r in range(b):
        one = {k: (v[:, r:r + 1] if not k.endswith(".pos") else v).clone()
               for k, v in cache.items()}
        ref, _ = model.decode_step(params, tok[r:r + 1], one, s)
        np.testing.assert_allclose(got[r:r + 1].numpy(), ref.numpy(), atol=1e-5,
                                   err_msg=f"row {r}")
    assert not torch.allclose(flat, got, atol=1e-5)


@pytest.mark.parametrize("family", ["dense", "mixtral-ring", "jamba"])
def test_row_positions_equal_shared_positions(family):
    """The slot pool's layout: per-row positions (B,) and per-row ``pos``
    leaves (nblocks, B, Sc) give the shared-position decode's logits and
    caches at equal positions, and each row its own at unequal ones."""
    model = tmodels.CausalLM(_cfg(tconfigs, family, attn_impl="plain"))
    params = model.init(torch.Generator().manual_seed(1))
    _, _, s, gen = FAMILIES[family]
    prompts = torch.from_numpy(_prompts(model.cfg, s))
    _, cache = model.prefill(params, {"tokens": prompts})
    cache = tserve.grow_caches(model, cache, s + gen)
    rowed = {k: (v[:, None].expand(v.shape[0], 2, v.shape[1]).contiguous()
                 if k.endswith(".pos") else v) for k, v in cache.items()}
    tok = torch.tensor([5, 9])
    ref, ref_cache = model.decode_step(params, tok, _clone(cache), s)
    got, got_cache = model.decode_step(params, tok, _clone(rowed), torch.tensor([s, s]))
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    for k, v in ref_cache.items():
        want = v[:, None].expand_as(got_cache[k]) if k.endswith(".pos") else v
        np.testing.assert_array_equal(got_cache[k].numpy(), want.numpy(), err_msg=k)
    # row 1 one position behind: its logits are a decode at s - 1 of its own
    got, _ = model.decode_step(params, tok, _clone(rowed), torch.tensor([s, s - 1]))
    one = {k: (v[:, 1:2] if not k.endswith(".pos") else v).clone() for k, v in cache.items()}
    ref1, _ = model.decode_step(params, tok[1:], one, s - 1)
    np.testing.assert_allclose(got[1:].numpy(), ref1.numpy(), atol=1e-5)


@pytest.mark.parametrize("family", ["dense", "mixtral-ring", "musicgen"])
def test_generate_greedy_matches_jax(family):
    jparams, prompts, _, _, steps = _jax_decode(family)
    jcfg = _cfg(jconfigs, family)
    gen = len(steps)
    ref = jgenerate(jmodels.CausalLM(jcfg), jax.tree.map(jnp.asarray, _unflat(jparams)),
                    jnp.asarray(prompts), gen)
    model = tmodels.CausalLM(_cfg(tconfigs, family))
    out = tserve.generate(model, params_from_numpy(jparams, "cpu"), torch.from_numpy(prompts),
                          gen)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def _unflat(flat):
    from repro_torch.convert import unflatten_params

    return unflatten_params(flat)


def test_generate_sampling_follows_the_seed():
    model = tmodels.CausalLM(_cfg(tconfigs, "dense"))
    params = model.init(torch.Generator().manual_seed(0))
    prompts = torch.from_numpy(_prompts(model.cfg, 8))
    a, b, c = (tserve.generate(model, params, prompts, 6, temperature=1.0, seed=s)
               for s in (3, 3, 4))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert int(a.max()) < model.cfg.vocab_size
    greedy = tserve.generate(model, params, prompts, 6)
    cold = tserve.generate(model, params, prompts, 6, temperature=1e-6, seed=3)
    assert torch.equal(greedy, cold)
