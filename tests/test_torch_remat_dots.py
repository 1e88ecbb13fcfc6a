"""Port parity: remat's ``"dots"`` policy (``models.transformer._Remat``).

With ``remat_policy="dots"`` a block's forward keeps the products without
batch dimensions of their own (``layers.dense``: the projections, the MoE
router's logits, mamba's projections; ``transformer.dots_saved`` lists
them) and its backward recomputes the rest, taking those products back
instead of multiplying again.  Inputs from a numpy seed, the reference's
weights through ``convert.params_from_numpy``, TF32 off (the CPU has none):

* loss and gradients under ``vmap(grad_and_value)`` over two clients equal
  policy ``"full"`` and remat off bit for bit, and the reference's
  ``remat_policy="dots"`` run within 1e-5 (of a leaf's largest entry where
  that is above 1), on a dense model, MoE, mamba2 and the jamba hybrid;
* the products a block keeps are the list ``dots_saved`` names, in shape
  and dtype, and the same set the reference keeps
  (``jax.ad_checkpoint``'s saved residuals of the scanned block, less its
  input), the post-norm and bias variants included;
* the backward takes no kept product again: one client's gradient takes
  as many fewer matrix products under ``"dots"`` than under ``"full"`` as
  a block has products;
* on a ``(1, 1)`` ``DeviceMesh`` in a one-rank ``gloo`` world (the
  DTensor path, whose backward recomputes under autograd) the gradients of
  the three runs are equal bit for bit.
"""
import dataclasses
import functools
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
from repro_torch.convert import (
    flatten_params, params_from_numpy, params_to_numpy, unflatten_params,
)
from repro_torch.models.layers import saved_products
from repro_torch.models.transformer import dots_saved

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh import _rank_main, _results, _start_world  # noqa: E402

TINY = dict(d_model=64, d_ff=128, vocab_size=100, attn_chunk=8, ssm_chunk=8)
ATTN = dict(num_heads=4, num_kv_heads=2, head_dim=16)
SSM = dict(ssm_state=16, ssm_head_dim=16)
# name -> (arch, overrides); two blocks of each family (jamba one of 8 layers)
VARIANTS = {
    "dense": ("granite-8b", dict(ATTN)),
    "moe": ("mixtral-8x7b", dict(ATTN, sliding_window=12)),
    "mamba2": ("mamba2-780m", dict(SSM, d_ff=0)),
    "hybrid": ("jamba-1.5-large-398b", dict(ATTN, **SSM, num_layers=8)),
    "post-norm": ("gemma2-2b", dict(ATTN, local_window=12)),
    "qkv-bias": ("qwen2.5-3b", dict(ATTN)),
}
GRAD_VARIANTS = ("dense", "moe", "mamba2", "hybrid")
SEQ, BATCH = 16, 3


def _cfg(package_configs, variant, remat=True, policy="dots", **extra):
    name, over = VARIANTS[variant]
    return dataclasses.replace(package_configs.get_config(name).reduced(),
                               **{**TINY, **over, **extra}, remat=remat, remat_policy=policy)


def _batch(c=2, seed=1):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, TINY["vocab_size"], size=(c, BATCH, SEQ)).astype(np.int32)
            for k in ("tokens", "labels")}


@functools.lru_cache(maxsize=None)
def _jax_dots(variant):
    """Two clients' (params, batch, losses, grads) of the reference with
    remat policy "dots", flat numpy."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro.models as jmodels

    model = jmodels.CausalLM(_cfg(jconfigs, variant))
    flat = flatten_params(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(0)
    for k, v in flat.items():
        if k.split(".")[-1].startswith(("ln_", "bias_", "dt_bias", "D", "norm_scale", "b")):
            flat[k] = (v + 0.1 * rng.normal(size=v.shape)).astype(v.dtype)
    stacked = {k: np.stack([v, v * 1.05]) for k, v in flat.items()}
    batch = _batch()

    def grad_and_loss(p, b):
        loss, g = jax.value_and_grad(model.loss)(p, b)
        return g, loss

    grads, losses = jax.jit(jax.vmap(grad_and_loss))(
        jax.tree.map(jnp.asarray, unflatten_params(stacked)),
        {k: jnp.asarray(v) for k, v in batch.items()})
    return stacked, batch, np.asarray(losses), flatten_params(jax.tree.map(np.asarray, grads))


def _port(variant, remat, policy="dots"):
    stacked, batch, _, _ = _jax_dots(variant)
    model = tmodels.CausalLM(_cfg(tconfigs, variant, remat, policy, attn_impl="cuda"))
    grads, losses = torch.func.vmap(torch.func.grad_and_value(model.loss))(
        params_from_numpy(stacked, "cpu"), {k: torch.from_numpy(v) for k, v in batch.items()})
    return losses.detach().numpy(), params_to_numpy(grads)


@pytest.mark.parametrize("variant", GRAD_VARIANTS)
def test_dots_grads_equal_full_and_no_remat_and_jax(variant):
    _, _, jlosses, jgrads = _jax_dots(variant)
    losses, grads = _port(variant, True, "dots")
    for remat, policy in ((True, "full"), (False, "full")):
        losses0, grads0 = _port(variant, remat, policy)
        np.testing.assert_array_equal(losses, losses0)
        for k, g in grads0.items():
            np.testing.assert_array_equal(grads[k], g, err_msg=f"{k} against {policy} {remat}")
    np.testing.assert_allclose(losses, jlosses, atol=1e-5)
    assert set(grads) == set(jgrads)
    for k, ref in jgrads.items():
        scale = max(1.0, float(np.abs(ref).max()))
        np.testing.assert_allclose(grads[k], ref, atol=1e-5 * scale, err_msg=k)


# -- what a block keeps ----------------------------------------------------------------

def _one_client(variant):
    model = tmodels.CausalLM(_cfg(tconfigs, variant))
    params = model.init(torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(_batch()["tokens"][0]).long()
    return model, params, {"tokens": tokens, "labels": tokens}


def _products_of_a_block(model, params, batch):
    """The products ``layers.dense`` takes in the first block's forward,
    in order (remat off: the forward records every product)."""
    cfg = dataclasses.replace(model.cfg, remat=False)
    with saved_products() as tape:
        tmodels.CausalLM(cfg).forward(params, batch)
    per_block = len(dots_saved(dataclasses.replace(cfg, use_post_norm=True)))
    return tape.saved[:per_block]


def _reference_kept(variant) -> list:
    """(shape, dtype) of what the reference's ``"dots"`` block keeps beside
    its input: the saved residuals stacked by the scan over blocks."""
    import jax
    import jax.numpy as jnp
    from jax._src.ad_checkpoint import saved_residuals

    import repro.configs as jconfigs
    import repro.models as jmodels

    cfg = _cfg(jconfigs, variant)
    model = jmodels.CausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0))
    tokens = jnp.asarray(_batch()["tokens"][0])
    res = saved_residuals(lambda p: model.loss(p, {"tokens": tokens, "labels": tokens}), params)
    nb = cfg.num_scan_blocks
    kept = [(tuple(a.shape[1:]), str(a.dtype)) for a, _ in res
            if a.ndim == 4 and tuple(a.shape[:3]) == (nb, BATCH, SEQ)]
    kept.remove(((BATCH, SEQ, cfg.d_model), "float32"))   # the block's input
    return sorted(kept)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_saved_products_are_the_listed_ones(variant):
    model, params, batch = _one_client(variant)
    names = dots_saved(model.cfg)
    products = _products_of_a_block(model, params, batch)
    # every product of the block, in the listed order; all but a last one
    # that only the residual add reads are kept
    every = dots_saved(dataclasses.replace(model.cfg, use_post_norm=True))
    assert names == every[:len(names)] and len(every) - len(names) in (0, 1)
    assert len(products) == len(every)
    for name, y in zip(every, products):
        w = params[f"blocks.{name}"]
        assert tuple(y.shape) == (BATCH, SEQ, w.shape[-1]), name
    kept = sorted((tuple(y.shape), str(y.dtype).replace("torch.", ""))
                  for y in products[:len(names)])
    assert kept == _reference_kept(variant)


class _Products(TorchDispatchMode):
    """Counts the matrix products the traced ops take."""

    OPS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default, torch.ops.aten.addmm.default}

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func in self.OPS
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("variant", GRAD_VARIANTS)
def test_dots_backward_takes_no_kept_product_again(variant):
    model, params, batch = _one_client(variant)
    counts = {}
    for policy in ("full", "dots"):
        m = tmodels.CausalLM(dataclasses.replace(model.cfg, remat_policy=policy))
        with _Products() as mode:
            torch.func.grad(m.loss)(params, batch)
        counts[policy] = mode.n
    per_block = len(dots_saved(dataclasses.replace(model.cfg, use_post_norm=True)))
    assert counts["full"] - counts["dots"] == per_block * model.cfg.num_scan_blocks, counts


# -- on a (1, 1) mesh -------------------------------------------------------------------

def _mesh1(rank: int, size: int, out: Path) -> dict:
    """One client's gradients through DTensors on a (1, 1) mesh, remat off,
    "full" and "dots"."""
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.mesh import mesh_axes_for
    from repro_torch.sharding import activation_sharding, distribute_params, param_pspecs

    mesh = make_test_mesh(1, 1, device="cpu")
    ax = mesh_axes_for(mesh)
    res = {}
    for variant in ("dense", "moe"):
        model, params, batch = _one_client(variant)
        specs = param_pspecs(model.cfg, model.param_shapes(), ax)
        for remat, policy in ((False, "full"), (True, "full"), (True, "dots")):
            m = tmodels.CausalLM(dataclasses.replace(model.cfg, remat=remat,
                                                     remat_policy=policy))
            p = distribute_params(params, specs, mesh)
            p = {k: v.detach().requires_grad_() for k, v in p.items()}
            with activation_sharding(mesh, ax.batch_axes, ax.model):
                loss = m.loss(p, batch)
                grads = torch.autograd.grad(loss, list(p.values()))
            res[(variant, remat, policy)] = {
                k: g.full_tensor().numpy().copy() for k, g in zip(p, grads)}
    return res


WORLDS = {"mesh1": _mesh1}


def test_dots_on_a_one_rank_mesh_equal_full_and_no_remat(tmp_path):
    procs = _start_world("mesh1", 1, tmp_path, script=__file__)
    (res,) = _results(procs, tmp_path)
    for variant in ("dense", "moe"):
        dots = res[(variant, True, "dots")]
        for key in ((variant, True, "full"), (variant, False, "full")):
            assert set(res[key]) == set(dots)
            for k, g in res[key].items():
                np.testing.assert_array_equal(dots[k], g, err_msg=f"{key} {k}")


if __name__ == "__main__":
    _rank_main({k: (lambda rank, size, _n=k: WORLDS[_n](rank, size, Path(sys.argv[5])))
                for k in WORLDS}, sys.argv[1:6])
