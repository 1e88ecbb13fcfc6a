"""Port parity: the slot pool on a mixture-of-experts model.

The reference's decode chunk runs each slot as a batch of one (a ``vmap``
over slots), so an MoE layer there never drops a slot's expert choice; the
port decodes all slots in one batch.  With more slots than the capacity
floor of 16, a flat dispatch over the pool would let other slots (empty,
finished, or another cluster's) take a live slot's expert room.  Here
``ContinuousServer`` and ``ContinuousFederatedServer`` on mixtral's reduced
shape (4 experts, top 2) at 24 slots, more requests than slots and mixed
budgets, are token for token the reference's at temperature 0, and so are
``ServeStats``' counts.
"""
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
import repro.models as jmodels
import repro.serving as jserving
import repro_torch.configs as tconfigs
import repro_torch.models as tmodels
import repro_torch.serving as tserving
from repro_torch.convert import flatten_params, params_from_numpy

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


SMALL = dict(num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1, head_dim=16,
             vocab_size=64, attn_chunk=8, remat=False)
SLOTS, BUCKETS, GEN_CAP = 24, (8, 16), 10
STATS = ("requests", "batches", "tokens_generated", "decode_steps", "occupancy_sum")


def _cfg(package_configs):
    return dataclasses.replace(package_configs.get_config("mixtral-8x7b").reduced(), **SMALL)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """Two clusters' reference weights, flat numpy."""
    model = jmodels.CausalLM(_cfg(jconfigs))
    return [flatten_params(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(s))))
            for s in range(2)]


def _requests(mod):
    rng = np.random.default_rng(0)
    out = []
    for i in range(40):
        plen = int(rng.integers(3, BUCKETS[-1] + 1))
        out.append(mod.Request(uid=i, prompt=rng.integers(0, 64, plen).astype(np.int32),
                               max_new_tokens=int(rng.integers(1, GEN_CAP + 1)),
                               cluster_id=int(rng.integers(0, 2))))
    return out


def _server(package, federated):
    flat = _jax_params()
    if package == "jax":
        mod, model = jserving, jmodels.CausalLM(_cfg(jconfigs))
        trees = [jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(s))) for s in range(2)]
        params = (jax.tree.map(lambda *ls: np.stack(ls), *trees) if federated else trees[0])
    else:
        mod, model = tserving, tmodels.CausalLM(_cfg(tconfigs))
        trees = [params_from_numpy(f, "cpu") for f in flat]
        params = ({k: torch.stack([t[k] for t in trees]) for k in trees[0]} if federated
                  else trees[0])
    kw = dict(max_batch=SLOTS, length_buckets=BUCKETS, gen_cap=GEN_CAP, chunk_steps=4)
    if federated:
        return mod, mod.ContinuousFederatedServer(model, params, **kw)
    return mod, mod.ContinuousServer(model, params, **kw)


@pytest.mark.parametrize("federated", [False, True], ids=["continuous", "continuous-federated"])
def test_moe_slot_pool_token_for_token_the_reference(federated):
    out = {}
    for package in ("jax", "torch"):
        mod, srv = _server(package, federated)
        for req in _requests(mod):
            srv.submit(req)
        done = srv.run()
        out[package] = ([(r.uid, np.asarray(r.output).tolist()) for r in done],
                        {f: getattr(srv.stats, f) for f in STATS})
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][1] == pytest.approx(out["jax"][1], abs=1e-9)
    assert out["torch"][1]["requests"] == 40
