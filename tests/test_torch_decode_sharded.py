"""Port parity: the sequence-sharded decode (``sharding.make_decode_impl``)
through ``launch.steps.build_serve``.

One world of 8 gloo rank processes started from this file
(``tests/test_torch_mesh.py``'s launcher) on a ``(data=4, model=2)`` mesh
decodes three cases, each for enough steps that ``q_pos`` wraps the ring
buffer, with the parameters of the JAX package (``repro_torch.convert``)
and tokens from numpy seeds:

* ``heads``: a reduced dense config with 4 q heads, so ``build_serve``
  all-gathers the query's heads over ``model`` (``gather_heads``); the batch
  of 8 over ``data``, the cache's sequence over ``model`` (decode_32k's
  layout);
* ``no_heads``: a reduced gemma2 with 3 q heads (``gather_heads`` off: the
  query is whole on every rank), with its local layers' 12-slot windows;
* ``long``: long_500k's layout, a batch of 1 replicated and the sequence
  over ``("data", "model")``, 8 shards.

Every step's logits and the final caches are held within 1e-5 of JAX's
local ``decode_step`` (computed in the test process while the ranks run),
and the ``heads`` case also of the reference's own ``make_decode_impl`` on
an 8-device host mesh, run in a subprocess with forced JAX devices
(``python tests/test_torch_decode_sharded.py jax8 <folder>``), as
``tests/test_spmd.py`` runs its checks.
"""
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh import _env, _rank_main, _results, _start_world  # noqa: E402

TINY = dict(num_heads=4, num_kv_heads=2, head_dim=16, d_model=64, d_ff=128, vocab_size=256,
            attn_chunk=16)
# case -> (arch, overrides, batch, cache length, steps, long context)
CASES = {
    "heads": ("qwen2.5-3b", TINY, 8, 16, 20, False),
    "no_heads": ("gemma2-2b", dict(TINY, num_heads=3, num_kv_heads=1, local_window=12), 8, 16,
                 20, False),
    "long": ("qwen2.5-3b", TINY, 1, 32, 36, True),
}
PARAMS_TIMEOUT = 120
JAX8_TIMEOUT = 240


def _cfg(configs, case: str):
    arch, over, *_ = CASES[case]
    return dataclasses.replace(configs.get_config(arch).reduced(), **over)


def _tokens(cfg, case: str) -> np.ndarray:
    """(steps, B) tokens."""
    _, _, b, _, steps, _ = CASES[case]
    return np.random.default_rng(3).integers(0, cfg.vocab_size, (steps, b)).astype(np.int32)


def _wait(path: Path) -> Path:
    deadline = time.monotonic() + PARAMS_TIMEOUT
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)
    return path


def _flat(tree) -> dict:
    import jax

    from repro_torch.convert import flatten_params

    return flatten_params(jax.tree.map(np.asarray, tree))


# -- the ranks ----------------------------------------------------------------------

def _full(x):
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.float().numpy().copy()


def _d8(rank: int, size: int, out: Path) -> dict:
    import repro_torch.configs as tconfigs
    from repro_torch.configs.shapes import InputShape
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch import build_serve, make_test_mesh

    mesh = make_test_mesh(4, 2, device="cpu")
    res = {}
    for case, (_, _, b, sc, steps, long_context) in CASES.items():
        cfg = _cfg(tconfigs, case)
        with np.load(_wait(out.parent / f"params_{case}.npz")) as z:
            params = params_from_numpy(dict(z), "cpu")
        step, abstract = build_serve(cfg, InputShape(case, sc, b, "decode", long_context),
                                     mesh)
        cache = step.model.init_cache(b, sc)
        assert {k: tuple(v.shape) for k, v in abstract[1].items()} == {
            k: tuple(v.shape) for k, v in cache.items()}
        logits = []
        for t, tok in enumerate(_tokens(cfg, case)):
            lg, cache = step(params, cache, torch.from_numpy(tok), t)
            logits.append(_full(lg))
        res[case] = {"logits": np.stack(logits), "cache": {k: _full(v) for k, v in
                                                            cache.items()},
                     "axes": (step.seq_axes, step.batch_axes),
                     "placements": {k: str(v.placements) for k, v in cache.items()}}
    return res


WORLDS = {"d8": _d8}


# -- the references -------------------------------------------------------------------

def _jax_params(out: Path) -> None:
    import jax

    import repro.configs as jconfigs
    from repro.models import CausalLM as JCausalLM

    for case in CASES:
        params = jax.jit(JCausalLM(_cfg(jconfigs, case)).init)(jax.random.PRNGKey(0))
        np.savez(out / f"tmp_{case}.npz", **_flat(params))
        os.replace(out / f"tmp_{case}.npz", out / f"params_{case}.npz")


def _jax_local(out: Path) -> dict:
    """Each case through JAX's local ``decode_step``."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.models import CausalLM as JCausalLM
    from repro_torch.convert import unflatten_params

    refs = {}
    for case, (_, _, b, sc, steps, long_context) in CASES.items():
        cfg = _cfg(jconfigs, case)
        model = JCausalLM(cfg, long_context=long_context)
        with np.load(out / f"params_{case}.npz") as z:
            params = jax.tree.map(jnp.asarray, unflatten_params(dict(z)))
        step = jax.jit(model.decode_step)
        cache, logits = model.init_cache(b, sc), []
        for t, tok in enumerate(_tokens(cfg, case)):
            lg, cache = step(params, jnp.asarray(tok), cache, jnp.int32(t))
            logits.append(np.asarray(lg))
        refs[case] = {"logits": np.stack(logits), "cache": _flat(cache)}
    return refs


def _jax8_main(out: Path) -> None:
    """The ``heads`` case through the reference's ``make_decode_impl`` on a
    ``(data=4, model=2)`` mesh of 8 forced host devices."""
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    from repro.launch.mesh import make_test_mesh
    from repro.models import CausalLM as JCausalLM
    from repro.sharding import make_decode_impl
    from repro_torch.convert import unflatten_params

    case = "heads"
    _, _, b, sc, _, _ = CASES[case]
    cfg = _cfg(jconfigs, case)
    mesh = make_test_mesh(data=4, model=2)
    impl = make_decode_impl(mesh, seq_axes=("model",), batch_axes=("data",),
                            gather_heads=True, model_axis="model")
    model = JCausalLM(cfg, decode_impl=impl)
    with np.load(_wait(out / f"params_{case}.npz")) as z:
        params = jax.tree.map(jnp.asarray, unflatten_params(dict(z)))
    logits = []
    with mesh:
        step = jax.jit(model.decode_step)
        cache = model.init_cache(b, sc)
        for t, tok in enumerate(_tokens(cfg, case)):
            lg, cache = step(params, jnp.asarray(tok), cache, jnp.int32(t))
            logits.append(np.asarray(lg))
    np.savez(out / "jax8.npz", logits=np.stack(logits),
             **{f"cache.{k}": v for k, v in _flat(cache).items()})


@pytest.fixture(scope="module")
def decoded(tmp_path_factory):
    out = tmp_path_factory.mktemp("decode")
    d = out / "d8"
    d.mkdir()
    procs = _start_world("d8", 8, d, script=__file__)
    env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=8", JAX_PLATFORMS="cpu")
    with open(out / "jax8.log", "wb") as log:
        jax8 = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "jax8",
                                 str(out)], env=env, stdout=log, stderr=subprocess.STDOUT)
    try:
        _jax_params(out)
        refs = _jax_local(out)
        jax8.wait(timeout=JAX8_TIMEOUT)
    except BaseException:
        for p in procs + [jax8]:
            p.kill()
        raise
    assert jax8.returncode == 0, (out / "jax8.log").read_text()[-6000:]
    with np.load(out / "jax8.npz") as z:
        refs["jax8"] = {"logits": z["logits"],
                        "cache": {k[6:]: z[k] for k in z.files if k.startswith("cache.")}}
    return _results(procs, d), refs


# -- the tests ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", list(CASES))
def test_sharded_decode_matches_jax_local_decode(decoded, case):
    ranks, refs = decoded
    want = refs[case]
    for r, res in enumerate(ranks):
        got = res[case]
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5,
                                   err_msg=f"{case} rank {r}")
        assert set(got["cache"]) == set(want["cache"])
        for k, v in want["cache"].items():
            np.testing.assert_allclose(got["cache"][k], v, atol=1e-5,
                                       err_msg=f"{case} {k} rank {r}")


def test_sharded_decode_matches_the_references_sharded_decode(decoded):
    ranks, refs = decoded
    want = refs["jax8"]
    for r, res in enumerate(ranks):
        got = res["heads"]
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5)
        for k, v in want["cache"].items():
            np.testing.assert_allclose(got["cache"][k], v, atol=1e-5, err_msg=f"{k} rank {r}")


def test_build_serve_layouts(decoded):
    ranks, _ = decoded
    res = ranks[0]
    assert res["heads"]["axes"] == (("model",), ("data",))
    assert res["long"]["axes"] == (("data", "model"), ())
    # k/v (nblocks, B, Sc, Hkv, hd): batch over data, sequence over model ...
    assert res["heads"]["placements"]["pos0.k"] == "(Shard(dim=1), Shard(dim=2))"
    assert res["heads"]["placements"]["pos0.pos"] == "(Replicate(), Shard(dim=1))"
    # ... or the sequence over both, the batch of one replicated
    assert res["long"]["placements"]["pos0.k"] == "(Shard(dim=2), Shard(dim=2))"


def test_per_row_positions_raise_mesh_serving():
    from repro_torch.sharding.decode import make_decode_impl

    class _Mesh:  # the impl reads only names, shape and coordinates
        mesh_dim_names = ("data", "model")
        mesh = torch.zeros(1, 1)

        def get_local_rank(self, name):
            return 0

    impl = make_decode_impl(_Mesh(), seq_axes=("model",), batch_axes=("data",),
                            gather_heads=False)
    kv = torch.zeros(2, 4, 1, 8)
    with pytest.raises(NotImplementedError, match="'mesh serving'"):
        impl(torch.zeros(2, 2, 8), kv, kv, torch.zeros(2, 4), torch.tensor(0),
             torch.zeros(2, 1, 8), torch.zeros(2, 1, 8), window=None, logit_cap=None)


if __name__ == "__main__":
    if sys.argv[1] == "jax8":
        _jax8_main(Path(sys.argv[2]))
    else:
        # argv: world rank size port out; the world reads its folder ``out``
        _rank_main({k: (lambda rank, size, _n=k: WORLDS[_n](rank, size, Path(sys.argv[5])))
                    for k in WORLDS}, sys.argv[1:6])
