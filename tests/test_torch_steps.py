"""Port parity: the step builders (``launch.steps``) on ``DeviceMesh``es.

Each world is a set of rank processes started from this file over ``gloo``
(``tests/test_torch_mesh.py``'s launcher: one intra-op thread a rank,
timeouts on the group's init and on every process); a rank writes what it
computed to ``<out>/<rank>.pt``.  The parameters come from the JAX package
(``repro_torch.convert``), saved before the ranks start; the batches from
numpy seeds.  The test process computes the reference's unsharded functions
while the ranks run, and every rank's gathered result is held to them in
f32.

* ``w8`` (8 ranks): ``build_train`` ``default`` on ``(data=4, model=2)``
  with ``FLSpec(4, 2, tau1=1, tau2=1, alpha=1)``, as the reference's
  ``check_tiny_dryrun``, and ``fsdp`` on ``(data=8, model=1)`` (cluster 4
  x fsdp 2), against JAX's dense ``build_fl_train_step``: 1e-5 after one
  step, 1e-4 after 10.
* ``w4`` (4 ranks): ``build_train`` ``pod`` on ``(pod=2, data=2,
  model=1)`` (10 steps) and ``default`` on the same mesh (one step: each
  client's batch split over ``pod``), and on ``(data=1, model=4)`` (the stack on every
  rank, the transition through ``fused_transition``'s plain version);
  on ``(data=2, model=2)``: one step with remat; ``build_prefill`` of a
  reduced dense config (4 q heads, 2 KV heads, tensor-parallel), of a
  reduced gemma2 with 3 q heads, which ``model=2`` does not divide
  (sequence-parallel attention, ``attn_impl="plain"`` and ``"cuda"``, the
  latter a rank's rows of every chunk as one flash call through its
  query-row map), and of a reduced mixtral through the MoE's per-shard
  branch (logits, caches and the router's aux loss), against JAX's
  ``prefill`` within 1e-5; one ``build_train`` step of gemma2's first block
  (``"cuda"``, sequence-parallel) against JAX's dense step within 1e-5;
  every client-mesh operator of ``core.aggregation`` on the ``data``
  subgroup of the ``(2, 2)`` mesh; and ``build_fl_train_step(impl="dense")``
  on a 4-rank client mesh, 10 iterations.
* ``w2`` (2 ranks): the same operators on a world of 2, which the
  subgroup's must equal bitwise; ``build_prefill`` and ``build_serve`` of
  reduced mamba2, pixtral and musicgen on ``(data=1, model=2)`` against
  the port's plain calls (2e-5).
* ``w1`` (1 rank, a ``(1, 1)`` mesh, the card's layout): the prefill and
  serve steps bitwise the plain ``CausalLM`` calls, the train step within
  1e-6 of ``build_fl_train_step`` without a mesh; ``impl="gossip"``
  refused.

The two stack-on-the-rank runs step each rank's 4 clients one by one, so
they take ``STACKED_STEPS`` iterations (held at 1e-5 after the first).
"""
import dataclasses
import os
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh import _rank_main, _results, _start_world  # noqa: E402

TINY = dict(num_heads=4, num_kv_heads=2, head_dim=16, d_model=64, d_ff=128, vocab_size=256,
            attn_chunk=16)
# name -> (arch, overrides)
CONFIGS = {
    "dense": ("qwen2.5-3b", TINY),
    "gemma2": ("gemma2-2b", dict(TINY, num_heads=3, num_kv_heads=1, local_window=12)),
    "mixtral": ("mixtral-8x7b", TINY),
}
TRAIN_SEQ, PREFILL_SEQ, STEPS = 16, 32, 10
STACKED_STEPS = 2   # the stack-on-the-rank case steps its 4 clients one by one
LR = 0.1
FL4 = dict(num_clients=4, num_clusters=2, tau1=1, tau2=1, alpha=1, learning_rate=LR)
FL2 = dict(num_clients=2, num_clusters=2, tau1=1, tau2=1, alpha=1, learning_rate=LR)
REDUCE_W = np.array([0.75, 1.25], dtype=np.float32)
# the other families on a (data=1, model=2) mesh, against the port's plain calls
FAMILIES = ("mamba2-780m", "pixtral-12b", "musicgen-large")
PARAMS_TIMEOUT = 120  # seconds a rank waits for the reference's parameters


def _cfg(configs, name: str):
    arch, over = CONFIGS[name]
    return dataclasses.replace(configs.get_config(arch).reduced(), **over)


# the train runs keep the dense config's first layer: a step on a mesh is
# bound by gloo's latency a collective, and a layer's collectives (forward,
# backward, its leaves' gradients) are most of a step's
def _train_cfg(configs, name: str = "dense"):
    """``name``'s first block: one layer of the dense config, gemma2's
    local and global layers."""
    cfg = _cfg(configs, name)
    return dataclasses.replace(cfg, num_layers=cfg.scan_period)


def _train_params(params: dict) -> dict:
    """The dense parameters cut to the train config's one block."""
    return {k: v[:1] if k.startswith("blocks.") else v for k, v in params.items()}


def _train_batch(cfg, c: int, it: int) -> dict:
    """Iteration ``it``'s ``(C, 2, S)`` tokens and labels."""
    rng = np.random.default_rng(1000 + it)
    shape = (c, 2, TRAIN_SEQ)
    return {k: rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
            for k in ("tokens", "labels")}


def _prefill_tokens(cfg) -> np.ndarray:
    return np.random.default_rng(7).integers(0, cfg.vocab_size, (4, PREFILL_SEQ)).astype(
        np.int32)


def _params(out: Path, name: str) -> dict:
    """A config's parameters, which the test process saves beside the
    worlds' folders while the ranks start (waited for here)."""
    from repro_torch.convert import params_from_numpy

    path = out.parent / f"params_{name}.npz"
    deadline = time.monotonic() + PARAMS_TIMEOUT
    while not path.exists():
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear")
        time.sleep(0.1)
    with np.load(path) as z:
        return params_from_numpy(dict(z), "cpu")


def _full(x):
    x = x.full_tensor() if hasattr(x, "full_tensor") else x
    return x.detach().float().numpy().copy()


def _full_tree(tree: dict) -> dict:
    return {k: _full(v) for k, v in tree.items()}


# -- the ranks ----------------------------------------------------------------------

def _train_run(cfg, mesh, fl_kw: dict, variant: str, params: dict, steps: int = STEPS) -> dict:
    """``steps`` train steps from the stacked ``params``: the gathered params
    after the first and the last, and the losses."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import FLSpec
    from repro_torch.launch import build_train

    c = fl_kw["num_clients"]
    step, abstract = build_train(cfg, InputShape("t", TRAIN_SEQ, 2 * c, "train"), mesh,
                                 fl=FLSpec(**fl_kw), variant=variant)
    assert {k: tuple(v.shape) for k, v in abstract[0].items()} == {
        k: (c,) + tuple(v.shape) for k, v in params.items()}
    p = {k: v[None].expand((c,) + tuple(v.shape)).clone() for k, v in params.items()}
    out, losses = {}, []
    for it in range(steps):
        batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg, c, it).items()}
        p, _, loss = step(p, (), batch)
        losses.append(float(loss))
        if it in (0, steps - 1):
            out[it] = _full_tree(p)
    out["losses"] = np.asarray(losses)
    out["placements"] = {k: str(v.placements) for k, v in p.items()}
    return out


def _prefill_run(cfg, mesh, params: dict) -> dict:
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import build_prefill
    from repro_torch.launch.mesh import mesh_axes_for
    from repro_torch.sharding import activation_sharding, distribute_params

    step, _ = build_prefill(cfg, InputShape("p", PREFILL_SEQ, 4, "prefill"), mesh)
    batch = {"tokens": torch.from_numpy(_prefill_tokens(cfg))}
    logits, cache = step(params, batch)
    out = {"logits": _full(logits), "cache": _full_tree(cache)}
    if cfg.num_experts:
        ax = mesh_axes_for(mesh)
        with activation_sharding(mesh, ax.batch_axes, ax.model):
            _, aux = step.model.forward(
                distribute_params(params, step.specs["params"], mesh),
                distribute_params(batch, step.specs["batch"], mesh))
        out["aux"] = _full(aux)
    return out


def _recording(module, name: str, log: list, what):
    """Wrap ``module.name`` so each call appends ``what(args, kwargs)`` to
    ``log``."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        log.append(what(args, kw))
        return fn(*args, **kw)

    setattr(module, name, wrapped)


def _w8(rank: int, size: int, out: Path) -> dict:
    import repro_torch.configs as tconfigs
    from repro_torch.launch import make_test_mesh

    from repro_torch.launch import default_fl_spec

    res = {}
    dense = _train_cfg(tconfigs)
    params = _train_params(_params(out, "dense"))
    meshes = {shape: make_test_mesh(*shape, device="cpu") for shape in ((4, 2), (8, 1))}
    res["default_fl_spec"] = {k: dataclasses.asdict(default_fl_spec(m))
                              for k, m in meshes.items()}
    res["default"] = _train_run(dense, meshes[(4, 2)], FL4, "default", params)
    res["fsdp"] = _train_run(dense, meshes[(8, 1)], FL4, "fsdp", params)
    return res


def _agg_rows(client: int, m: int) -> dict:
    """Client ``client``'s ``(1, ...)`` row in the subgroup of model index ``m``."""
    rng = np.random.default_rng(100 + 10 * m + client)
    return {"w": torch.tensor(rng.standard_normal((1, 3, 4)).astype(np.float32)),
            "b": torch.tensor(rng.standard_normal((1, 5)).astype(np.float32)).to(torch.bfloat16)}


def _agg_ops(mesh, m: int) -> dict:
    """Every client-mesh operator on ``mesh`` (2 clients), rows of model index ``m``."""
    from repro_torch.core.aggregation import (
        cluster_sums_on_mesh, dense_transition_on_mesh, fleet_weighted_sum, gather_rows,
        gather_rows_to_host, ppermute,
    )

    rows, w = _agg_rows(mesh.index, m), torch.tensor(REDUCE_W)
    t = torch.tensor([[0.25, 0.5], [0.75, 0.5]])
    return {"swap": ppermute(rows, mesh, [(0, 1), (1, 0)]),
            "keep": ppermute(rows["w"], mesh, [(0, 0)]),
            "gather": gather_rows(rows, mesh),
            "weighted_sum": fleet_weighted_sum(rows, mesh, w),
            "cluster_sums": cluster_sums_on_mesh(rows, mesh, 2, w),
            "to_host": gather_rows_to_host(rows, mesh, dst=1),
            "dense": dense_transition_on_mesh(rows, mesh, t)}


def _client_mesh_dense(params: dict) -> dict:
    """``build_fl_train_step(impl="dense")`` on a 4-rank client mesh, ``STEPS``
    iterations of the default run's batches: this rank's row at the end."""
    import repro_torch.configs as tconfigs
    from repro_torch import optim
    from repro_torch.core import FLSpec, build_fl_train_step
    from repro_torch.launch.mesh import make_client_mesh
    from repro_torch.models import CausalLM

    cfg = _train_cfg(tconfigs)
    mesh = make_client_mesh(4, device="cpu")
    step = build_fl_train_step(CausalLM(cfg), optim.sgd(LR), FLSpec(**FL4, impl="dense"),
                               mesh=mesh, device="cpu")
    p = {k: v[None].clone() for k, v in params.items()}
    losses = []
    for it in range(STEPS):
        batch = {k: torch.from_numpy(v) for k, v in _train_batch(cfg, 4, it).items()}
        p, _, loss = step(p, (), batch)
        losses.append(float(loss))
    return {"row": _full_tree(p), "losses": np.asarray(losses)}


def _w4(rank: int, size: int, out: Path) -> dict:
    import repro_torch.configs as tconfigs
    import repro_torch.kernels as tkernels
    import repro_torch.models.layers as tlayers
    import repro_torch.models.moe as tmoe
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.mesh import ClientMesh

    res = {}
    train, train_params = _train_cfg(tconfigs), _train_params(_params(out, "dense"))
    pod = make_test_mesh(2, 1, pod=2, device="cpu")
    res["pod"] = _train_run(train, pod, FL2, "pod", train_params)
    # default on the same mesh: clients on data, each client's batch split
    # over pod, its leaves whole there (their gradients summed over pod)
    res["default_pod"] = _train_run(train, pod, FL2, "default", train_params, steps=1)
    res["stacked"] = _train_run(train, make_test_mesh(1, 4, device="cpu"), FL4, "default",
                                train_params, steps=STACKED_STEPS)
    mesh = make_test_mesh(2, 2, device="cpu")
    res["prefill_dense"] = _prefill_run(_cfg(tconfigs, "dense"), mesh, _params(out, "dense"))
    gemma2 = _cfg(tconfigs, "gemma2")
    # attn_impl "cuda": each rank's rows through the flash op's query-row map
    flash, prefill_calls, train_calls = tkernels.flash_attention, [], []
    shapes = lambda a, kw: (tuple(a[0].shape), tuple(a[1].shape), kw.get("rows"))
    _recording(tkernels, "flash_attention", prefill_calls, shapes)
    res["prefill_gemma2_cuda"] = _prefill_run(gemma2, mesh, _params(out, "gemma2"))
    tkernels.flash_attention = flash
    _recording(tkernels, "flash_attention", train_calls, shapes)
    res["train_gemma2"] = _train_run(_train_cfg(tconfigs, "gemma2"), mesh, FL2, "default",
                                     _train_params(_params(out, "gemma2")), steps=1)
    tkernels.flash_attention = flash
    res["gemma2_flash_calls"], res["gemma2_train_flash_calls"] = prefill_calls, train_calls
    rows = []
    _recording(tlayers, "_rows_attention", rows, lambda a, kw: tuple(a[0].shape))
    res["prefill_gemma2"] = _prefill_run(dataclasses.replace(gemma2, attn_impl="plain"), mesh,
                                         _params(out, "gemma2"))
    res["seq_parallel_rows"] = rows
    # remat on a mesh: the backward recomputes each block under autograd
    res["remat"] = _train_run(dataclasses.replace(train, remat=True), mesh, FL2, "default",
                              train_params, steps=1)
    local_batches = []
    _recording(tmoe, "_experts", local_batches, lambda a, kw: int(a[0].shape[0]))
    res["prefill_mixtral"] = _prefill_run(_cfg(tconfigs, "mixtral"), mesh,
                                          _params(out, "mixtral"))
    res["moe_local_batches"] = local_batches
    cmesh = ClientMesh.from_device_mesh(mesh, "data")
    res["subgroup"] = {"index": cmesh.index, "size": cmesh.size,
                       "ops": _agg_ops(cmesh, mesh.get_local_rank("model"))}
    res["client_mesh_dense"] = _client_mesh_dense(train_params)
    return res


def _family_on_mesh(name: str, mesh) -> dict:
    """A tiny ``name`` prefilled and decoded (2 steps) through the steps on
    ``mesh`` and through the plain calls: their largest differences."""
    import repro_torch.configs as tconfigs
    from repro_torch.configs.shapes import InputShape, make_concrete_batch
    from repro_torch.launch import build_prefill, build_serve
    from repro_torch.models import CausalLM

    base = tconfigs.get_config(name)
    cfg = dataclasses.replace(base.reduced(), d_model=64, d_ff=128 if base.d_ff else 0,
                              vocab_size=256)
    model = CausalLM(cfg)
    params = model.init(torch.Generator().manual_seed(0))
    shape = InputShape("p", 16, 4, "prefill")
    step, _ = build_prefill(cfg, shape, mesh)
    batch = make_concrete_batch(cfg, shape, device="cpu")
    (logits, cache), (want, want_cache) = step(params, batch), model.prefill(params, batch)
    out = {"prefill": max(np.abs(_full(v) - _full(want_cache[k])).max() for k, v in
                          cache.items())}
    out["prefill_logits"] = np.abs(_full(logits) - _full(want)).max()
    serve, _ = build_serve(cfg, InputShape("d", 16, 4, "decode"), mesh)
    cache, ref = model.init_cache(4, 16), model.init_cache(4, 16)
    tok = torch.from_numpy(make_concrete_batch(cfg, InputShape("d", 16, 4, "decode"),
                                               device="cpu")["token"].numpy())
    diffs = []
    for t in range(2):
        logits, cache = serve(params, cache, tok, t)
        want, ref = model.decode_step(params, tok, ref, t)
        diffs.append(np.abs(_full(logits) - _full(want)).max())
    out["decode"] = max(diffs + [np.abs(_full(v) - _full(ref[k])).max()
                                 for k, v in cache.items()])
    return out


def _w2(rank: int, size: int, out: Path) -> dict:
    from repro_torch.launch import make_test_mesh
    from repro_torch.launch.mesh import make_client_mesh

    mesh = make_client_mesh(2, device="cpu")
    res = {m: _agg_ops(mesh, m) for m in (0, 1)}
    try:
        make_test_mesh(2, 2, device="cpu")
    except ValueError as e:
        res["wrong_size"] = str(e)
    tp = make_test_mesh(1, 2, device="cpu")
    res["families"] = {name: _family_on_mesh(name, tp) for name in FAMILIES}
    return res


def _w1(rank: int, size: int, out: Path) -> dict:
    """The steps on a (1, 1) mesh against the plain calls."""
    import repro_torch.configs as tconfigs
    from repro_torch import optim
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import FLSpec, build_fl_train_step
    from repro_torch.launch import build_prefill, build_serve, build_train, make_test_mesh
    from repro_torch.models import CausalLM

    mesh = make_test_mesh(1, 1, device="cpu")
    cfg = _cfg(tconfigs, "dense")
    params = _params(out, "dense")
    model = CausalLM(cfg)
    res = {}
    step, _ = build_prefill(cfg, InputShape("p", PREFILL_SEQ, 4, "prefill"), mesh)
    batch = {"tokens": torch.from_numpy(_prefill_tokens(cfg))}
    got, want = step(params, batch), model.prefill(params, batch)
    res["prefill"] = (_full(got[0]), _full(want[0]), _full_tree(got[1]), _full_tree(want[1]))
    serve, _ = build_serve(cfg, InputShape("d", 8, 4, "decode"), mesh)
    cache, ref = model.init_cache(4, 8), model.init_cache(4, 8)
    logits = []
    for t in range(10):
        tok = torch.from_numpy(np.random.default_rng(t).integers(0, 256, 4).astype(np.int32))
        g, cache = serve(params, cache, tok, t)
        w, ref = model.decode_step(params, tok, ref, t)
        logits.append((_full(g), _full(w)))
    res["serve"] = (logits, _full_tree(cache), _full_tree(ref))
    tcfg, tparams = _train_cfg(tconfigs), _train_params(params)
    train = _train_run(tcfg, mesh, FL4, "default", tparams, steps=STACKED_STEPS)
    plain = build_fl_train_step(CausalLM(tcfg), optim.sgd(LR), FLSpec(**FL4), device="cpu")
    p = {k: v[None].expand((4,) + tuple(v.shape)).clone() for k, v in tparams.items()}
    for it in range(STACKED_STEPS):
        batch = {k: torch.from_numpy(v) for k, v in _train_batch(tcfg, 4, it).items()}
        p, _, _ = plain(p, (), batch)
    res["train"] = (train[STACKED_STEPS - 1], _full_tree(p))
    try:
        build_train(tcfg, InputShape("t", TRAIN_SEQ, 4, "train"), mesh,
                    fl=FLSpec(**dict(FL4, impl="gossip")))
        res["gossip"] = None
    except ValueError as e:
        res["gossip"] = str(e)
    return res


WORLDS = {"w8": _w8, "w4": _w4, "w2": _w2, "w1": _w1}


# -- the references -------------------------------------------------------------------

def _jax_params(out: Path) -> dict:
    """Each config's JAX init, flat numpy, saved for the ranks."""
    import jax

    import repro.configs as jconfigs
    from repro.models import CausalLM as JCausalLM
    from repro_torch.convert import flatten_params

    flat = {}
    for name in CONFIGS:
        params = jax.jit(JCausalLM(_cfg(jconfigs, name)).init)(jax.random.PRNGKey(0))
        flat[name] = flatten_params(jax.tree.map(np.asarray, params))
        # written whole, then renamed: a rank never reads a partial file
        np.savez(out / f"tmp_{name}.npz", **flat[name])
        os.replace(out / f"tmp_{name}.npz", out / f"params_{name}.npz")
    return flat


def _jax_references(flat: dict) -> dict:
    import jax
    import jax.numpy as jnp

    import repro.configs as jconfigs
    import repro.core as jcore
    from repro import optim as joptim
    from repro.models import CausalLM as JCausalLM
    from repro_torch.convert import flatten_params, unflatten_params

    def tree(f):
        return jax.tree.map(jnp.asarray, unflatten_params(f))

    refs = {}
    cfg = _train_cfg(jconfigs)
    model = JCausalLM(cfg)
    for key, fl_kw in (("train4", FL4), ("train2", FL2)):
        c = fl_kw["num_clients"]
        step = jax.jit(jcore.build_fl_train_step(model, joptim.sgd(LR),
                                                 jcore.FLSpec(**fl_kw, impl="dense")))
        p = tree({k: np.broadcast_to(v, (c,) + v.shape)
                  for k, v in _train_params(flat["dense"]).items()})
        got, losses = {}, []
        for it in range(STEPS):
            batch = {k: jnp.asarray(v) for k, v in _train_batch(cfg, c, it).items()}
            p, _, loss = step(p, (), batch)
            losses.append(float(loss))
            if it in (0, STACKED_STEPS - 1, STEPS - 1):
                got[it] = flatten_params(jax.tree.map(np.asarray, p))
        got["losses"] = np.asarray(losses)
        refs[key] = got
    gcfg = _train_cfg(jconfigs, "gemma2")
    step = jax.jit(jcore.build_fl_train_step(JCausalLM(gcfg), joptim.sgd(LR),
                                             jcore.FLSpec(**FL2, impl="dense")))
    p = tree({k: np.broadcast_to(v, (2,) + v.shape)
              for k, v in _train_params(flat["gemma2"]).items()})
    batch = {k: jnp.asarray(v) for k, v in _train_batch(gcfg, 2, 0).items()}
    p, _, loss = step(p, (), batch)
    refs["train2_gemma2"] = {0: flatten_params(jax.tree.map(np.asarray, p)),
                             "losses": np.asarray([float(loss)])}
    for name in CONFIGS:
        cfg = _cfg(jconfigs, name)
        model = JCausalLM(cfg)
        params = tree(flat[name])
        batch = {"tokens": jnp.asarray(_prefill_tokens(cfg))}
        logits, cache = jax.jit(model.prefill)(params, batch)
        refs[f"prefill_{name}"] = {"logits": np.asarray(logits),
                                   "cache": flatten_params(jax.tree.map(np.asarray, cache))}
        if cfg.num_experts:
            refs[f"prefill_{name}"]["aux"] = np.asarray(jax.jit(model.forward)(params, batch)[1])
    return refs


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    out = tmp_path_factory.mktemp("steps")
    started = {}
    for name, size in (("w8", 8), ("w4", 4), ("w2", 2), ("w1", 1)):
        d = out / name
        d.mkdir()
        started[name] = (_start_world(name, size, d, script=__file__), d)
    try:
        refs = _jax_references(_jax_params(out))
    except BaseException:
        for procs, _ in started.values():
            for p in procs:
                p.kill()
        raise
    return {name: _results(procs, d) for name, (procs, d) in started.items()}, refs


def _close(got: dict, want: dict, atol: float, what: str) -> None:
    assert set(got) == set(want), what
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, atol=atol, err_msg=f"{what} {k}")


# -- train -------------------------------------------------------------------------------

@pytest.mark.parametrize("world,case,ref", [("w8", "default", "train4"),
                                            ("w8", "fsdp", "train4"),
                                            ("w4", "pod", "train2"),
                                            ("w4", "default_pod", "train2"),
                                            ("w4", "stacked", "train4"),
                                            ("w4", "remat", "train2")])
def test_build_train_matches_jax(worlds, world, case, ref):
    ranks, refs = worlds
    want = refs[ref]
    steps = {"stacked": STACKED_STEPS, "remat": 1, "default_pod": 1}.get(case, STEPS)
    for r, res in enumerate(ranks[world]):
        got = res[case]
        _close(got[0], want[0], 1e-5, f"{case} step 1 rank {r}")
        _close(got[steps - 1], want[steps - 1], 1e-4, f"{case} step {steps} rank {r}")
        np.testing.assert_allclose(got["losses"], want["losses"][:steps], atol=1e-4)
        np.testing.assert_array_equal(got["losses"], ranks[world][0][case]["losses"])


def test_build_train_lays_leaves_out_by_the_rules(worlds):
    ranks, _ = worlds
    pl = ranks["w8"][0]["default"]["placements"]
    # the client dimension on data; wq's heads and the vocabulary on model
    assert pl["blocks.pos0.attn.wq"] == "(Shard(dim=0), Shard(dim=3))"
    assert pl["embed"] == "(Shard(dim=0), Shard(dim=1))"
    assert pl["blocks.pos0.attn.wk"] == "(Shard(dim=0), Replicate())"
    fsdp = ranks["w8"][0]["fsdp"]["placements"]
    # (cluster, fsdp, model): each client's first free dimension over fsdp
    assert fsdp["blocks.pos0.ffn.w_gate"] == "(Shard(dim=0), Shard(dim=2), Shard(dim=3))"


# -- prefill -------------------------------------------------------------------------------

@pytest.mark.parametrize("world,name", [("w4", "dense"), ("w4", "gemma2"), ("w4", "mixtral")])
def test_build_prefill_matches_jax(worlds, world, name):
    """(gemma2 with ``attn_impl="plain"``: the cuda impl is held below.)"""
    ranks, refs = worlds
    want = refs[f"prefill_{name}"]
    for r, res in enumerate(ranks[world]):
        got = res[f"prefill_{name}"]
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5)
        _close(got["cache"], want["cache"], 1e-5, f"{name} cache rank {r}")
        if "aux" in want:
            np.testing.assert_allclose(got["aux"], want["aux"], atol=1e-5)


def test_gemma2_prefill_runs_sequence_parallel(worlds):
    import repro_torch.configs as tconfigs

    ranks, _ = worlds
    layers = _cfg(tconfigs, "gemma2").num_layers
    for res in ranks["w4"]:
        # one call a layer, on the rank's 8 of each 16-row query chunk:
        # (B_l, n chunks, rows, Hq, hd)
        assert res["seq_parallel_rows"] == [(2, 2, 8, 3, 16)] * layers


def test_gemma2_sequence_parallel_through_the_flash_kernels_matches_jax(worlds):
    """gemma2's 3 heads on model=2 with ``attn_impl="cuda"``: each rank's 8
    of every 16-row query chunk as one flash call through the query-row map
    (``rows = (8, 16, 8 * model rank)``, one a layer), the prefill's
    logits and caches and one train step's parameters and loss within 1e-5
    of JAX."""
    import repro_torch.configs as tconfigs

    ranks, refs = worlds
    layers = _cfg(tconfigs, "gemma2").num_layers
    want = refs["prefill_gemma2"]
    for r, res in enumerate(ranks["w4"]):
        m = r % 2  # the (data, model) mesh's model coordinate
        # (B_l, 2 chunks x 8 rows, Hq, hd) against K of the whole sequence
        assert res["gemma2_flash_calls"] == [((2, 16, 3, 16), (2, 32, 1, 16),
                                              (8, 16, 8 * m))] * layers
        got = res["prefill_gemma2_cuda"]
        np.testing.assert_allclose(got["logits"], want["logits"], atol=1e-5)
        _close(got["cache"], want["cache"], 1e-5, f"gemma2 cuda cache rank {r}")
        # one client's 2 rows of 16 tokens a rank, both layers of the block
        assert res["gemma2_train_flash_calls"] == [((2, 8, 3, 16), (2, 16, 1, 16),
                                                    (8, 16, 8 * m))] * 2
        train = res["train_gemma2"]
        _close(train[0], refs["train2_gemma2"][0], 1e-5, f"gemma2 train rank {r}")
        np.testing.assert_allclose(train["losses"], refs["train2_gemma2"]["losses"], atol=1e-5)


@pytest.mark.parametrize("name", FAMILIES)
def test_other_families_step_on_a_mesh_as_the_plain_calls(worlds, name):
    ranks, _ = worlds
    for r, res in enumerate(ranks["w2"]):
        got = res["families"][name]
        # f32, tensor-parallel: the model axis splits the reductions
        assert max(got.values()) <= 2e-5, (name, r, got)


def test_mixtral_prefill_dispatches_each_batch_shard(worlds):
    import repro_torch.configs as tconfigs

    ranks, _ = worlds
    layers = _cfg(tconfigs, "mixtral").num_layers
    for res in ranks["w4"]:
        # the (data=2) batch shard's 2 examples, once a MoE layer for the
        # prefill and once for the aux loss's forward
        assert res["moe_local_batches"] == [2] * (2 * layers)


# -- the client-mesh operators on a subgroup ------------------------------------------------

def _equal(a, b, what: str) -> None:
    if isinstance(a, dict):
        assert set(a) == set(b), what
        for k in a:
            _equal(a[k], b[k], f"{what}.{k}")
    elif a is None or b is None:
        assert a is None and b is None, what
    else:
        assert a.dtype == b.dtype and torch.equal(a, b), what


def test_mesh_operators_on_the_data_subgroup_match_a_world_of_two(worlds):
    ranks, _ = worlds
    pair = ranks["w2"]
    for r, res in enumerate(ranks["w4"]):
        sub = res["subgroup"]
        data, model = divmod(r, 2)
        assert (sub["index"], sub["size"]) == (data, 2)
        # the (2, 2) mesh's data subgroup {model, 2 + model} against ranks 0, 1
        _equal(sub["ops"], pair[data][model], f"rank {r}")


def test_dense_train_step_on_a_client_mesh_matches_jax(worlds):
    ranks, refs = worlds
    want = refs["train4"]
    for r, res in enumerate(ranks["w4"]):
        got = res["client_mesh_dense"]
        _close(got["row"], {k: v[r:r + 1] for k, v in want[STEPS - 1].items()}, 1e-4,
               f"rank {r}")
        np.testing.assert_allclose(got["losses"], want["losses"], atol=1e-4)


# -- the card's layout: a (1, 1) mesh -------------------------------------------------------

def test_steps_on_a_one_rank_mesh_are_the_plain_calls(worlds):
    (res,) = worlds[0]["w1"]
    logits, want, cache, want_cache = res["prefill"]
    np.testing.assert_array_equal(logits, want)
    _close(cache, want_cache, 0.0, "prefill cache")
    steps, cache, want_cache = res["serve"]
    for got, want in steps:
        np.testing.assert_array_equal(got, want)
    _close(cache, want_cache, 0.0, "serve cache")
    train, plain = res["train"]
    _close(train, plain, 1e-6, "train")


def test_build_train_refuses_gossip_and_donate(worlds):
    import repro_torch.configs as tconfigs
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import build_train

    (res,) = worlds[0]["w1"]
    # the collective backend runs on a ClientMesh, not on a DeviceMesh step
    assert res["gossip"] is not None and "runs on a ClientMesh" in res["gossip"]
    with pytest.raises(TypeError, match="donate"):
        build_train(_cfg(tconfigs, "dense"), InputShape("t", TRAIN_SEQ, 4, "train"), None,
                    donate=True)


def test_default_fl_spec_matches_the_reference(worlds):
    import types

    import repro.launch.steps as jsteps

    ranks, _ = worlds
    for (data, model), got in ranks["w8"][0]["default_fl_spec"].items():
        fake = types.SimpleNamespace(axis_names=("data", "model"),
                                     devices=np.zeros((data, model)))
        assert got == dataclasses.asdict(jsteps.default_fl_spec(fake)), (data, model)


def test_make_test_mesh_names_the_launch():
    from repro_torch.launch import make_test_mesh

    with pytest.raises(ValueError, match="have none; launch .*torchrun --nproc-per-node 4"):
        make_test_mesh(2, 2, device="cpu")
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 8"):
        make_test_mesh(2, 2, pod=2, device="cpu")


def test_make_test_mesh_refuses_a_world_of_another_size(worlds):
    ranks, _ = worlds
    for res in ranks["w2"]:
        assert "needs 4 ranks: the process group has 2" in res["wrong_size"]
        assert "torchrun --nproc-per-node 4" in res["wrong_size"]


def test_context_without_a_mesh_passes_tensors_through():
    from repro_torch.sharding import constrain_batch, constrain_dim, model_axis_size
    from repro_torch.sharding.context import current

    x = torch.arange(12.0).reshape(3, 4)
    assert current() is None and model_axis_size() == 1
    assert constrain_batch(x) is x and constrain_dim(x, 1) is x


if __name__ == "__main__":
    # argv: world rank size port out; a world reads its folder ``out``
    _rank_main({k: (lambda rank, size, _n=k: WORLDS[_n](rank, size, Path(sys.argv[5])))
                for k in WORLDS}, sys.argv[1:6])
