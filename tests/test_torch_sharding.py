"""Port parity: the sharding rules (``repro_torch.sharding``) and the input
shapes (``repro_torch.configs.shapes``).

* The port's specs equal the reference's leaf for leaf, the reference's
  nested names mapped through ``convert.flatten_params``, for all ten
  configs at published widths: ``MeshAxes`` with and without ``pod``, with
  ``client_axis``, and with ``fsdp_axis`` (``fsdp_size`` = 4); so do
  ``describe_sharding``'s counts, and ``replica_pspecs``.  The port reads its shapes from
  ``CausalLM.param_shapes()`` (meta tensors), the reference from
  ``jax.eval_shape``, as ``tests/test_sharding.py`` does.
* ``batch_pspecs`` and ``cache_pspecs`` match for each ``SHAPES`` step.
* ``SHAPES``, ``input_specs`` (every config and shape) and
  ``make_concrete_batch`` (reduced configs: the same integers and values).
* ``distribute_params`` on a (data = 2, model = 2) ``DeviceMesh`` in one
  4-rank ``gloo`` world (started as ``tests/test_torch_mesh.py`` starts
  its worlds): each rank's local shard equals its slice of the full tensor,
  and the round trip through ``full_tensor`` is bitwise.
"""
import dataclasses
import functools
import os
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.configs.shapes import SHAPES, input_specs, make_concrete_batch
from repro_torch.convert import flatten_params
from repro_torch.models import CausalLM
from repro_torch.sharding import (
    MeshAxes, Spec, batch_pspecs, cache_pspecs, describe_sharding, param_pspecs,
    replica_pspecs, to_placements,
)

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

# the rank processes' launcher: tests/ is on the path under pytest and for
# the script itself (the ranks import no JAX)
from test_torch_mesh import _rank_main, _results, _start_world  # noqa: E402

VARIANTS = {
    "model": (MeshAxes(), {}),
    "pod": (MeshAxes(pod="pod"), {}),
    "client": (MeshAxes(), {"client_axis": "data"}),
    "fsdp": (MeshAxes(pod="pod"), {"fsdp_axis": "data", "fsdp_size": 4}),
}


def _jax_axes(ax):
    from repro.sharding import MeshAxes as JMeshAxes

    return JMeshAxes(**dataclasses.asdict(ax))


def _specs_equal(tspecs: dict, jspecs, what: str) -> None:
    flat = flatten_params(jspecs)
    assert sorted(flat) == sorted(tspecs), what
    for k, s in tspecs.items():
        assert isinstance(s, Spec)
        assert tuple(s) == tuple(flat[k]), f"{what} {k}: {s} vs {flat[k]}"


@functools.lru_cache(maxsize=None)
def _shapes(name: str):
    """(reference config, port config, reference shapes, port meta shapes)."""
    import jax

    from repro.configs import get_config as jget
    from repro.models import CausalLM as JCausalLM

    jcfg, tcfg = jget(name), get_config(name)
    jshape = jax.eval_shape(JCausalLM(jcfg).init, jax.random.PRNGKey(0))
    return jcfg, tcfg, jshape, CausalLM(tcfg).param_shapes()


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_param_specs_equal_reference(name):
    import jax

    from repro.sharding import describe_sharding as jdescribe
    from repro.sharding import param_pspecs as jparam_pspecs

    jcfg, tcfg, jshape, tshape = _shapes(name)
    flat = flatten_params(jshape)
    assert sorted(flat) == sorted(tshape)
    for k, v in tshape.items():
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(flat[k].shape), k
        assert str(v.dtype).split(".")[-1] == str(flat[k].dtype), k
    for variant, (ax, kw) in VARIANTS.items():
        shapes_t, shapes_j = tshape, jshape
        if "client_axis" in kw:
            shapes_t = {k: torch.empty((4,) + tuple(v.shape), device="meta")
                        for k, v in tshape.items()}
            shapes_j = jax.tree.map(lambda s: jax.ShapeDtypeStruct((4,) + s.shape, s.dtype),
                                    jshape)
        tspecs = param_pspecs(tcfg, shapes_t, ax, **kw)
        jspecs = jparam_pspecs(jcfg, shapes_j, _jax_axes(ax), **kw)
        _specs_equal(tspecs, jspecs, f"{name} {variant}")
        assert describe_sharding(tcfg, tspecs) == jdescribe(jcfg, jspecs)


def test_replica_specs_equal_reference():
    import jax

    from repro.sharding import replica_pspecs as jreplica_pspecs

    _, tcfg, jshape, tshape = _shapes("mixtral-8x7b")
    stack_t = {k: torch.empty((2,) + tuple(v.shape), device="meta") for k, v in tshape.items()}
    stack_j = jax.tree.map(lambda s: jax.ShapeDtypeStruct((2,) + s.shape, s.dtype), jshape)
    _specs_equal(replica_pspecs(stack_t, "cluster"), jreplica_pspecs(stack_j, "cluster"),
                 "replicas")


def test_model_axis_carries_most_bytes():
    """As the reference's ``test_every_arch_has_sharded_majority_of_bytes``:
    the big weights are model-sharded."""
    for name in ("grok-1-314b", "jamba-1.5-large-398b", "command-r-35b"):
        _, tcfg, _, tshape = _shapes(name)
        specs = param_pspecs(tcfg, tshape, MeshAxes())
        total = sum(v.numel() for v in tshape.values())
        sharded = sum(v.numel() for k, v in tshape.items()
                      if any(a is not None for a in specs[k]))
        assert sharded / total > 0.9, name


def _cache_shapes(name: str, shape):
    """Decode-cache shapes of ``shape``'s batch and length: (reference, port)."""
    import jax

    from repro.models import CausalLM as JCausalLM

    jcfg, tcfg, _, _ = _shapes(name)
    b = shape.global_batch
    jc = jax.eval_shape(lambda: JCausalLM(jcfg, long_context=shape.long_context)
                        .init_cache(b, shape.seq_len))
    tc = CausalLM(tcfg, long_context=shape.long_context).init_cache(b, shape.seq_len,
                                                                    device="meta")
    return jc, tc


@pytest.mark.parametrize("shape_name", list(SHAPES))
def test_batch_and_cache_specs_equal_reference(shape_name):
    from repro.configs.shapes import input_specs as jinput_specs
    from repro.sharding import batch_pspecs as jbatch_pspecs
    from repro.sharding import cache_pspecs as jcache_pspecs

    shape = SHAPES[shape_name]
    c = 16 if shape.step == "train" else None
    for name in ARCH_NAMES:
        jcfg, tcfg, _, _ = _shapes(name)
        for ax in (MeshAxes(), MeshAxes(pod="pod")):
            jax_ax = _jax_axes(ax)
            kw = dict(federated=shape.step == "train", batch_div=16)
            tspecs = batch_pspecs(tcfg, input_specs(tcfg, shape, c), ax, shape.step, **kw)
            jspecs = jbatch_pspecs(jcfg, jinput_specs(jcfg, shape, c), jax_ax, shape.step, **kw)
            _specs_equal(tspecs, jspecs, f"{name} {shape_name} batch")
            jc, tc = _cache_shapes(name, shape)
            for seq_axes, batch_axes in ((("model",), ax.batch_axes),
                                         ((), ("data",)), (("pod", "model"), ())):
                _specs_equal(cache_pspecs(tcfg, tc, ax, seq_axes, batch_axes),
                             jcache_pspecs(jcfg, jc, jax_ax, seq_axes, batch_axes),
                             f"{name} {shape_name} cache {seq_axes} {batch_axes}")


def test_shapes_and_input_specs_equal_reference():
    from repro.configs.shapes import SHAPES as JSHAPES
    from repro.configs.shapes import input_specs as jinput_specs

    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JSHAPES.items()}
    for name in ARCH_NAMES:
        jcfg, tcfg, _, _ = _shapes(name)
        for shape in SHAPES.values():
            for c in ((None, 16) if shape.step == "train" else (None,)):
                t, j = input_specs(tcfg, shape, c), jinput_specs(jcfg, shape, c)
                assert list(t) == list(j), (name, shape.name)
                for k, v in t.items():
                    assert v.device.type == "meta"
                    assert tuple(v.shape) == tuple(j[k].shape), (name, shape.name, k)
                    assert str(v.dtype).split(".")[-1] == str(j[k].dtype), (name, k)
    with pytest.raises(ValueError, match="global_batch 256 % num_clients 3"):
        input_specs(get_config("granite-8b"), SHAPES["train_4k"], 3)


def test_configs_export_all_configs_and_the_shapes_as_the_reference():
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    from repro_torch.configs import shapes

    assert sorted(tconfigs.__all__) == sorted(jconfigs.__all__)
    tall, jall = tconfigs.all_configs(), jconfigs.all_configs()
    assert list(tall) == list(jall) == list(ARCH_NAMES)
    for name, cfg in tall.items():
        assert cfg == get_config(name)
        # every width and option as the reference's; the attention route is
        # named by each package's own kernels
        t, j = dataclasses.asdict(cfg), dataclasses.asdict(jall[name])
        assert (t.pop("attn_impl"), j.pop("attn_impl")) == ("cuda", "xla")
        assert t == j, name
    for name in ("SHAPES", "InputShape", "input_specs", "make_concrete_batch"):
        assert getattr(tconfigs, name) is getattr(shapes, name)


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_concrete_batch_equals_reference(name):
    from repro.configs import get_config as jget
    from repro.configs.shapes import make_concrete_batch as jmake

    jcfg, tcfg = jget(name).reduced(), get_config(name).reduced()
    for i, shape in enumerate(SHAPES.values()):
        c = 16 if shape.step == "train" else None
        t = make_concrete_batch(tcfg, shape, rng_seed=i, num_clients=c, device="cpu")
        j = jmake(jcfg, shape, rng_seed=i, num_clients=c)
        assert list(t) == list(j)
        for k, v in t.items():
            assert v.device.type == "cpu"
            np.testing.assert_array_equal(v.float().numpy(), np.asarray(j[k], np.float32),
                                          err_msg=f"{name} {shape.name} {k}")


# -- distribute_params on a (data = 2, model = 2) device mesh ------------------

DM_CONFIG = "mixtral-8x7b"   # reduced: 3-d expert leaves, a scan-stacked tree


def _dm_specs(cfg, params):
    return param_pspecs(cfg, params, MeshAxes(model_size=2), fsdp_axis="data", fsdp_size=2)


def _world_dmesh(rank: int, size: int) -> dict:
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import distribute_params

    dm = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = get_config(DM_CONFIG).reduced()
    params = CausalLM(cfg).init(torch.Generator().manual_seed(0))
    specs = _dm_specs(cfg, params)
    laid = distribute_params(params, specs, dm)
    coord = dm.get_coordinate()
    out = {"coord": list(coord), "local_bad": [], "full_bad": [], "placements": {}}
    for k, dt in laid.items():
        expect = params[k]
        for md, pl in enumerate(dt.placements):
            if pl.is_shard():
                expect = torch.chunk(expect, dm.size(md), dim=pl.dim)[coord[md]]
        if not torch.equal(dt.to_local(), expect):
            out["local_bad"].append(k)
        if not torch.equal(dt.full_tensor(), params[k]):
            out["full_bad"].append(k)
        out["placements"][k] = [repr(p) for p in dt.placements]
    return out


def test_distribute_params_on_a_device_mesh(tmp_path):
    from torch.distributed.tensor import Replicate, Shard

    ranks = _results(_start_world("dmesh", 4, tmp_path, script=__file__), tmp_path)
    assert sorted(tuple(r["coord"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        assert r["local_bad"] == [] and r["full_bad"] == []
    cfg = get_config(DM_CONFIG).reduced()
    specs = _dm_specs(cfg, CausalLM(cfg).param_shapes())

    class _Names:
        mesh_dim_names = ("data", "model")

    placed = {k: to_placements(s, _Names()) for k, s in specs.items()}
    for r in ranks:
        assert r["placements"] == {k: [repr(x) for x in p] for k, p in placed.items()}
    # some leaf is sharded on both mesh dimensions, and some replicated on one
    assert any(all(isinstance(x, Shard) for x in p) for p in placed.values())
    assert any(isinstance(x, Replicate) for p in placed.values() for x in p)
    assert to_placements(Spec(None, ("data", "model")), _Names()) == (Shard(1), Shard(1))
    assert to_placements(Spec("pod", None), _Names()) == (Replicate(), Replicate())


if __name__ == "__main__":
    _rank_main({"dmesh": _world_dmesh}, sys.argv[1:])
