"""Port parity: the dry run (``launch/dryrun.py``) and its roofline (``roofline/``).

The reference compiles each step for a TPU mesh and reads the partitioned
HLO (``repro.roofline.hlo.HloAnalysis``); the port traces one rank's step
on ``meta`` local shards over a fake process group
(``roofline.trace.StepCounter``).  Held here, on the CPU:

* ``model_flops`` equal to the reference's for all 10 archs x 4 shapes;
* the collective counter, fed the reference's fixture collectives
  (``tests/test_roofline.py``: an all-reduce of f32[8,32] and an
  all-gather into f32[16,16] on groups of 2, a permute of f32[8,16]) in a
  fake world of 4 ranks, equal to ``HloAnalysis(FIXTURE)
  .collective_wire_bytes()``: 1,024, 512 and 512 bytes (one step: the
  fixture's x5 loop trip has no counterpart in a trace);
* the per-device product flops of the reduced qwen2.5-3b train, prefill and
  decode steps on a (4, 2) mesh against the reference's ``dot_flops()`` of
  the same steps (8 forced host devices in a subprocess, as
  ``tests/spmd_check.py::check_tiny_dryrun`` builds them), product by
  product: each side's products keyed by (result elements, contraction
  length).  The decode's products are the reference's exactly; the
  prefill's and the train step's differ by the terms ``TERMS`` names, each
  a substitution of the reference's products by the port's (the totals
  then agree exactly);
* ``launch.dryrun --arch granite-8b --shape decode_32k --mesh single``
  exits 0 with a full record;
* a real tensor never takes the kernel wrappers' traced path, and a meta
  one always does, with the kernel's counted work.
"""
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

import repro_torch.configs as tconfigs  # noqa: E402
from repro_torch.roofline import StepCounter, model_flops, roofline_terms  # noqa: E402
from repro_torch.roofline.analysis import collective_bytes  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
sys.path.insert(0, str(Path(__file__).resolve().parent))
SUBPROCESS_TIMEOUT = 600
TINY_SHAPES = {"train": ("t", 128, 8), "prefill": ("p", 128, 4), "decode": ("d", 128, 8)}
# the port's products = the reference's with these substitutions, each
# (reference products, port products, why), a product keyed by (result
# elements, contraction length) with its count (f32; the flash kernels'
# work, which has no product of its own, under "flash")
TERMS = {
    "prefill": [
        ({(8192, 256): 4}, {(16384, 256): 4},
         "K and V projections whole on each model rank: the rules replicate wk/wv (the "
         "reference's too), the reference's partitioner computes each rank's KV head only"),
        ({(16384, 256): 1}, {(32768, 256): 1},
         "the second layer's q projection with wq all-gathered over model: DTensor's "
         "sharding propagation, on that layer's input placement"),
        ({(8192, 64): 16}, {"flash": 8454144},
         "attention: the reference's blocked chunk products (every live chunk pair, masked "
         "entries included) against the flash forward's 4 hd flops a live pair (split TF32)"),
    ],
    "train": [
        ({(16384, 256): 8, (65536, 64): 4}, {(32768, 256): 8, (65536, 128): 4},
         "K and V projections whole on each model rank, forward, input and weight "
         "gradients (as in the prefill)"),
        ({(128, 4): 2, (32768, 4): 2}, {(256, 4): 2, (65536, 4): 2},
         "the transition's rows of wk, wv, bk, bv, which are whole on each model rank"),
        ({(32768, 256): 6, (65536, 256): 8}, {(131072, 256): 14},
         "the MLP's products whole on each model rank: DTensor's plan all-gathers the "
         "model-sharded w_gate/w_up/w_down and runs them at full d_ff on the client's "
         "replicated activations, forward and backward; the reference's partitioner splits "
         "them over model"),
        ({(8192, 128): 16, (16384, 64): 32}, {"flash": 59179008},
         "attention: the reference's blocked chunk products forward and backward against "
         "the flash kernels' 4 hd flops a live pair forward (split TF32) and 2.5x that "
         "backward (f32)"),
    ],
    "decode": [],
}


@contextlib.contextmanager
def _fake_world(size: int):
    """A fake process group of ``size`` ranks (this process rank 0) for the
    block's length, destroyed after it."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# -- model_flops ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", tconfigs.ARCH_NAMES)
def test_model_flops_equals_the_references(arch, shape):
    import repro.configs as jconfigs
    from repro.roofline import model_flops as jmodel_flops

    from repro_torch.configs.shapes import SHAPES

    jshape, tshape = jconfigs.SHAPES[shape], SHAPES[shape]
    assert model_flops(tconfigs.get_config(arch), tshape, tshape.step) == jmodel_flops(
        jconfigs.get_config(arch), jshape, jshape.step)


# -- the collective counter --------------------------------------------------------------

def test_collective_counter_matches_the_reference_fixture():
    import torch.distributed as dist

    from repro.roofline.hlo import HloAnalysis
    from test_roofline import FIXTURE

    want = HloAnalysis(FIXTURE).collective_wire_bytes()["per_kind"]
    with _fake_world(4):
        pair = dist.new_group([0, 1])
        dist.new_group([2, 3])
        x = torch.zeros(8, 16)
        with StepCounter() as counter:
            dist.all_reduce(torch.zeros(8, 32), group=pair)
            dist.all_gather_into_tensor(torch.empty(16, 16), x, group=pair)
            for w in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, 1, group=pair),
                                            dist.P2POp(dist.irecv, torch.empty(8, 16), 1,
                                                       group=pair)]):
                w.wait()
    got = collective_bytes(counter.collectives)
    assert got["num_ops"] == 3
    assert got["per_kind"] == {"all-reduce": want["all-reduce"] / 5,
                               "all-gather": want["all-gather"],
                               "collective-permute": want["collective-permute"]}
    assert got["per_kind"] == {"all-reduce": 1024.0, "all-gather": 512.0,
                               "collective-permute": 512.0}
    # ranks 0 and 1 share a node: NVLink
    assert got["per_link"] == {"nvlink": 2048.0}


# -- product flops against the reference's dots ----------------------------------------------

def _tiny_cfg(configs):
    return dataclasses.replace(configs.get_config("qwen2.5-3b").reduced(), num_heads=4,
                               num_kv_heads=2, head_dim=64)


def _reference_main(out: str) -> None:
    """In a process with 8 forced host devices: the reference's dot products
    of the tiny steps, keyed by (result elements, contraction length) and
    weighted by their loops' trip counts, and its ``dot_flops()``."""
    import re

    from repro.configs.shapes import InputShape
    from repro.core.sdfeel import FLSpec
    from repro.launch.mesh import make_test_mesh
    from repro.launch.steps import build_prefill, build_serve, build_train
    import repro.configs as jconfigs
    from repro.roofline.hlo import _SHAPE_RE, HloAnalysis, _shape_elems

    mesh = make_test_mesh(data=4, model=2)
    cfg = _tiny_cfg(jconfigs)
    fl = FLSpec(num_clients=4, num_clusters=2, tau1=1, tau2=1, alpha=1)
    res = {}
    with mesh:
        for name, (tag, seq, batch) in TINY_SHAPES.items():
            shape = InputShape(tag, seq, batch, name)
            step, abstract = (build_train(cfg, shape, mesh, fl=fl) if name == "train" else
                              build_prefill(cfg, shape, mesh) if name == "prefill" else
                              build_serve(cfg, shape, mesh))
            ana = HloAnalysis(step.lower(*abstract).compile().as_text())
            products = Counter()
            for comp, ops in ana.computations.items():
                mult = ana.multipliers.get(comp, 1.0)
                for op in ops:
                    if op.kind != "dot" or not mult:
                        continue
                    m = _SHAPE_RE.search(op.result_text)
                    lhs = _SHAPE_RE.search(ana.symbols[comp].get(op.operands[0], ""))
                    dims = [int(d) for d in lhs.group(2).split(",")] if lhs.group(2) else []
                    k = 1
                    for i in re.search(r"lhs_contracting_dims=\{([\d,]*)\}",
                                       op.rest).group(1).split(","):
                        k *= dims[int(i)] if i else 1
                    products[f"{_shape_elems(m.group(2))},{k}"] += mult
            res[name] = {"dot_flops": ana.dot_flops(), "products": dict(products)}
    Path(out).write_text(json.dumps(res))


@pytest.fixture(scope="module")
def reference_products(tmp_path_factory):
    out = tmp_path_factory.mktemp("dots") / "dots.json"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH"))
                                          if p))
    run = subprocess.run([sys.executable, str(Path(__file__).resolve()), "reference",
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT)
    assert run.returncode == 0, run.stderr[-6000:]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def port_products():
    from repro_torch.configs.shapes import InputShape
    from repro_torch.core import FLSpec
    from repro_torch.launch import build_prefill, build_serve, build_train, make_test_mesh
    from repro_torch.launch.dryrun import _operands, trace_step

    cfg = _tiny_cfg(tconfigs)
    res = {}
    with _fake_world(8):
        mesh = make_test_mesh(4, 2, device="cpu")
        fl = FLSpec(num_clients=4, num_clusters=2, tau1=1, tau2=1, alpha=1)
        for name, (tag, seq, batch) in TINY_SHAPES.items():
            shape = InputShape(tag, seq, batch, name)
            step, abstract = (build_train(cfg, shape, mesh, fl=fl) if name == "train" else
                              build_prefill(cfg, shape, mesh) if name == "prefill" else
                              build_serve(cfg, shape, mesh))
            counter, _, _ = trace_step(step, _operands(step, abstract, name, mesh, seq - 1))
            res[name] = counter
    return res


@pytest.mark.parametrize("step", list(TINY_SHAPES))
def test_product_flops_match_the_references_dots_term_by_term(reference_products,
                                                               port_products, step):
    ref = reference_products[step]
    counter = port_products[step]
    want = Counter({tuple(map(int, k.split(","))): v for k, v in ref["products"].items()})
    assert 2 * sum(r * k * n for (r, k), n in want.items()) == ref["dot_flops"]
    flash = 0.0
    for before, after, why in TERMS[step]:
        for key, n in before.items():
            assert want[key] >= n, (why, key)
            want[key] -= n
        for key, n in after.items():
            if key == "flash":
                flash += n
            else:
                want[key] += n
    got = Counter()
    for (cls, r, k), n in counter.products.items():
        assert cls == "f32"
        got[(r, k)] += n
    assert +got == +want
    kernel_flops = sum(counter.flops.values()) - 2 * sum(r * k * n for (r, k), n in got.items())
    assert kernel_flops == pytest.approx(flash, rel=1e-12)
    # the totals: the reference's dots plus the terms' differences
    delta = sum(_flops_of(after) - _flops_of(before) for before, after, _ in TERMS[step])
    assert sum(counter.flops.values()) == pytest.approx(ref["dot_flops"] + delta, rel=1e-12)


def _flops_of(products: dict) -> float:
    return sum(n if key == "flash" else 2 * key[0] * key[1] * n for key, n in products.items())


# -- the command ---------------------------------------------------------------------------

def test_dryrun_granite_decode_on_the_single_mesh(tmp_path):
    out = tmp_path / "dry.jsonl"
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(p for p in (str(SRC), os.environ.get("PYTHONPATH"))
                                          if p))
    run = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                          "granite-8b", "--shape", "decode_32k", "--mesh", "single", "--out",
                          str(out)], env=env, capture_output=True, text=True,
                         timeout=SUBPROCESS_TIMEOUT)
    assert run.returncode == 0, run.stderr[-6000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["ok"] and rec["chips"] == 256 and rec["step"] == "decode"
    assert rec["attn_impl"] == "cuda"
    mem = rec["memory"]
    for key in ("argument_bytes", "output_bytes", "temp_bytes", "alias_bytes"):
        assert mem[key] >= 0
    assert mem["fits_h100_80gb"] and 0 < mem["peak_per_device_gb"] < 80
    # the cache is written in place: the aliased outputs are the cache's shards
    assert mem["alias_bytes"] > 0.5 * mem["output_bytes"]
    terms = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "flops_per_device",
                "bytes_per_device", "collective_bytes_per_device", "collective_ops",
                "per_kind", "dominant"):
        assert key in terms
    assert terms["dominant"] == "memory" and terms["collective_ops"] > 0
    assert rec["model_flops_global"] > 0 and 0 < rec["useful_flop_ratio"] <= 1


# -- the traced path ---------------------------------------------------------------------------

def _kernel_calls(device: str) -> tuple:
    """Every kernel wrapper on ``device`` tensors under a counter: (the
    counter, the outputs)."""
    from repro_torch import kernels as K

    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(dtype).to(device)

    q, k, v = r(1, 16, 4, 16), r(1, 16, 2, 16), r(1, 16, 2, 16)
    w, gr = r(4, 8), r(4, 8)
    vt, p, bt = r(2, 4).abs(), r(2, 2).abs(), r(4, 2).abs()
    with StepCounter() as counter:
        out, lse = K.flash_attention_fwd(q, k, v, None, None)
        grads = K.flash_attention_bwd(q, k, v, out, lse, torch.ones_like(out), None, None)
        outs = [out, *grads,
                K.fused_transition(w, vt, p, bt, 1), K.sgd_update(w, gr, 0.1),
                K.normalized_update(w, gr, 0.5), K.cluster_agg(w, r(4), 2),
                K.gossip_mix(r(2, 8), p, 1)]
    return counter, outs


def test_the_traced_path_is_never_taken_by_a_real_tensor():
    from repro_torch.kernels import _trace

    counter, outs = _kernel_calls("cpu")
    assert not counter.kernels and not _trace.LISTENERS
    assert all(not _trace.traced(t) and torch.isfinite(t).all() for t in outs)
    meta, mouts = _kernel_calls("meta")
    assert dict(meta.kernels) == {name: 1 for name in (
        "flash_attention_fwd", "flash_attention_bwd", "fused_transition", "sgd_update",
        "normalized_update", "cluster_agg", "gossip_mix")}
    assert [(m.shape, m.dtype) for m in mouts] == [(o.shape, o.dtype) for o in outs]
    # flash: 4 hd flops a live pair (16 * 17 / 2 a head), 2.5x backward
    fwd = 4 * 16 * (16 * 17 // 2) * 4
    assert meta.flops["split_tf32"] == fwd and meta.flops["f32"] >= 2.5 * fwd
    terms = roofline_terms(meta)
    assert terms.flops_per_device == sum(meta.flops.values()) and terms.memory_s > 0


if __name__ == "__main__":
    if sys.argv[1] == "reference":
        _reference_main(sys.argv[2])
