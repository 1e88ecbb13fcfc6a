"""Port parity: continuous serving on a cluster mesh.

``ContinuousFederatedServer(mesh=)`` puts one cluster replica a rank of the
default process group: rank ``d`` holds row ``d`` of the stack and the
whole slot pool, prefills its cluster's admissions, decodes every slot on
its replica and keeps its own slots' tokens, which one all-reduce a step
gives every rank.  A world of D = 4 ``gloo`` rank processes is started
from this file (``tests/test_torch_mesh.py``'s launcher: one intra-op
thread a rank, timeouts on the group's init and on every process), in the
reference's ``check_continuous_mesh_serving`` setting
(``tests/spmd_check.py``: a 2-layer f32 dense model, 12 requests, 4 slots,
buckets (8, 16), chunks of 3 steps, temperature 0), the four replicas
initialized by JAX and passed through ``repro_torch.convert``:

* every request's tokens on every rank equal the off-mesh port server's
  bit for bit, and the reference's (its off-mesh server; its mesh server
  equals that one bitwise in ``spmd_check``);
* a hot swap through ``publish`` on the mesh stages each rank's row of the
  new stack, and the requests served after it equal the off-mesh server's
  after the same swap;
* ``graph`` resolves by the rank's device, as off the mesh: on a CPU rank
  ``graph=True`` raises "graph=True needs a CUDA device" and ``graph=None``
  runs the chunk eagerly (the graphed chunk's body on a mesh is
  ``tests/test_torch_mesh_graphs.py``'s);
* ``launch.serve --scenario lm-serving-continuous --continuous --mesh
  auto`` on 4 ranks under torchrun's variables serves on the cluster mesh
  (rank 0 prints, the others do not) the tokens one process serves.
"""
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_mesh import (  # noqa: E402
    _env, _free_port, _join, _rank_main, _results, _start, _start_world,
)

D = 4
# the reference's check_continuous_mesh_serving model
ARCH = dict(name="spmd-serve", family="dense", num_layers=2, d_model=32, d_ff=64,
            vocab_size=64, num_heads=2, num_kv_heads=1, head_dim=16, dtype="float32",
            remat=False, attn_chunk=16, tie_embeddings=True)
SERVER = dict(max_batch=4, length_buckets=(8, 16), gen_cap=8, chunk_steps=3)
SCENARIO_ARGS = ["--scenario", "lm-serving-continuous", "--continuous", "--device", "cpu",
                 "--train-steps", "1", "--requests", "8", "--gen", "4"]


def _requests(request_cls, seed: int = 0) -> list:
    rng = np.random.default_rng(seed)
    return [request_cls(uid=i, prompt=rng.integers(0, ARCH["vocab_size"],
                                                   int(rng.integers(3, 17))),
                        max_new_tokens=int(rng.integers(1, 9)),
                        eos_id=int(rng.integers(0, ARCH["vocab_size"])),
                        cluster_id=int(rng.integers(0, D)))
            for i in range(12)]


def _stacks(out: Path) -> tuple:
    """The two (D, ...) stacks the ranks serve (before and after the swap)."""
    from repro_torch.convert import params_from_numpy

    with np.load(out / "stacks.npz") as z:
        flat = dict(z)
    return tuple(params_from_numpy({k[len(f"{i}."):]: v for k, v in flat.items()
                                    if k.startswith(f"{i}.")}, "cpu") for i in range(2))


def _serve_port(stacks: tuple, mesh) -> dict:
    """The 12 requests on the first stack, then again after a swap to the
    second: each request's tokens, the swap count and the served rows."""
    from repro_torch.models import CausalLM
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving import ContinuousFederatedServer, Request

    model = CausalLM(ArchConfig(**ARCH))
    srv = ContinuousFederatedServer(model, stacks[0], mesh=mesh, **SERVER)
    res = {}
    for phase in ("before", "after"):
        reqs = _requests(Request)
        for r in reqs:
            srv.submit(r)
        srv.run()
        res[phase] = [r.output.copy() for r in reqs]
        srv.publish(stacks[1])
    res["swaps"] = srv.swaps
    res["rows"] = {k: v.numpy().copy() for k, v in srv.active_params.items()}
    return res


def _serve4(rank: int, size: int, out: Path) -> dict:
    from repro_torch.launch.mesh import make_cluster_mesh
    from repro_torch.models import CausalLM
    from repro_torch.models.config import ArchConfig
    from repro_torch.serving import ContinuousFederatedServer

    mesh = make_cluster_mesh(D, device="cpu")
    stacks = _stacks(out.parent)
    res = _serve_port(stacks, mesh)
    res["index"] = mesh.index
    try:
        ContinuousFederatedServer(CausalLM(ArchConfig(**ARCH)), stacks[0], mesh=mesh,
                                  graph=True, **SERVER)
        res["graph"] = None
    except ValueError as e:
        res["graph"] = str(e)
    res["graph_none_eager"] = ContinuousFederatedServer(
        CausalLM(ArchConfig(**ARCH)), stacks[0], mesh=mesh, **SERVER)._chunk_p.graphed is None
    return res


WORLDS = {"serve4": _serve4}


def _jax_stacks(out: Path) -> list:
    """Two (D, ...) stacks of the reference's init (keys 0-3 and 4-7), flat
    numpy, saved for the ranks."""
    import jax

    from repro.models import CausalLM as JCausalLM
    from repro.models.config import ArchConfig as JArchConfig
    from repro_torch.convert import flatten_params

    model = JCausalLM(JArchConfig(**ARCH))
    stacks = []
    for first in (0, D):
        inits = [flatten_params(jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(s))))
                 for s in range(first, first + D)]
        stacks.append({k: np.stack([p[k] for p in inits]) for k in inits[0]})
    np.savez(out / "stacks.npz", **{f"{i}.{k}": v for i, s in enumerate(stacks)
                                    for k, v in s.items()})
    return stacks


def _serve_jax(stack: dict) -> list:
    import jax
    import jax.numpy as jnp

    from repro.models import CausalLM as JCausalLM
    from repro.models.config import ArchConfig as JArchConfig
    from repro.serving import ContinuousFederatedServer, Request
    from repro_torch.convert import unflatten_params

    srv = ContinuousFederatedServer(JCausalLM(JArchConfig(**ARCH)),
                                    jax.tree.map(jnp.asarray, unflatten_params(stack)),
                                    mesh=None, **SERVER)
    reqs = _requests(Request)
    for r in reqs:
        srv.submit(r)
    srv.run()
    return [np.asarray(r.output) for r in reqs]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    out = tmp_path_factory.mktemp("serve_mesh")
    world = out / "serve4"
    world.mkdir()
    stacks = _jax_stacks(out)
    procs = _start_world("serve4", D, world, script=__file__)
    try:
        off = _serve_port(_stacks(out), None)
        refs = [_serve_jax(s) for s in stacks]
    except BaseException:
        for p in procs:
            p.kill()
        raise
    return _results(procs, world), off, refs


def test_mesh_tokens_equal_the_off_mesh_server_and_jax(served):
    ranks, off, refs = served
    assert [r["index"] for r in ranks] == list(range(D))
    for rank in ranks:
        for got, want, ref in zip(rank["before"], off["before"], refs[0]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref)


def test_hot_swap_on_the_mesh_stages_each_ranks_row(served):
    ranks, off, refs = served
    for rank in ranks:
        assert rank["swaps"] == off["swaps"] == 1
        d = rank["index"]
        for k, v in off["rows"].items():
            np.testing.assert_array_equal(rank["rows"][k], v[d:d + 1], err_msg=k)
        for got, want, ref in zip(rank["after"], off["after"], refs[1]):
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(got, ref)


def test_graph_on_a_cluster_mesh_raises(served):
    ranks, _, _ = served
    for rank in ranks:
        assert rank["graph"] and "graph=True needs a CUDA device" in rank["graph"]
        assert rank["graph_none_eager"]


def _tokens_line(lines) -> str:
    (line,) = [ln for ln in lines if " tokens in " in ln]
    return line.split(" tokens in ")[0]


def test_launch_serve_on_a_cluster_mesh_under_torchrun(tmp_path, capsys):
    import repro_torch.launch.serve as tserve

    port = _free_port()
    argv = [sys.executable, "-m", "repro_torch.launch.serve", *SCENARIO_ARGS, "--mesh", "auto"]
    envs = [_env(RANK=str(r), WORLD_SIZE=str(D), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)) for r in range(D)]
    procs = _start([argv] * D, envs, tmp_path)
    try:
        tserve.main(SCENARIO_ARGS)
    finally:
        logs = _join(procs, tmp_path)
    one = capsys.readouterr().out.splitlines()
    assert "on a cluster mesh of 4 ranks over gloo" in logs[0]
    assert any("on one device" in ln for ln in one)
    assert _tokens_line(logs[0].splitlines()) == _tokens_line(one)
    for log in logs[1:]:
        assert " tokens in " not in log, log


if __name__ == "__main__":
    _rank_main({k: (lambda rank, size, _n=k: WORLDS[_n](rank, size, Path(sys.argv[5])))
                for k in WORLDS}, sys.argv[1:6])
