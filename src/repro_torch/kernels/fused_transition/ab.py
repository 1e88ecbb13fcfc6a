"""Time ``csrc/fused_transition.cu`` against other builds of its launcher.

An A/B of designs of the transition kernel on one card, in one process:
each ``--against`` names a CUDA source exporting the same ``extern "C"``
``fused_transition_launch`` (an earlier design, say, taken with ``git
show <commit>:src/repro_torch/kernels/fused_transition/csrc/fused_transition.cu``
into a directory that ``.gitignore`` lists).  All are built with the
package's ``nvcc`` flags and launched through the same leaf table, on the
leaf sets of three paths:

* ``mnist``: MnistCNN, 8 f32 leaves, C = 20, D = 4, alpha = 1;
* ``cifar``: CifarCNN, 16 f32 leaves, C = 20, D = 4, alpha = 1;
* ``granite``: the 12 bf16 leaves of granite-8b's widths cut to 2 layers
  (838,881,280 parameters a client), C = 8, D = 4, alpha = 2 (the inter
  event) and alpha = 0 (the intra event).

Each build is first held to the plain version on random leaves (out of
place; f32 1e-5, bf16 3e-2; the run fails at its end if one disagrees),
then timed in place, replayed from a CUDA graph, in the order A B B A (A B
C C B A for three builds), ``--reps`` replays each.  Prints each build's
ptxas registers and one line per leaf set, and writes everything to
``chiprun_out/transition_ab.json``::

    PYTHONPATH=src python3 -m repro_torch.kernels.fused_transition.ab \\
        --against archive/fused_transition_regs.cu
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import hashlib
import json
import statistics
import subprocess
from pathlib import Path

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data-sheet memory rate
TOLS = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
CHUNK = 1 << 24  # columns the plain version takes at a time


def _build_against(src: Path):
    from .. import _build

    h = hashlib.sha256(" ".join(_build.NVCC_FLAGS).encode() + src.read_bytes()).hexdigest()[:16]
    so = _build._build_root() / f"libfused_transition_ab-{h}.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    out = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(so), str(src)],
                         capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(str(so))
    fn = lib.fused_transition_launch
    fn.argtypes = [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int] + [ctypes.c_void_p] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn, out.stdout + out.stderr


def _leaf_shapes(name: str) -> dict:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ...models import CausalLM, CifarCNN, MnistCNN

    if name == "granite":
        from ...configs import get_config

        cfg = dataclasses.replace(
            get_config("granite-8b").reduced(), vocab_size=49152, num_layers=2, d_model=4096,
            d_ff=14336, num_heads=32, num_kv_heads=8, head_dim=128, dtype="bfloat16")
        model = CausalLM(cfg)
    else:
        model = {"mnist": MnistCNN, "cifar": CifarCNN}[name]()
    with FakeTensorMode():  # shapes and dtypes only
        return {k: tuple(w.shape) for k, w in model.init(torch.Generator()).items()}


def _factors(c: int, d: int, seed: int):
    """V^T, P and B^T of ``c`` clients in ``d`` clusters on a ring, with
    random data sizes, as f32 on the card."""
    import numpy as np

    from ...core import ClusterSpec, mixing_matrix, ring

    rng = np.random.default_rng(seed)
    spec = ClusterSpec(c, tuple(i // (c // d) for i in range(c)), tuple(rng.uniform(0.5, 2.0, c)))
    f32 = lambda a: torch.tensor(np.ascontiguousarray(a), dtype=torch.float32, device="cuda")
    return f32(spec.V().T), f32(mixing_matrix(ring(d), spec.m_tilde())), f32(spec.B().T)


def _launcher(lib, fn, leaves: list, outs: list, vt, p, bt, alpha: int):
    """A function launching ``fn`` over ``leaves`` (C, M) into ``outs``."""
    from .._build import check, stream_of
    from .._leaves import plan_launches
    from .ops import _DTYPES

    d, c = vt.shape
    plan = plan_launches([(w.dtype, w.shape[1], (w.data_ptr(), o.data_ptr()))
                          for w, o in zip(leaves, outs)])
    calls = []
    for dtype, members in plan:
        rows = []
        for i, vec in members:
            rows += (leaves[i].data_ptr(), outs[i].data_ptr(), leaves[i].shape[1], vec)
        calls.append(((ctypes.c_longlong * len(rows))(*rows), len(members), _DTYPES[dtype]))

    def run():
        stream = stream_of(vt.device)
        for rows, n, code in calls:
            check(lib, fn(rows, n, vt.data_ptr(), p.data_ptr(), bt.data_ptr(), c, d, alpha, code,
                          stream), "fused_transition")
    return run


def _graph_ms(fn, reps: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _hold(run, leaves: list, outs: list, vt, p, bt, alpha: int) -> float:
    """Max abs error of ``run``'s outputs against the plain version."""
    from .ref import fused_transition_ref

    run()
    torch.cuda.synchronize()
    err = 0.0
    for w, o in zip(leaves, outs):
        for a in range(0, w.shape[1], CHUNK):
            ref = fused_transition_ref(w[:, a:a + CHUNK], vt, p, bt, alpha).float()
            err = max(err, (o[:, a:a + CHUNK].float() - ref).abs().max().item())
    return err


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, action="append", required=True,
                    help="CUDA source of another design (same extern \"C\" launcher); "
                         "may be repeated")
    ap.add_argument("--reps", type=int, default=20, help="graph replays a timing")
    ap.add_argument("--out", type=Path, default=Path("chiprun_out/transition_ab.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from .ops import _bind

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {"this": _bind()}
    for src in args.against:
        lib, fn, log = _build_against(src)
        libs[src.stem] = (lib, fn)
        print(f"{src.stem} ptxas: " + " | ".join(ln.strip() for ln in log.splitlines()
                                               if "registers" in ln), flush=True)
    cases = [("mnist", torch.float32, 20, 1), ("cifar", torch.float32, 20, 1),
             ("granite", torch.bfloat16, 8, 2), ("granite", torch.bfloat16, 8, 0)]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results, shapes, wrong = [], {}, []
    for name, dtype, c, alpha in cases:
        if name not in shapes:
            shapes = {name: _leaf_shapes(name)}  # one leaf set on the card at a time
            leaves = [torch.randn((c, *s), generator=gen, device="cuda").to(dtype).view(c, -1)
                      for s in shapes[name].values()]
            torch.cuda.empty_cache()
        vt, p, bt = _factors(c, 4, seed=1)
        nbytes = 2 * sum(w.numel() * w.element_size() for w in leaves)
        errs, ms = {}, {k: [] for k in libs}
        for key, (lib, fn) in libs.items():  # out of place against the plain version
            outs = [torch.empty_like(w) for w in leaves]
            errs[key] = _hold(_launcher(lib, fn, leaves, outs, vt, p, bt, alpha), leaves, outs,
                              vt, p, bt, alpha)
            if not errs[key] <= TOLS[dtype]:
                wrong.append(f"{key} {name} alpha={alpha}: max abs err {errs[key]}")
            del outs
        torch.cuda.empty_cache()
        runs = {k: _launcher(lib, fn, leaves, leaves, vt, p, bt, alpha)
                for k, (lib, fn) in libs.items()}
        for key in [*libs, *reversed(libs)]:  # A B ... B A
            ms[key].append(_graph_ms(runs[key], args.reps))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        row = {"leaves": name, "dtype": str(dtype)[6:], "clients": c, "clusters": 4,
               "alpha": alpha, "bytes": nbytes, "bound_ms": bound, "max_abs_err": errs,
               "graph_ms": ms, "mean_ms": {k: statistics.mean(v) for k, v in ms.items()}}
        row["bound_share"] = {k: bound / v for k, v in row["mean_ms"].items()}
        results.append(row)
        print(f"{name} {row['dtype']} C={c} alpha={alpha}: bound {bound:.6g} ms; "
              + "; ".join(f"{k} graph {[round(t, 5) for t in ms[k]]} ms, "
                          f"{row['bound_share'][k]:.1%} of bound, err {errs[k]:.3e}"
                          for k in libs), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"device": smi, "against": [str(a) for a in args.against],
                                    "results": results, "wrong": wrong}, indent=1))
    if wrong:
        raise SystemExit("disagrees with the plain version: " + "; ".join(wrong))


if __name__ == "__main__":
    main()
