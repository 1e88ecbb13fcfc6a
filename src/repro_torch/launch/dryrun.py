"""Multi-node dry run: trace every (arch x shape x mesh) step of one rank on a fake process group.

The port's ``repro.launch.dryrun``.  The reference lowers and compiles each
step for its TPU production mesh and reads XLA's memory and cost analyses;
here each combination builds its step with ``launch.steps`` on
``launch.mesh.make_production_mesh`` (256 or 512 ranks of a fake process
group: nothing is exchanged), lays its operands out as ``DTensor``s whose
local shards are ``meta`` tensors (shapes and dtypes, no storage), and runs
the step once under ``roofline.trace.StepCounter``, which counts rank 0's
product flops, HBM bytes, collective wire bytes and peak live bytes.  It is
a host tool: it allocates no device memory and launches nothing (the
kernel wrappers' traced calls report their work instead).  The roofline
terms use the H100 SXM's peaks (``roofline.analysis``): derived, not
measured.

Records (JSON lines with ``--out``) keep the reference's keys, with
``fits_16gb`` as ``fits_h100_80gb`` (against ``HW["device_memory"]``),
``lower_s`` and ``compile_s`` as one ``trace_s``, and ``attn_impl``, the
configuration's attention (``"cuda"``: the flash kernels' work is counted,
also where a head count the model axis does not divide, gemma2's 8 heads on
16, runs sequence-parallel through their query-row map).  A combination that
fails is recorded ``ok: false`` with its error, and the exit code is 1.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch mixtral-8x7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out dryrun.jsonl
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh multi
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from ..configs import ARCH_NAMES, get_config
from ..configs.shapes import SHAPES
from ..roofline import HW, StepCounter, model_flops, roofline_terms
from ..roofline.trace import local_bytes
from ..sharding import distribute_params
from .mesh import make_production_mesh
from .steps import build_prefill, build_serve, build_train, default_fl_spec

__all__ = ["run_one", "trace_step", "main"]


def _meta(tree: dict) -> dict:
    return {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in tree.items()}


def _operands(step, abstract: tuple, kind: str, mesh, pos: int) -> tuple:
    """The step's operands as the rules lay them out, local shards on meta."""
    params = distribute_params(_meta(abstract[0]), step.specs["params"], mesh)
    if kind == "train":
        return params, (), distribute_params(_meta(abstract[2]), step.specs["batch"], mesh)
    if kind == "prefill":
        return params, distribute_params(_meta(abstract[1]), step.specs["batch"], mesh)
    cache = distribute_params(_meta(abstract[1]), step.specs["cache"], mesh)
    token = distribute_params(_meta({"token": abstract[2]}), {"token": step.specs["token"]},
                              mesh)["token"]
    return params, cache, token, pos


def _storages(tree) -> dict:
    out = {}
    for t in torch.utils._pytree.tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            local = t.to_local() if hasattr(t, "to_local") else t
            out[local.untyped_storage()._cdata] = local_bytes(t)
    return out


def trace_step(step, operands: tuple, keep_ops: bool = False) -> tuple:
    """Run ``step(*operands)`` once under a ``StepCounter``: (the counter,
    the memory record, the seconds it took).  Arguments are the operands'
    local bytes; outputs those of the results, ``alias`` the results that
    are operands (a cache written in place); the peak is the arguments plus
    the peak of the storages the step made, as the reference's
    ``argument + temp + output - alias``."""
    args = _storages(operands)
    counter = StepCounter(keep_ops=keep_ops)
    t0 = time.time()
    with counter:
        out = step(*operands)
    seconds = time.time() - t0
    outs = _storages(out)
    arg_b, out_b = sum(args.values()), sum(outs.values())
    alias_b = sum(n for k, n in outs.items() if k in args)
    temp_b = counter.peak_bytes - (out_b - alias_b)
    peak = arg_b + counter.peak_bytes
    memory = {"argument_bytes": arg_b, "output_bytes": out_b, "temp_bytes": temp_b,
              "alias_bytes": alias_b, "peak_per_device_gb": round(peak / 2**30, 3),
              "fits_h100_80gb": peak < HW["device_memory"]}
    del out
    return counter, memory, seconds


def run_one(arch: str, shape_name: str, mesh_kind: str, fl_impl: str = "dense",
            event: str = "inter", save_trace: str | None = None,
            variant: str = "default", microbatch: int = 1,
            remat_policy: str = "full", serve_dtype: str | None = None, mesh=None) -> dict:
    cfg = get_config(arch)
    if remat_policy != "full":
        cfg = dataclasses.replace(cfg, remat_policy=remat_policy)
    if serve_dtype:
        # fp8 weight storage for decode: activations stay bf16
        cfg = dataclasses.replace(cfg, dtype=serve_dtype, activation_dtype="bfloat16")
    shape = SHAPES[shape_name]
    mesh = mesh if mesh is not None else make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.size()
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind, "chips": n_chips,
        "step": shape.step, "fl_impl": fl_impl if shape.step == "train" else None,
        "long_context_variant": bool(
            shape.long_context and not cfg.is_subquadratic(long_context=False)),
        "attn_impl": cfg.attn_impl,
    }
    if shape.step == "train":
        fl = None if variant in ("fsdp", "pod") else default_fl_spec(mesh, impl=fl_impl)
        step, abstract = build_train(cfg, shape, mesh, fl=fl, event=event, variant=variant,
                                     microbatch=microbatch)
        rec["variant"] = variant
        rec["microbatch"] = microbatch
    elif shape.step == "prefill":
        step, abstract = build_prefill(cfg, shape, mesh)
    else:
        step, abstract = build_serve(cfg, shape, mesh)
    operands = _operands(step, abstract, shape.step, mesh, pos=shape.seq_len - 1)
    counter, rec["memory"], rec["trace_s"] = trace_step(step, operands, bool(save_trace))
    rec["trace_s"] = round(rec["trace_s"], 2)
    terms = roofline_terms(counter)
    rec["roofline"] = terms.as_dict()
    rec["kernels"] = dict(counter.kernels)
    mf = model_flops(cfg, shape, shape.step)
    rec["model_flops_global"] = mf
    flops_global = terms.flops_per_device * n_chips
    rec["useful_flop_ratio"] = round(mf / flops_global, 4) if flops_global else None
    if save_trace:
        with open(save_trace, "w") as f:
            f.write("\n".join(counter.ops) + "\n")
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "trace_s", "attn_impl")}))
    print("  memory:", rec["memory"])
    print("  roofline:", {k: (round(v, 6) if isinstance(v, float) else v)
                          for k, v in rec["roofline"].items() if k != "per_kind"})
    print("  collectives:", terms.per_kind)
    print("  useful_flop_ratio:", rec["useful_flop_ratio"])
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_NAMES)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--fl-impl", choices=["dense", "gossip"], default="dense")
    ap.add_argument("--event", choices=["local", "intra", "inter"], default="inter")
    ap.add_argument("--all", action="store_true", help="sweep all arch x shape")
    ap.add_argument("--out", default=None, help="append JSONL records here")
    ap.add_argument("--save-trace", default=None,
                    help="write the traced step's op list here")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", choices=["default", "fsdp", "pod"], default="default")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--remat-policy", choices=["full", "dots"], default="full")
    ap.add_argument("--serve-dtype", default=None,
                    help="weight storage dtype for serve steps (e.g. float8_e4m3fn)")
    args = ap.parse_args(argv)
    if not args.all and (args.arch is None or args.shape is None):
        ap.error("pass --arch and --shape, or --all")

    combos = ([(a, s) for a in ARCH_NAMES for s in SHAPES] if args.all
              else [(args.arch, args.shape)])
    done = set()
    if args.out and args.skip_existing and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                try:
                    r = json.loads(line)
                    if r.get("ok"):
                        done.add((r["arch"], r["shape"], r["mesh"], r.get("fl_impl") or "dense"))
                except json.JSONDecodeError:
                    pass

    mesh = make_production_mesh(multi_pod=(args.mesh == "multi"))
    failures = 0
    for arch, shape in combos:
        key = (arch, shape, args.mesh, args.fl_impl)
        if key in done:
            print(f"skip (done): {key}")
            continue
        try:
            rec = run_one(arch, shape, args.mesh, args.fl_impl, args.event, args.save_trace,
                          args.variant, args.microbatch, args.remat_policy, args.serve_dtype,
                          mesh=mesh)
            rec["ok"] = True
        except Exception as e:  # record the failure: it is a fault to fix
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "mesh": args.mesh, "fl_impl": args.fl_impl,
                   "ok": False, "error": f"{type(e).__name__}: {e}"}
            failures += 1
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
