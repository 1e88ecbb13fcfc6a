#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero without the final
``{"ok": true, ...}`` line:

1. device   card name and power limit (nvidia-smi), torch/CUDA versions and
            both TF32 flags; TF32 is then switched off for the whole run
            (cuDNN convolutions would otherwise run f32 in TF32).
2. build    ``nvcc`` builds every kernel library from ``src/`` (five:
            fused_sgd with sgd_update and normalized_update,
            fused_transition, gossip_mix, cluster_agg, flash_attention with
            its forward and backward kernels), one process per library, all
            at once.  ptxas's report of the two leaf-table kernels
            (``fused_transition_kernel``, ``sgd_update_kernel``): the phase
            fails if any instantiation spills registers.  ``cuobjdump -sass``
            of the flash library: the counts of ``HGMMA`` (wgmma) and
            ``UTMALDG`` (TMA load) instructions per kernel; the phase fails if
            the bf16 tensor-core forward, dK/dV or dQ kernel has none.
3. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the leaf shapes of MnistCNN and CifarCNN stacked over
            C=20 clients in D=4 clusters, f32 and bf16.  Transition and SGD:
            the tree calls, one launch each (and a tree of 96 leaves, two
            launches); transition alpha 0/1/2, static factors and masked
            participation weights with a faulted mixing matrix (ring with one
            link down); SGD bit for bit.  gossip_mix:
            D=4, alpha 0/1/2, the ring P and an eq. 22 P_t, in place.
            cluster_agg: C=20 -> D=4 and the async g=5 -> 1, masked weights.
            normalized_update: R=5 rows with 1/theta per row, and R=1.
            Tolerances as the reference's kernel tests: 1e-5 f32
            transition, gossip and aggregation, 1e-6 f32 SGD and normalized
            update, 3e-2 bf16.  Then CUDA-event times of the kernel, the
            plain version and one library call computing the same function
            (where there is one), beside the bound, at the shapes of the
            path that runs the kernel (the transition and SGD as tree calls
            in place, against per-leaf ``torch.matmul`` and one
            ``torch._foreach_add_``).  Flash attention forward and backward
            against their plain versions at federated-lm-ring's (16, 64, 4,
            4, 64), granite-8b's (8, 2048, 32, 8, 128), gemma2-2b's (1, 8192,
            8, 4, 256) with window 4096 and cap 50, a GQA case with hd 96
            and a ragged S = 80, and S = 16 (below one tile), f32 and bf16
            (bf16 on the tensor-core route except gemma2-2b's backward at hd
            256, which stays on the CUDA cores; 2e-5 f32 and 3e-2 bf16
            forward, as the reference's kernel tests; lse 1e-4; gradients
            1e-4 f32 and 3e-2 bf16 relative to the largest reference entry),
            then timed at both LM phases' shapes against
            ``scaled_dot_product_attention``, with the achieved TFLOP/s and
            the share of the bound.
4. main     the main path: ``mnist-noniid-ring`` with ``tau2=2`` through
            ``build_scenario`` (which calls ``make_run``) on the default
            device, backend auto -> cuda, 10 iterations (local, intra and
            inter events), launch counters zeroed just before and read
            just after and held to their exact counts (one launch per stage:
            2 transitions and 10 SGD steps).  Held against the same run with
            the dense backend
            on the card and on the CPU (1e-4 max abs on the parameters,
            1e-4 relative on the eval loss).
5. cifar    ``cifar-dirichlet-torus`` with the kernel backend, launches held
            to one per stage: iterations/s and the split of one iteration
            into local gradient, ``sgd_update`` and transition.
6. async    asynchronous SD-FEEL: ``straggler-bimodal-async`` through
            ``build_scenario`` on the default device, backend auto -> cuda,
            24 cluster events, launch counters zeroed just before and read
            just after (normalized_update, cluster_agg and gossip_mix once
            per leaf per event).  Held against the same run with the dense
            backend on the card and on the CPU (identical event sequence,
            1e-4 max abs on the cluster models, 1e-4 relative on the eval
            loss).  Then warm events/s, the split of one event (client
            deltas, normalized_update, cluster_agg, gossip_mix) and the
            profiled device-busy share.
7. lm       federated LM training: ``federated-lm-ring`` as registered
            (reduced granite: d_model 256, 4 heads of 64, 2 layers, vocab
            512, S = 64; C = 8 in D = 4, tau1 = tau2 = 2, alpha = 2, R = 2)
            through ``build_scenario`` on the default device, backend auto
            -> cuda, attn_impl cuda: 4 supersteps (32 iterations) and one
            evaluate, launch counters zeroed just before and read just
            after and held to their exact counts (the clients fold into one
            attention launch per layer; one SGD and one transition launch per
            stage for the 12 leaves).  Held against the same run with
            the dense backend and plain attention on the card and on the
            CPU (1e-4 max abs on parameters and per-iteration losses, 1e-4
            relative on the eval loss).  Then warm iterations/s, tokens/s,
            the split of one iteration and the profiled busy share.
8. lm-width the same scenario at granite-8b's published widths (d_model
            4096, d_ff 14336, 32 heads, 8 KV heads of 128, vocab 49152,
            S = 2048, bf16), cut to 2 layers, per-client batch 1 and no
            evaluate: 2 supersteps (every flash launch on the tensor-core
            route), their launches held exactly, their rate, peak device
            memory and the attention kernels' share; then one client's loss
            and gradients with the flash kernels against the plain attention;
            then the transition (the inter event: D=4, alpha=2) and SGD timed
            on the run's own 12-leaf bf16 tree in place, against the bytes
            bound and the library calls.

The line before the last is the kernels' JSON record (the flash,
transition and SGD entries also carry, under ``width``, their granite-8b
bf16 numbers and the ``lm-width`` launches); the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data-sheet memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16 tensor-core peak
C, D, LR = 20, 4, 0.05
G = C // D                  # clients per cluster: the async event's rows
THETAS = (1.0, 3.0, 7.0, 8.0, 3.0)  # per-row eq. 19 factors 1/theta for R = G
ASYNC_EVENTS = 24
KERNELS = {
    "fused_transition": {
        "source": "src/repro_torch/kernels/fused_transition/csrc/fused_transition.cu",
        "replaces": "src/repro/kernels/fused_transition/kernel.py:39",
    },
    "sgd_update": {
        "source": "src/repro_torch/kernels/fused_sgd/csrc/sgd_update.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:23",
    },
    "gossip_mix": {
        "source": "src/repro_torch/kernels/gossip_mix/csrc/gossip_mix.cu",
        "replaces": "src/repro/kernels/gossip_mix/kernel.py:29",
    },
    "cluster_agg": {
        "source": "src/repro_torch/kernels/cluster_agg/csrc/cluster_agg.cu",
        "replaces": "src/repro/kernels/cluster_agg/kernel.py:27",
    },
    "normalized_update": {
        "source": "src/repro_torch/kernels/fused_sgd/csrc/normalized_update.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:29",
    },
    "flash_attention": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:34",
    },
    "flash_attention_backward": {
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        # no TPU kernel: the reference differentiates its plain attention
        "replaces": "none (gradient of src/repro/kernels/flash_attention/kernel.py:34)",
    },
}
# (B, S, Hq, Hkv, hd, window, cap): federated-lm-ring's registered shape (C*B
# = 8*2 folded), granite-8b's (C = 8, batch 1), gemma2-2b's local layer, a
# GQA case with hd 96 and a ragged S, and S below one tile
FLASH_SHAPES = {
    "federated-lm-ring": (16, 64, 4, 4, 64, None, None),
    "granite-8b": (8, 2048, 32, 8, 128, None, None),
    "gemma2-2b": (1, 8192, 8, 4, 256, 4096, 50.0),
    "gqa-hd96-ragged": (2, 80, 8, 2, 96, None, None),
    "short-s16": (2, 16, 8, 2, 128, None, None),
}
# the bf16 tensor-core kernels of csrc/flash_attention_sm90.cu, which the
# build phase requires to hold wgmma and TMA-load instructions
FLASH_SM90 = "src/repro_torch/kernels/flash_attention/csrc/flash_attention_sm90.cu"
SM90_KERNELS = ("flash_fwd_sm90_kernel", "flash_bwd_dkdv_sm90_kernel",
                "flash_bwd_dq_sm90_kernel")
LM_STEPS, LM_WIDTH_STEPS = 4, 2
LM_WIDTH = dict(
    arch_overrides=dict(num_layers=2, d_model=4096, d_ff=14336, num_heads=32, num_kv_heads=8,
                        head_dim=128, dtype="bfloat16", attn_chunk=512),
    vocab_size=49152, seq_len=2048, batch_size=1, num_samples=16,
)
ASYNC_KERNELS = ("normalized_update", "cluster_agg", "gossip_mix")
# the kernels that take a table of leaves (one launch per tree), by library;
# the build phase fails if ptxas spills registers in either
LEAF_TABLE_KERNELS = {"fused_transition": "fused_transition_kernel",
                      "fused_sgd": "sgd_update_kernel"}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def main() -> None:
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout of the repository")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    Smoke(torch).run()


class Smoke:
    def __init__(self, torch):
        self.torch = torch
        self.dev = torch.device("cuda")
        self.failed: list[str] = []
        self.detail: dict = {}
        self.record: dict = {}

    # -- helpers -------------------------------------------------------------
    def phase(self, name, fn):
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:  # report every phase, then fail the run
            traceback.print_exc()
            self.failed.append(name)
            print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f}s", flush=True)
        else:
            print(f"[{name}] ok in {time.perf_counter() - t0:.1f}s", flush=True)

    def cuda_ms(self, fn, reps=20, warmup=3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    def graph_ms(self, fn, reps=20) -> float:
        """Device time of ``fn``'s launches replayed from a CUDA graph: the
        same kernels without the host's per-call Python and launch cost."""
        torch = self.torch
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            fn()
        return self.cuda_ms(graph.replay, reps=reps)

    def stacked_leaves(self, model_cls, dtype, seed=0, rows=C):
        torch = self.torch
        shapes = {k: tuple(v.shape) for k, v in model_cls().init(torch.Generator()).items()}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return {k: torch.randn((rows,) + s, generator=gen, device=self.dev).to(dtype)
                for k, s in shapes.items()}

    def bound(self, byts, flops, peak=F32_FLOPS_PER_S):
        """(ms, what bounds it): the larger of bytes over the memory rate and
        flops over the peak of the inputs' type (f32 unless given)."""
        tb, to = byts / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        return (tb, "bytes") if tb >= to else (to, "operations")

    def async_operands(self):
        """Host-side operands of the async kernels: the ring P and an eq. 22
        P_t (CPU f32, as the scheduler passes them), masked (C,) weights and
        the per-row eq. 19 factors (device f32)."""
        import numpy as np
        from repro_torch.core import ClusterSpec, mixing_matrix, ring, staleness_mixing_matrix

        torch = self.torch
        rng = np.random.default_rng(1)
        spec = ClusterSpec(C, tuple(i // G for i in range(C)), tuple(rng.uniform(0.5, 2.0, C)))
        f32 = lambda a: torch.tensor(np.asarray(a), dtype=torch.float32)
        gaps = np.array([3.0, 0.0, 5.0, 1.0])  # cluster 1 fires
        mixings = {"ring": f32(mixing_matrix(ring(D), spec.m_tilde())),
                   "p_t": f32(staleness_mixing_matrix(ring(D), 1, gaps))}
        mask = np.ones(C, bool)
        mask[1::G] = mask[3::G] = False
        w = np.where(mask, spec.data_sizes, 0.0)
        tot = np.zeros(D)
        np.add.at(tot, list(spec.assignments), w)
        masked = f32(w / tot[list(spec.assignments)]).to(self.dev)
        m_hat = f32(spec.m_hat()).to(self.dev)
        inv = 1.0 / torch.tensor(THETAS, device=self.dev)
        return mixings, masked, m_hat, inv

    def factors(self):
        import numpy as np
        from repro_torch.core import ClusterSpec, chain, mixing_matrix, ring

        rng = np.random.default_rng(0)
        spec = ClusterSpec(C, tuple(i // (C // D) for i in range(C)),
                           tuple(rng.uniform(0.5, 2.0, C)))
        f32 = lambda a: self.torch.tensor(np.asarray(a), dtype=self.torch.float32, device=self.dev)
        vt, bt = f32(spec.V().T), f32(spec.B().T)
        p = f32(mixing_matrix(ring(D), spec.m_tilde()))
        # masked participation: drop two clients per cluster, renormalize m^
        mask = np.ones(C, bool)
        mask[1::5] = mask[3::5] = False
        w = np.where(mask, spec.data_sizes, 0.0)
        tot = np.zeros(D)
        np.add.at(tot, list(spec.assignments), w)
        vt_masked = bt.T * f32(w / tot[list(spec.assignments)])[None, :]
        # faulted mixing: the ring with link (0, 3) down is a chain
        p_fault = f32(mixing_matrix(chain(D), spec.m_tilde()))
        return {"static": (vt, p, bt), "masked+faulted": (vt_masked, p_fault, bt)}

    # -- phases --------------------------------------------------------------
    def device(self):
        torch = self.torch
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip().splitlines()[0]
        self.smi = smi
        print(smi, flush=True)
        print(f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}; "
              f"tf32 as found: cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}", flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print("tf32 switched off for every phase below (matmul and cuDNN)", flush=True)
        self.detail["device"] = {"nvidia_smi": smi, "torch": torch.__version__,
                                 "cuda": torch.version.cuda, "tf32": False}

    def build(self):
        from repro_torch.kernels import _build

        t0 = time.perf_counter()
        libs = _build.build_all()
        dt = time.perf_counter() - t0
        print(f"built {sorted(libs)} in {dt:.2f}s (parallel nvcc; sm_90a)", flush=True)
        for name, log in _build.build_logs.items():
            regs = [ln.strip() for ln in log.splitlines() if "registers" in ln]
            print(f"  {name} ptxas: {' | '.join(regs)}", flush=True)
        self.detail["build_s"] = dt
        self.detail["leaf_table_ptxas"] = self.check_spills()
        self.detail["flash_sass"] = self.sass_counts(libs["flash_attention"])

    @staticmethod
    def ptxas_report(log: str) -> dict:
        """``{kernel symbol: {"registers", "stack", "spill_stores"}}`` from a
        ``-Xptxas -v`` build log."""
        report, cur = {}, None
        for ln in log.splitlines():
            found = re.search(r"Function properties for (\S+)", ln)
            if found:
                cur = found.group(1)
                report[cur] = {"registers": None, "stack": None, "spill_stores": None}
                continue
            found = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", ln)
            if found and cur:
                report[cur]["stack"], report[cur]["spill_stores"] = map(int, found.groups())
            found = re.search(r"Used (\d+) registers", ln)
            if found and cur:
                report[cur]["registers"] = int(found.group(1))
        return report

    def check_spills(self) -> dict:
        """Every instantiation of the two leaf-table kernels, with its
        registers and spills; raises if ptxas reports a spill store in one."""
        from repro_torch.kernels import _build

        found = {}
        for lib, kname in LEAF_TABLE_KERNELS.items():
            if lib not in _build.build_logs:
                raise AssertionError(f"no ptxas report for kernels/{lib}")
            rep = {sym: r for sym, r in self.ptxas_report(_build.build_logs[lib]).items()
                   if kname in sym}
            if not rep or any(r["spill_stores"] is None for r in rep.values()):
                raise AssertionError(f"{kname}: no ptxas spill report in the build log")
            for sym, r in rep.items():
                print(f"  ptxas {kname} {sym}: {r['registers']} registers, {r['stack']} bytes "
                      f"stack, {r['spill_stores']} bytes spill stores", flush=True)
            spilled = {sym: r for sym, r in rep.items() if r["spill_stores"]}
            if spilled:
                raise AssertionError(f"{kname}: ptxas spills registers in {spilled}")
            found[kname] = rep
        return found

    @staticmethod
    def sass_counts(lib) -> dict:
        """``{kernel symbol: {"HGMMA": n, "UTMALDG": n}}`` from ``cuobjdump
        -sass`` of the flash library; raises unless every tensor-core kernel
        holds both."""
        from repro_torch.kernels import _build

        cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
        sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                              text=True, check=True).stdout
        counts, cur = {}, None
        for ln in sass.splitlines():
            if "Function :" in ln:
                cur = ln.split("Function :")[1].strip()
                counts[cur] = {"HGMMA": 0, "UTMALDG": 0}
            elif cur is not None:
                for op in ("HGMMA", "UTMALDG"):
                    counts[cur][op] += op in ln
        for sym, c in counts.items():
            print(f"  sass {sym}: HGMMA {c['HGMMA']}, UTMALDG {c['UTMALDG']}", flush=True)
        for kname in SM90_KERNELS:
            found = {sym: c for sym, c in counts.items() if kname in sym}
            if not found or not all(c["HGMMA"] and c["UTMALDG"] for c in found.values()):
                raise AssertionError(f"{kname}: no HGMMA/UTMALDG in the built library ({found})")
        return counts

    def kernels(self):
        torch = self.torch
        from repro_torch.models import CifarCNN, MnistCNN

        factors = self.factors()
        worst = {"fused_transition": 0.0, "sgd_update": 0.0}
        main_err = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            for dtype, t_tol, s_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
                leaves = self.stacked_leaves(mcls, dtype)
                for fname, (vt, p, bt) in factors.items():
                    for alpha in (0, 1, 2):
                        err, _ = self.hold_transition_tree(leaves, vt, p, bt, alpha, t_tol,
                                                           f"{mname} {dtype} {fname}", 1)
                        worst["fused_transition"] = max(worst["fused_transition"], err)
                        if (mname, dtype, fname, alpha) == ("mnist", torch.float32, "static", 1):
                            main_err["fused_transition"] = err
                grads = self.stacked_leaves(mcls, dtype, seed=1)
                err = self.hold_sgd_tree(leaves, grads, s_tol, f"{mname} {dtype}", 1)
                worst["sgd_update"] = max(worst["sgd_update"], err)
                if (mname, dtype) == ("mnist", torch.float32):
                    main_err["sgd_update"] = err
                print(f"  {mname} {str(dtype)[6:]}: transition tree (2 factor sets x alpha 0-2) "
                      f"and sgd_update tree agree with their plain versions, one launch each",
                      flush=True)
        # more leaves than one table holds: CifarCNN's and MnistCNN's leaves
        # four times over (96), f32, two launches per tree
        many = {f"{i}.{k}": w for i in range(4) for mcls in (CifarCNN, MnistCNN)
                for k, w in self.stacked_leaves(mcls, torch.float32, seed=10 + i).items()}
        groups = self.launch_groups(many)
        vt, p, bt = factors["masked+faulted"]
        err, _ = self.hold_transition_tree(many, vt, p, bt, 2, 1e-5, f"{len(many)} leaves",
                                           groups)
        worst["fused_transition"] = max(worst["fused_transition"], err)
        grads = {k: torch.randn_like(w) for k, w in many.items()}
        worst["sgd_update"] = max(worst["sgd_update"], self.hold_sgd_tree(
            many, grads, 1e-6, f"{len(many)} leaves", groups))
        print(f"  {len(many)} leaves f32: {groups} launches per tree, both kernels agree with "
              f"their plain versions", flush=True)
        del many, grads
        self.check_async_kernels(worst, main_err)
        self.check_flash(worst, main_err)
        print(f"max abs err over all cases: {json.dumps(worst)}", flush=True)
        self.detail["max_abs_err_all_cases"] = worst

        timings = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            timings[mname] = self.time_kernels(mcls, factors["static"])
            timings[mname].update(self.time_async_kernels(mcls))
            for kname, t in timings[mname].items():
                print(f"  time {mname} f32 {kname}: " + ", ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in t.items()
                ), flush=True)
        self.detail["timings_f32"] = timings
        flash = self.time_flash()
        self.detail["timings_flash"] = flash
        for kname in KERNELS:
            t = flash["federated-lm-ring"] if kname in flash["federated-lm-ring"] else \
                timings["mnist"]
            self.record[kname] = dict(t[kname], max_abs_err=main_err[kname])
            if kname in flash["granite-8b"]:
                w = flash["granite-8b"][kname]
                self.record[kname]["width"] = {
                    "shape": w["shape"], "dtype": w["dtype"], "route": w["route"],
                    "source": FLASH_SM90, "max_abs_err": main_err[f"{kname}@granite-8b"],
                    **{f: w[f] for f in ("ms", "graph_ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "tflops", "bound_share")}}

    @staticmethod
    def launch_groups(tree: dict) -> int:
        """Launches one call of a leaf-table kernel takes for ``tree``."""
        from repro_torch.kernels.fused_transition.ops import plan_launches

        return len(plan_launches([(w.dtype, 0, ()) for w in tree.values()]))

    def hold_transition_tree(self, leaves, vt, p, bt, alpha, tol, what, launches,
                             chunk=None) -> tuple:
        """The tree call (out of place) against the plain version leaf by
        leaf, ``chunk`` columns at a time where given (to bound the plain
        version's memory), and its launch count.  Raises unless the error is
        within ``tol`` and the transition moves its input by more than 10x
        ``tol``, so that a kernel returning its input fails; returns (max
        abs error, max abs move)."""
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition, fused_transition_ref, fused_transition_tree,
        )

        n = fused_transition.launches
        out = fused_transition_tree(leaves, vt, p, bt, alpha=alpha)
        torch.cuda.synchronize()
        if fused_transition.launches - n != launches:
            raise AssertionError(f"fused_transition {what}: {fused_transition.launches - n} "
                                 f"launches, expected {launches}")
        err = moved = 0.0
        for k, w in leaves.items():
            w2, o2 = w.reshape(w.shape[0], -1), out[k].view(w.shape[0], -1)
            step = chunk or w2.shape[1]
            for a in range(0, w2.shape[1], step):
                ref = fused_transition_ref(w2[:, a:a + step], vt, p, bt, alpha).float()
                err = max(err, (o2[:, a:a + step].float() - ref).abs().max().item())
                moved = max(moved, (w2[:, a:a + step].float() - ref).abs().max().item())
        del out
        if not err <= tol:
            raise AssertionError(f"fused_transition {what} alpha={alpha}: max abs err {err} > "
                                 f"{tol}")
        if not moved > 10 * tol:
            raise AssertionError(f"fused_transition {what} alpha={alpha}: the transition moves "
                                 f"its input by {moved} at most, too little to tell a kernel "
                                 f"that returns its input at tol {tol}")
        return err, moved

    def hold_sgd_tree(self, leaves, grads, tol, what, launches, chunk=None) -> float:
        """The tree call (out of place) against the plain version, which it
        must equal bit for bit, ``chunk`` elements at a time where given,
        and its launch count; returns the max abs error."""
        torch = self.torch
        from repro_torch.kernels import sgd_update, sgd_update_ref, sgd_update_tree

        n = sgd_update.launches
        out = sgd_update_tree(leaves, grads, LR)
        torch.cuda.synchronize()
        if sgd_update.launches - n != launches:
            raise AssertionError(f"sgd_update {what}: {sgd_update.launches - n} launches, "
                                 f"expected {launches}")
        err = 0.0
        for k, w in leaves.items():
            wf, gf, of = w.reshape(-1), grads[k].reshape(-1), out[k].reshape(-1)
            step = chunk or wf.numel()
            for a in range(0, wf.numel(), step):
                ref, got = sgd_update_ref(wf[a:a + step], gf[a:a + step], LR), of[a:a + step]
                e = (got.float() - ref.float()).abs().max().item()
                if not (e <= tol and torch.equal(got, ref)):
                    raise AssertionError(f"sgd_update {what} {k}: max abs err {e}, not bitwise "
                                         f"equal")
                err = max(err, e)
        return err

    def check_async_kernels(self, worst: dict, main_err: dict) -> None:
        """gossip_mix, cluster_agg and normalized_update against their plain
        versions; fills ``worst`` (every case) and ``main_err`` (MnistCNN f32
        at the async path's operands: P_t with alpha 1, g -> 1, R = 5)."""
        torch = self.torch
        from repro_torch.kernels import (
            cluster_agg, cluster_agg_ref, gossip_mix, gossip_mix_ref, normalized_update,
            normalized_update_ref,
        )
        from repro_torch.models import CifarCNN, MnistCNN

        mixings, masked, m_hat, inv = self.async_operands()
        for name in ASYNC_KERNELS:
            worst[name] = 0.0

        def hold(name, got, ref, tol, what, main):
            err = (got.float() - ref.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {what}: max abs err {err} > {tol}")
            worst[name] = max(worst[name], err)
            if main:
                main_err[name] = max(main_err.get(name, 0.0), err)

        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            for dtype, tol, n_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
                main = (mname, dtype) == ("mnist", torch.float32)
                ys = self.stacked_leaves(mcls, dtype, seed=2, rows=D)
                ws = self.stacked_leaves(mcls, dtype, seed=3)
                w0s = self.stacked_leaves(mcls, dtype, seed=4)
                for k in ys:
                    y = ys[k].reshape(D, -1)
                    for pname, p in mixings.items():
                        for alpha in (0, 1, 2):
                            ref = gossip_mix_ref(y, p.to(self.dev), alpha)
                            got = y.clone()
                            gossip_mix(got, p, alpha, out=got)  # in place, as the path
                            hold("gossip_mix", got, ref, tol, f"{mname} {dtype} {k} {pname} "
                                 f"alpha={alpha}", main and pname == "p_t" and alpha == 1)
                    w = ws[k].reshape(C, -1)
                    hold("cluster_agg", cluster_agg(w, masked, D),
                         cluster_agg_ref(w, masked, D), tol, f"{mname} {dtype} {k} C->D", False)
                    hold("cluster_agg", cluster_agg(w[:G], masked[:G], 1),
                         cluster_agg_ref(w[:G], masked[:G], 1), tol,
                         f"{mname} {dtype} {k} g->1 masked", False)
                    hold("cluster_agg", cluster_agg(w[:G], m_hat[:G], 1),
                         cluster_agg_ref(w[:G], m_hat[:G], 1), tol,
                         f"{mname} {dtype} {k} g->1", main)
                    wf, w0 = w[:G], w0s[k].reshape(C, -1)[:G]
                    hold("normalized_update", normalized_update(wf, w0, inv),
                         normalized_update_ref(wf, w0, inv), n_tol, f"{mname} {dtype} {k} R=5",
                         main)
                    hold("normalized_update", normalized_update(wf[0], w0[0], 1.0 / 7.0),
                         normalized_update_ref(wf[0], w0[0], 1.0 / 7.0), n_tol,
                         f"{mname} {dtype} {k} R=1", False)
                torch.cuda.synchronize()
                print(f"  {mname} {str(dtype)[6:]}: gossip_mix (ring, P_t x alpha 0-2, in "
                      f"place), cluster_agg (C->D, g->1, masked) and normalized_update "
                      f"(R=5, R=1) agree with their plain versions", flush=True)

    def time_async_kernels(self, mcls) -> dict:
        """Times of the async path's kernels at its shapes: the (D, M) cluster
        stack mixed in place with P_t (alpha 1), the fired cluster's (g, M)
        deltas reduced with m^ to (1, M), and (g, M) normalized updates."""
        torch = self.torch
        from repro_torch.kernels import (
            cluster_agg, cluster_agg_ref, gossip_mix, gossip_mix_ref, normalized_update,
            normalized_update_ref,
        )

        mixings, _, m_hat, inv = self.async_operands()
        p_t = mixings["p_t"]
        p_dev = p_t.to(self.dev)
        m_row = m_hat[:G].contiguous()
        y = {k: w.reshape(D, -1) for k, w in self.stacked_leaves(mcls, torch.float32, 5,
                                                                  rows=D).items()}
        wf = {k: w.reshape(G, -1) for k, w in self.stacked_leaves(mcls, torch.float32, 6,
                                                                   rows=G).items()}
        w0 = {k: w.reshape(G, -1) for k, w in self.stacked_leaves(mcls, torch.float32, 7,
                                                                   rows=G).items()}
        agg_out = {k: torch.empty((1, w.shape[1]), device=self.dev) for k, w in wf.items()}
        norm_out = {k: torch.empty_like(w) for k, w in wf.items()}
        m_total = sum(w.shape[1] for w in y.values())
        calls = {
            "gossip_mix": {
                "ms": lambda: [gossip_mix(v, p_t, 1, out=v) for v in y.values()],
                "plain_ms": lambda: [gossip_mix_ref(v, p_dev, 1) for v in y.values()],
                "library_ms": lambda: [torch.matmul(p_dev.T, v) for v in y.values()],
            },
            "cluster_agg": {
                "ms": lambda: [cluster_agg(v, m_row, 1, out=agg_out[k]) for k, v in wf.items()],
                "plain_ms": lambda: [cluster_agg_ref(v, m_row, 1) for v in wf.values()],
                "library_ms": lambda: [torch.matmul(m_row[None], v) for v in wf.values()],
            },
            "normalized_update": {
                "ms": lambda: [normalized_update(v, w0[k], inv, out=norm_out[k])
                               for k, v in wf.items()],
                "plain_ms": lambda: [normalized_update_ref(v, w0[k], inv) for k, v in wf.items()],
                # no single PyTorch call computes (a - b) * s per row
            },
        }
        bounds = {
            "gossip_mix": self.bound(2 * D * m_total * 4, 2 * D * D * m_total),
            "cluster_agg": self.bound((G + 1) * m_total * 4 + G * 4, 2 * G * m_total),
            "normalized_update": self.bound(3 * G * m_total * 4 + G * 4, 2 * G * m_total),
        }
        # the largest leaf alone: the kernel's own rate, without launch gaps
        big = max(y, key=lambda k: y[k].shape[1])
        m_big = y[big].shape[1]
        big_calls = {
            "gossip_mix": (lambda: gossip_mix(y[big], p_t, 1, out=y[big]), 2 * D * m_big * 4),
            "cluster_agg": (lambda: cluster_agg(wf[big], m_row, 1, out=agg_out[big]),
                            (G + 1) * m_big * 4),
            "normalized_update": (lambda: normalized_update(wf[big], w0[big], inv,
                                                            out=norm_out[big]), 3 * G * m_big * 4),
        }
        out = {}
        for kname, fns in calls.items():
            t = {k: self.cuda_ms(fn) for k, fn in fns.items()}
            t.update({f"graph_{k}": self.graph_ms(fn) for k, fn in fns.items()})
            t.setdefault("library_ms", None)
            t.setdefault("graph_library_ms", None)
            bnd, by = bounds[kname]
            fn, byts = big_calls[kname]
            out[kname] = dict(t, bound_ms=bnd, bound_by=by, leaves=len(y), largest_leaf={
                "leaf": big, "m": m_big, "graph_ms": self.graph_ms(fn),
                "bound_ms": byts / HBM_BYTES_PER_S * 1e3})
        return out

    def flash_inputs(self, shape, dtype, seed=0):
        """q, k, v and an output gradient at ``shape``, standard normal."""
        torch = self.torch
        b, s, hq, hkv, hd = shape[:5]
        gen = torch.Generator(device=self.dev).manual_seed(seed)
        mk = lambda *sh: torch.randn(sh, generator=gen, device=self.dev).to(dtype)
        return mk(b, s, hq, hd), mk(b, s, hkv, hd), mk(b, s, hkv, hd), mk(b, s, hq, hd)

    def check_flash(self, worst: dict, main_err: dict) -> None:
        """Flash attention forward and backward against their plain versions
        at every shape of ``FLASH_SHAPES``, f32 and bf16; ``main_err`` at
        federated-lm-ring's f32 shape (the lm phase's)."""
        torch = self.torch
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention import route

        worst["flash_attention"] = worst["flash_attention_backward"] = 0.0
        for sname, shape in FLASH_SHAPES.items():
            window, cap = shape[5:]
            for dtype, f_tol, g_tol in ((torch.float32, 2e-5, 1e-4),
                                        (torch.bfloat16, 3e-2, 3e-2)):
                q, k, v, dout = self.flash_inputs(shape, dtype)
                out, lse = flash_attention_fwd(q, k, v, window, cap)
                ref_out, ref_lse = flash_attention_fwd_ref(q, k, v, window, cap)
                torch.cuda.synchronize()
                err = (out.float() - ref_out.float()).abs().max().item()
                lse_err = (lse - ref_lse).abs().max().item()
                del ref_out, ref_lse
                if not (err <= f_tol and lse_err <= 1e-4):
                    raise AssertionError(f"flash_attention {sname} {dtype}: max abs err {err} "
                                         f"(tol {f_tol}), lse {lse_err} (tol 1e-4)")
                grads = flash_attention_bwd(q, k, v, out, lse, dout, window, cap)
                refs = flash_attention_bwd_ref(q, k, v, out, lse, dout, window, cap)
                torch.cuda.synchronize()
                g_err = 0.0
                for name, g, r in zip(("dq", "dk", "dv"), grads, refs):
                    scale = max(1.0, r.float().abs().max().item())
                    e = (g.float() - r.float()).abs().max().item()
                    if not e <= g_tol * scale:
                        raise AssertionError(f"flash_attention_backward {sname} {dtype} {name}: "
                                             f"max abs err {e} > {g_tol} x {scale}")
                    g_err = max(g_err, e)
                del grads, refs, q, k, v, dout, out, lse
                torch.cuda.empty_cache()
                worst["flash_attention"] = max(worst["flash_attention"], err)
                worst["flash_attention_backward"] = max(worst["flash_attention_backward"], g_err)
                if (sname, dtype) == ("federated-lm-ring", torch.float32):
                    main_err["flash_attention"], main_err["flash_attention_backward"] = err, g_err
                if (sname, dtype) == ("granite-8b", torch.bfloat16):
                    main_err["flash_attention@granite-8b"] = err
                    main_err["flash_attention_backward@granite-8b"] = g_err
                print(f"  flash {sname} {shape[:5]} window={window} cap={cap} "
                      f"{str(dtype)[6:]} ({route(dtype, shape[4])} forward, "
                      f"{route(dtype, shape[4], backward=True)} backward): forward max abs err "
                      f"{err:.3e} (tol {f_tol}), lse {lse_err:.3e}; backward {g_err:.3e} (tol "
                      f"{g_tol} relative)", flush=True)

    @staticmethod
    def flash_work(shape, itemsize):
        """(forward flops, backward flops, forward bytes, backward bytes) that
        the function needs: 4 hd flops per live (query, key) pair forward,
        2.5x that backward; each input read once, each output written once."""
        b, s, hq, hkv, hd, window = shape[:6]
        w = min(window or s, s)
        pairs = w * (w + 1) // 2 + (s - w) * w  # live pairs of one (b, head)
        flops = 4 * b * hq * hd * pairs
        qo, kv, lse = b * s * hq * hd * itemsize, b * s * hkv * hd * itemsize, b * hq * s * 4
        return flops, 2.5 * flops, 2 * qo + 2 * kv + lse, 4 * qo + 4 * kv + lse

    def time_flash(self) -> dict:
        """Forward and backward times at the lm phase's shape (f32) and the
        lm-width phase's (granite-8b, bf16): the kernel, the plain version
        and ``scaled_dot_product_attention`` (causal, GQA), beside the bound.
        Each also replayed from a CUDA graph, except the library backward:
        that is ``autograd.grad`` of one retained autograd graph."""
        torch = self.torch
        import torch.nn.functional as F
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_bwd_ref, flash_attention_fwd,
            flash_attention_fwd_ref,
        )
        from repro_torch.kernels.flash_attention import route

        out = {}
        for sname, dtype in (("federated-lm-ring", torch.float32),
                             ("granite-8b", torch.bfloat16)):
            shape = FLASH_SHAPES[sname]
            window, cap = shape[5:]
            small = shape[1] <= 256
            q, k, v, dout = self.flash_inputs(shape, dtype, seed=1)
            o, lse = flash_attention_fwd(q, k, v, window, cap)
            qt, kt, vt, gt = (x.transpose(1, 2) for x in (q, k, v, dout))  # (B, H, S, hd)
            leaves = [x.detach().clone().requires_grad_() for x in (qt, kt, vt)]
            lib_out = F.scaled_dot_product_attention(*leaves, is_causal=True, enable_gqa=True)
            calls = {
                "flash_attention": {
                    "ms": lambda: flash_attention_fwd(q, k, v, window, cap),
                    "plain_ms": lambda: flash_attention_fwd_ref(q, k, v, window, cap),
                    "library_ms": lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True),
                },
                "flash_attention_backward": {
                    "ms": lambda: flash_attention_bwd(q, k, v, o, lse, dout, window, cap),
                    "plain_ms": lambda: flash_attention_bwd_ref(q, k, v, o, lse, dout,
                                                                window, cap),
                    "library_ms": lambda: torch.autograd.grad(lib_out, leaves, gt,
                                                              retain_graph=True),
                },
            }
            flops_f, flops_b, bytes_f, bytes_b = self.flash_work(shape, q.element_size())
            peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
            bounds = {"flash_attention": self.bound(bytes_f, flops_f, peak),
                      "flash_attention_backward": self.bound(bytes_b, flops_b, peak)}
            res = {}
            for kname, fns in calls.items():
                reps = 20 if small else 3
                t = {key: self.cuda_ms(fn, reps=reps, warmup=1 if not small else 3)
                     for key, fn in fns.items()}
                for key, fn in fns.items():
                    graphable = not (kname.endswith("backward") and key == "library_ms")
                    t[f"graph_{key}"] = self.graph_ms(fn, reps=reps) if graphable else None
                bnd, by = bounds[kname]
                flops = flops_f if kname == "flash_attention" else flops_b
                res[kname] = dict(t, bound_ms=bnd, bound_by=by, shape=list(shape[:5]),
                                  window=window, cap=cap, dtype=str(dtype)[6:], flops=flops,
                                  route=route(dtype, shape[4], kname.endswith("backward")),
                                  tflops=flops / t["ms"] / 1e9, bound_share=bnd / t["ms"],
                                  graph_bound_share=bnd / t["graph_ms"])
                print(f"  time flash {sname} {str(dtype)[6:]} {kname}: " + ", ".join(
                    f"{key}={val:.6g}" if isinstance(val, float) else f"{key}={val}"
                    for key, val in res[kname].items()), flush=True)
            out[sname] = res
            del q, k, v, dout, o, lse, qt, kt, vt, gt, leaves, lib_out, calls
            torch.cuda.empty_cache()
        return out

    def time_kernels(self, mcls, factors) -> dict:
        """Times of the two leaf-table kernels over every leaf of ``mcls``
        stacked over C clients (f32), in place as the main path calls them:
        the tree call (one launch), the plain version leaf by leaf, and the
        library yardsticks, per-leaf ``torch.matmul(T^T, W)`` for the
        transition and one ``torch._foreach_add_`` for SGD; then the largest
        leaf alone."""
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition, fused_transition_ref, fused_transition_tree, sgd_update,
            sgd_update_ref, sgd_update_tree,
        )

        vt, p, bt = factors
        alpha = 1  # the main path's inter event
        tree = self.stacked_leaves(mcls, torch.float32)
        grads = {k: torch.randn_like(w) for k, w in tree.items()}
        leaves = {k: w.view(C, -1) for k, w in tree.items()}
        ws, gs = list(tree.values()), [grads[k] for k in tree]
        t_full = (vt.T @ torch.linalg.matrix_power(p, alpha) @ bt.T)  # (C, C) T_k
        t_lib = t_full.T.contiguous()
        nbytes = sum(w.numel() * w.element_size() for w in leaves.values())
        m_total = sum(w.shape[1] for w in leaves.values())
        factor_bytes = 4 * (vt.numel() + p.numel() + bt.numel())

        tr_calls = {
            "ms": lambda: fused_transition_tree(tree, vt, p, bt, alpha, inplace=True),
            "plain_ms": lambda: [fused_transition_ref(w, vt, p, bt, alpha)
                                 for w in leaves.values()],
            "library_ms": lambda: [torch.matmul(t_lib, w) for w in leaves.values()],
        }
        sgd_calls = {
            "ms": lambda: sgd_update_tree(tree, grads, LR, inplace=True),
            "plain_ms": lambda: [sgd_update_ref(w, grads[k], LR) for k, w in tree.items()],
            "library_ms": lambda: torch._foreach_add_(ws, gs, alpha=-LR),
        }
        tr_bound, tr_by = self.bound(2 * nbytes + factor_bytes,
                                     2 * m_total * (2 * C * D + alpha * D * D))
        sgd_bound, sgd_by = self.bound(3 * nbytes, 2 * m_total * C)
        out = {}
        for kname, calls, bnd, by, moved in (
            ("fused_transition", tr_calls, tr_bound, tr_by, 2 * nbytes),
            ("sgd_update", sgd_calls, sgd_bound, sgd_by, 3 * nbytes),
        ):
            t = {k: self.cuda_ms(fn) for k, fn in calls.items()}
            t.update({f"graph_{k}": self.graph_ms(fn) for k, fn in calls.items()})
            out[kname] = dict(t, bound_ms=bnd, bound_by=by, leaves=len(leaves),
                              launches_per_call=self.launch_groups(tree), bytes_moved=moved,
                              bound_share=bnd / t["ms"], graph_bound_share=bnd / t["graph_ms"])
        # the largest leaf alone: the kernel's own rate at its largest shape
        big = max(leaves, key=lambda k: leaves[k].numel())
        w = leaves[big]
        out["fused_transition"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: fused_transition(w, vt, p, bt, alpha, out=w)),
            "bound_ms": 2 * w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        out["sgd_update"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: sgd_update(tree[big], grads[big], LR,
                                                         out=tree[big])),
            "bound_ms": 3 * w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        return out

    def run_scenario(self, name, iters, device=None, **overrides):
        """(runtime, host seconds for ``iters`` steps ending in a synchronize, eval)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario(name, device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        for _ in range(iters):
            run.runtime.step(src)
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, run.runtime.evaluate(run.eval_batch)

    def warm_rate(self, run, iters) -> float:
        """Iterations/s over ``iters`` more steps, ending in a synchronize."""
        src = run.batch_source()
        t0 = time.perf_counter()
        for _ in range(iters):
            run.runtime.step(src)
        self.torch.cuda.synchronize()
        return iters / (time.perf_counter() - t0)

    def profile_steps(self, run, iters) -> dict:
        """Device busy time over ``iters`` warm steps (torch.profiler, CUPTI):
        the device's share of the host wall time and the top kernels."""
        torch = self.torch
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        src = run.batch_source()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                run.runtime.step(src)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        # device-side events only, each counted once (an aten op's aggregate
        # row repeats its kernels' time); busy time is the union of intervals
        spans = {(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                 if e.device_type == DeviceType.CUDA}
        busy_us, end = 0.0, float("-inf")
        for _, a, b in sorted(spans, key=lambda s: s[1]):
            if b > end:
                busy_us += b - max(a, end)
                end = b
        busy_ms = busy_us / 1e3
        per_name: dict = {}
        for name, a, b in spans:
            per_name[name] = per_name.get(name, 0.0) + (b - a) / 1e3
        top = sorted(per_name.items(), key=lambda r: -r[1])[:6]
        flash_split: dict = {}  # by kernel function, template arguments dropped
        for name, ms in per_name.items():
            found = re.search(r"(flash_\w+)", name)
            if found:
                flash_split[found.group(1)] = flash_split.get(found.group(1), 0.0) + ms
        flash_ms = sum(flash_split.values())
        leaf_table = {k: sum(ms for name, ms in per_name.items() if k in name)
                      for k in LEAF_TABLE_KERNELS.values()}
        return {"iters": iters, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "busy_ms_per_step": busy_ms / iters, "busy_share": busy_ms / wall_ms,
                "flash_kernels_ms": flash_ms, "flash_share_of_busy": flash_ms / busy_ms,
                "flash_split_ms": {k: round(ms, 4) for k, ms in flash_split.items()},
                "leaf_table_ms": {k: round(ms, 4) for k, ms in leaf_table.items()},
                "top_kernels_ms": [(k[:60], round(ms, 4)) for k, ms in top]}

    def iteration_split(self, run) -> dict:
        """CUDA-event times of the three stages of one iteration, each
        called as the scheduler calls it on its own stacked parameters."""
        torch = self.torch
        from repro_torch.core.pipeline import device_batch
        from repro_torch.kernels import sgd_update_tree

        sched = run.runtime.scheduler
        params = sched.params
        batch = device_batch(run.batch_source()(0), run.runtime.device)
        vgrad = torch.func.vmap(torch.func.grad_and_value(run.runtime.model.loss))

        def grad_fn():
            # as local_update does: vmapped grads, made contiguous for the kernel
            grads, _ = vgrad(params, batch)
            return {k: g.contiguous() for k, g in grads.items()}

        grads = grad_fn()
        return {
            "local_grad_ms": self.cuda_ms(grad_fn, reps=5, warmup=2),
            "sgd_update_ms": self.cuda_ms(
                lambda: sgd_update_tree(params, grads, 0.0, inplace=True), reps=10),
            "transition_inter_ms": self.cuda_ms(
                lambda: sched.backend.transition(params, "inter"), reps=10),
        }

    def check_finite(self, params, what):
        for k, w in params.items():
            if not bool(self.torch.isfinite(w).all()):
                raise AssertionError(f"{what}: non-finite values in {k}")

    def main_path(self):
        torch = self.torch
        from repro_torch.kernels import fused_transition, sgd_update

        fused_transition.launches = 0
        sgd_update.launches = 0
        run, dt, (loss, acc) = self.run_scenario("mnist-noniid-ring", 10, tau2=2)
        launches = {"fused_transition": fused_transition.launches,
                    "sgd_update": sgd_update.launches}
        sched = run.runtime.scheduler
        events = [sched.cfg.event_at(k) for k in range(1, 11)]
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on {run.runtime.device}")
        expected = self.sync_launches(sched, 10)
        if launches != expected:
            raise AssertionError(f"main path launches {launches}, expected {expected}")
        self.check_finite(sched.params, "mnist cuda run")
        print(f"main path mnist-noniid-ring tau2=2 on {run.runtime.device}, backend "
              f"{sched.backend.name}: events {events}; launches {json.dumps(launches)} "
              f"(expected exactly: one per stage); "
              f"{10 / dt:.3f} it/s cold (10 iterations, {dt:.4f}s, first-call costs included); "
              f"eval loss {loss:.6f} acc {acc:.4f}", flush=True)
        for kname, n in launches.items():
            self.record[kname]["launches"] = n

        ref = {}
        for label, device in (("dense on cuda", None), ("dense on cpu", "cpu")):
            r, _, (rloss, _) = self.run_scenario("mnist-noniid-ring", 10, device=device,
                                                 tau2=2, backend="dense")
            err = max((w.float().cpu() - r.runtime.scheduler.params[k].float().cpu())
                      .abs().max().item() for k, w in sched.params.items())
            rel = abs(rloss - loss) / abs(rloss)
            ref[label] = {"max_abs_param_diff": err, "eval_loss": rloss, "loss_rel_diff": rel}
            print(f"  vs {label}: max abs param diff {err:.3e} (tol 1e-4), eval loss "
                  f"{rloss:.6f} rel diff {rel:.3e} (tol 1e-4)", flush=True)
            if not (err <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"kernel-backend run disagrees with {label}")

        warm = self.warm_rate(run, 20)
        split = self.iteration_split(run)
        busy = self.profile_steps(run, 10)
        print(f"main path warm: {warm:.3f} it/s over 20 more iterations; split "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + f"; profiled 10 steps: {json.dumps(busy)}", flush=True)
        self.detail["main_path"] = {"launches": launches, "events": events,
                                    "it_per_s_cold": 10 / dt, "it_per_s_warm": warm,
                                    "split": split, "profile": busy, "eval_loss": loss,
                                    "eval_acc": acc, "references": ref}

    def sync_launches(self, sched, iters) -> dict:
        """Exact launches of ``iters`` sync iterations: one SGD launch per
        iteration and one per transition, each times the tree's launch groups."""
        groups = self.launch_groups(sched.params)
        transitions = sum(sched.cfg.event_at(k) != "local" for k in range(1, iters + 1))
        return {"fused_transition": transitions * groups, "sgd_update": iters * groups}

    def cifar(self):
        torch = self.torch
        from repro_torch.kernels import fused_transition, sgd_update

        fused_transition.launches = 0
        sgd_update.launches = 0
        torch.cuda.reset_peak_memory_stats()
        run, dt, (loss, acc) = self.run_scenario("cifar-dirichlet-torus", 10)
        launches = {"fused_transition": fused_transition.launches,
                    "sgd_update": sgd_update.launches}
        sched = run.runtime.scheduler
        expected = self.sync_launches(sched, 10)
        if sched.backend.name != "cuda" or launches != expected:
            raise AssertionError(f"cifar path: backend {sched.backend.name}, launches "
                                 f"{launches}, expected {expected}")
        self.check_finite(sched.params, "cifar run")
        peak = torch.cuda.max_memory_allocated()
        warm = self.warm_rate(run, 10)
        split = self.iteration_split(run)
        busy = self.profile_steps(run, 5)
        params = sched.params
        n_params = sum(w[0].numel() for w in params.values())
        print(f"cifar-dirichlet-torus on cuda: {n_params} params x {C} clients, "
              f"{len(params)} leaves; launches (10 iterations) {json.dumps(launches)}; "
              f"{10 / dt:.3f} it/s cold, {warm:.3f} it/s warm; eval loss {loss:.6f} "
              f"acc {acc:.4f}; peak device memory {peak / 2**20:.1f} MiB; split "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + f"; profiled 5 steps: {json.dumps(busy)}", flush=True)
        self.detail["cifar"] = {"launches": launches, "it_per_s_cold": 10 / dt,
                                "it_per_s_warm": warm, "eval_loss": loss, "eval_acc": acc,
                                "peak_bytes": peak, "split": split, "profile": busy,
                                "params": n_params}

    def run_async(self, name, events, device=None, **overrides):
        """(run, host seconds for ``events`` steps ending in a synchronize,
        [(kind, cluster, iteration)], eval)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario(name, device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        seq = []
        for _ in range(events):
            ev = run.runtime.step(src)
            seq.append((ev.kind, ev.cluster, ev.iteration))
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, seq, run.runtime.evaluate(run.eval_batch)

    def event_split(self, run) -> dict:
        """CUDA-event times of the stages of one cluster event, each called as
        the scheduler calls it, on the next event's cluster and batches."""
        import numpy as np
        from repro_torch.core import staleness_mixing_matrix
        from repro_torch.kernels import cluster_agg, normalized_update

        torch = self.torch
        sched = run.runtime.scheduler
        d = sched._queue[0][1]
        g = len(sched._members[d])
        batches = sched._gather(run.batch_source(), d)
        w0, w = sched._local_steps(d, batches)
        wf = {k: v.reshape(g, -1).contiguous() for k, v in w.items()}
        w0f = {k: v.view(g, -1) for k, v in w0.items()}
        inv, m_hat = sched._inv_thetas[d], sched._m_hats[d]
        deltas = {k: normalized_update(wf[k], w0f[k], inv) for k in wf}
        y = {k: v.clone() for k, v in sched.y.items()}
        gaps = (sched.t - sched.last_update).astype(np.float64)
        gaps[d] = 0.0
        p_t = torch.as_tensor(staleness_mixing_matrix(sched.cfg.topology, d, gaps,
                                                      sched.cfg.psi), dtype=torch.float32)
        return {
            "client_deltas_ms": self.cuda_ms(lambda: sched._local_steps(d, batches),
                                             reps=5, warmup=2),
            "normalized_update_ms": self.cuda_ms(
                lambda: [normalized_update(wf[k], w0f[k], inv) for k in wf], reps=10),
            "cluster_agg_ms": self.cuda_ms(
                lambda: [cluster_agg(v, m_hat, 1) for v in deltas.values()], reps=10),
            "gossip_mix_ms": self.cuda_ms(lambda: sched.backend.inter_cluster(y, p_t, 1),
                                          reps=10),
        }

    def async_path(self):
        torch = self.torch
        from repro_torch.kernels import cluster_agg, gossip_mix, normalized_update

        name = "straggler-bimodal-async"
        counters = {"normalized_update": normalized_update, "cluster_agg": cluster_agg,
                    "gossip_mix": gossip_mix}
        for fn in counters.values():
            fn.launches = 0
        run, dt, events, (loss, acc) = self.run_async(name, ASYNC_EVENTS)
        launches = {k: fn.launches for k, fn in counters.items()}
        sched = run.runtime.scheduler
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on {run.runtime.device}")
        leaves = len(sched.y)
        expected = ASYNC_EVENTS * leaves  # one launch per leaf per cluster event
        if any(n != expected for n in launches.values()):
            raise AssertionError(f"async launches {launches}, expected {expected} each")
        self.check_finite(sched.y, "async cuda run")
        self.check_finite(run.runtime.global_params(), "async cuda run (consensus)")
        print(f"async {name} on {run.runtime.device}, backend {sched.backend.name}: "
              f"{ASYNC_EVENTS} events over clusters {[c for _, c, _ in events]}; launches "
              f"{json.dumps(launches)} ({leaves} leaves); {ASYNC_EVENTS / dt:.3f} events/s cold "
              f"({dt:.4f}s, first-call costs included); eval loss {loss:.6f} acc {acc:.4f}; "
              f"clock {sched.clock:.6f}", flush=True)
        for kname, n in launches.items():
            self.record[kname]["launches"] = n

        ref = {}
        for label, device in (("dense on cuda", None), ("dense on cpu", "cpu")):
            r, _, revents, (rloss, _) = self.run_async(name, ASYNC_EVENTS, device=device,
                                                       backend="dense")
            err = max((v.float().cpu() - r.runtime.scheduler.y[k].float().cpu())
                      .abs().max().item() for k, v in sched.y.items())
            rel = abs(rloss - loss) / abs(rloss)
            same = revents == events
            ref[label] = {"max_abs_y_diff": err, "eval_loss": rloss, "loss_rel_diff": rel,
                          "same_events": same}
            print(f"  vs {label}: same event sequence {same}; max abs y diff {err:.3e} "
                  f"(tol 1e-4), eval loss {rloss:.6f} rel diff {rel:.3e} (tol 1e-4)", flush=True)
            if not (same and err <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"async kernel-backend run disagrees with {label}")

        warm = self.warm_rate(run, ASYNC_EVENTS)
        split = self.event_split(run)
        busy = self.profile_steps(run, 8)
        print(f"async warm: {warm:.3f} events/s over {ASYNC_EVENTS} more events; split "
              + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + f"; profiled 8 events: {json.dumps(busy)}", flush=True)
        self.detail["async"] = {"launches": launches, "events": events,
                                "events_per_s_cold": ASYNC_EVENTS / dt,
                                "events_per_s_warm": warm, "split": split, "profile": busy,
                                "eval_loss": loss, "eval_acc": acc, "references": ref}

    def lm_counters(self) -> dict:
        """The LM path's wrappers, their launch counts (and the flash
        wrappers' counts by route) set to 0."""
        from repro_torch.kernels import (
            flash_attention_bwd, flash_attention_fwd, fused_transition, sgd_update,
        )

        counters = {"flash_attention": flash_attention_fwd,
                    "flash_attention_backward": flash_attention_bwd,
                    "fused_transition": fused_transition, "sgd_update": sgd_update}
        for fn in counters.values():
            fn.launches = 0
        for fn in (flash_attention_fwd, flash_attention_bwd):
            fn.routes = dict.fromkeys(fn.routes, 0)
        return counters

    @staticmethod
    def check_routes(counters, want: str, what: str) -> dict:
        """Every flash launch of the run took route ``want``."""
        routes = {k: dict(counters[k].routes)
                  for k in ("flash_attention", "flash_attention_backward")}
        for k, r in routes.items():
            if r[want] != counters[k].launches or r[want] == 0:
                raise AssertionError(f"{what}: {k} routes {r}, expected all "
                                     f"{counters[k].launches} on {want}")
        return routes

    def run_lm(self, steps, device=None, **overrides):
        """(run, host seconds for ``steps`` supersteps ending in a synchronize,
        per-iteration losses on the host)."""
        torch = self.torch
        from repro_torch.scenarios import build_scenario

        run = build_scenario("federated-lm-ring", device=device, **overrides)
        src = run.batch_source()
        t0 = time.perf_counter()
        losses = [run.runtime.step(src).losses for _ in range(steps)]
        if run.runtime.device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return run, dt, torch.cat(losses).float().cpu()

    def lm_launches(self, sched, cfg, steps, evaluate) -> dict:
        """Exact launches of ``steps`` supersteps: one attention launch per
        layer per iteration (clients folded), plus the evaluate's forward;
        one leaf-table launch per launch group per SGD step and transition."""
        iters = steps * sched.iterations_per_step
        transitions = steps * sched.rounds_per_step * (sched.fl.tau2 + 1)
        groups = self.launch_groups(sched.params)
        return {"flash_attention": cfg.num_layers * (iters + evaluate),
                "flash_attention_backward": cfg.num_layers * iters,
                "fused_transition": transitions * groups, "sgd_update": iters * groups}

    def lm_path(self):
        """This slice's path: federated-lm-ring on the flash, SGD and
        transition kernels, held to the dense backend with plain attention."""
        torch = self.torch
        counters = self.lm_counters()
        run, dt, losses = self.run_lm(LM_STEPS)
        loss, _ = run.runtime.evaluate(run.eval_batch)
        launches = {k: fn.launches for k, fn in counters.items()}
        self.check_routes(counters, "cuda_core", "lm (f32)")
        sched, cfg = run.runtime.scheduler, run.runtime.model.cfg
        if sched.backend.name != "cuda" or run.runtime.device.type != "cuda" \
                or cfg.attn_impl != "cuda":
            raise AssertionError(f"auto resolved to {sched.backend.name} on "
                                 f"{run.runtime.device} with attn_impl {cfg.attn_impl}")
        iters = LM_STEPS * sched.iterations_per_step
        leaves = len(sched.params)
        expected = self.lm_launches(sched, cfg, LM_STEPS, evaluate=True)
        if launches != expected:
            raise AssertionError(f"lm launches {launches}, expected {expected}")
        self.check_finite(sched.params, "lm cuda run")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("lm cuda run: non-finite losses")
        c, b, s = sched.fl.num_clients, run.batch_size, run.eval_batch["tokens"].shape[1]
        print(f"lm federated-lm-ring on {run.runtime.device}, backend {sched.backend.name}, "
              f"attn_impl {cfg.attn_impl}: {LM_STEPS} supersteps = {iters} iterations "
              f"(C={c}, b={b}, S={s}, {cfg.num_layers} layers, {leaves} leaves); launches "
              f"{json.dumps(launches)} (expected exactly); {iters / dt:.3f} it/s cold "
              f"({dt:.4f}s); losses first {losses[0]:.6f} last {losses[-1]:.6f}; eval loss "
              f"{loss:.6f}", flush=True)
        for kname in ("flash_attention", "flash_attention_backward"):
            self.record[kname]["launches"] = launches[kname]

        ref = {}
        plain = {"backend": "dense", "arch_overrides": {"attn_impl": "plain"}}
        for label, device in (("dense+plain on cuda", None), ("dense+plain on cpu", "cpu")):
            r, _, rlosses = self.run_lm(LM_STEPS, device=device, **plain)
            rloss, _ = r.runtime.evaluate(r.eval_batch)
            err = max((w.float().cpu() - r.runtime.scheduler.params[k].float().cpu())
                      .abs().max().item() for k, w in sched.params.items())
            lerr = (losses - rlosses).abs().max().item()
            rel = abs(rloss - loss) / abs(rloss)
            ref[label] = {"max_abs_param_diff": err, "max_abs_loss_diff": lerr,
                          "eval_loss": rloss, "loss_rel_diff": rel}
            print(f"  vs {label}: max abs param diff {err:.3e} (tol 1e-4), per-iteration "
                  f"losses {lerr:.3e} (tol 1e-4), eval loss {rloss:.6f} rel diff {rel:.3e} "
                  f"(tol 1e-4)", flush=True)
            if not (err <= 1e-4 and lerr <= 1e-4 and rel <= 1e-4):
                raise AssertionError(f"lm kernel run disagrees with {label}")
            del r

        warm = self.warm_rate(run, LM_STEPS) * sched.iterations_per_step
        split = self.iteration_split(run)
        busy = self.profile_steps(run, 2)
        tokens = warm * c * b * s
        print(f"lm warm: {warm:.3f} it/s, {tokens:.1f} tokens/s over {LM_STEPS} more "
              f"supersteps; split " + ", ".join(f"{k}={v:.4f}" for k, v in split.items())
              + f"; profiled 2 supersteps: {json.dumps(busy)}", flush=True)
        self.detail["lm"] = {"launches": launches, "expected": expected,
                             "it_per_s_cold": iters / dt, "it_per_s_warm": warm,
                             "tokens_per_s_warm": tokens, "split": split, "profile": busy,
                             "eval_loss": loss, "losses": losses.tolist(), "references": ref}

    def lm_width(self):
        """federated-lm-ring at granite-8b's published widths, cut in depth."""
        torch = self.torch
        counters = self.lm_counters()
        torch.cuda.reset_peak_memory_stats()
        run, dt, losses = self.run_lm(LM_WIDTH_STEPS, **LM_WIDTH)
        peak = torch.cuda.max_memory_allocated()
        launches = {k: fn.launches for k, fn in counters.items()}
        routes = self.check_routes(counters, "tensor_core", "lm-width (bf16)")
        for kname in routes:
            self.record[kname]["width"]["launches"] = launches[kname]
        sched, cfg = run.runtime.scheduler, run.runtime.model.cfg
        iters = LM_WIDTH_STEPS * sched.iterations_per_step
        c, b, s = sched.fl.num_clients, run.batch_size, LM_WIDTH["seq_len"]
        expected = self.lm_launches(sched, cfg, LM_WIDTH_STEPS, evaluate=False)
        if launches != expected:
            raise AssertionError(f"lm-width launches {launches}, expected {expected}")
        if not bool(torch.isfinite(losses).all()):
            raise AssertionError("lm-width run: non-finite losses")
        n_params = sum(w[0].numel() for w in sched.params.values())
        print(f"lm-width federated-lm-ring at granite-8b widths ({cfg.d_model} d_model, "
              f"{cfg.d_ff} d_ff, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
              f"vocab {cfg.vocab_size}, S={s}, {cfg.dtype}); cuts: depth 36 -> "
              f"{cfg.num_layers} layers, per-client batch 2 -> {b}, no evaluate (its 64 "
              f"sequences would need 25.8 GB of f32 logits); {n_params} params per client x "
              f"{c} clients; {iters} iterations in {dt:.3f}s = {iters / dt:.4f} it/s, "
              f"{iters * c * b * s / dt:.1f} tokens/s (first-call costs included); launches "
              f"{json.dumps(launches)}, flash routes {json.dumps(routes)}; peak device "
              f"memory {peak / 2**30:.2f} GiB; losses "
              f"{[round(x, 4) for x in losses.tolist()]}", flush=True)
        warm_dt = 1.0 / self.warm_rate(run, 1)
        busy = self.profile_steps(run, 1)
        wiph = sched.iterations_per_step / warm_dt
        print(f"lm-width warm: {wiph:.4f} it/s, {wiph * c * b * s:.1f} tokens/s (1 superstep, "
              f"{warm_dt:.3f}s); profiled 1 superstep: {json.dumps(busy)}", flush=True)

        # one client's loss and gradients: flash kernels against plain attention
        import dataclasses
        from repro_torch.models import CausalLM

        p0 = {k: w[0] for k, w in sched.params.items()}
        batch = {k: torch.as_tensor(v[0], device=self.dev)
                 for k, v in run.batch_source()(0).items()}
        got = {}
        for impl in ("cuda", "plain"):
            model = CausalLM(dataclasses.replace(cfg, attn_impl=impl))
            g, l = torch.func.grad_and_value(model.loss)(p0, batch)
            got[impl] = (l.item(), g)
            del g
        lrel = abs(got["cuda"][0] - got["plain"][0]) / abs(got["plain"][0])
        # per leaf: the norm of the difference over the norm of the plain
        # gradient (the largest over leaves), and the same with max norms
        gerr = max(((got["cuda"][1][k].float() - g.float()).norm() / g.float().norm()).item()
                   for k, g in got["plain"][1].items())
        gmax = max((got["cuda"][1][k].float() - g.float()).abs().max().item()
                   / max(g.float().abs().max().item(), 1e-30)
                   for k, g in got["plain"][1].items())
        print(f"  one client at width, attn_impl cuda vs plain: loss {got['cuda'][0]:.6f} vs "
              f"{got['plain'][0]:.6f} (rel {lrel:.3e}, tol 1e-2); gradients |diff| / |plain| "
              f"{gerr:.3e} (tol 5e-2: bf16 keeps 8 bits, and both paths round every "
              f"activation to bf16, from sums taken in different orders), max-norm "
              f"{gmax:.3e}", flush=True)
        if not (lrel <= 1e-2 and gerr <= 5e-2):
            raise AssertionError("lm-width: flash and plain attention disagree")
        del got, p0, batch
        torch.cuda.empty_cache()
        tree_times = self.time_width_trees(run, launches)
        self.detail["lm_width"] = {
            "launches": launches, "flash_routes": routes, "params_per_client": n_params,
            "peak_bytes": peak,
            "it_per_s_cold": iters / dt, "it_per_s_warm": wiph,
            "tokens_per_s_warm": wiph * c * b * s, "profile": busy,
            "losses": losses.tolist(), "cuts": {"num_layers": [36, cfg.num_layers],
                                                "batch_size": [2, b], "evaluate": False},
            "cuda_vs_plain": {"loss_rel": lrel, "grad_rel_norm": gerr, "grad_rel_max": gmax},
            "leaf_table_kernels": tree_times}

    def time_width_trees(self, run, launches) -> dict:
        """The two leaf-table kernels at the lm-width run's bf16 shapes (C = 8
        clients, 12 leaves), first out of place against their plain versions
        (the transition on random leaves, SGD on the run's), then timed on
        the run's own tree, in place: the transition as the inter event
        calls it (``CudaBackend.transition``, D = 4, alpha = 2), SGD with a
        gradient-sized buffer.  Eager and graph times against the bytes
        bound, and the library yardsticks (per-leaf ``torch.matmul`` into a
        reused buffer, one ``torch._foreach_add_``); recorded under each
        kernel's ``width``."""
        torch = self.torch
        from repro_torch.kernels import sgd_update_tree

        sched = run.runtime.scheduler
        backend, params = sched.backend, sched.params
        nbytes = sum(w.numel() * w.element_size() for w in params.values())
        m_total = sum(w[0].numel() for w in params.values())
        c, d, alpha = backend._bt.shape[0], backend._bt.shape[1], backend.alpha
        groups = self.launch_groups(params)
        chunk = 1 << 24  # columns the plain versions take at a time

        # both tree calls (out of place) against the plain versions first, on
        # random leaves of the run's shapes: the run's own clients are nearly
        # equal after its transitions, so a mix of them hardly moves them
        gen = torch.Generator(device=self.dev).manual_seed(3)
        grads = {k: torch.randn(w.shape, generator=gen, device=self.dev).to(w.dtype)
                 for k, w in params.items()}
        tr_err, tr_moved = self.hold_transition_tree(
            grads, backend._vt, backend._p, backend._bt, alpha, 3e-2, "lm-width bf16", groups,
            chunk)
        sgd_err = self.hold_sgd_tree(params, grads, 0.0, "lm-width bf16", groups, chunk * c)
        torch.cuda.empty_cache()
        print(f"  lm-width tree calls against the plain versions: fused_transition on random "
              f"bf16 leaves max abs err {tr_err:.3e} (tol 3e-2; the transition moves its input "
              f"by up to {tr_moved:.3e}), sgd_update {sgd_err:.3e} (bitwise equal)", flush=True)
        errs = {"fused_transition": tr_err, "sgd_update": sgd_err}
        t_lib = (backend._vt.T @ torch.linalg.matrix_power(backend._p, alpha)
                 @ backend._bt.T).T.to(torch.bfloat16).contiguous()
        scratch = torch.empty(max(w.numel() for w in params.values()), dtype=torch.bfloat16,
                              device=self.dev)
        flat = [w.view(c, -1) for w in params.values()]
        ws, gs = list(params.values()), [grads[k] for k in params]
        calls = {
            "fused_transition": (
                lambda: backend.transition(params, "inter"),
                lambda: [torch.matmul(t_lib, w, out=scratch[:w.numel()].view(w.shape))
                         for w in flat],
                self.bound(2 * nbytes, 2 * m_total * (2 * c * d + alpha * d * d),
                           BF16_FLOPS_PER_S)),
            "sgd_update": (
                lambda: sgd_update_tree(params, grads, 1e-6, inplace=True),
                lambda: torch._foreach_add_(ws, gs, alpha=-1e-6),
                self.bound(3 * nbytes, 2 * m_total * c, BF16_FLOPS_PER_S)),
        }
        # yardsticks of the transition: the intra event (alpha = 0, two of the
        # three transitions of a round), and the card's copy of the same tree
        # (read once, written once, as the transition)
        extra = {"fused_transition": {
            "intra_ms": self.cuda_ms(lambda: backend.transition(params, "intra"), reps=5,
                                     warmup=1),
            "intra_graph_ms": self.graph_ms(lambda: backend.transition(params, "intra"), reps=5),
            "copy_graph_ms": self.graph_ms(lambda: torch._foreach_copy_(gs, ws), reps=5)},
            "sgd_update": {}}
        out = {}
        for kname, (fn, lib, (bnd, by)) in calls.items():
            ms, lib_ms = self.cuda_ms(fn, reps=5, warmup=1), self.cuda_ms(lib, reps=5, warmup=1)
            g_ms = self.graph_ms(fn, reps=5)
            torch.cuda.empty_cache()
            out[kname] = {
                "shape": {"clients": c, "clusters": d, "alpha": alpha if kname ==
                          "fused_transition" else None, "leaves": len(params),
                          "params_per_client": m_total},
                "dtype": "bfloat16", "route": "cuda", "source": KERNELS[kname]["source"],
                "launches": launches[kname], "launches_per_call": groups,
                "max_abs_err": errs[kname], "ms": ms, "graph_ms": g_ms, "bound_ms": bnd,
                "bound_by": by,
                "bound_share": bnd / ms, "graph_bound_share": bnd / g_ms, "library_ms": lib_ms,
                **extra[kname]}
            self.record[kname]["width"] = out[kname]
            print(f"  lm-width {kname} over {len(params)} bf16 leaves ({m_total} params x {c} "
                  f"clients): " + ", ".join(f"{k}={v:.6g}" if isinstance(v, float) else
                                            f"{k}={v}" for k, v in out[kname].items()
                                            if k not in ("shape", "source")), flush=True)
        del grads, scratch, ws, gs, flat
        torch.cuda.empty_cache()
        return out

    def run(self):
        torch = self.torch
        self.phase("device", self.device)
        self.phase("build", self.build)
        if not self.failed:
            self.phase("kernels", self.kernels)
            self.phase("main", self.main_path)
            self.phase("cifar", self.cifar)
            self.phase("async", self.async_path)
            self.phase("lm", self.lm_path)
            self.phase("lm-width", self.lm_width)
        if "jax" in sys.modules:
            self.failed.append("jax imported")
        out = HERE / "chiprun_out"
        out.mkdir(exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(
            {"failed": self.failed, **self.detail}, indent=1, default=str))
        if self.failed:
            fail(f"phases failed: {self.failed}")
        keys = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
        kernels = [dict(name=k, route="cuda", **KERNELS[k], **{f: self.record[k][f] for f in keys})
                   for k in KERNELS]
        for entry in kernels:  # the flash kernels' granite-8b bf16 numbers
            if "width" in self.record[entry["name"]]:
                entry["width"] = self.record[entry["name"]]["width"]
        print(self.smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
