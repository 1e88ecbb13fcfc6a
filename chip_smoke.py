#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one result line each; any failure exits non-zero without the final
``{"ok": true, ...}`` line:

1. device   card name and power limit (nvidia-smi), torch/CUDA versions and
            both TF32 flags; TF32 is then switched off for the whole run
            (cuDNN convolutions would otherwise run f32 in TF32).
2. build    ``nvcc`` builds every kernel of the path from ``src/``, one
            process per kernel, all at once.
3. kernels  each kernel's wrapper against its plain PyTorch version on the
            card, at the leaf shapes of MnistCNN and CifarCNN stacked over
            C=20 clients in D=4 clusters: f32 and bf16, alpha 0/1/2, static
            factors and masked participation weights with a faulted mixing
            matrix (ring with one link down).  Tolerances as the reference's
            kernel tests: 1e-5 f32 transition, 1e-6 f32 SGD, 3e-2 bf16.
            Then CUDA-event times of the kernel, the plain version and one
            library call computing the same function, beside the bound.
4. main     the main path: ``mnist-noniid-ring`` with ``tau2=2`` through
            ``build_scenario`` (which calls ``make_run``) on the default
            device, backend auto -> cuda, 10 iterations (local, intra and
            inter events), launch counters zeroed just before and read
            just after.  Held against the same run with the dense backend
            on the card and on the CPU (1e-4 max abs on the parameters,
            1e-4 relative on the eval loss).
5. cifar    ``cifar-dirichlet-torus`` with the kernel backend: iterations/s
            and the split of one iteration into local gradient,
            ``sgd_update`` and transition.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  Details go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE / "src"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data-sheet memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM f32 peak outside the tensor cores
C, D, LR = 20, 4, 0.05
KERNELS = {
    "fused_transition": {
        "source": "src/repro_torch/kernels/fused_transition/csrc/fused_transition.cu",
        "replaces": "src/repro/kernels/fused_transition/kernel.py:39",
    },
    "sgd_update": {
        "source": "src/repro_torch/kernels/fused_sgd/csrc/sgd_update.cu",
        "replaces": "src/repro/kernels/fused_sgd/kernel.py:23",
    },
}


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

    def stacked_leaves(self, model_cls, dtype, seed=0):
        torch = self.torch
        shapes = {k: tuple(v.shape) for k, v in model_cls().init(torch.Generator()).items()}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return {k: torch.randn((C,) + s, generator=gen, device=self.dev).to(dtype)
                for k, s in shapes.items()}

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

    def kernels(self):
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition_ref, fused_transition_tree, sgd_update, sgd_update_ref,
        )
        from repro_torch.models import CifarCNN, MnistCNN

        factors = self.factors()
        worst = {"fused_transition": 0.0, "sgd_update": 0.0}
        main_err = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            for dtype, t_tol, s_tol in ((torch.float32, 1e-5, 1e-6), (torch.bfloat16, 3e-2, 3e-2)):
                leaves = self.stacked_leaves(mcls, dtype)
                for fname, (vt, p, bt) in factors.items():
                    for alpha in (0, 1, 2):
                        out = fused_transition_tree(leaves, vt, p, bt, alpha=alpha)
                        err = max(
                            (out[k].float() - fused_transition_ref(
                                w.reshape(C, -1), vt, p, bt, alpha).float().view(w.shape)
                             ).abs().max().item()
                            for k, w in leaves.items()
                        )
                        torch.cuda.synchronize()
                        if not err <= t_tol:
                            raise AssertionError(f"fused_transition {mname} {dtype} {fname} "
                                                 f"alpha={alpha}: max abs err {err} > {t_tol}")
                        worst["fused_transition"] = max(worst["fused_transition"], err)
                        if (mname, dtype, fname, alpha) == ("mnist", torch.float32, "static", 1):
                            main_err["fused_transition"] = err
                grads = self.stacked_leaves(mcls, dtype, seed=1)
                for k, w in leaves.items():
                    out = sgd_update(w, grads[k], LR)
                    err = (out.float() - sgd_update_ref(w, grads[k], LR).float()).abs().max().item()
                    if not err <= s_tol:
                        raise AssertionError(f"sgd_update {mname} {dtype} {k}: max abs err {err}")
                    worst["sgd_update"] = max(worst["sgd_update"], err)
                    if (mname, dtype) == ("mnist", torch.float32):
                        main_err["sgd_update"] = max(main_err.get("sgd_update", 0.0), err)
                print(f"  {mname} {str(dtype)[6:]}: transition (2 factor sets x alpha 0-2) and "
                      f"sgd_update agree with their plain versions", flush=True)
        print(f"max abs err over all cases: {json.dumps(worst)}", flush=True)
        self.detail["max_abs_err_all_cases"] = worst

        timings = {}
        for mname, mcls in (("mnist", MnistCNN), ("cifar", CifarCNN)):
            timings[mname] = self.time_kernels(mcls, factors["static"])
            for kname, t in timings[mname].items():
                print(f"  time {mname} f32 {kname}: " + ", ".join(
                    f"{k}={v:.6g}" if isinstance(v, float) else f"{k}={v}" for k, v in t.items()
                ), flush=True)
        self.detail["timings_f32"] = timings
        for kname in KERNELS:
            self.record[kname] = dict(timings["mnist"][kname], max_abs_err=main_err[kname])

    def time_kernels(self, mcls, factors) -> dict:
        torch = self.torch
        from repro_torch.kernels import (
            fused_transition, fused_transition_ref, sgd_update, sgd_update_ref,
        )

        vt, p, bt = factors
        alpha = 1  # the main path's inter event
        leaves = {k: w.reshape(C, -1) for k, w in self.stacked_leaves(mcls, torch.float32).items()}
        grads = {k: torch.randn_like(w) for k, w in leaves.items()}
        outs = {k: torch.empty_like(w) for k, w in leaves.items()}
        t_full = (vt.T @ torch.linalg.matrix_power(p, alpha) @ bt.T)  # (C, C) T_k
        t_lib = t_full.T.contiguous()
        nbytes = sum(w.numel() * w.element_size() for w in leaves.values())
        m_total = sum(w.shape[1] for w in leaves.values())
        factor_bytes = 4 * (vt.numel() + p.numel() + bt.numel())

        def bound(byts, flops):
            tb, to = byts / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
            return (tb, "bytes") if tb >= to else (to, "operations")

        tr_calls = {
            "ms": lambda: [fused_transition(w, vt, p, bt, alpha, out=outs[k])
                           for k, w in leaves.items()],
            "plain_ms": lambda: [fused_transition_ref(w, vt, p, bt, alpha)
                                 for w in leaves.values()],
            "library_ms": lambda: [torch.matmul(t_lib, w) for w in leaves.values()],
        }
        sgd_calls = {
            "ms": lambda: [sgd_update(w, grads[k], LR, out=outs[k]) for k, w in leaves.items()],
            "plain_ms": lambda: [sgd_update_ref(w, grads[k], LR) for k, w in leaves.items()],
            "library_ms": lambda: [torch.add(w, grads[k], alpha=-LR)
                                   for k, w in leaves.items()],
        }
        tr_bound, tr_by = bound(2 * nbytes + factor_bytes,
                                2 * m_total * (2 * C * D + alpha * D * D))
        sgd_bound, sgd_by = bound(3 * nbytes, 2 * m_total * C)
        out = {}
        for kname, calls, bnd, by, moved in (
            ("fused_transition", tr_calls, tr_bound, tr_by, 2 * nbytes),
            ("sgd_update", sgd_calls, sgd_bound, sgd_by, 3 * nbytes),
        ):
            t = {k: self.cuda_ms(fn) for k, fn in calls.items()}
            t.update({f"graph_{k}": self.graph_ms(fn) for k, fn in calls.items()})
            out[kname] = dict(t, bound_ms=bnd, bound_by=by, leaves=len(leaves),
                              bytes_moved=moved)
        # the largest leaf alone: the kernel's own rate, without launch gaps
        big = max(leaves, key=lambda k: leaves[k].numel())
        w = leaves[big]
        out["fused_transition"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: fused_transition(w, vt, p, bt, alpha, out=outs[big])),
            "bound_ms": 2 * w.numel() * w.element_size() / HBM_BYTES_PER_S * 1e3,
        }
        out["sgd_update"]["largest_leaf"] = {
            "leaf": big, "shape": list(w.shape),
            "graph_ms": self.graph_ms(lambda: sgd_update(w, grads[big], LR, out=outs[big])),
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
        return {"iters": iters, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
                "busy_ms_per_step": busy_ms / iters, "busy_share": busy_ms / wall_ms,
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
        if min(launches.values()) < 1:
            raise AssertionError(f"a kernel of the main path was never launched: {launches}")
        self.check_finite(sched.params, "mnist cuda run")
        print(f"main path mnist-noniid-ring tau2=2 on {run.runtime.device}, backend "
              f"{sched.backend.name}: events {events}; launches {json.dumps(launches)}; "
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
        if sched.backend.name != "cuda" or min(launches.values()) < 1:
            raise AssertionError(f"cifar path off the kernels: {sched.backend.name} {launches}")
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

    def run(self):
        torch = self.torch
        self.phase("device", self.device)
        self.phase("build", self.build)
        if not self.failed:
            self.phase("kernels", self.kernels)
            self.phase("main", self.main_path)
            self.phase("cifar", self.cifar)
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
        print(self.smi)
        print(json.dumps({"kernels": kernels}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
