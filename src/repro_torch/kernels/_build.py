"""Build the hand-written CUDA kernels with ``nvcc`` and bind them with ctypes.

Each kernel package keeps its sources under ``csrc/`` and exports plain
``extern "C"`` launchers that return ``cudaGetLastError()``.  ``load(name)``
compiles ``csrc/*.cu`` of ``kernels/<name>`` for ``sm_90a`` into a shared
library at first use and loads it; ``build_all()`` starts one ``nvcc`` per
source of every kernel at once, then links each library.  Libraries land in
``build/repro_torch_kernels/`` of the checkout (or ``$REPRO_TORCH_BUILD_DIR``),
keyed by a hash of the sources and flags, so an edited source rebuilds and
an unchanged one loads as built.

Nothing here runs at import: the CPU tests import every module, and
``nvcc`` is only called when a kernel is first launched on a CUDA tensor (or
``build_all`` is called).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["load", "build_all", "check", "stream_of", "KERNELS"]

_KERNEL_ROOT = Path(__file__).resolve().parent
KERNELS = ("fused_sgd", "fused_transition", "gossip_mix", "cluster_agg", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas register/shared-memory/spill report of each library (kept beside it)
build_logs: dict[str, str] = {}


def _build_root() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    # src/repro_torch/kernels/_build.py -> <checkout>/build/repro_torch_kernels
    return _KERNEL_ROOT.parents[2] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); CUDA kernels cannot be built")
    return found


def _sources(name: str) -> list[Path]:
    srcs = sorted((_KERNEL_ROOT / name / "csrc").glob("*.cu"))
    if not srcs:
        raise FileNotFoundError(f"no CUDA sources under kernels/{name}/csrc")
    return srcs


def _target(name: str) -> tuple[Path, list[Path]]:
    srcs = _sources(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs:
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return _build_root() / f"lib{name}-{h.hexdigest()[:16]}.so", srcs


def _start(name: str):
    """Start one ``nvcc -c`` per source of ``name`` unless its library exists;
    returns (path, (procs, objects) | None)."""
    so, srcs = _target(name)
    if so.exists():
        return so, None
    so.parent.mkdir(parents=True, exist_ok=True)
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    objs = [so.with_name(f"{so.stem}.{src.stem}.{os.getpid()}.o") for src in srcs]
    procs = [subprocess.Popen([_nvcc(), *compile_flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(srcs, objs)]
    return so, (procs, objs)


def _finish(name: str, so: Path, pending) -> None:
    if pending is None:  # built before: its ptxas report lies beside it
        log = so.with_suffix(".log")
        if log.exists():
            build_logs[name] = log.read_text()
        return
    procs, objs = pending
    outs = [proc.communicate()[0] for proc in procs]
    rcs = [proc.returncode for proc in procs]
    tmp = so.with_suffix(f".{os.getpid()}.tmp.so")
    try:
        if any(rcs):
            raise RuntimeError(f"nvcc failed for kernels/{name} (rc {rcs}):\n" + "".join(outs))
        link = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)],
                              capture_output=True, text=True)
        outs.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"linking kernels/{name} failed (rc {link.returncode}):\n"
                               + "".join(outs))
    except RuntimeError:
        tmp.unlink(missing_ok=True)
        raise
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    build_logs[name] = "".join(outs)
    so.with_suffix(".log").write_text(build_logs[name])
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing


def build_all(names=KERNELS) -> dict[str, Path]:
    """Build every named kernel library, one ``nvcc`` per source, all at once."""
    with _lock:
        started = {n: _start(n) for n in names if n not in _libs}
        errors = []
        for n, (so, pending) in started.items():  # wait for every nvcc, then report
            try:
                _finish(n, so, pending)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
        for n, (so, _) in started.items():
            _libs[n] = ctypes.CDLL(str(so))
    return {n: _target(n)[0] for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build_all((name,))
        lib = _libs[name]
    return lib


def stream_of(device) -> int:
    """The current stream of ``device`` as the launchers take it.

    Kernels launch on the current device, so a tensor on another card is
    refused rather than silently launched into the wrong context.
    """
    import torch

    current = torch.cuda.current_device()
    if device.index is not None and device.index != current:
        raise ValueError(f"tensor on {device} but the current device is cuda:{current}; "
                         f"launch under torch.cuda.device({device})")
    return torch.cuda.current_stream().cuda_stream


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by one of ``lib``'s launchers."""
    if rc != 0:
        lib.error_string.restype = ctypes.c_char_p
        lib.error_string.argtypes = [ctypes.c_int]
        msg = lib.error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: cudaError_t {rc} ({msg})")
