"""Batched decode serving driver: the port's ``repro.launch.serve``.

Prefills a batch of prompts (through the flash forward with
``attn_impl="cuda"``) and decodes tokens autoregressively with the
ring-buffer KV and SSM caches of ``CausalLM``; ``serve_scenario`` closes the
training-to-serving loop of a federated scenario.  Runs on the card unless
``--device cpu``::

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b --reduced \\
        --batch 4 --prompt-len 64 --gen 32 [--device cpu]

With ``--scenario <name> --continuous --mesh auto`` under ``torchrun
--nproc-per-node D`` (D the scenario's clusters) each rank serves one
cluster's replica (``ContinuousFederatedServer(mesh=)``), a CUDA rank's decode
chunk replayed from a CUDA graph with its token all-reduce inside;
``--device cpu`` runs the ranks eagerly over gloo::

    OMP_NUM_THREADS=1 PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.serve \
        --scenario lm-serving-continuous --continuous --mesh auto --device cpu

Sampling at ``temperature > 0`` draws Gumbel noise from a counter-based hash
of a key per row (``sample_tokens``, ``next_keys``): the draws follow from
the seed and are plain tensor ops, so a captured CUDA graph replays them.
They are not the reference's ``jax.random`` draws; at temperature 0 the
token is the argmax, as the reference's.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import torch
import torch.nn.functional as F

__all__ = ["grow_caches", "generate", "serve_scenario", "sample_tokens", "next_keys",
           "initial_keys", "main"]

_M32 = 0xFFFFFFFF
_MUL = 0x45D9F3B      # both multipliers below 2^31: products of 32-bit values
_GOLDEN = 0x61C88647  # stay inside int64


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer hash of int64 tensors holding values below 2^32."""
    x = x & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    x = x ^ (x >> 16)
    x = (x * _MUL) & _M32
    return x ^ (x >> 16)


def initial_keys(seed: int, rows: int, device=None) -> torch.Tensor:
    """(rows,) int64 sampling keys from ``seed``."""
    base = torch.arange(rows, dtype=torch.int64, device=device) * _GOLDEN
    return _mix32(_mix32(torch.full((rows,), seed & _M32, dtype=torch.int64, device=device))
                  + base)


def next_keys(keys: torch.Tensor) -> torch.Tensor:
    """Each row's key for its next draw."""
    return _mix32(keys + _GOLDEN)


def sample_tokens(logits: torch.Tensor, vocab_size: int, temperature: float,
                  keys: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tokens from ``logits`` (B, ..., V_padded) over the first ``vocab_size``
    entries: the argmax at ``temperature <= 0`` (the first maximum, as
    ``jnp.argmax``), else a Gumbel-max draw keyed by ``keys`` (B,)."""
    flat = logits[..., :vocab_size]
    if temperature <= 0:
        return flat.argmax(dim=-1)
    idx = torch.arange(flat[0].numel(), dtype=torch.int64, device=flat.device)
    key = keys.reshape((-1,) + (1,) * (flat.dim() - 1))
    h = _mix32(_mix32(key) + idx.reshape(flat.shape[1:]) * _GOLDEN)
    u = ((h >> 8).to(torch.float32) + 0.5) / float(1 << 24)
    gumbel = -torch.log(-torch.log(u))
    return (flat.float() / temperature + gumbel).argmax(dim=-1)


def grow_caches(model, cache: dict, new_len: int) -> dict:
    """Extend full-attention KV caches to ``new_len`` slots (``pos`` -1 in
    the padding).  Sliding-window layers keep their ring buffers (size =
    window): the ring overwrite is the sliding window's eviction."""
    cfg = model.cfg
    out = dict(cache)
    for i in range(cfg.scan_period):
        if cfg.layer_kind(i) == "mamba" or f"pos{i}.k" not in cache:
            continue
        if cfg.window_for_layer(i, model.long_context) is not None:
            continue
        k = cache[f"pos{i}.k"]  # (nblocks, B, Sc, H, hd)
        pad = new_len - k.shape[2]
        if pad <= 0:
            continue
        out[f"pos{i}.k"] = F.pad(k, (0, 0, 0, 0, 0, pad))
        out[f"pos{i}.v"] = F.pad(cache[f"pos{i}.v"], (0, 0, 0, 0, 0, pad))
        out[f"pos{i}.pos"] = F.pad(cache[f"pos{i}.pos"], (0, pad), value=-1)
    return out


@torch.no_grad()
def generate(model, params: dict, prompts: torch.Tensor, gen_len: int,
             cache_len: Optional[int] = None, temperature: float = 0.0,
             seed: int = 0) -> torch.Tensor:
    """prompts: (B, S), or (B, K, S) audio, on the params' device.  Returns
    the generated tokens (B, gen), or (B, gen, K)."""
    cfg = model.cfg
    s = prompts.shape[-1]
    cache_len = cache_len or (s + gen_len)
    logits, cache = model.prefill(params, {"tokens": prompts})
    cache = grow_caches(model, cache, cache_len)
    keys = initial_keys(seed, prompts.shape[0], prompts.device)
    tok = sample_tokens(logits[:, -1], cfg.vocab_size, temperature, keys)
    outs = []
    for i in range(gen_len):
        outs.append(tok)
        keys = next_keys(keys)
        logits, cache = model.decode_step(params, tok, cache, s + i)
        tok = sample_tokens(logits[:, -1], cfg.vocab_size, temperature, keys)
    return torch.stack(outs, dim=1)


def serve_scenario(name: str, *, train_steps: int = 4, requests: int = 16,
                   max_batch: int = 8, gen: int = 16, seed: int = 0,
                   arch_overrides=None, length_buckets=(16, 32, 64),
                   continuous: bool = False, mesh=None, device=None):
    """Close the training-to-serving loop for one named federated scenario.

    Builds the scenario (its corpus must be ``lm-clustered``, so the trace
    knows each cluster's successor table) on ``device`` (None: the card),
    trains it ``train_steps`` scheduler steps, serves the live runtime's
    ``cluster_params()`` through a federated server and replays a Zipf
    per-cluster request trace.  Returns ``(server, done, history)``.

    ``continuous=True`` serves through the slot-pool
    ``ContinuousFederatedServer`` (budgets heavy-tailed on ``[1, gen]``);
    ``mesh`` (None, ``"auto"`` or a ``launch.mesh.ClientMesh``) then puts
    one cluster replica a rank of the default process group, as the
    reference's shards the replica axis.  Every rank trains the scenario
    alike (one seed), so every rank serves the same stack."""
    from ..scenarios import build_scenario
    from ..serving import ContinuousFederatedServer, FederatedServer, synthetic_trace

    overrides = {"seed": seed}
    if arch_overrides:
        overrides["arch_overrides"] = arch_overrides
    run = build_scenario(name, device=device, **overrides)
    history = run.run(train_steps)
    if continuous:
        server = ContinuousFederatedServer(
            run.runtime.model, runtime=run.runtime, mesh=mesh, max_batch=max_batch,
            length_buckets=tuple(length_buckets), gen_cap=gen)
        budgets = (1, gen)
    else:
        server = FederatedServer(run.runtime.model, runtime=run.runtime, max_batch=max_batch,
                                 length_buckets=tuple(length_buckets))
        budgets = gen
    trace = synthetic_trace(run.dataset, num_requests=requests, prompt_lens=(8, 16),
                            max_new_tokens=budgets, seed=seed)
    for req in trace:
        server.submit(req)
    done = server.run()
    return server, done, history


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--scenario", default=None,
                    help="train this federated scenario briefly, then serve "
                         "its per-cluster models (e.g. federated-lm-serving)")
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--continuous", action="store_true",
                    help="serve through the continuous slot-pool engine "
                         "(mid-decode admission, decode chunks on a CUDA graph)")
    ap.add_argument("--mesh", default=None,
                    help="'auto' puts one cluster replica a rank of the continuous "
                         "server (--scenario ... --continuous; under torchrun "
                         "--nproc-per-node D, D the scenario's clusters)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.scenario is not None:
        return _serve_scenario_main(args)
    if args.mesh is not None:
        raise ValueError("--mesh applies to the continuous federated server: pass "
                         "--scenario <name> --continuous")

    import numpy as np

    from ..configs import get_config
    from ..core import resolve_device
    from ..models import CausalLM

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = CausalLM(cfg)
    params = {k: v.to(device) for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(0)
    shape = ((args.batch, cfg.num_codebooks, args.prompt_len)
             if cfg.modality == "audio" and cfg.num_codebooks > 1
             else (args.batch, args.prompt_len))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(device)
    t0 = time.time()
    out = generate(model, params, prompts, args.gen, temperature=args.temperature)
    out = out.cpu()
    dt = time.time() - t0
    print(f"arch={cfg.name} batch={args.batch} prompt={args.prompt_len} gen={args.gen} "
          f"device={device}")
    print(f"generated {out.numel()} tokens in {dt:.2f}s ({out.numel() / dt:.1f} tok/s, "
          f"kernel builds included)")
    print("sample tokens:", out[0, :10].tolist())
    return out


def _serve_scenario_main(args):
    """``--scenario``: under torchrun with ``--mesh auto`` the default
    process group is started first (``launch.train``'s rule) and only rank
    0 prints."""
    from .train import _say, _start_process_group

    started = _start_process_group(args)
    try:
        server, _, _ = serve_scenario(
            args.scenario, train_steps=args.train_steps, requests=args.requests,
            max_batch=args.max_batch, gen=args.gen, continuous=args.continuous,
            mesh=args.mesh, device=args.device)
        s = server.stats
        engine = "continuous" if args.continuous else "static"
        mesh = getattr(server, "mesh", None)
        where = ("one device" if mesh is None else
                 f"a cluster mesh of {mesh.size} ranks over {mesh.backend}")
        _say(f"scenario={args.scenario} engine={engine} clusters={server.num_clusters} "
             f"requests={s.requests} batches={s.batches} on {where}")
        _say(f"{s.tokens_generated} tokens in {s.wall_s:.2f}s -> {s.tokens_per_s:.1f} tok/s, "
             f"{s.requests_per_s:.2f} req/s (mean occupancy {s.mean_occupancy:.2f})")
        _say(f"latency p50/p95 {s.latency_p50:.3f}/{s.latency_p95:.3f}s, "
             f"ttft p50/p95 {s.ttft_p50:.3f}/{s.ttft_p95:.3f}s")
        return server
    finally:
        if started:
            import torch.distributed as dist

            dist.destroy_process_group()


if __name__ == "__main__":
    main()
