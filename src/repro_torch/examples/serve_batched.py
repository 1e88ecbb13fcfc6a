"""Batched-request serving with the queue scheduler.

    PYTHONPATH=src python -m repro_torch.examples.serve_batched [--arch qwen2.5-3b] [--device cpu]

The port's ``examples/serve_batched.py``: submits a mixed-length request
stream to a ``BatchServer`` over a reduced model, lets the length-bucketed
scheduler batch it, and prints throughput and occupancy.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2.5-3b", choices=ARCH_NAMES)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.7)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import resolve_device
    from repro_torch.models import CausalLM
    from repro_torch.serving import BatchServer, Request

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = CausalLM(cfg)
    params = {k: v.to(device) for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    srv = BatchServer(model, params, max_batch=args.max_batch, length_buckets=(32, 64, 128),
                      temperature=args.temperature)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        plen = int(rng.choice([12, 24, 48, 100]))
        srv.submit(Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
                           max_new_tokens=args.gen))
    done = srv.run()
    s = srv.stats
    print(f"served {s.requests} requests in {s.batches} batches on {device} "
          f"(mean occupancy {s.mean_occupancy:.2f})")
    print(f"{s.tokens_generated} tokens in {s.wall_s:.2f}s -> {s.tokens_per_s:.1f} tok/s")
    for r in done[:3]:
        print(f"  req {r.uid}: prompt {r.prompt.shape[-1]} toks -> "
              f"{r.output.size} generated, latency {r.latency_s:.2f}s")
    return srv, done


if __name__ == "__main__":
    main()
