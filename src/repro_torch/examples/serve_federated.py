"""Train-then-serve: per-cluster personalized inference with live hot-swap.

    PYTHONPATH=src python -m repro_torch.examples.serve_federated [--device cpu]

The port's ``examples/serve_federated.py``.  Builds ``federated-lm-serving``
(clustered Markov corpora whose per-cluster successor tables conflict on a
shared vocabulary), trains it a few round supersteps, then serves a Zipf
per-cluster request trace from the runtime's live ``cluster_params()``
through a ``FederatedServer`` (batches bucketed by cluster and padded
length).  Midway through the trace it trains on and hot-swaps the new
weights through ``sync_from``, training and serving in one process.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--train-steps", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--full-size", action="store_true",
                    help="use the scenario's reduced-granite arch instead of the "
                         "tiny one")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np

    from repro_torch.launch.serve import serve_scenario
    from repro_torch.scenarios import build_scenario
    from repro_torch.serving import FederatedServer, synthetic_trace

    tiny = None if args.full_size else dict(
        num_layers=2, d_model=32, d_ff=64, num_heads=2, num_kv_heads=1,
        head_dim=16, dtype="float32", remat=False)

    # -- phase 1: train briefly, then serve the whole trace --------------------
    server, done, _ = serve_scenario("federated-lm-serving", train_steps=args.train_steps,
                                     requests=args.requests, gen=args.gen,
                                     arch_overrides=tiny, device=args.device)
    s = server.stats
    print(f"phase 1: trained {args.train_steps} supersteps on {args.device}, served "
          f"{s.requests} requests in {s.batches} batches")
    print(f"  {s.tokens_generated} tokens, {s.mean_decode_steps:.1f} mean decode "
          f"steps/batch ({s.tokens_per_s:.1f} tok/s)")

    # -- phase 2: keep training, hot-swap mid-stream ---------------------------
    run = build_scenario("federated-lm-serving", device=args.device,
                         **({"arch_overrides": tiny} if tiny else {}))
    run.run(args.train_steps)
    srv = FederatedServer(run.runtime.model, runtime=run.runtime, max_batch=8,
                          length_buckets=(16, 32))
    trace = synthetic_trace(run.dataset, num_requests=args.requests, prompt_lens=(8, 16),
                            max_new_tokens=args.gen, seed=1)
    half = len(trace) // 2
    for req in trace[:half]:
        srv.submit(req)
    srv.run()
    run.run(args.train_steps)      # more training rounds...
    srv.sync_from()                # ...published; flips at the next batch boundary
    for req in trace[half:]:
        srv.submit(req)
    srv.run()
    print(f"phase 2: {srv.swaps} hot swap(s) mid-stream, {srv.stats.requests} requests "
          f"total, {srv.stats.mean_decode_steps:.1f} mean decode steps/batch")
    print("sample generations:", [np.asarray(d.output)[:6].tolist() for d in done[:2]])
    return {"phase1": server, "phase2": srv, "done": done}


if __name__ == "__main__":
    main()
