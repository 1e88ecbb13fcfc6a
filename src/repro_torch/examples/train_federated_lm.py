"""End-to-end driver: federated training of a ~100M-parameter LM with SD-FEEL.

    PYTHONPATH=src python -m repro_torch.examples.train_federated_lm [--steps 200] [--device cuda]

The port's ``examples/train_federated_lm.py``: a 12-layer, d_model=768
llama-style decoder (the granite-8b family scaled down), 8 clients in 4 ring
clusters, SD-FEEL iterations of next-token training on synthetic Markov
corpora (one distinct corpus per client: non-IID), through the named
``federated-lm-ring`` scenario.  On a CUDA device each superstep replays from
one CUDA graph, with the flash attention, SGD and transition kernels.
As in the reference, bf16 runs with activation checkpointing (``remat``,
recomputing each block in the backward) and f32 without.  ``--mesh auto``
resolves as ``launch.mesh.resolve_client_mesh`` does: to no mesh when there
are fewer CUDA devices than clients, which it prints; with a device a client
it asks for one process a client (``python -m repro_torch.launch.train
--mesh auto`` under ``torchrun``), where the client mesh runs.
"""
from __future__ import annotations

import argparse
import dataclasses
import time


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200,
                    help="protocol iterations (rounded up to whole supersteps)")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--layers", type=int, default=12)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--precision", choices=["float32", "bfloat16"], default="float32")
    ap.add_argument("--mesh", choices=["none", "auto"], default="none",
                    help="'auto': none when there are fewer CUDA devices than clients; "
                         "a client mesh needs one process a client (launch.train)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--heads", type=int, default=12)
    ap.add_argument("--kv-heads", type=int, default=4)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--samples", type=int, default=512)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config
    from repro_torch.models import CausalLM
    from repro_torch.scenarios import build_scenario

    cfg = dataclasses.replace(
        get_config("granite-8b"),
        num_layers=args.layers, d_model=args.d_model, d_ff=4 * args.d_model,
        num_heads=args.heads, num_kv_heads=args.kv_heads, head_dim=args.head_dim,
        vocab_size=args.vocab, dtype=args.precision, remat=args.precision == "bfloat16",
        attn_chunk=128,
    )
    model = CausalLM(cfg)
    print(f"LM config: {cfg.num_layers}L d={cfg.d_model} vocab={cfg.vocab_size} "
          f"-> {cfg.param_count() / 1e6:.1f}M params")

    run = build_scenario(
        "federated-lm-ring",
        device=args.device,
        model=model,
        num_clients=args.clients,
        seq_len=args.seq,
        vocab_size=cfg.vocab_size,
        batch_size=args.batch,
        num_samples=args.samples,
        learning_rate=0.3,
        mesh=None if args.mesh == "none" else "auto",
    )
    runtime = run.runtime
    if args.mesh == "auto":
        from repro_torch.launch.mesh import describe_resolution

        print(describe_resolution("auto", args.clients))
    batch_fn = run.batch_source()
    rounds = runtime.scheduler.rounds_for(args.steps)
    steps = runtime.scheduler.steps_for(args.steps)

    t0 = time.time()
    losses = []
    for s in range(1, steps + 1):
        ev = runtime.step(batch_fn)
        losses.append(float(ev.losses[-1]))
        if s % 5 == 0 or s == 1:
            print(f"superstep {s:4d} (iter {ev.iteration:4d}) "
                  f"loss={losses[-1]:.4f}  ({(time.time() - t0):.0f}s)")

    global_params = runtime.global_params()
    eval_loss, _ = runtime.evaluate(run.eval_batch)
    print(f"consensus model extracted; eval loss {eval_loss:.4f}; "
          f"{rounds} rounds in {time.time() - t0:.0f}s.")
    return {"rounds": rounds, "steps": steps, "losses": losses, "eval_loss": eval_loss,
            "global_params": global_params}


if __name__ == "__main__":
    main()
