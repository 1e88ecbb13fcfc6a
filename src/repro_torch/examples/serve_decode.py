"""Batched decode serving of the architectures (reduced configs).

    PYTHONPATH=src python -m repro_torch.examples.serve_decode [--arch mixtral-8x7b] [--device cpu]

The port's ``examples/serve_decode.py``: prefill a batch of prompts, then
decode autoregressively through the ring-buffer KV and SSM caches,
including sliding-window eviction (mixtral), local/global alternation
(gemma2) and O(1) recurrent state (mamba2).
"""
from __future__ import annotations

import argparse
import time


def main(argv=None):
    from repro_torch.configs import ARCH_NAMES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b", choices=ARCH_NAMES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=128)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import resolve_device
    from repro_torch.launch.serve import generate
    from repro_torch.models import CausalLM

    device = resolve_device(args.device)
    cfg = get_config(args.arch).reduced()
    model = CausalLM(cfg)
    params = {k: v.to(device) for k, v in model.init(torch.Generator().manual_seed(0)).items()}
    rng = np.random.default_rng(0)
    shape = ((args.batch, cfg.num_codebooks, args.prompt_len)
             if cfg.modality == "audio" and cfg.num_codebooks > 1
             else (args.batch, args.prompt_len))
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, shape)).to(device)
    t0 = time.time()
    out = generate(model, params, prompts, args.gen, temperature=args.temperature).cpu()
    dt = time.time() - t0
    print(f"{args.arch}: generated {out.numel()} tokens in {dt:.2f}s on {device} "
          f"({out.numel() / dt:.1f} tok/s, kernel builds included)")
    print("first sequence:", out.reshape(out.shape[0], -1)[0, :16].tolist())
    return out


if __name__ == "__main__":
    main()
