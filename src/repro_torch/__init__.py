"""SD-FEEL in PyTorch and CUDA: the port of the JAX package ``repro``.

Imports ``torch`` and numpy only — never JAX, never ``repro``.  Entry
points (``core.make_run``, ``scenarios.build_scenario``,
``core.FederationRuntime``) run on the GPU unless given ``device="cpu"``;
the hand-written CUDA kernels live under ``kernels/``.
"""
