"""The port's counterparts of the reference's example scripts.

Each runs as ``python -m repro_torch.examples.<name>`` (``--device cuda`` by
default, ``--device cpu`` at a small size) and is a ``main(argv)`` the tests
call: ``quickstart`` (the paper's §V-A MNIST run, sync), ``async_heterogeneous``
(Fig. 10: sync against vanilla and staleness-aware async at gap H),
``train_federated_lm`` (federated LM training on ``federated-lm-ring``), and
the serving examples ``serve_batched`` (``BatchServer``), ``serve_decode``
(``generate`` on a reduced family) and ``serve_federated`` (train, serve the
clusters' models, hot swap).
"""
