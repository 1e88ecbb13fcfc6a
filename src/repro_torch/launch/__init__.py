"""Launchers: the training and serving entry points and the client mesh.

``train.py`` is the training CLI (``python -m repro_torch.launch.train``: the
LM path on the round scheduler, or any named scenario; under ``torchrun``
with ``--mesh auto`` one client a rank), ``serve.py`` the serving CLI, and
``mesh.py`` the client mesh over ``torch.distributed`` and the resolution
of a run's ``mesh`` field.  The reference's production meshes, ``dryrun.py``
and ``steps.py`` are queued under ROADMAP.md §1 item 4 ('steps', 'dryrun').
"""
