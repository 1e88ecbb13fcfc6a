"""Launchers: the training and serving entry points and the client mesh.

``train.py`` is the training CLI (``python -m repro_torch.launch.train``: the
LM path on the round scheduler, or any named scenario), ``serve.py`` the
serving CLI, and ``mesh.py`` resolves a run's ``mesh`` field
(``None``/``"auto"``: no mesh on a host with fewer CUDA devices than
clients).  The reference's production meshes, ``dryrun.py`` and
``steps.py`` need process-group collectives and ``sharding/``, and are
queued under ROADMAP.md §1 item 4.
"""
