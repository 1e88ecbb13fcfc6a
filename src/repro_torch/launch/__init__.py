"""Launchers: the serving driver (``launch.serve``).

The reference's production meshes, dry run and training drivers
(``mesh.py``, ``dryrun.py``, ``train.py``, ``steps.py``) are multi-device and
are queued under ROADMAP.md queue 1, 'Multi-device and launch'.
"""
