"""Launchers: the meshes, the step builders, the training and serving entry points.

``mesh.py`` holds the client mesh over ``torch.distributed`` and the
resolution of a run's ``mesh`` field, and the test mesh (a ``DeviceMesh``
over the initialized group); ``steps.py`` the step builders
(``default_fl_spec``, ``build_train``, ``build_prefill``, ``build_serve``)
on a ``DeviceMesh``; ``train.py`` the training CLI (``python -m
repro_torch.launch.train``: the LM path on the round scheduler, or any named
scenario; under ``torchrun`` with ``--mesh auto`` one client a rank) and
``serve.py`` the serving CLI.  The reference's ``make_production_mesh`` and
``dryrun.py`` are queued under ROADMAP.md §1 item 4 ('dryrun').
"""
from .mesh import make_test_mesh, mesh_axes_for
from .steps import build_prefill, build_serve, build_train, default_fl_spec

__all__ = ["make_test_mesh", "mesh_axes_for", "default_fl_spec", "build_train",
           "build_prefill", "build_serve"]
