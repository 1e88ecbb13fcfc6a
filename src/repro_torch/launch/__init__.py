"""Launchers: the meshes, the step builders, the dry run, the training and serving entry points.

``mesh.py`` holds the client mesh over ``torch.distributed`` and the
resolution of a run's ``mesh`` field, the test mesh (a ``DeviceMesh`` over
the initialized group) and the production mesh (over a fake group);
``steps.py`` the step builders (``default_fl_spec``, ``build_train``,
``build_prefill``, ``build_serve``) on a ``DeviceMesh``; ``dryrun.py`` the
dry run (``python -m repro_torch.launch.dryrun``: one rank's step of each
arch and shape traced on the production mesh, with its roofline terms);
``train.py`` the training CLI (``python -m repro_torch.launch.train``: the
LM path on the round scheduler, or any named scenario; under ``torchrun``
with ``--mesh auto`` one client a rank) and ``serve.py`` the serving CLI
(under ``torchrun`` with ``--mesh auto`` one cluster replica a rank).
"""
from .mesh import make_production_mesh, make_test_mesh, mesh_axes_for
from .steps import build_prefill, build_serve, build_train, default_fl_spec

__all__ = ["make_test_mesh", "make_production_mesh", "mesh_axes_for", "default_fl_spec",
           "build_train", "build_prefill", "build_serve"]
