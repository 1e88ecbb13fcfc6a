"""Port parity: ``launch.train --mesh auto --device cpu`` under torchrun's
environment variables, 8 ``gloo`` ranks started from this file with a
timeout on each (the launcher of ``tests/test_torch_mesh.py``).

* From scratch: rank 0 prints the one-process run's losses, the others
  print nothing, and rank 0 writes the gathered ``(C, ...)`` stack as one
  process writes its own.
* ``--resume`` from a one-process checkpoint: each rank restores its own
  row, and rank 0 prints and writes what the one-process resume does.
"""
import os
import shutil
import sys

import numpy as np
import torch

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

# the rank processes' launcher: tests/ is on the path under pytest
from test_torch_mesh import C, D, _env, _free_port, _join, _start  # noqa: E402

TRAIN_ARGS = ["--device", "cpu", "--arch", "qwen2.5-3b", "--tau1", "1", "--seq", "16",
              "--batch", "1", "--clients", str(C), "--clusters", str(D),
              "--backend", "collective", "--log-every", "1", "--save-every", "2"]


def _train_on_mesh(tmp_path, capsys, mesh_args: list, one_args: list) -> tuple:
    """``launch.train`` on 8 ranks under torchrun's variables with
    ``mesh_args``, and in this process with ``one_args`` while they run:
    (the ranks' logs, the one-process run's printed lines)."""
    import repro_torch.launch.train as ttrain

    port = _free_port()
    argv = [sys.executable, "-m", "repro_torch.launch.train", *TRAIN_ARGS, "--mesh", "auto",
            *mesh_args]
    envs = [_env(RANK=str(r), WORLD_SIZE=str(C), LOCAL_RANK=str(r), MASTER_ADDR="127.0.0.1",
                 MASTER_PORT=str(port)) for r in range(C)]
    procs = _start([argv] * C, envs, tmp_path)
    try:
        ttrain.main(TRAIN_ARGS + one_args)
    finally:
        logs = _join(procs, tmp_path)
    return logs, capsys.readouterr().out.splitlines()


def _losses(lines) -> list:
    return [ln.split("loss=")[1].split()[0] for ln in lines if ln.startswith("round ")]


def _same_checkpoints(mesh_dir, one_dir, steps) -> None:
    for step in steps:
        files = sorted(p.name for p in (one_dir / step).iterdir())
        assert sorted(p.name for p in (mesh_dir / step).iterdir()) == files
        for f in files:
            if f.endswith(".npy"):
                np.testing.assert_allclose(np.load(mesh_dir / step / f),
                                           np.load(one_dir / step / f), atol=1e-6,
                                           err_msg=f"{step}/{f}")


def test_launch_train_under_torchrun(tmp_path, capsys):
    saved = {"mesh": tmp_path / "ck_mesh", "one": tmp_path / "ck_one"}
    logs, one = _train_on_mesh(tmp_path, capsys,
                               ["--steps", "4", "--save-dir", str(saved["mesh"])],
                               ["--steps", "4", "--save-dir", str(saved["one"])])
    ranked = logs[0].splitlines()
    assert len(_losses(one)) == 4 and _losses(ranked) == _losses(one)
    assert "resolved to a client mesh: 8 ranks over gloo" in logs[0]
    # the other ranks print nothing of the run
    for log in logs[1:]:
        assert not [ln for ln in log.splitlines()
                    if ln.startswith(("round ", "arch=", "mesh=", "done"))], log
    # rank 0 wrote the gathered (C, ...) stack, as one process writes its own
    _same_checkpoints(saved["mesh"], saved["one"], ("step_00000002", "step_00000004"))


def test_launch_train_resumes_on_a_mesh(tmp_path, capsys):
    import repro_torch.launch.train as ttrain

    saved = {"mesh": tmp_path / "ck_mesh", "one": tmp_path / "ck_one"}
    # two rounds in one process, the checkpoint both resumes start from
    ttrain.main(TRAIN_ARGS + ["--steps", "2", "--save-dir", str(saved["one"])])
    capsys.readouterr()
    shutil.copytree(saved["one"], saved["mesh"])
    resume = ["--steps", "4", "--resume"]
    logs, one = _train_on_mesh(tmp_path, capsys, resume + ["--save-dir", str(saved["mesh"])],
                               resume + ["--save-dir", str(saved["one"])])
    assert "resumed from round 2" in logs[0] and "resumed from round 2" in "\n".join(one)
    assert len(_losses(one)) == 2 and _losses(logs[0].splitlines()) == _losses(one)
    _same_checkpoints(saved["mesh"], saved["one"], ("step_00000004",))
