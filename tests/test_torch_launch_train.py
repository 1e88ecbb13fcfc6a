"""Port parity: the training CLI (``repro_torch.launch.train``) and the
round engine on the collective backend.

* ``--scenario list`` names the reference's scenarios, in its order.
* ``federated-lm-ring`` with ``backend=None, impl="gossip"`` (the legacy
  field, mapped to the collective backend) against the reference's, from
  the reference's initial models: one round of 4 iterations (tau1 = tau2
  = 2) at a reduced size (one layer, d_model 64, vocab 128, S = 16),
  parameters and losses within 1e-4.
* The LM path through ``main``: the reference's ``main`` writes a
  checkpoint (``--save-dir``); both ``main``s ``--resume`` from copies of it
  (the port on ``--device cpu``) and train one more round, and their
  consensus parameters agree within 1e-4.  The shared checkpoint carries the
  reference's ``jax.random`` initialization over.
* ``--scenario mnist-noniid-ring`` and ``--backend collective --mesh auto``
  run on the CPU and print how the mesh resolved.
"""
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import repro.launch.train as jtrain
import repro.scenarios as jscenarios
import repro_torch.launch.train as ttrain
import repro_torch.scenarios as tscenarios
from repro_torch.convert import flatten_params, params_from_numpy, params_to_numpy

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

LM_SMALL = dict(arch_overrides=dict(d_model=64, d_ff=128, num_layers=1), seq_len=16,
                num_samples=64, vocab_size=128, rounds_per_step=1)
# the LM path at a tiny size: 4 clients in 2 clusters, one iteration a round
LM_ARGS = ["--arch", "granite-8b", "--tau1", "1", "--clients", "4", "--clusters", "2",
           "--seq", "16", "--batch", "1"]


def _flat(tree):
    return flatten_params(jax.tree.map(np.asarray, tree))


def test_scenario_list_names_the_reference_scenarios(capsys):
    assert ttrain.main(["--scenario", "list", "--device", "cpu"]) is None
    names = [line.split()[0] for line in capsys.readouterr().out.strip().splitlines()]
    assert names == [s.name for s in jscenarios.list_scenarios()]


def test_round_engine_gossip_tracks_jax():
    kw = dict(LM_SMALL, backend=None, impl="gossip")
    jrun = jscenarios.build_scenario("federated-lm-ring", **kw)
    assert jrun.runtime.scheduler.backend.name == "collective"
    init = _flat(jrun.runtime.scheduler.params)
    ref_losses = np.asarray(jrun.runtime.step(jrun.batch_source()).losses)
    trun = tscenarios.build_scenario("federated-lm-ring", device="cpu", **kw)
    sched = trun.runtime.scheduler
    assert sched.backend.name == "collective" and sched.iterations_per_step == 4
    sched.params = params_from_numpy(init, "cpu")
    ev = trun.runtime.step(trun.batch_source())
    np.testing.assert_allclose(ev.losses.numpy(), ref_losses, atol=1e-4, rtol=0)
    ref = _flat(jrun.runtime.scheduler.params)
    for k, v in params_to_numpy(sched.params).items():
        np.testing.assert_allclose(v, ref[k], atol=1e-4, rtol=0, err_msg=k)


def test_lm_path_resumes_the_reference_checkpoint(tmp_path, capsys):
    ck = tmp_path / "ref"
    jtrain.main(LM_ARGS + ["--steps", "1", "--save-dir", str(ck), "--save-every", "1"])
    shutil.copytree(ck, tmp_path / "jax")
    shutil.copytree(ck, tmp_path / "torch")
    capsys.readouterr()
    resume = LM_ARGS + ["--steps", "2", "--resume", "--save-every", "100"]
    ref = _flat(jtrain.main(resume + ["--save-dir", str(tmp_path / "jax")]))
    jout = capsys.readouterr().out
    got = ttrain.main(resume + ["--save-dir", str(tmp_path / "torch"), "--device", "cpu"])
    tout = capsys.readouterr().out
    for out in (jout, tout):
        assert "resumed from round 1" in out and "round    2 (iter     2)" in out
    # the printed lines are the reference's, the loss within 1e-4
    lines = [[line for line in out.splitlines() if line.startswith(("arch=", "round"))]
             for out in (jout, tout)]
    assert lines[0][0] == lines[1][0]
    assert abs(float(lines[0][1].split("loss=")[1].split()[0])
               - float(lines[1][1].split("loss=")[1].split()[0])) <= 1e-4
    assert set(got) == set(ref)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_allclose(v.numpy(), ref[k], atol=1e-4, rtol=0, err_msg=k)


def test_scenarios_and_mesh_through_main(capsys):
    out = ttrain.main(["--scenario", "mnist-noniid-ring", "--steps", "4", "--samples", "400",
                       "--clients", "8", "--device", "cpu"])
    assert all(bool(torch.isfinite(v).all()) for v in out.values())
    text = capsys.readouterr().out
    assert "scenario=mnist-noniid-ring scheduler=sync" in text and "done: steps=4" in text
    ttrain.main(["--scenario", "mnist-noniid-ring", "--steps", "2", "--samples", "400",
                 "--clients", "8", "--backend", "collective", "--mesh", "auto",
                 "--device", "cpu"])
    assert "mesh=auto resolved to none" in capsys.readouterr().out
    with pytest.raises(ValueError, match="power-of-two"):
        ttrain.main(["--scenario", "mnist-noniid-ring", "--steps", "2", "--samples", "400",
                     "--backend", "collective", "--device", "cpu"])
    with pytest.raises(TypeError, match="unused scenario keys"):  # as the reference's
        ttrain.main(["--scenario", "straggler-bimodal-async", "--mesh", "auto",
                     "--device", "cpu"])
    if not torch.cuda.is_available():  # the default device is the card: no fallback
        for argv in (["--scenario", "mnist-noniid-ring"], LM_ARGS):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                ttrain.main(argv + ["--steps", "1"])
