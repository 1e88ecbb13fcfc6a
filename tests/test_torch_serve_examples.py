"""The serving driver and examples on the CPU: ``repro_torch.launch.serve.main``
(``generate`` on a reduced model, and a serving scenario through the slot
pool), ``examples.serve_batched``, ``serve_decode`` (musicgen's codebooks)
and ``serve_federated`` (train, serve, hot swap) at tiny sizes; ``--mesh``
and the CUDA default without a card raise."""
import os

import pytest
import torch

from repro_torch.launch import serve as tserve

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)


def test_serve_main_and_examples_on_cpu(capsys):
    from repro_torch.examples import serve_batched, serve_decode, serve_federated

    out = tserve.main(["--device", "cpu", "--batch", "2", "--prompt-len", "16", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    srv = tserve.main(["--device", "cpu", "--scenario", "lm-serving-continuous",
                       "--train-steps", "1", "--continuous", "--requests", "4", "--gen", "3"])
    assert srv.stats.requests == 4 and srv.compile_counts()["decode"] == 1
    srv, done = serve_batched.main(["--device", "cpu", "--requests", "3", "--gen", "3"])
    assert len(done) == 3 and srv.stats.requests == 3
    out = serve_decode.main(["--device", "cpu", "--arch", "musicgen-large", "--batch", "2",
                             "--prompt-len", "8", "--gen", "3"])
    assert tuple(out.shape) == (2, 3, 4)
    res = serve_federated.main(["--device", "cpu", "--train-steps", "1", "--requests", "6",
                                "--gen", "3"])
    assert res["phase2"].swaps == 1 and res["phase2"].stats.requests == 6
    assert "hot swap" in capsys.readouterr().out


def test_serve_refuses_mesh_and_a_missing_card():
    # a mesh the cluster-mesh rules cannot honour, and --mesh off the
    # continuous scenario server, raise (mesh serving runs in
    # tests/test_torch_serving_mesh.py)
    with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
        tserve.serve_scenario("lm-serving-continuous", mesh="everywhere", continuous=True,
                              train_steps=0, device="cpu")
    with pytest.raises(ValueError, match="--continuous"):
        tserve.main(["--device", "cpu", "--mesh", "auto"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tserve.main(["--gen", "2"])
