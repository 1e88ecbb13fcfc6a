"""Port parity: the collective aggregation path against the reference's.

* Operators: ``hypercube_cluster_allreduce`` and ``ring_gossip`` on the
  stacked client axis against the reference's per-device functions under
  ``jax.vmap(axis_name=...)`` (its ``lax.ppermute`` lowered to gathers), on
  numpy inputs from a seed: cluster sizes 1, 2, 4, D = 3, 4, 5 clusters,
  alpha 1-3, f32 and bf16 leaves, within 1e-6.  ``ring_mixing_weights``
  equals the reference's and refuses a chord alike.
* ``CollectiveBackend``: ``transition`` (local, intra, inter; static
  factors, participation weights, a faulted ``p``, both), ``intra_cluster``
  and ``inter_cluster`` against the reference's ``CollectiveBackend``
  without a mesh, within 1e-6; its constraints raise the reference's
  errors.
* Selection: ``collective_supported`` and ``select_auto_backend`` on every
  registered scenario, the legacy ``aggregation_impl``/``impl`` mapping,
  and ``launch.mesh``'s resolution (no mesh on a host with fewer devices
  than clients; a raise for what the port cannot honour).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
import repro.core.aggregation as jagg
import repro.core.backends as jbackends
import repro.core.topology as jtopo
import repro.scenarios as jscenarios
import repro_torch.core as tcore
import repro_torch.core.aggregation as tagg
import repro_torch.scenarios as tscenarios
from repro_torch.convert import params_to_numpy
from repro_torch.launch import mesh as tmesh

# six test workers share the host's cores: one intra-op thread each, also
# in the processes a test starts
os.environ.setdefault("OMP_NUM_THREADS", "1")
torch.set_num_threads(1)

ATOL = 1e-6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(c, d, seed=0):
    """(C, 3, 5) f32 leaves, (C,) weights and a ring P's stencil columns."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(c, 3, 5)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, c).astype(np.float32)
    ratios = rng.uniform(0.5, 2.0, d)
    p = jcore.mixing_matrix(jcore.ring(d), ratios / ratios.sum())
    return x, w, [s.astype(np.float32) for s in jagg.ring_mixing_weights(p)]


@pytest.mark.parametrize("d", [3, 4, 5])
@pytest.mark.parametrize("g", [1, 2, 4])
def test_operators_match_the_reference_under_vmap(g, d):
    """Both dtypes and alpha 1-3 at one layout, the reference in one program."""
    c, alphas = g * d, (1, 2, 3)
    x, w, (wl, ws, wr) = _inputs(c, d, seed=g * 10 + d)
    tw = [torch.from_numpy(v) for v in (wl, ws, wr)]

    def per_client(xi, wi):
        acc = jagg.hypercube_cluster_allreduce(xi, "clients", c, g, wi)
        return (acc,) + tuple(jagg.ring_gossip(acc, "clients", c, g, wl, ws, wr, a)
                              for a in alphas)

    def per_cluster(yd):
        return tuple(jagg.ring_gossip(yd, "clusters", d, 1, wl, ws, wr, a) for a in alphas)

    @jax.jit
    def reference(xs, wv):
        return [(jax.vmap(per_client, axis_name="clients")(xx, wv),
                 jax.vmap(per_cluster, axis_name="clusters")(xx[::g])) for xx in xs]

    dtypes = sorted(DTYPES)
    refs = reference([jnp.asarray(x).astype(DTYPES[n][0]) for n in dtypes], jnp.asarray(w))
    for name, ((ref_acc, *ref_y), ref_yd) in zip(dtypes, refs):
        tx = torch.from_numpy(x).to(DTYPES[name][1])
        acc = tagg.hypercube_cluster_allreduce(tx, g, torch.from_numpy(w))
        assert acc.dtype == torch.float32 and ref_acc.dtype == jnp.float32
        np.testing.assert_allclose(acc.numpy(), np.asarray(ref_acc), atol=ATOL, rtol=0,
                                   err_msg=name)
        for alpha, y_ref, yd_ref in zip(alphas, ref_y, ref_yd):
            y = tagg.ring_gossip(acc, g, *tw, alpha)
            np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=ATOL, rtol=0,
                                       err_msg=f"{name} alpha={alpha}")
            # the cluster models' own dtype (the async inter_cluster): a bf16
            # y is rounded once a round in both
            yd = tagg.ring_gossip(tx[::g].contiguous(), 1, *tw, alpha)
            assert yd.dtype == tx.dtype
            np.testing.assert_allclose(yd.float().numpy(), np.asarray(yd_ref, np.float32),
                                       atol=ATOL, rtol=0, err_msg=f"{name} alpha={alpha}")


def test_operators_refuse_what_the_reference_refuses():
    x, w = torch.zeros(6, 2), torch.ones(6)
    with pytest.raises(ValueError, match="must be a power of two"):
        tagg.hypercube_cluster_allreduce(x, 3, w)
    with pytest.raises(ValueError, match="must divide axis_size"):
        tagg.hypercube_cluster_allreduce(torch.zeros(6, 2), 4, w)
    with pytest.raises(ValueError, match=">= 2 clusters"):
        tagg.ring_gossip(x, 6, torch.ones(1), torch.ones(1), torch.ones(1), 1)


@pytest.mark.parametrize("d", [3, 4, 6])
def test_ring_mixing_weights_match_and_refuse_a_chord(d):
    rng = np.random.default_rng(d)
    ratios = rng.uniform(0.5, 2.0, d)
    p = jcore.mixing_matrix(jcore.ring(d), ratios / ratios.sum())
    for a, b in zip(tagg.ring_mixing_weights(p), jagg.ring_mixing_weights(p)):
        np.testing.assert_array_equal(a, b)
    chord = p.copy()
    chord[0, 2] = chord[2, 0] = 0.1  # support off the ring stencil
    if d > 3:
        for mod in (tagg, jagg):
            with pytest.raises(ValueError, match="outside the ring stencil"):
                mod.ring_mixing_weights(chord)
    star = jcore.mixing_matrix(jcore.star(d), ratios / ratios.sum())
    assert (d <= 3) == tcore.collective_supported(
        tcore.ClusterSpec.uniform(2 * d, d), star)


# -- the backend -------------------------------------------------------------

def _setup(c=8, d=4, alpha=2, seed=0, dtype="float32"):
    rng = np.random.default_rng(seed)
    sizes = tuple(rng.uniform(0.5, 2.0, c))
    assign = tuple(i // (c // d) for i in range(c))
    jcl, tcl = jcore.ClusterSpec(c, assign, sizes), tcore.ClusterSpec(c, assign, sizes)
    p = jcore.mixing_matrix(jcore.ring(d), jcl.m_tilde())
    tree = {"w": rng.normal(size=(c, 3, 5)).astype(np.float32),
            "b": rng.normal(size=(c, 7)).astype(np.float32)}
    mask = rng.uniform(size=c) > 0.3
    mask[:: c // d] = True  # no empty cluster
    w = np.where(mask, np.asarray(sizes), 0.0)
    totals = np.zeros(d)
    np.add.at(totals, list(assign), w)
    weights = (w / totals[list(assign)]).astype(np.float32)
    # a faulted matrix still on the ring stencil: link (0, d-1) down
    p_fault = jcore.mixing_matrix(jcore.chain(d), jcl.m_tilde()).astype(np.float32)
    jt = {k: jnp.asarray(v).astype(DTYPES[dtype][0]) for k, v in tree.items()}
    tt = {k: torch.from_numpy(v).to(DTYPES[dtype][1]) for k, v in tree.items()}
    return jcl, tcl, p, alpha, jt, tt, weights, p_fault


def _close(out, ref, atol=ATOL):
    for k, v in params_to_numpy(out).items():
        np.testing.assert_allclose(v, np.asarray(ref[k], np.float32), atol=atol, rtol=0,
                                   err_msg=k)


@pytest.mark.parametrize("c,d", [(8, 4), (16, 4), (12, 3)])
@pytest.mark.parametrize("event", ["local", "intra", "inter"])
@pytest.mark.parametrize("operands", ["static", "weights", "p", "weights+p"])
def test_transition_matches_the_reference_collective(c, d, event, operands):
    jcl, tcl, p, alpha, jt, tt, weights, p_fault = _setup(c, d)
    kw = {}
    if "weights" in operands:
        kw["weights"] = weights
    if operands.endswith("p"):
        kw["p"] = p_fault
    ref = jcore.CollectiveBackend(jcl, p, alpha).transition(
        jt, event, **{k: jnp.asarray(v) for k, v in kw.items()})
    be = tcore.resolve_backend("collective", tcl, p, alpha, device="cpu")
    assert be.name == "collective" and be.mesh is None
    out = be.transition(tt, event, **{k: torch.from_numpy(v) for k, v in kw.items()})
    if event == "local":
        assert out is tt
    _close(out, ref)


def test_bf16_transition_and_factors_match_the_reference():
    jcl, tcl, p, alpha, jt, tt, weights, p_fault = _setup(dtype="bfloat16")
    jb = jcore.CollectiveBackend(jcl, p, alpha)
    tb = tcore.CollectiveBackend(tcl, p, alpha, device="cpu")
    for event in ("intra", "inter"):
        out = tb.transition(tt, event, weights=torch.from_numpy(weights))
        assert all(v.dtype == torch.bfloat16 for v in out.values())
        _close(out, jb.transition(jt, event, weights=jnp.asarray(weights)))
    y = tb.intra_cluster(tt, torch.from_numpy(weights))
    y_ref = jb.intra_cluster(jt, jnp.asarray(weights))
    _close(y, y_ref)
    _close(tb.inter_cluster(y, p_fault, alpha=3), jb.inter_cluster(y_ref, p_fault, alpha=3))


@pytest.mark.parametrize("alpha", [1, 3])
def test_factors_match_the_reference(alpha):
    jcl, tcl, p, _, jt, tt, weights, p_fault = _setup()
    jb = jcore.CollectiveBackend(jcl, p, 2)
    tb = tcore.CollectiveBackend(tcl, p, 2, device="cpu")
    y_ref = jb.intra_cluster(jt, jnp.asarray(weights))
    y = tb.intra_cluster(tt, torch.from_numpy(weights))
    for k, v in y.items():
        assert v.shape == (jcl.num_clusters,) + tuple(tt[k].shape[1:]) and v.is_contiguous()
    _close(y, y_ref)
    for mix in (p, p_fault):
        # P as the host gives it (numpy) and as a device tensor
        out = tb.inter_cluster(y, mix, alpha=alpha)
        _close(out, jb.inter_cluster(y_ref, mix, alpha=alpha))
        _close(tb.inter_cluster(y, torch.tensor(mix, dtype=torch.float32), alpha=alpha), out, 0)
    chord = np.asarray(p).copy()
    chord[0, 2] = chord[2, 0] = 0.1
    for b, yy in ((tb, y), (jb, y_ref)):
        with pytest.raises(ValueError, match="outside the ring stencil"):
            b.inter_cluster(yy, chord, alpha=1)


def test_collective_constraints_raise_the_reference_errors():
    ring8 = jcore.mixing_matrix(jcore.ring(4), np.full(4, 0.25))
    cases = [
        (tcore.ClusterSpec(5, (0, 0, 1, 1, 1), (1.0,) * 5), np.eye(2), "contiguous uniform"),
        (tcore.ClusterSpec.uniform(12, 4), ring8, "power-of-two cluster sizes"),
        (tcore.ClusterSpec.uniform(4, 2), np.full((2, 2), 0.5), ">= 3 clusters"),
        (tcore.ClusterSpec.uniform(8, 4), jcore.mixing_matrix(jcore.star(4), np.full(4, .25)),
         "outside the ring stencil"),
    ]
    for spec, p, msg in cases:
        with pytest.raises(ValueError, match=msg):
            tcore.CollectiveBackend(spec, p, 1, device="cpu")
        jspec = jcore.ClusterSpec(spec.num_clients, spec.assignments, spec.data_sizes)
        with pytest.raises(ValueError, match=msg):
            jcore.CollectiveBackend(jspec, p, 1)
    with pytest.raises(ValueError, match="a launch.mesh.ClientMesh"):
        tcore.CollectiveBackend(tcore.ClusterSpec.uniform(8, 4), ring8, 1, device="cpu",
                                mesh=object())


# -- selection ----------------------------------------------------------------

@pytest.mark.parametrize("name", [s.name for s in tscenarios.list_scenarios()])
def test_supported_and_auto_on_every_scenario(name):
    tsc, jsc = tscenarios.get_scenario(name), jscenarios.get_scenario(name)
    c, d = tsc.num_clients, tsc.num_clusters
    assert (c, d, tsc.topology) == (jsc.num_clients, jsc.num_clusters, jsc.topology)
    # the constraints read the layout and P's support only, which the
    # scenario's topology fixes whatever its data sizes
    rng = np.random.default_rng(0)
    sizes = tuple(rng.uniform(0.5, 2.0, c)) if c <= 1000 else (1.0,) * c
    assign = tuple(i * d // c for i in range(c))
    tcl, jcl = tcore.ClusterSpec(c, assign, sizes), jcore.ClusterSpec(c, assign, sizes)
    p = jcore.mixing_matrix(jtopo.TOPOLOGIES[tsc.topology](d), jcl.m_tilde())
    ok = tcore.collective_supported(tcl, p)
    assert ok == jbackends.collective_supported(jcl, p)
    # no mesh: the CPU picks dense as the reference's CPU does, the card the
    # kernels where the reference's TPU picks its kernels
    assert tcore.select_auto_backend(tcl, "cpu", p) == jcore.select_auto_backend(jcl, p)
    assert (tcore.select_auto_backend(tcl, "cuda", p) == "cuda") == (
        tcore.backends._uniform_contiguous(tcl))
    # a client mesh picks collective exactly where it is supported
    with_mesh = tcore.select_auto_backend(tcl, "cpu", p, mesh="a mesh")
    assert (with_mesh == "collective") == ok


def test_legacy_impl_mapping_and_auto():
    def backend(**kw):
        cfg = {"scenario": "mnist-iid-ring", "num_samples": 200, "backend": None, **kw}
        return tcore.make_run(cfg, device="cpu").scheduler.backend.name

    assert backend(num_clients=8) == "dense"  # auto on the CPU: the default path
    assert backend(num_clients=8, aggregation_impl="gossip") == "collective"
    assert backend(aggregation_impl="gossip") == "dense"  # C = 20: g = 5 degrades
    assert backend(num_clients=8, aggregation_impl="pallas") == "cuda"
    rt = tcore.make_run({"scenario": "round-compiled-ring", "num_samples": 200, "backend": None,
                         "impl": "gossip", "mesh": "auto"}, device="cpu")
    assert rt.scheduler.backend.name == "collective" and rt.scheduler.mesh is None
    rt = tcore.make_run({"scenario": "mnist-noniid-star", "num_samples": 200, "backend": None,
                         "num_clients": 8, "aggregation_impl": "gossip"}, device="cpu")
    assert rt.scheduler.backend.name == "dense"  # a star is off the ring stencil
    with pytest.raises(ValueError, match="power-of-two"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 200,
                        "backend": "collective"}, device="cpu")


def test_mesh_resolution():
    n = torch.cuda.device_count()
    assert tmesh.resolve_client_mesh(None, 8) is None
    assert tmesh.resolve_client_mesh("auto", n + 1) is None
    assert tmesh.resolve_cluster_mesh("auto", n + 1) is None
    assert "resolved to none" in tmesh.describe_resolution("auto", n + 1)
    # a device a client without a process group: one process a client is
    # the launcher's to start, and the error names it
    with pytest.raises(ValueError, match="torchrun --nproc-per-node"):
        tmesh.resolve_client_mesh("auto", n)
    with pytest.raises(ValueError, match="mesh must be None, 'auto', or a ClientMesh"):
        tmesh.resolve_client_mesh(object(), 8)
    with pytest.raises(ValueError, match="mesh must be None, 'auto'"):
        tmesh.resolve_client_mesh("data", 8)
    with pytest.raises(ValueError, match="exec.mesh must be None, 'auto', or a ClientMesh"):
        tcore.make_run({"scenario": "mnist-iid-ring", "num_samples": 200,
                        "mesh": object()}, device="cpu")
