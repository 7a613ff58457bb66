"""The port's APPNP serving path against the JAX package: the same graph
and features, the JAX parameters carried over with ``params_from_jax``.

Clean-forward logits: rtol=1e-4, atol=1e-5 (float32; ten propagation steps
accumulate the rounding of sums taken in another order).  ``predict`` and
``evaluate`` must be equal.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import random_power_law_edges, synthetic_planetoid
from _jax_budget import release_jax_layout_caches  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _setup(kind):
    if kind == "small":
        G, labels, features, *_ = synthetic_planetoid(
            n_nodes=300, n_classes=4, n_features=24, avg_degree=6.0, seed=3)
        return (gt.graph2adj(G), tt.graph2adj(G, device="cpu"), features,
                labels, 4)
    # >= 65,536 edges: the dispatcher takes PreparedSpMM (hub slice + ELL)
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    rng = np.random.RandomState(1)
    features = rng.randn(n, 32).astype(np.float32)
    labels = rng.randint(0, 6, size=n)
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu"),
            features, labels, 6)


def _pair(kind, **kw):
    jg, pg, features, labels, c = _setup(kind)
    jm = gt.APPNP(jg, features, num_classes=c, **kw)
    jm.reset(seed=0)
    pm = tt.APPNP(pg, features, num_classes=c, device="cpu", **kw)
    tt.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, pm)
    return jm, pm, labels


@pytest.mark.parametrize("kind", ["small", "large"])
@pytest.mark.parametrize("kw", [{}, {"a": None, "latent_dims": (16, 8)}],
                         ids=["defaults", "learnable_restart"])
def test_clean_forward_matches_jax(kind, kw):
    jm, pm, labels = _pair(kind, **kw)
    if kw.get("a", 0.1) is None:  # give the learnable restart a real value
        with torch.no_grad():
            pm.params[pm.param_specs[-1].name].fill_(0.2)
        jm.params = dict(jm.params)
        jm.params[jm.param_specs[-1].name] = np.full((1, 1), 0.2, np.float32)
        jm._act_cache = None
    ref = np.asarray(jm._activations())
    out = pm._activations()
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("kind", ["small", "large"])
def test_predict_and_evaluate_match_jax(kind):
    jm, pm, labels = _pair(kind)
    nodes = np.random.RandomState(9).permutation(len(labels))[:200]
    jtask = gt.NodeClassification(nodes, labels[nodes])
    ptask = tt.NodeClassification(nodes, labels[nodes])
    np.testing.assert_array_equal(pm.predict(ptask).numpy(),
                                  np.asarray(jm.predict(jtask)))
    assert float(pm.evaluate(ptask)) == float(jm.evaluate(jtask))
    np.testing.assert_allclose(float(pm.loss(ptask)), float(jm.loss(jtask)),
                               rtol=1e-5)


def test_adjacency_and_operator_built_once():
    _, pm, _ = _pair("large")
    pm._activations()
    assert list(pm._adjacency) == [("symmetric", "none", "auto")]
    graph, op = pm._adjacency[("symmetric", "none", "auto")]
    assert isinstance(op, tt.ops.PreparedSpMM)
    assert pm.adjacency() is graph and pm.operator(graph) is op


def test_params_from_jax_rejects_mismatch():
    jm, pm, _ = _pair("small")
    good = {k: np.asarray(v) for k, v in jm.params.items()}
    before = {k: v.detach().clone() for k, v in pm.params.items()}
    wrong_name = dict(good)
    wrong_name["q0"] = wrong_name.pop("p0")
    wrong_shape = dict(good)
    wrong_shape["p2"] = good["p2"].T
    missing = dict(good)
    del missing["p3"]
    for bad in (wrong_name, wrong_shape, missing):
        with pytest.raises(ValueError):
            tt.params_from_jax(bad, pm)
    for k, v in pm.params.items():  # nothing was copied
        assert torch.equal(v, before[k])


def test_reset_is_seeded_and_drops_the_cache():
    _, pm, _ = _pair("small")
    pm.reset(seed=1)
    a = pm._activations()
    assert pm._activations() is a
    first = {k: v.detach().clone() for k, v in pm.params.items()}
    pm.reset(seed=1)
    for k, v in pm.params.items():
        assert torch.equal(v, first[k])
    assert pm._activations() is not a


def test_training_mode_dropout_raises():
    """A training forward draws dropout, so it needs the step's generator."""
    _, pm, _ = _pair("small")
    with pytest.raises(ValueError, match="generator"):
        pm.forward(pm.features, training=True)
