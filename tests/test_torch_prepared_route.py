"""The prepared operator's route under ``auto`` (``PreparedSpMM`` without
a hub slice: K1's scaled walk over every live slot of the ELL, the scales
and identity applied in its gathers and its store) against the JAX
package's ``PreparedSpMM``, which takes a hub slice on these graphs.

Tolerance rtol=1e-5, atol=1e-5 for one product and its ``dx``: float32 on
both sides, the port summing a row's slots in one walk where JAX sums the
rest ELL and adds the hub matmul.  The models (APPNP's forward, GCNII's
steps): rtol=1e-4, atol=1e-5, as ``test_torch_models.py`` holds them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import random_power_law_edges
from gnntf_tpu.ops import normalize_adjacency as jax_normalize
from gnntf_tpu.ops.spmm import PreparedSpMM as JaxPreparedSpMM
from gnntf_tpu.ops.spmm import spmm as jax_spmm
from gnntf_tpu_torch.ops import normalize_adjacency, prepare
from gnntf_tpu_torch.ops.spmm import PreparedSpMM, _per_call, spmm_ell
from _jax_budget import release_jax_layout_caches  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-5)


def _edges(kind):
    """``power_law``: 36,000 edges (72,000 counted, >= 65,536), on which
    JAX builds a hub slice; ``dup_split``: the same with every tenth edge
    repeated and node 7 joined to 2,500 random nodes (one row over many
    of the walk's units)."""
    n = 4000
    src, dst = random_power_law_edges(n, 36_000, seed=21)
    if kind == "dup_split":
        rng = np.random.RandomState(22)
        src = np.concatenate([src, src[::10], np.full(2500, 7)])
        dst = np.concatenate([dst, dst[::10], rng.randint(0, n, 2500)])
    vals = np.random.RandomState(23).rand(len(src)) + 0.5
    return n, src, dst, vals


def _pair(kind, normalized="symmetric", add_eye="none"):
    n, src, dst, vals = _edges(kind)
    kw = dict(n_nodes=n, directed=False)
    jg = jax_normalize(gt.from_edges(src, dst, vals, **kw),
                       graph_dropout=0.0, normalized=normalized,
                       add_eye=add_eye)
    pg = normalize_adjacency(tt.from_edges(src, dst, vals, device="cpu",
                                           **kw),
                             graph_dropout=0.0, normalized=normalized,
                             add_eye=add_eye)
    return jg, pg


CASES = [("power_law", "symmetric", "none"),
         ("power_law", "none", "after"),
         ("dup_split", "symmetric", "after"),
         ("dup_split", "bipartite", "none")]


def test_auto_builds_no_hub_slice():
    """``prepare`` under ``auto`` at >= 65,536 edges: no hub slice, the
    whole list (every row, no row ids), the scales kept for the walk;
    ``hybrid`` still builds the JAX package's hub slice."""
    jg, pg = _pair("power_law")
    assert pg.n_edges >= 65_536
    assert JaxPreparedSpMM(jg).dense is not None
    op = prepare(pg)
    assert isinstance(op, PreparedSpMM) and not op.hubs
    assert op.dense is None and op.hub_ids is None
    assert op.k1_list.rows is None and op.k1_list.n_rows == pg.n_nodes
    hybrid = prepare(pg, "hybrid")
    assert hybrid.hubs and hybrid.dense is not None
    assert hybrid.k1_list.rows is not None
    assert op.k1_list.n_edges > hybrid.k1_list.n_edges


@pytest.mark.parametrize("f", [13, 40])
@pytest.mark.parametrize("case", CASES)
def test_auto_forward_matches_jax(case, f):
    jg, pg = _pair(*case)
    x = np.random.RandomState(f).randn(jg.n_nodes, f).astype(np.float32)
    jp, pp = JaxPreparedSpMM(jg), prepare(pg)
    assert not pp.hubs
    if case[0] == "dup_split":
        split = pp.k1_list.split.numpy()
        assert len(split) and split[:, 2].max() > 10
    np.testing.assert_allclose(pp(torch.from_numpy(x)).numpy(),
                               np.asarray(jp(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("case", CASES)
def test_auto_gradient_matches_jax(case):
    """``dx`` of the ``auto`` operator (one walk over the whole list's
    transposed list, the scales and identity around it) against
    ``jax.vjp`` of JAX's ``PreparedSpMM``."""
    jg, pg = _pair(*case)
    rng = np.random.RandomState(5)
    x = rng.randn(jg.n_nodes, 13).astype(np.float32)
    dy = rng.randn(jg.n_nodes, 13).astype(np.float32)
    _, vjp = jax.vjp(JaxPreparedSpMM(jg), jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    pp = prepare(pg)
    xt = torch.from_numpy(x).requires_grad_()
    pp(xt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), **TOL)


def test_per_call_auto_walks_every_edge():
    """``_per_call("auto")`` at >= 65,536 edges (values routed per call,
    as for a realized draw) is ``spmm_ell``: K1 over the whole ELL, no hub
    slice, allclose to JAX's dispatcher."""
    jg, pg = _pair("dup_split", add_eye="after")
    x = np.random.RandomState(9).randn(jg.n_nodes, 8).astype(np.float32)
    xt = torch.from_numpy(x)
    out = _per_call("auto", pg, xt)
    assert torch.equal(out, spmm_ell(pg, xt))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jax_spmm(jg, jnp.asarray(x))),
                               **TOL)


def _model_data():
    n, src, dst, _ = _edges("power_law")
    rng = np.random.RandomState(31)
    return (n, src, dst, rng.randn(n, 20).astype(np.float32),
            rng.randint(0, 5, n))


def _params(jm, seed):
    rng = np.random.RandomState(seed)
    return {s.name: rng.uniform(-0.2, 0.2, s.shape).astype(np.float32)
            for s in jm.param_specs}


def test_appnp_forward_under_auto_matches_jax():
    n, src, dst, features, _ = _model_data()
    jm = gt.APPNP(gt.from_edges(src, dst, n_nodes=n, directed=False),
                  features, num_classes=5)
    pm = tt.APPNP(tt.from_edges(src, dst, n_nodes=n, directed=False,
                                device="cpu"),
                  features, num_classes=5, device="cpu")
    params = _params(jm, 3)
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._act_cache = None
    tt.params_from_jax(params, pm)
    out = pm._activations()
    ops = [op for _, op in pm._adjacency.values()]
    assert ops and all(isinstance(op, PreparedSpMM) and not op.hubs
                       for op in ops)
    np.testing.assert_allclose(out.detach().numpy(),
                               np.asarray(jm._activations()), **MODEL_TOL)


def test_gcnii_steps_under_auto_match_jax():
    """Three epochs of GCNII (dropout off) through the ``auto`` operator,
    forward and backward, against JAX's: losses and parameters."""
    n, src, dst, features, labels = _model_data()
    build = lambda pkg, g, **kw: pkg.GCNII(
        g, features, num_classes=5, iterations=6, latent_dims=(16,),
        dropout=0.0, **kw)
    jm = build(gt, gt.from_edges(src, dst, n_nodes=n, directed=False))
    pm = build(tt, tt.from_edges(src, dst, n_nodes=n, directed=False,
                                 device="cpu"), device="cpu")
    init = _params(jm, 4)
    tasks = lambda pkg: dict(
        train=pkg.NodeClassification(np.arange(400), labels[:400]),
        valid=pkg.NodeClassification(np.arange(400, 800), labels[400:800]))
    jh = jm.train(**tasks(gt), epochs=3, patience=100, seed=2,
                  init_params=dict(init))
    ph = pm.train(**tasks(tt), epochs=3, patience=100, seed=2,
                  init_params=dict(init))
    ops = [op for _, op in pm._adjacency.values()]
    assert ops and all(not op.hubs for op in ops)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **MODEL_TOL)
    for k, v in jm.params.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   np.asarray(v), **MODEL_TOL)


def _gradient_models(kind, pkg, graph, features, **kw):
    """A GCN of two ``GCNLayer``s (no edge or feature dropout, so its
    adjacency is the fixed one) or a GCNII of 4 iterations, dropout off."""
    if kind == "GCN":
        model = pkg.GNN(graph, features, **kw)
        model.add(pkg.GCNLayer(16))
        model.add(pkg.GCNLayer(5, activation=lambda x: x))
        return model
    return pkg.GCNII(graph, features, num_classes=5, iterations=4,
                     latent_dims=(16,), dropout=0.0, **kw)


@pytest.mark.parametrize("kind", ["GCN", "GCNII"])
def test_auto_parameter_gradients_match_jax(kind):
    """The gradients of GCN's and GCNII's training loss (losses and the
    weight decay) through the ``auto`` operator, whose backward is one
    scaled walk over the transposed whole list, against ``jax.grad`` of
    the JAX package's loss, from the same numpy weights: rtol=1e-4 and an
    atol of 1e-5 of the parameter's largest JAX gradient (float32, sums in
    other orders)."""
    from gnntf_tpu.train import trainer as jax_trainer
    from gnntf_tpu_torch.train.trainer import _total_loss
    n, src, dst, features, labels = _model_data()
    jm = _gradient_models(kind, gt, gt.from_edges(src, dst, n_nodes=n,
                                                  directed=False), features)
    pm = _gradient_models(kind, tt, tt.from_edges(
        src, dst, n_nodes=n, directed=False, device="cpu"), features,
        device="cpu")
    params = _params(jm, 6)
    tt.params_from_jax(params, pm)
    jtask = gt.NodeClassification(np.arange(600), labels[:600])
    ptask = tt.NodeClassification(np.arange(600), labels[:600])
    ref = jax.grad(lambda p: jax_trainer._total_loss(
        jm, jtask, p, jm.features, jax.random.PRNGKey(0), jtask.batch(),
        5e-4))({k: jnp.asarray(v) for k, v in params.items()})
    loss = _total_loss(pm, ptask, ptask.batch(), 5e-4,
                       torch.Generator().manual_seed(0))
    names = sorted(params)
    got = torch.autograd.grad(loss, [pm.params[k] for k in names])
    ops = [op for _, op in pm._adjacency.values()]
    assert ops and all(isinstance(op, PreparedSpMM) and not op.hubs
                       for op in ops)
    for name, g in zip(names, got):
        r = np.asarray(ref[name])
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
