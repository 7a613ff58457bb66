"""The port's link prediction (``tasks/link_prediction.py``, the native
sampler bridge ``utils/native.py``) against the JAX package, on the CPU.

* The sampler's edges are *equal* to JAX's after the same ``set_seed``,
  over several calls: prefetch on and off, the C++ path and the Python path
  (a custom ``pool``).  An array a call returned never changes afterwards
  (the JAX sampler's prefetch thread refills it two calls later).
* The heads (``dot``/``cos`` x DistMult x ``diff``/``bce``) on the same
  numpy activations: ``HEAD_TOL`` (float32, sums in another order).
* NGCF link-prediction training with dropout off, against JAX: ``TRAJ_TOL``
  (float32 over three propagations and optimizer updates), on a graph above
  and one below ``min_edges()``; the fused stacked path against the port's
  host loop (equal, dropout on) and against JAX's fused ``fit``.

NGCF's output regularization (``output_regularize=1`` on l2-normalized
rows) is 0.5 a node and layer whatever the weights, so its gradient is zero
in exact arithmetic and float32 rounding noise in each package (~1e-5 on
the small graph, as large as the smallest gradients of the task), which
Adam's first steps scale to whole steps of their own.  The trajectories
against JAX therefore train with it off in both packages;
``test_output_regularization_is_constant`` holds the rest of it.

Parameters after training agree within ``TRAJ_TOL`` but for at most
``PARAM_OUTLIERS`` of their elements, none off by more than
``MAX_PARAM_DIFF`` (the rule of ``chip_smoke.py`` phase 4b): an Adam update
``-alpha * m / (sqrt(v) + eps)`` turns a difference of ~1e-8 in a gradient
near ``eps`` into ~1e-5 in the parameter.
"""
import jax.numpy as jnp
import networkx as nx
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.ops import stochastic as pst
from gnntf_tpu_torch.utils import native
from _jax_budget import release_jax_layout_caches  # noqa: F401

HEAD_TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-4
PARAM_OUTLIERS = 0.01
MAX_PARAM_DIFF = 1e-3


def _assert_params_close(port, jax_params):
    outside = total = 0
    for k, v in jax_params.items():
        got, want = port[k].detach().numpy(), np.asarray(v)
        np.testing.assert_allclose(got, want, rtol=0, atol=MAX_PARAM_DIFF)
        outside += int((~np.isclose(got, want, **TRAJ_TOL)).sum())
        total += want.size
    assert outside <= PARAM_OUTLIERS * total, (outside, total)


def _digraph(n, e, seed):
    return nx.gnm_random_graph(n, e, seed=seed, directed=True)


def _draws(pkg, graph, calls=4, pos=None, **kw):
    """``calls`` sampler calls after ``set_seed(3)``, each copied at once
    (the JAX sampler's prefetch rewrites an array it returned)."""
    pkg.set_seed(3)
    pos = list(graph.edges())[:400] if pos is None else pos
    sampler = pkg.negative_sampling(pos, graph, samples=2, **kw)
    out = []
    for _ in range(calls):
        edges, labels = sampler()
        out.append((np.array(edges), np.array(labels)))
    return sampler, out


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "sync"])
@pytest.mark.parametrize("pool", [None, 6], ids=["native", "python-pool"])
def test_sampler_edges_equal_jax(prefetch, pool):
    graph = _digraph(300, 1500, 1)
    js, jout = _draws(gt, graph, prefetch=prefetch, pool=pool)
    ps, pout = _draws(tt, graph, prefetch=prefetch, pool=pool)
    assert ps.native is (pool is None)
    for (je, jl), (pe, pl) in zip(jout, pout):
        np.testing.assert_array_equal(pe, je)
        np.testing.assert_array_equal(pl, jl)
    edges = pout[-1][0]
    assert (edges[:, 0] != edges[:, 1]).all()
    arcs = set(graph.edges())
    negatives = edges[2::3]
    assert not any((u, v) in arcs or (v, u) in arcs
                   for u, v in negatives.tolist())


def test_sampler_python_path_without_library(monkeypatch):
    """Without the library the sampler takes the Python path, as the JAX
    package does, and says so."""
    monkeypatch.setattr(native, "_load", lambda: None)
    graph = _digraph(200, 800, 2)
    ps, pout = _draws(tt, graph, prefetch=False)
    assert ps.native is False
    rng_edges = pout[0][0]
    assert (rng_edges[1::3, 1] >= 0).all()


def test_prefetched_arrays_never_change():
    """The array a call returned is unchanged after the next two calls (the
    fault of the JAX sampler, whose prefetch thread refills it), and the
    edges stay equal to JAX's."""
    graph = _digraph(300, 1500, 4)
    _, jout = _draws(gt, graph, calls=5)
    tt.set_seed(3)
    sampler = tt.negative_sampling(list(graph.edges())[:400], graph,
                                   samples=2)
    held = []
    for call in range(5):
        edges, _ = sampler()
        held.append((edges, edges.copy()))
        for returned, copy in held:
            np.testing.assert_array_equal(returned, copy)
        np.testing.assert_array_equal(edges, jout[call][0])
    assert len({id(e) for e, _ in held}) == 5


def test_sampler_on_the_ports_graph_equals_networkx():
    """A sampler over the port's ``Graph`` (no networkx) draws what one over
    the same networkx graph draws."""
    graph = _digraph(250, 1000, 5)
    src, dst = np.asarray(list(graph.edges())).T
    g = tt.from_edges(src, dst, n_nodes=250, directed=True, device="cpu")
    pos = list(graph.edges())[:400]
    for prefetch in (False, True):
        _, want = _draws(tt, graph, pos=pos, prefetch=prefetch)
        _, got = _draws(tt, g, pos=pos, prefetch=prefetch)
        for (a, _), (b, _) in zip(want, got):
            np.testing.assert_array_equal(a, b)


def test_recommend_all_matches_jax():
    graph = _digraph(60, 200, 6)
    for node in (0, 7, 33):
        je, jl = gt.recommend_all(node, graph)
        pe, pl = tt.recommend_all(node, graph)
        np.testing.assert_array_equal(pe, je)
        assert pl == jl
    pos = [[3, 4], [4, 9], [1, 2]]
    je, jl = gt.recommend_all(4, graph, positive_edges=pos,
                              negative_nodes=list(range(20)))
    pe, pl = tt.recommend_all(4, graph, positive_edges=pos,
                              negative_nodes=list(range(20)))
    np.testing.assert_array_equal(pe, je)
    assert pl == jl


class _Stub:
    """A model that only registers the DistMult vector."""

    def __init__(self, n, d):
        self.shape = (n, d)

    def top_shape(self):
        return self.shape

    def create_var(self, **kw):
        assert kw["shared_name"] == "distmult"
        assert kw["normalization"] == "ones"
        return "distmult"


def _head_inputs(n=80, d=12, e=300, seed=0):
    """Activations and ``e`` distinct unordered pairs ``u < v``: the
    similarities are symmetric, so a pair and its reverse would tie exactly,
    each package would round the two scores its own way, and the AUC would
    count the flipped pair whole."""
    rng = np.random.RandomState(seed)
    acts = rng.randn(n, d).astype(np.float32)
    u, v = np.triu_indices(n, 1)
    pick = rng.choice(len(u), e, replace=False)
    edges = np.stack([u[pick], v[pick]], 1)
    labels = (rng.rand(e) < 0.5).astype(np.float32)
    r = (rng.rand(d, 1) + 0.5).astype(np.float32)
    return acts, edges, labels, r


@pytest.mark.parametrize("loss", ["diff", "bce"])
@pytest.mark.parametrize("distmult", [False, True], ids=["plain", "distmult"])
@pytest.mark.parametrize("similarity", ["dot", "cos"])
def test_heads_match_jax(similarity, distmult, loss):
    acts, edges, labels, r = _head_inputs()
    kw = dict(similarity=similarity, loss=loss)
    jt = gt.LinkPrediction(edges, labels, gnn=_Stub(*acts.shape)
                           if distmult else None, **kw)
    pt = tt.LinkPrediction(edges, labels, gnn=_Stub(*acts.shape)
                           if distmult else None, **kw)
    jp = {"distmult": r} if distmult else None
    pp = {"distmult": torch.from_numpy(r)} if distmult else None
    ja, pa = jnp.asarray(acts), torch.from_numpy(acts)
    jt.refresh()
    pt.refresh()
    np.testing.assert_allclose(
        float(pt.loss(pa, pt.batch(), params=pp)),
        float(jt.loss(ja, jt.batch(), params=jp)), **HEAD_TOL)
    for to_logits in (False, True):
        np.testing.assert_allclose(
            pt.predict(pa, params=pp, to_logits=to_logits).numpy(),
            np.asarray(jt.predict(ja, params=jp, to_logits=to_logits)),
            **HEAD_TOL)
    np.testing.assert_allclose(pt.evaluate(pa, params=pp),
                               jt.evaluate(ja, params=jp), **HEAD_TOL)


def test_batch_size_subsampling_picks_jax_indices():
    acts, edges, labels, _ = _head_inputs(e=200)
    picks = []
    for pkg in (gt, tt):
        pkg.set_seed(11)
        task = pkg.LinkPrediction(edges, labels, batch_size=64, loss="bce")
        assert not task.static
        rounds = []
        for _ in range(3):
            task.refresh()
            rounds.append(np.asarray(task._batch_idx).copy())
            assert np.asarray(task.batch()[0]).shape == (64, 2)
        picks.append(rounds)
    for j, p in zip(*picks):
        np.testing.assert_array_equal(p, j)


def test_mean_link_prediction_matches_jax(capsys):
    graph = _digraph(120, 500, 8)
    rng = np.random.RandomState(9)
    acts = rng.randn(120, 10).astype(np.float32)
    r = (rng.rand(10, 1) + 0.5).astype(np.float32)
    edges = np.asarray(list(graph.edges()))[:150]
    labels = np.ones(len(edges))
    for similarity in ("dot", "cos"):
        kw = dict(similarity=similarity, loss="bce", graph=graph, k=5,
                  positive_nodes=sorted({int(u) for u in edges[:40, 0]}))
        jt = gt.MeanLinkPrediction(edges, labels, gnn=_Stub(120, 10), **kw)
        pt = tt.MeanLinkPrediction(edges, labels, gnn=_Stub(120, 10), **kw)
        want = jt.evaluate(jnp.asarray(acts),
                           params={"distmult": r})
        got = pt.evaluate(torch.from_numpy(acts),
                          params={"distmult": torch.from_numpy(r)})
        np.testing.assert_allclose(got, want, **HEAD_TOL)
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 4 and out[0] == out[1] and out[2] == out[3]


def _lp_setup(pkg, graph, features, dropout, prefetch=True, device=None,
              output_regularize=True):
    """NGCF over ``graph`` with a sampled BPR training task over every edge
    and a static BCE validation task over 150 edges with 2 negatives each
    (drawn once with the sampler after ``set_seed(0)``)."""
    pkg.set_seed(0)
    kw = {} if device is None else dict(device=device)
    adj = pkg.graph2adj(graph, **kw)
    gnn = pkg.NGCF(adj, features, num_classes=8, dropout=dropout, **kw)
    if not output_regularize:
        for layer in gnn.layers():
            layer.output_regularize = 0.0
    held = pkg.negative_sampling(list(graph.edges())[:150], graph, samples=2,
                                 prefetch=False)
    v_edges, v_labels = held()
    sampler = pkg.negative_sampling(list(graph.edges()), graph, samples=1,
                                    prefetch=prefetch)
    train = pkg.LinkPrediction(lambda: sampler(), gnn=gnn, loss="diff")
    valid = pkg.LinkPrediction(np.array(v_edges), np.array(v_labels),
                               gnn=gnn, loss="bce")
    return gnn, train, valid, sampler


GRAPHS = {"small": (300, 1500), "large": (4000, 34000)}


def _features(n, seed=1):
    return np.random.RandomState(seed).rand(n, 8).astype(np.float32)


@pytest.mark.parametrize("size", sorted(GRAPHS))
def test_training_trajectory_matches_jax(size):
    """3 epochs of NGCF with BPR over resampled negatives, dropout off:
    the large graph (>= 65,536 counted edges) takes the prepared operator
    with K1 and its backward walk, the small one the per-call product."""
    n, e = GRAPHS[size]
    graph = _digraph(n, e, 12)
    features = _features(n)
    jm, jtr, jva, _ = _lp_setup(gt, graph, features, 0.0,
                                output_regularize=False)
    init = {k: np.asarray(v) for k, v in jm.init(7).items()}
    jh = jm.train(jtr, jva, epochs=3, patience=100, seed=7,
                  init_params=dict(init))
    pm, ptr, pva, sampler = _lp_setup(tt, graph, features, 0.0,
                                      device="cpu", output_regularize=False)
    assert sampler.native
    large = 2 * e >= pst.min_edges()
    assert large == (size == "large")
    ph = pm.train(ptr, pva, epochs=3, patience=100, seed=7,
                  init_params=dict(init))
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], rtol=LOSS_RTOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    _assert_params_close(pm.params, jm.params)
    # the AUC moves in steps of 1 / (positives x negatives) = 2.2e-5 here,
    # a step wherever two near-equal scores swap places
    np.testing.assert_allclose(pm.evaluate(pva), jm.evaluate(jva),
                               rtol=0, atol=1e-3)


def test_output_regularization_is_constant():
    """With NGCF's output regularization on, the first step's loss equals
    JAX's, the regularization is 0.5 a node and layer in both packages, and
    the task's gradients equal JAX's: what the trajectories leave out is a
    constant."""
    import jax
    n, e = GRAPHS["small"]
    graph = _digraph(n, e, 12)
    features = _features(n)
    jm, jtr, _, _ = _lp_setup(gt, graph, features, 0.0)
    init = {k: np.asarray(v) for k, v in jm.init(7).items()}
    pm, ptr, _, _ = _lp_setup(tt, graph, features, 0.0, device="cpu")
    tt.params_from_jax(init, pm)
    jp = {k: jnp.asarray(v) for k, v in init.items()}
    jt_batch, pt_batch = jtr.batch(), ptr.batch()
    np.testing.assert_array_equal(pt_batch[0].numpy(), np.asarray(jt_batch[0]))

    def jax_loss(p, part):
        out, fw = jm.apply(p, jm.features, training=False, return_ctx=True)
        return jtr.loss(out, jt_batch, params=p) if part == "task" \
            else jm.layer_losses(fw)

    out, fw = pm.forward(pm.features, training=False, return_ctx=True)
    reg = pm.layer_losses(fw).detach()
    np.testing.assert_allclose(float(reg), 0.5 * n * 3, rtol=1e-6)
    np.testing.assert_allclose(float(jax_loss(jp, "reg")), 0.5 * n * 3,
                               rtol=1e-6)
    task = ptr.loss(out, pt_batch, params=pm.params)
    np.testing.assert_allclose(float(task), float(jax_loss(jp, "task")),
                               **HEAD_TOL)
    names = list(pm.params)
    grads = torch.autograd.grad(task, [pm.params[k] for k in names])
    want = jax.grad(lambda p: jax_loss(p, "task"))(jp)
    for k, g in zip(names, grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-7)


def _port_run(block_epochs, size="small", dropout=0.1, epochs=7, **kw):
    n, e = GRAPHS[size]
    graph = _digraph(n, e, 13)
    gnn, train, valid, _ = _lp_setup(tt, graph, _features(n), dropout,
                                     device="cpu")
    h = gnn.train(train, valid, epochs=epochs, patience=100, seed=5,
                  block_epochs=block_epochs, **kw)
    return h, {k: p.detach().clone() for k, p in gnn.params.items()}


def test_fused_stacked_equals_host_loop():
    """``fit(block_epochs=3)`` with a sampled task draws each block's
    batches with ``stack_batches`` and feeds each epoch its slice: equal to
    the host loop, with feature dropout on."""
    (hh, hp), (fh, fp) = _port_run(1), _port_run(3)
    for key in ("train_loss", "valid_loss", "best_epoch"):
        assert hh[key] == fh[key], key
    for k in hp:
        assert torch.equal(hp[k], fp[k]), k


def test_fused_stacked_matches_jax_fused():
    n, e = GRAPHS["small"]
    graph = _digraph(n, e, 14)
    features = _features(n)
    jm, jtr, jva, _ = _lp_setup(gt, graph, features, 0.0,
                                output_regularize=False)
    init = {k: np.asarray(v) for k, v in jm.init(3).items()}
    jh = jm.train(jtr, jva, epochs=4, patience=100, seed=7, block_epochs=2,
                  init_params=dict(init))
    pm, ptr, pva, _ = _lp_setup(tt, graph, features, 0.0, device="cpu",
                                output_regularize=False)
    ph = pm.train(ptr, pva, epochs=4, patience=100, seed=7, block_epochs=2,
                  init_params=dict(init))
    assert ph["epochs_run"] == jh["epochs_run"] == 4
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], rtol=LOSS_RTOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    _assert_params_close(pm.params, jm.params)


def test_stack_batches_shapes_and_order():
    """The stack holds the next ``n`` draws in order, on the device asked
    for, the same as ``n`` refreshes."""
    graph = _digraph(100, 400, 15)
    pos = list(graph.edges())
    tt.set_seed(2)
    a = tt.negative_sampling(pos, graph, samples=1)
    ta = tt.LinkPrediction(lambda: a())
    edges, labels = ta.stack_batches(3, device="cpu")
    assert edges.shape == (3, 2 * len(pos), 2) and edges.dtype == torch.int64
    assert labels.shape == (3, 2 * len(pos))
    tt.set_seed(2)
    b = tt.negative_sampling(pos, graph, samples=1)
    tb = tt.LinkPrediction(lambda: b())
    for i in range(3):
        tb.refresh()
        e, l = tb.batch()
        assert torch.equal(edges[i], e) and torch.equal(labels[i], l)
    assert ta.supports_stacking and not ta.static


def test_link_prediction_names_exported():
    for name in ("LinkPrediction", "MeanLinkPrediction", "negative_sampling",
                 "recommend_all"):
        assert getattr(tt, name) is getattr(tt.tasks, name)
