"""The port's training path against the JAX package: the counter-hash edge
dropout (bit-equal masks and values), ``keras_adam`` (rtol=1e-6) and ``fit``
trajectories of a hand-built APPNP stack with the JAX parameters carried
over (rtol=1e-4, atol=1e-5: float32, sums in another order over several
propagation steps and optimizer updates).

The stack has no ``Dropout`` layer and ``graph_dropout=0``: the JAX and torch
generators cannot draw the same feature masks, and below ``MIN_EDGES`` edges
the JAX package draws edge masks from ``jax.random``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import stochastic as jst
from gnntf_tpu.train.trainer import keras_adam as jax_keras_adam
from gnntf_tpu_torch.ops import stochastic as pst
from gnntf_tpu_torch.ops.normalize import edge_dropout
from gnntf_tpu_torch.ops.spmm import PreparedSpMM, _ELLGatherFn

TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
SALTS = [(0, 0), (1, 2), (0x80000000, 0xFFFFFFFF), (0xDEADBEEF, 0x9E3779B9)]


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("keep,n_drop", [(0.5, 100_000), (0.1, 70_000),
                                         (0.9, 99_999)])
def test_keep_mask_bit_equal_to_jax(salt, keep, n_drop):
    e = 100_000
    ref = jst.keep_mask(jnp.arange(e, dtype=jnp.uint32),
                        jnp.asarray(salt, jnp.uint32), keep, n_drop)
    ours = pst.keep_mask(torch.arange(e), torch.tensor(salt), keep, n_drop)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))


@pytest.mark.parametrize("salt", SALTS[1:])
def test_materialize_dropped_bit_equal_to_jax(salt):
    rng = np.random.RandomState(0)
    n, e = 5000, 100_000
    src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
    vals = rng.rand(e)
    jg = gt.add_self_loops(gt.from_edges(src, dst, vals, n_nodes=n))
    pg = tt.add_self_loops(tt.from_edges(src, dst, vals, n_nodes=n,
                                         device="cpu"))
    n_drop = pg.n_edges - pg.num_self_loop
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=0.7, drop_n=n_drop)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=0.7, drop_n=n_drop)
    ref = np.asarray(jst.materialize_dropped(jd))
    ours = pst.materialize_dropped(pd).numpy()
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours[n_drop:], 1.0)  # self-loops kept
    np.testing.assert_array_equal(
        pd.materialized().to_dense().numpy(), np.asarray(jd.to_dense()))


@pytest.mark.parametrize("n_edges", [20_000, pst.MIN_EDGES + 10_000])
def test_edge_dropout_keep_rate_and_self_loops(n_edges):
    rng = np.random.RandomState(1)
    n = 2000
    g = tt.add_self_loops(tt.from_edges(
        rng.randint(0, n, n_edges), rng.randint(0, n, n_edges), n_nodes=n,
        device="cpu"))
    gen = torch.Generator().manual_seed(3)
    d = edge_dropout(g, 0.5, gen)
    assert d.dropped == (g.n_edges >= pst.MIN_EDGES)
    val = d.materialized_dropout().val
    head = val[:g.n_edges - g.num_self_loop]
    assert abs(float((head != 0).double().mean()) - 0.5) < 0.01
    assert set(head.unique().tolist()) <= {0.0, 2.0}
    assert torch.equal(val[g.n_edges - g.num_self_loop:],
                       torch.ones(g.num_self_loop))
    # the same generator state draws the same masks
    again = edge_dropout(g, 0.5, torch.Generator().manual_seed(3))
    assert torch.equal(again.materialized_dropout().val, val)


def test_dropped_values_hashed_once_per_draw(monkeypatch):
    rng = np.random.RandomState(2)
    n, e = 2000, pst.MIN_EDGES + 1000
    g = tt.from_edges(rng.randint(0, n, e), rng.randint(0, n, e), n_nodes=n,
                      device="cpu")
    x = torch.from_numpy(rng.randn(n, 3).astype(np.float32))
    hashed = []
    real = pst.dropped_values
    monkeypatch.setattr(pst, "dropped_values",
                        lambda *a: hashed.append(1) or real(*a))
    adj = tt.normalize_adjacency(g, graph_dropout=0.5,
                                 generator=torch.Generator().manual_seed(0))
    out = tt.spmm(adj, x)  # degrees and product read one draw
    assert len(hashed) == 1
    np.testing.assert_allclose(out.numpy(),
                               (adj.materialized().to_dense() @ x).numpy(),
                               rtol=1e-5, atol=1e-5)
    tt.normalize_adjacency(g, graph_dropout=0.5,
                           generator=torch.Generator().manual_seed(1))
    assert len(hashed) == 2  # a new draw hashes anew


def test_dropout_is_inverted_and_seeded():
    x = torch.ones(200, 50)
    out = tt.dropout(x, 0.6, torch.Generator().manual_seed(0))
    assert set(out.unique().tolist()) <= {0.0, 2.5}
    assert abs(float((out != 0).double().mean()) - 0.4) < 0.02
    assert torch.equal(out, tt.dropout(x, 0.6,
                                       torch.Generator().manual_seed(0)))
    assert tt.dropout(x, 0.0, None) is x
    with pytest.raises(ValueError):
        tt.dropout(x, 1.0, torch.Generator())


def test_keras_adam_matches_jax():
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(5, 3).astype(np.float32),
              "b": rng.randn(1, 3).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32)
              for k, v in params.items()} for _ in range(3)]
    jtx, ptx = jax_keras_adam(0.01), tt.keras_adam(0.01)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    js, ps = jtx.init(jp), ptx.init(pp)
    for g in grads:
        ju, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()}, js)
        jp = {k: jp[k] + ju[k] for k in jp}
        pu, ps = ptx.update({k: torch.from_numpy(v) for k, v in g.items()},
                            ps)
        pp = {k: pp[k] + pu[k] for k in pp}
    for k in params:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6)


def _stack(pkg, graph, feats, classes, device=None, iterations=3):
    kw = {} if device is None else {"device": device}
    relu = jax.nn.relu if pkg is gt else torch.relu
    m = pkg.GNN(graph, feats, **kw)
    m.add(pkg.Dense(16, activation=relu))
    h0 = m.add(pkg.Dense(classes, regularize=False))
    for _ in range(iterations):
        m.add(pkg.PPRIteration(h0, 0.1, graph_dropout=0.0))
    return m


@pytest.mark.parametrize("impl,kw", [
    ("pallas", {}), ("segment", {}),
    ("segment", dict(batches=2, degradation=lambda epoch: 0.5 ** epoch,
                     regularization=1e-2))],
    ids=["pallas", "segment", "segment-batches-degradation"])
def test_fit_trajectory_matches_jax(impl, kw):
    rng = np.random.RandomState(0)
    n = 120
    src, dst = rng.randint(0, n, 360), rng.randint(0, n, 360)
    feats = rng.rand(n, 12).astype(np.float32)
    nodes = rng.choice(n, 60, replace=False)
    labels = rng.randint(0, 3, 60)
    jm = _stack(gt, gt.from_edges(src, dst, n_nodes=n, directed=False),
                feats, 3)
    pm = _stack(tt, tt.from_edges(src, dst, n_nodes=n, directed=False,
                                  device="cpu"), feats, 3, device="cpu")
    init = {k: np.asarray(v) for k, v in jm.init(11).items()}
    tasks = lambda pkg: dict(train=pkg.NodeClassification(nodes[:30],
                                                          labels[:30]),
                             valid=pkg.NodeClassification(nodes[30:],
                                                          labels[30:]))
    jh = jm.train(**tasks(gt), epochs=4, patience=100, seed=7,
                  spmm_impl=impl, init_params=dict(init), **kw)
    ph = pm.train(**tasks(tt), epochs=4, patience=100, seed=7,
                  spmm_impl=impl, init_params=dict(init), **kw)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **TRAJ_TOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    assert ph["epochs_run"] == jh["epochs_run"]
    for k, v in jm.params.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   np.asarray(v), **TRAJ_TOL)


def test_fit_patience_restores_best_and_valid_defaults_to_train():
    rng = np.random.RandomState(1)
    n = 80
    g = tt.from_edges(rng.randint(0, n, 240), rng.randint(0, n, 240),
                      n_nodes=n, directed=False, device="cpu")
    m = _stack(tt, g, rng.rand(n, 6).astype(np.float32), 3, device="cpu")
    task = tt.NodeClassification(np.arange(40), rng.randint(0, 3, 40))
    seen = []

    def record(epoch, params, valid_loss, **_):
        seen.append({k: p.detach().clone() for k, p in params.items()})

    h = m.train(task, epochs=30, patience=2, learning_rate=0.5, seed=0,
                callbacks=[record])
    assert len(h["valid_loss"]) == len(seen) < 30
    best = int(np.argmin(h["valid_loss"]))
    assert h["best_epoch"] == best
    for k, p in m.params.items():
        assert torch.equal(p, seen[best][k])
    # valid = train: the recorded validation loss is the task's loss
    assert abs(float(m.loss(task)) - h["valid_loss"][best]) < 1e-5


def test_frozen_parameters_do_not_move():
    rng = np.random.RandomState(2)
    n = 60
    g = tt.from_edges(rng.randint(0, n, 200), rng.randint(0, n, 200),
                      n_nodes=n, directed=False, device="cpu")
    m = tt.GNN(g, rng.rand(n, 5).astype(np.float32), device="cpu")
    frozen = m.create_param((5, 3), trainable=False)
    m.add(tt.Dense(3))
    m.reset(seed=0)
    before = m.params[frozen].detach().clone()
    task = tt.NodeClassification(np.arange(30), rng.randint(0, 3, 30))
    m.train(task, epochs=3, seed=0, init_params={
        k: p.detach().numpy() for k, p in m.params.items()})
    assert torch.equal(m.params[frozen], before)


def test_training_forward_draws_from_the_generator():
    rng = np.random.RandomState(3)
    n = 300
    g = tt.from_edges(rng.randint(0, n, 900), rng.randint(0, n, 900),
                      n_nodes=n, directed=False, device="cpu")
    m = tt.APPNP(g, rng.rand(n, 8).astype(np.float32), num_classes=3,
                 iterations=2, device="cpu")
    m.reset(seed=0)
    run = lambda s: m.forward(m.features, training=True,
                              generator=torch.Generator().manual_seed(s))
    a, b = run(5), run(5)
    assert torch.equal(a, b) and not torch.equal(a, run(6))
    assert not torch.equal(a, m.forward(m.features))


@pytest.mark.parametrize("option", [
    dict(spmm="bogus"), dict(spmm="halo"), dict(checkpoint_dir="ckpt"),
    dict(resume=True), dict(remat=True), dict(spmm_impl="bogus")])
def test_fit_unported_options_raise(option, tmp_path):
    """Every option of the JAX package's ``fit`` is ported: ``spmm`` is
    ignored without a mesh, as in JAX, and ``checkpoint_dir``, ``resume``
    and ``remat`` run; an unknown ``spmm`` or ``spmm_impl`` raises
    ``ValueError`` (``mesh`` runs on gloo ranks:
    ``tests/test_torch_parallel*.py``)."""
    g = tt.from_edges([0, 1, 2], [1, 2, 0], device="cpu")
    m = _stack(tt, g, np.ones((3, 4), np.float32), 2, device="cpu")
    task = tt.NodeClassification([0, 1], [0, 1])
    if "checkpoint_dir" in option:
        option = dict(checkpoint_dir=str(tmp_path / option["checkpoint_dir"]))
    if "bogus" not in option.values():
        assert len(m.train(task, epochs=1, **option)["train_loss"]) == 1
        return
    with pytest.raises(ValueError):
        m.train(task, epochs=1, **option)


@pytest.mark.parametrize("route", ["hybrid", "auto"])
def test_prepared_operator_gradient_matches_plain(route):
    """On the card the prepared operator's gradient comes from
    ``_ELLGatherFn`` (``hybrid``) or ``_ScaledGatherFn`` (``auto``, the
    scales and identity around the transposed walk); on the CPU its
    backward is held against autograd through the plain version."""
    from gnntf_tpu_torch.ops.ell_gather import ell_gather_scaled_plain
    from gnntf_tpu_torch.ops.spmm import _ScaledGatherFn
    rng = np.random.RandomState(4)
    n = 3000
    g = tt.normalize_adjacency(tt.from_edges(
        rng.randint(0, n, 40_000), rng.randint(0, n, 40_000), n_nodes=n,
        directed=False, device="cpu"), graph_dropout=0.0, add_eye="after")
    prep = PreparedSpMM(g, hubs=route == "hybrid")
    x = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    if route == "hybrid":
        fns = (lambda x: _ELLGatherFn.apply(x, torch.zeros(n, 6),
                                            prep.k1_list, prep.k1_val),
               lambda x: tt.ops.blocked_spmm_plain(
                   prep.k1_list, prep.k1_val, x, torch.zeros(n, 6)))
    else:
        args = (*prep._scales, float(prep.eye_weight))
        fns = (lambda x: _ScaledGatherFn.apply(x, prep._routed, prep.k1_val,
                                               *args),
               lambda x: ell_gather_scaled_plain(prep.k1_list, prep.k1_val,
                                                 x, *args))
    grads = []
    for fn in fns:
        xt = x.clone().requires_grad_()
        fn(xt).backward(dy)
        grads.append(xt.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-5)
