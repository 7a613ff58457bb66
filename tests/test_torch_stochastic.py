"""The port's training grids and the default-impl training path against the
JAX package (``ops/stochastic.py``), under ``min_edges_scope(0)`` in both
packages so small graphs take the grid path, with the same salts injected
into both graphs and the inputs made from numpy seeds.

Tolerances: grids, edge ids and masks bit-equal (integer layouts and the
counter hash); the masked product and its ``dx`` ``rtol=1e-5, atol=1e-6``
(float32 both sides, summed in another order: the port a row's edges in
one run, JAX each virtual row's k slots and then the virtual rows); degrees
and normalization scales ``rtol=1e-6`` (unit edge values, so the dropped
values are 0 or 1/keep and the sums are exact up to the last rsqrt or
division ulp).  Edge weights and features are small dyadic rationals and
``1/keep`` a power of two where a product is compared, so every product and
sum is exact in float32 whatever its order and the tolerances hold the
functions, not the orders (the kernels' order is held bit for bit against
their plain versions in test_torch_ell_gather.py).  With an inf and a NaN
that only dropped edges read (keep 0.3 and 0.5), the NaNs and infs of the
product and of its gradient are where JAX's are, and every other element
is within ``1e-5`` of the sum of its terms' magnitudes (``1/0.3`` is not a
power of two).
"""
import dataclasses
import importlib
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import random_power_law_edges
from gnntf_tpu.ops import normalize_adjacency as jax_normalize
from gnntf_tpu.ops import stochastic as jst
from gnntf_tpu_torch.ops import normalize as pnorm
from gnntf_tpu_torch.ops import stochastic as pst
from _jax_budget import release_jax_layout_caches  # noqa: F401

# the modules, not the functions that both packages' ``ops`` export as
# ``spmm``
jax_spmm_module = importlib.import_module("gnntf_tpu.ops.spmm")
pspmm = importlib.import_module("gnntf_tpu_torch.ops.spmm")

SPMM_TOL = dict(rtol=1e-5, atol=1e-6)
RTOL = 1e-6
SALTS = [(12345, 678), (0x9E3779B9, 0xDEADBEEF), (0, 1)]


@pytest.fixture
def grid_scope():
    """``min_edges_scope(0)`` in both packages."""
    with jst.min_edges_scope(0), pst.min_edges_scope(0):
        yield


def _pair(n=800, e=4000, seed=0, weighted=False, loops=False, sort=True):
    """The same power-law graph (symmetrized, duplicates kept) in both
    packages; unit values unless ``weighted``."""
    src, dst = random_power_law_edges(n, e, seed=seed)
    vals = None
    if weighted:  # quarters in [0.25, 2]
        vals = np.random.RandomState(seed + 1).randint(1, 9, len(src)) / 4
    kw = dict(n_nodes=n, directed=False, sort=sort)
    jg = gt.from_edges(src, dst, vals, **kw)
    pg = tt.from_edges(src, dst, vals, device="cpu", **kw)
    if loops:
        jg, pg = gt.add_self_loops(jg), tt.add_self_loops(pg)
    return jg, pg


def _dyadic(rng, *shape):
    """Eighths in [-2, 2], as float32."""
    return (rng.randint(-16, 17, shape) / 8).astype(np.float32)


def _dropped(jg, pg, salt, keep=0.5):
    n_drop = pg.n_edges - pg.num_self_loop
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=keep, drop_n=n_drop)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=keep, drop_n=n_drop)
    return jd, pd


def _grids(jg, pg):
    args = lambda g: (np.asarray(g.row), np.asarray(g.col),
                      np.asarray(g.val), g.n_nodes)
    return jst.build_train_grids(*args(jg)), pst.build_train_grids(*args(pg))


GRID_NAMES = ("r_idx", "r_vrow", "r_val", "r_eid", "c_idx", "c_vrow",
              "c_val", "c_eid")


@pytest.mark.parametrize("case", ["sorted", "unsorted-weighted-loops"])
def test_build_train_grids_bit_equal_to_jax(case):
    if case == "sorted":
        jg, pg = _pair(seed=1)
    else:
        jg, pg = _pair(seed=2, weighted=True, loops=True, sort=False)
    jgrid, pgrid = _grids(jg, pg)
    assert pgrid.n_nodes == jgrid.n_nodes
    for name in GRID_NAMES:
        a, b = getattr(jgrid, name), getattr(pgrid, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def test_lists_keep_grid_order_and_drop_pads():
    """The walk's two lists: every edge once, in grid order, ``ptr`` over
    all N rows; the row list of a row-sorted graph stores no ``eid``, the
    column list's ``eid`` is the stable argsort of ``col``."""
    _, pg = _pair(seed=3)
    grids = pst.build_train_grids(pg.row.numpy(), pg.col.numpy(),
                                  pg.val.numpy(), pg.n_nodes)
    rows, cols = grids.lists("cpu")
    col = pg.col.numpy()
    for lst, grid_idx, grid_eid in ((rows, grids.r_idx, grids.r_eid),
                                    (cols, grids.c_idx, grids.c_eid)):
        assert lst.n_rows == pg.n_nodes and lst.n_edges == pg.n_edges
        live = grid_idx.reshape(-1) < pg.n_nodes
        np.testing.assert_array_equal(lst.idx.numpy(),
                                      grid_idx.reshape(-1)[live])
        eid = (np.arange(pg.n_edges) if lst.eid is None
               else lst.eid.numpy())
        np.testing.assert_array_equal(eid, grid_eid.reshape(-1)[live])
    assert rows.eid is None
    np.testing.assert_array_equal(cols.eid.numpy(),
                                  np.argsort(col, kind="stable"))
    np.testing.assert_array_equal(cols.ptr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(col, minlength=pg.n_nodes))]))
    assert grids.lists("cpu") is grids.lists(torch.device("cpu"))


@pytest.mark.parametrize("salt", SALTS)
@pytest.mark.parametrize("keep", [0.5, 0.1, 1.0])
def test_keep_mask_and_masked_values_over_grids_bit_equal(salt, keep):
    jg, pg = _pair(seed=4, weighted=True, loops=True)
    jgrid, pgrid = _grids(jg, pg)
    jd, pd = _dropped(jg, pg, salt, keep)
    for grid in ("r_eid", "c_eid"):
        ref = jst.keep_mask(jnp.asarray(getattr(jgrid, grid)),
                            jnp.asarray(salt, jnp.uint32), keep, pd.drop_n)
        ours = pst.keep_mask(torch.from_numpy(
            getattr(pgrid, grid).astype(np.int64)), torch.tensor(salt), keep,
            pd.drop_n)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for jf, pf in ((jst.masked_row_values, pst.masked_row_values),
                   (jst.masked_col_values, pst.masked_col_values)):
        np.testing.assert_array_equal(pf(pgrid, pd).numpy(),
                                      np.asarray(jf(jgrid, jd)))


@pytest.mark.parametrize("salt", SALTS[:2])
@pytest.mark.parametrize("keep,weighted,loops", [
    (0.5, False, False), (0.25, True, True), (1.0, True, False)])
def test_stochastic_spmm_and_dx_match_jax(grid_scope, salt, keep, weighted,
                                          loops):
    jg, pg = _pair(seed=5, weighted=weighted, loops=loops)
    jd, pd = _dropped(jg, pg, salt, keep)
    rng = np.random.RandomState(6)
    x, dy = _dyadic(rng, pg.n_nodes, 12), _dyadic(rng, pg.n_nodes, 12)
    ref, vjp = jax.vjp(lambda v: jst.stochastic_spmm(jd, v), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    out = pst.stochastic_spmm(pd, xt)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **SPMM_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               **SPMM_TOL)


def _only_dropped(lst, pd):
    """Rows of the product's input that only dropped edges of ``lst`` read
    (and one that a kept edge reads)."""
    eids = torch.arange(lst.n_edges) if lst.eid is None else lst.eid.long()
    kept = pst.keep_mask(eids, pd.drop_salt, pd.drop_keep, pd.drop_n)
    src = lst.idx.long()
    return (np.setdiff1d(src[~kept].numpy(), src[kept].numpy()),
            int(src[kept][0]))


def _plant(a, only_dropped, read_kept):
    """An inf and a NaN in rows that only dropped edges read, an inf in one
    that a kept edge reads."""
    a = a.copy()
    a[only_dropped[0], 0] = np.inf
    a[only_dropped[-1], -1] = np.nan
    a[read_kept, 1] = -np.inf
    return a


def _same_nonfinite(ours, ref, scale):
    """NaN and inf where ``ref`` has them; elsewhere within ``1e-5`` of the
    sum of the terms' magnitudes (``scale``: keep 0.3's 1/keep is not a
    power of two, so the two orders of the sum round apart)."""
    np.testing.assert_array_equal(np.isnan(ours), np.isnan(ref))
    np.testing.assert_array_equal(np.isposinf(ours), np.isposinf(ref))
    np.testing.assert_array_equal(np.isneginf(ours), np.isneginf(ref))
    finite = np.isfinite(ref)
    assert (np.abs(ours[finite] - ref[finite])
            <= 1e-5 * scale[finite] + 1e-6).all()


@pytest.mark.parametrize("keep", [0.3, 0.5])
def test_nonfinite_inputs_of_dropped_edges_give_jax_nans(grid_scope, keep):
    """An inf or a NaN that only a dropped edge reads: JAX multiplies the
    edge's +0 by it (NaN), and so does the port, in the product (x) and in
    its gradient (dy); an inf that a kept edge reads stays an inf."""
    jg, pg = _pair(seed=11, weighted=True)
    jd, pd = _dropped(jg, pg, SALTS[1], keep)
    rows, cols = pst.train_grids(pd).lists("cpu")
    rng = np.random.RandomState(12)
    x = _plant(_dyadic(rng, pg.n_nodes, 6), *_only_dropped(rows, pd))
    dy = _plant(_dyadic(rng, pg.n_nodes, 6), *_only_dropped(cols, pd))
    ref, vjp = jax.vjp(lambda v: jst.stochastic_spmm(jd, v), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    out = pst.stochastic_spmm(pd, xt)
    out.backward(torch.from_numpy(dy))
    # the sums of the terms' magnitudes (the values are positive)
    size = lambda a: torch.from_numpy(np.nan_to_num(
        np.abs(a), nan=0.0, posinf=0.0))
    xs = size(x).requires_grad_()
    scale = pst.stochastic_spmm(pd, xs)
    scale.backward(size(dy))
    assert np.isnan(np.asarray(ref)).any() and np.isnan(
        np.asarray(ref_dx)).any()
    _same_nonfinite(out.detach().numpy(), np.asarray(ref),
                    scale.detach().numpy())
    _same_nonfinite(xt.grad.numpy(), np.asarray(ref_dx), xs.grad.numpy())


@pytest.mark.parametrize("items,tile_items", [(16, 32), (32, 300)])
def test_stochastic_spmm_matches_jax_for_other_list_cuts(
        grid_scope, monkeypatch, items, tile_items):
    """Lists cut into other pieces and tiles (the walks' knobs) give the
    same product, gradient and degrees, within the float32 tolerance."""
    k1 = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
    monkeypatch.setattr(k1, "_DROP_ITEMS", items)
    monkeypatch.setattr(k1, "_TILE_ITEMS", tile_items)
    jg, pg = _pair(seed=13, weighted=True, loops=True)
    jd, pd = _dropped(jg, pg, SALTS[0], 0.25)
    rows, cols = pst.train_grids(pd).lists("cpu")
    assert rows.split.shape[0] and cols.split.shape[0]
    rng = np.random.RandomState(14)
    x, dy = _dyadic(rng, pg.n_nodes, 10), _dyadic(rng, pg.n_nodes, 10)
    ref, vjp = jax.vjp(lambda v: jst.stochastic_spmm(jd, v), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    out = pst.stochastic_spmm(pd, xt)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **SPMM_TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx),
                               **SPMM_TOL)
    for by in ("col", "row"):
        np.testing.assert_allclose(
            pst.stochastic_degree(pd, by=by).numpy(),
            np.asarray(jst.stochastic_degree(jd, by=by)), rtol=RTOL)


@pytest.mark.parametrize("by", ["col", "row"])
@pytest.mark.parametrize("salt", SALTS)
def test_stochastic_degree_matches_jax(grid_scope, by, salt):
    jg, pg = _pair(seed=7, loops=True, sort=False)
    jd, pd = _dropped(jg, pg, salt)
    ref = jst.stochastic_degree(jd, by=by)
    ours = pst.stochastic_degree(pd, by=by)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=RTOL)


@pytest.mark.parametrize("normalized", ["symmetric", "bipartite", "row"])
@pytest.mark.parametrize("add_eye", ["none", "before", "after"])
def test_normalize_dropped_graph_matches_jax(grid_scope, normalized,
                                             add_eye):
    jg, pg = _pair(seed=8)
    jd, pd = _dropped(jg, pg, SALTS[1])
    jn = jax_normalize(jd, normalized=normalized, add_eye=add_eye, rng=None)
    pn = tt.normalize_adjacency(pd, normalized=normalized, add_eye=add_eye,
                                generator=None)
    assert pn.dropped and jn.dropped
    for a, b in ((jn.row_scale, pn.row_scale), (jn.col_scale, pn.col_scale)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL)
    assert jn.eye_weight == pn.eye_weight


def test_degree_takes_the_walk_not_the_realized_values(grid_scope,
                                                       monkeypatch):
    """A dropped graph's degrees never realize the per-edge values."""
    _, pg = _pair(seed=9)
    _, pd = _dropped(pg, pg, SALTS[0])
    want = pnorm._degree(pd.materialized_dropout())
    monkeypatch.setattr(pst, "materialize_dropped", _refuse)
    np.testing.assert_array_equal(pnorm._degree(pd).numpy(), want.numpy())


def _refuse(*_, **__):
    raise AssertionError("the default training path left its kernels")


@pytest.mark.parametrize("impl", ["auto", "hybrid", "ell", "pallas"])
def test_dispatcher_routes_dropped_graph(grid_scope, monkeypatch, impl):
    """``auto``/``hybrid``/``ell`` take ``stochastic_spmm`` (never the
    realized values or ``spmm_segment``), ``pallas`` takes K2; all agree
    with the JAX package's dispatcher."""
    jg, pg = _pair(seed=10)
    jd, pd = _dropped(jg, pg, SALTS[0])
    jn = jax_normalize(jd, rng=None)
    pn = tt.normalize_adjacency(pd, generator=None)
    x = np.random.RandomState(11).randn(pg.n_nodes, 8).astype(np.float32)
    with jax_spmm_module.spmm_impl(impl):
        ref = np.asarray(jax_spmm_module.spmm(jn, jnp.asarray(x)))
    calls = []
    record = lambda name, fn: (lambda *a, **k: calls.append(name)
                               or fn(*a, **k))
    monkeypatch.setattr(pst, "stochastic_spmm",
                        record("grids", pst.stochastic_spmm))
    monkeypatch.setattr(pspmm, "spmm_pallas",
                        record("K2", pspmm.spmm_pallas))
    if impl != "pallas":
        monkeypatch.setattr(pspmm, "spmm_segment", _refuse)
        monkeypatch.setattr(pst, "materialize_dropped", _refuse)
    with tt.spmm_impl(impl):
        out = tt.spmm(pn, torch.from_numpy(x))
    assert calls == ["K2" if impl == "pallas" else "grids"]
    np.testing.assert_allclose(out.numpy(), ref, **SPMM_TOL)


def test_below_the_threshold_a_dropped_graph_is_realized(monkeypatch):
    """Outside the scope the small graph is not eligible: the dispatcher
    realizes the draw and takes the per-call form."""
    _, pg = _pair(seed=12)
    _, pd = _dropped(pg, pg, SALTS[0])
    assert not pst.grids_eligible(pd)
    monkeypatch.setattr(pst, "stochastic_spmm", _refuse)
    x = torch.ones(pg.n_nodes, 3)
    np.testing.assert_allclose(
        tt.spmm(pd, x).numpy(),
        (pd.materialized().to_dense() @ x).numpy(), **SPMM_TOL)


def test_min_edges_scope_governs_both_packages():
    jg, pg = _pair(seed=13)
    key, gen = jax.random.PRNGKey(0), torch.Generator().manual_seed(0)
    assert pst.min_edges() == pst.MIN_EDGES
    assert not gt.ops.edge_dropout(jg, 0.5, key).dropped
    assert not tt.ops.edge_dropout(pg, 0.5, gen).dropped
    with jst.min_edges_scope(0), pst.min_edges_scope(0) as n:
        assert n == 0 and pst.min_edges() == 0
        assert gt.ops.edge_dropout(jg, 0.5, key).dropped
        lazy = tt.ops.edge_dropout(pg, 0.5, gen)
        assert lazy.dropped and lazy.val is pg.val
        assert lazy.drop_n == pg.n_edges and lazy.drop_keep == 0.5
    assert pst.min_edges() == pst.MIN_EDGES


def test_grids_built_once_over_a_three_epoch_run(grid_scope):
    """Every layer's dropped graph shares the model graph's tensors: one
    grid build for the whole run, and the lists reused."""
    _, pg = _pair(seed=14)
    rng = np.random.RandomState(15)
    model = tt.APPNP(pg, rng.randn(pg.n_nodes, 8).astype(np.float32),
                     num_classes=3, iterations=4, device="cpu")
    labels = rng.randint(0, 3, pg.n_nodes)
    before = pst.train_grids.builds
    model.train(tt.NodeClassification(np.arange(200), labels[:200]),
                tt.NodeClassification(np.arange(200, 400), labels[200:400]),
                epochs=3, patience=10, seed=0)
    assert pst.train_grids.builds == before + 1


def test_appnp_training_under_auto_equals_segment(grid_scope):
    """The slice as a whole: a 3-epoch APPNP run under the default impl
    (the grids, the masked and degree walks' plain versions) computes the
    same function as the same run under ``segment`` (the realized values,
    gather + ``index_add_``)."""
    _, pg = _pair(n=1500, e=9000, seed=16)
    rng = np.random.RandomState(17)
    feats = rng.randn(pg.n_nodes, 16).astype(np.float32)
    labels = rng.randint(0, 4, pg.n_nodes)
    tasks = dict(train=tt.NodeClassification(np.arange(300), labels[:300]),
                 valid=tt.NodeClassification(np.arange(300, 600),
                                             labels[300:600]))
    hist, params = {}, {}
    for impl in (None, "segment"):
        model = tt.APPNP(pg, feats, num_classes=4, iterations=5,
                         device="cpu")
        hist[impl] = model.train(**tasks, epochs=3, patience=10, seed=3,
                                 spmm_impl=impl)
        params[impl] = {k: p.detach().clone()
                        for k, p in model.params.items()}
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist[None][key], hist["segment"][key],
                                   rtol=1e-5)
    for k, p in params["segment"].items():
        np.testing.assert_allclose(params[None][k].numpy(), p.numpy(),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fn", ["spmm_ell", "spmm_hybrid"])
@pytest.mark.parametrize("scaled", [False, True])
def test_per_call_forms_and_dval_match_jax(fn, scaled):
    """``spmm_ell``/``spmm_hybrid`` route the values per call: their
    product, ``dx`` and ``dval`` against ``jax.vjp`` of the JAX forms."""
    jg, pg = _pair(n=3000, e=20_000, seed=18, weighted=True)
    if scaled:
        jg = jax_normalize(jg, graph_dropout=0.0, add_eye="after")
        pg = tt.normalize_adjacency(pg, graph_dropout=0.0, add_eye="after")
    rng = np.random.RandomState(19)
    x, dy = _dyadic(rng, pg.n_nodes, 10), _dyadic(rng, pg.n_nodes, 10)
    jfn = getattr(jax_spmm_module, fn)

    def jax_call(v, xx):
        return jfn(dataclasses.replace(jg, val=v), xx)

    ref, vjp = jax.vjp(jax_call, jg.val, jnp.asarray(x))
    ref_dval, ref_dx = vjp(jnp.asarray(dy))
    val = pg.val.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = getattr(pspmm, fn)(dataclasses.replace(pg, val=val), xt)
    out.backward(torch.from_numpy(dy))
    tol = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **tol)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **tol)
    np.testing.assert_allclose(val.grad.numpy(), np.asarray(ref_dval),
                               rtol=1e-4, atol=1e-4)
    if fn == "spmm_hybrid":
        routed = pspmm._routed_layout(pg, 8, hubs=True)
        assert routed.to_dense is not None and routed.list.split.shape[0]


def test_spmm_with_learned_values_takes_the_per_call_form():
    """A fixed graph whose values need a gradient never reaches the
    prepared operator (its values are constants)."""
    _, pg = _pair(n=3000, e=40_000, seed=20, weighted=True)
    assert pg.n_edges >= pspmm._ELL_MIN_EDGES
    val = pg.val.clone().requires_grad_()
    x = torch.from_numpy(np.random.RandomState(21).randn(3000, 4)
                         .astype(np.float32))
    out = tt.spmm(dataclasses.replace(pg, val=val), x)
    out.sum().backward()
    want = torch.zeros(pg.n_edges).index_add_(
        0, torch.arange(pg.n_edges), x.sum(1)[pg.col])
    np.testing.assert_allclose(val.grad.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_prepared_operator_is_kept_per_graph():
    _, pg = _pair(n=3000, e=40_000, seed=22)
    pn = tt.normalize_adjacency(pg, graph_dropout=0.0)
    x = torch.ones(3000, 2)
    tt.spmm(pn, x)
    first = pspmm._prepared_cached(
        dataclasses.replace(pn, row_scale=None, col_scale=None), 8)
    tt.spmm(pn, x)
    assert pspmm._prepared_cached(
        dataclasses.replace(pn, row_scale=None, col_scale=None), 8) is first
    other = dataclasses.replace(pn, val=pn.val * 2, row_scale=None,
                                col_scale=None)
    assert pspmm._prepared_cached(other, 8) is not first


def test_edge_dot_and_sddmm_match_jax():
    jg, pg = _pair(seed=23)
    rng = np.random.RandomState(24)
    x = rng.randn(pg.n_nodes, 6).astype(np.float32)
    y = rng.randn(pg.n_nodes, 6).astype(np.float32)
    ds = rng.randn(pg.n_edges).astype(np.float32)
    ref, vjp = jax.vjp(lambda a, b: jax_spmm_module.sddmm(jg, a, b),
                       jnp.asarray(x), jnp.asarray(y))
    ref_dx, ref_dy = vjp(jnp.asarray(ds))
    xt = torch.from_numpy(x).requires_grad_()
    yt = torch.from_numpy(y).requires_grad_()
    out = tt.sddmm(pg, xt, yt)
    out.backward(torch.from_numpy(ds))
    for a, b in ((out.detach(), ref), (xt.grad, ref_dx), (yt.grad, ref_dy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    row, col = pg.row[:50], pg.col[:50]
    np.testing.assert_allclose(
        tt.edge_dot(row, col, torch.from_numpy(x)).numpy(),
        np.asarray(gt.edge_dot(jnp.asarray(row.numpy()),
                               jnp.asarray(col.numpy()), jnp.asarray(x))),
        rtol=1e-5, atol=1e-5)


def test_executor_override_is_scoped_per_context(grid_scope):
    _, pg = _pair(seed=25)
    _, pd = _dropped(pg, pg, SALTS[0])
    x = torch.ones(pg.n_nodes, 2)
    seen = []

    def plain(graph, xx):
        seen.append(("plain", graph.dropped))
        return torch.zeros_like(xx)

    def lazy(graph, xx):
        seen.append(("lazy", graph.dropped))
        return torch.ones_like(xx)

    lazy.supports_lazy_dropout = True
    with tt.ops.spmm_executor(plain):
        assert not tt.spmm(pd, x).any()
        with tt.ops.spmm_executor(lazy):
            assert tt.spmm(pd, x).all()
        # another thread does not see this context's executor
        other = []
        worker = threading.Thread(target=lambda: other.append(
            pspmm._SPMM_EXECUTOR_VAR.get()))
        worker.start()
        worker.join()
        assert other == [None]
    assert seen == [("plain", False), ("lazy", True)]
    out = tt.spmm(pd, x)  # no executor: the grids
    np.testing.assert_allclose(out.numpy(), pst.stochastic_spmm(pd, x).numpy())
    tt.ops.set_spmm_executor(plain)
    try:
        tt.spmm(pg, x)
    finally:
        tt.ops.set_spmm_executor(None)
    assert seen[-1] == ("plain", False)


# the JAX package's tests/test_stochastic.py cases that apply to the port

def test_threshold_engages_lazy(grid_scope):
    _, pg = _pair(seed=26)
    lazy = tt.ops.edge_dropout(pg, 0.5, torch.Generator().manual_seed(0))
    assert lazy.dropped and lazy.drop_keep == 0.5
    assert lazy.drop_n == pg.n_edges and lazy.val is pg.val


def test_self_loops_never_dropped(grid_scope):
    _, pg = _pair(seed=27, loops=True)
    lazy = tt.ops.edge_dropout(pg, 0.9, torch.Generator().manual_seed(4))
    assert lazy.drop_n == pg.n_edges - pg.n_nodes
    val = pst.materialize_dropped(lazy).numpy()
    np.testing.assert_array_equal(val[lazy.drop_n:],
                                  pg.val.numpy()[lazy.drop_n:])
    deg = pst.stochastic_degree(lazy).numpy()
    np.testing.assert_array_equal(deg >= 1.0, np.ones(pg.n_nodes, bool))


def test_spmm_and_gradient_match_materialized(grid_scope):
    """Grid SpMM on the lazy normalized graph equals the segment SpMM on the
    realized edges, forward and gradient."""
    _, pg = _pair(seed=28)
    rng = np.random.RandomState(29)
    x = torch.from_numpy(rng.randn(pg.n_nodes, 16).astype(np.float32))
    t = torch.from_numpy(rng.randn(pg.n_nodes, 16).astype(np.float32))
    adj = tt.normalize_adjacency(pg, graph_dropout=0.5,
                                 generator=torch.Generator().manual_seed(6))
    assert adj.dropped and adj.scaled
    grads = []
    for fn in (tt.spmm, lambda g, v: tt.ops.spmm_segment(g.materialized(),
                                                         v)):
        xt = x.clone().requires_grad_()
        loss = ((fn(adj, xt) - t) ** 2).sum()
        grads.append((loss.item(), torch.autograd.grad(loss, xt)[0]))
    assert abs(grads[0][0] - grads[1][0]) <= 1e-5 * abs(grads[1][0])
    np.testing.assert_allclose(grads[0][1].numpy(), grads[1][1].numpy(),
                               rtol=2e-4, atol=2e-5)


def test_stacked_dropout_realizes_first_draw(grid_scope):
    _, pg = _pair(n=2000, e=20_000, seed=30)
    lazy = tt.ops.edge_dropout(pg, 0.5, torch.Generator().manual_seed(14))
    twice = tt.ops.edge_dropout(lazy, 0.5, torch.Generator().manual_seed(15))
    kept = (pst.materialize_dropped(twice) if twice.dropped
            else twice.val).numpy() != 0
    first = pst.materialize_dropped(lazy).numpy() != 0
    assert (kept <= first).all()
    assert abs(kept.mean() - 0.25) < 0.02


def test_prepare_rejects_dropped(grid_scope):
    _, pg = _pair(seed=31)
    lazy = tt.ops.edge_dropout(pg, 0.5, torch.Generator().manual_seed(13))
    with pytest.raises(TypeError):
        tt.ops.PreparedSpMM(lazy)
    with pytest.raises(ValueError):
        tt.ops.prepare(lazy)
