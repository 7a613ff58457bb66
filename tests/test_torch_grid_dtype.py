"""``GNNTF_GRID_VALUE_DTYPE=bfloat16`` in the port against the JAX package:
the training grids' base values rounded to bfloat16, and the masked
product, its ``dx`` and the dropped degrees weighted by the rounded values.

Under ``min_edges_scope(0)`` in both packages, with the same salts in both
graphs and inputs from numpy seeds.  Grids: bit-equal (the port holds the
bfloat16 bits as uint16, JAX as ``ml_dtypes.bfloat16``).  Products, ``dx``
and degrees: ``rtol=1e-6``.  The weights are ``(256 + m) / 256`` for odd
``m``: nine significant bits, so bfloat16 (eight) rounds every one of them,
and the features are eighths in [-2, 2] with ``1 / keep`` a power of two, so
every product and sum is exact in float32 in any order and the tolerance
holds the rounded values, not an order of summation.  Each weighted case
also differs from the port's float32 result, the function without the
knob.  Unit values are exact in bfloat16: with and without the knob the
port's results are bit-equal.
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
from gnntf_tpu.ops import stochastic as jst
from gnntf_tpu_torch.ops import stochastic as pst

KNOB = "GNNTF_GRID_VALUE_DTYPE"
RTOL = 1e-6
SALT = (0x9E3779B9, 0xDEADBEEF)


@pytest.fixture
def grid_scope():
    with jst.min_edges_scope(0), pst.min_edges_scope(0):
        yield


def _pair(n=800, e=4000, seed=0, weighted=True, loops=False):
    """The same power-law graph in both packages (symmetrized, duplicates
    kept), weights of nine significant bits unless unit-valued."""
    src, dst = random_power_law_edges(n, e, seed=seed)
    vals = None
    if weighted:
        vals = (256 + 2 * np.random.RandomState(seed + 1).randint(
            0, 128, len(src)) + 1) / 256
    kw = dict(n_nodes=n, directed=False)
    jg = gt.from_edges(src, dst, vals, **kw)
    pg = tt.from_edges(src, dst, vals, device="cpu", **kw)
    if loops:
        jg, pg = gt.add_self_loops(jg), tt.add_self_loops(pg)
    return jg, pg


def _dropped(jg, pg, keep=0.5):
    n_drop = pg.n_edges - pg.num_self_loop
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(SALT, jnp.uint32),
                             drop_keep=keep, drop_n=n_drop)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(SALT),
                             drop_keep=keep, drop_n=n_drop)
    return jd, pd


def _eighths(rng, *shape):
    return (rng.randint(-16, 17, shape) / 8).astype(np.float32)


def _port_product(pd, x, dy):
    """The port's masked product and its ``dx``."""
    xt = torch.from_numpy(x).requires_grad_()
    out = pst.stochastic_spmm(pd, xt)
    out.backward(torch.from_numpy(dy))
    return out.detach().numpy(), xt.grad.numpy()


@pytest.mark.parametrize("name,dtype", [
    ("bfloat16", torch.bfloat16), ("bf16", torch.bfloat16),
    ("float32", torch.float32), ("float16", torch.float32)])
def test_grid_value_dtype_reads_the_variable_as_jax(monkeypatch, name,
                                                    dtype):
    monkeypatch.setenv(KNOB, name)
    assert pst.grid_value_dtype() == dtype
    want = "bfloat16" if dtype == torch.bfloat16 else "float32"
    assert jst.grid_value_dtype().name == want


def test_grid_value_dtype_defaults_to_float32(monkeypatch):
    monkeypatch.delenv(KNOB, raising=False)
    assert pst.grid_value_dtype() == torch.float32


@pytest.mark.parametrize("loops", [False, True])
def test_bf16_grids_bit_equal_to_jax(monkeypatch, loops):
    monkeypatch.setenv(KNOB, "bfloat16")
    jg, pg = _pair(seed=1, loops=loops)
    args = lambda g: (np.asarray(g.row), np.asarray(g.col),
                      np.asarray(g.val), g.n_nodes)
    jgrid = jst.build_train_grids(*args(jg))
    pgrid = pst.build_train_grids(pg.row.numpy(), pg.col.numpy(),
                                  pg.val.numpy(), pg.n_nodes)
    assert pgrid.value_dtype == torch.bfloat16
    for name in ("r_val", "c_val"):
        ref = getattr(jgrid, name)
        assert ref.dtype.name == "bfloat16"
        ours = getattr(pgrid, name)
        assert ours.dtype == np.uint16, name
        np.testing.assert_array_equal(ours, ref.view(np.uint16),
                                      err_msg=name)
    for name in ("r_idx", "r_vrow", "r_eid", "c_idx", "c_vrow", "c_eid"):
        np.testing.assert_array_equal(getattr(pgrid, name),
                                      getattr(jgrid, name), err_msg=name)
    # the per-edge copy the walks read: the row grid's values by edge id
    vals = pgrid.values("cpu")
    assert vals.dtype == torch.bfloat16 and vals.shape == (pg.n_edges,)
    assert torch.equal(vals, pg.val.to(torch.bfloat16))
    assert pgrid.values("cpu") is vals
    # every weight lost a bit; the self-loops' 1.0 did not
    changed = int((vals.to(torch.float32) != pg.val).sum())
    assert changed == pg.n_edges - pg.num_self_loop


@pytest.mark.parametrize("keep,loops", [(0.5, False), (0.25, True)])
def test_masked_product_and_dx_match_jax_under_bf16(grid_scope, monkeypatch,
                                                    keep, loops):
    jg, pg = _pair(seed=2, loops=loops)
    jd, pd = _dropped(jg, pg, keep)
    rng = np.random.RandomState(3)
    x, dy = _eighths(rng, pg.n_nodes, 12), _eighths(rng, pg.n_nodes, 12)
    f32 = _port_product(pd, x, dy)
    monkeypatch.setenv(KNOB, "bfloat16")
    ref, vjp = jax.vjp(lambda v: jst.stochastic_spmm(jd, v), jnp.asarray(x))
    (ref_dx,) = vjp(jnp.asarray(dy))
    out, dx = _port_product(pd, x, dy)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL)
    np.testing.assert_allclose(dx, np.asarray(ref_dx), rtol=RTOL)
    assert not np.array_equal(out, f32[0])
    assert not np.array_equal(dx, f32[1])


@pytest.mark.parametrize("by", ["col", "row"])
def test_dropped_degrees_match_jax_under_bf16(grid_scope, monkeypatch, by):
    jg, pg = _pair(seed=4, loops=True)
    jd, pd = _dropped(jg, pg)
    f32 = pst.stochastic_degree(pd, by=by).numpy()
    monkeypatch.setenv(KNOB, "bf16")
    ref = np.asarray(jst.stochastic_degree(jd, by=by))
    ours = pst.stochastic_degree(pd, by=by).numpy()
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    assert not np.array_equal(ours, f32)


def test_normalized_dropped_product_matches_jax_under_bf16(grid_scope,
                                                           monkeypatch):
    """Through the dispatcher: the symmetric normalization's degrees and
    the masked product both weight by the rounded values."""
    jg, pg = _pair(seed=5)
    jd, pd = _dropped(jg, pg)
    x = _eighths(np.random.RandomState(6), pg.n_nodes, 8)
    monkeypatch.setenv(KNOB, "bfloat16")
    jn = gt.normalize_adjacency(jd, rng=None)
    pn = tt.normalize_adjacency(pd, generator=None)
    ref = np.asarray(gt.spmm(jn, jnp.asarray(x)))
    out = tt.spmm(pn, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)


def test_unit_values_bit_equal_with_and_without_the_knob(grid_scope,
                                                         monkeypatch):
    _, pg = _pair(seed=7, weighted=False, loops=True)
    _, pd = _dropped(pg, pg)
    rng = np.random.RandomState(8)
    x, dy = rng.randn(pg.n_nodes, 16).astype(np.float32), \
        rng.randn(pg.n_nodes, 16).astype(np.float32)
    runs = []
    for name in ("float32", "bfloat16"):
        monkeypatch.setenv(KNOB, name)
        runs.append((*_port_product(pd, x, dy),
                     pst.stochastic_degree(pd, by="col").numpy(),
                     pst.stochastic_degree(pd, by="row").numpy()))
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_changing_the_variable_rebuilds_the_grids(grid_scope, monkeypatch):
    _, pg = _pair(seed=9)
    _, pd = _dropped(pg, pg)
    x = torch.ones(pg.n_nodes, 2)
    before = pst.train_grids.builds
    dtypes = []
    for name in ("float32", "bfloat16", "float32", "bfloat16"):
        monkeypatch.setenv(KNOB, name)
        pst.stochastic_spmm(pd, x)
        dtypes.append(pst.train_grids(pd).value_dtype)
    assert pst.train_grids.builds == before + 2
    assert dtypes == [torch.float32, torch.bfloat16] * 2


def test_appnp_trains_equal_with_and_without_the_knob(grid_scope,
                                                      monkeypatch):
    """APPNP's normalized graph has unit base values, so 3 epochs under the
    knob repeat the float32 run exactly."""
    _, pg = _pair(n=1200, e=7000, seed=10, weighted=False)
    rng = np.random.RandomState(11)
    feats = rng.randn(pg.n_nodes, 16).astype(np.float32)
    labels = rng.randint(0, 4, pg.n_nodes)
    tasks = dict(train=tt.NodeClassification(np.arange(300), labels[:300]),
                 valid=tt.NodeClassification(np.arange(300, 600),
                                             labels[300:600]))
    hist, params = {}, {}
    for name in ("float32", "bfloat16"):
        monkeypatch.setenv(KNOB, name)
        model = tt.APPNP(pg, feats, num_classes=4, iterations=5,
                         device="cpu")
        hist[name] = model.train(**tasks, epochs=3, patience=10, seed=3)
        params[name] = {k: p.detach().clone()
                        for k, p in model.params.items()}
    for key in ("train_loss", "valid_loss"):
        assert hist["bfloat16"][key] == hist["float32"][key], key
    for k, p in params["float32"].items():
        assert torch.equal(params["bfloat16"][k], p), k
