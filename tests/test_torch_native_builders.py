"""The C++ host builders the port takes where the JAX package does
(``utils/native.py``: the radix argsort of edges by (row, col) in
``from_edges`` at or above 100,000 edges, the one-pass ELL build in
``build_ell`` without deduplication), each against its numpy path and the
JAX package's layout, bit for bit; and ``prepare_spmm`` against the JAX
package's (``rtol=atol=1e-5``: float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import prepare_spmm as jax_prepare_spmm
from gnntf_tpu.ops.spmm import build_ell as jax_build_ell
from gnntf_tpu_torch.ops import PreparedSpMM, build_ell, prepare_spmm
from gnntf_tpu_torch.utils import native
from _jax_budget import release_jax_layout_caches  # noqa: F401

ELL_FIELDS = ("idx", "slot", "vrow_row", "edge_slot")


@pytest.fixture
def no_library(monkeypatch):
    """The builders as where the library cannot be built."""
    monkeypatch.setattr(native, "_load", lambda: None)


def _edges(n, e, seed, ties=True):
    """Random edges, unsorted, with repeated pairs and rows without
    edges."""
    rng = np.random.RandomState(seed)
    hi = max(1, n // 3) if ties else n
    row = rng.randint(0, hi, e) * (3 if ties else 1)
    col = rng.randint(0, hi, e)
    return row.astype(np.int64), col.astype(np.int64)


@pytest.mark.parametrize("n,e,seed", [(50, 2000, 0), (5000, 30000, 1),
                                      (3000, 1, 2), (70000, 200000, 3)])
def test_lexsort_edges_is_numpy_lexsort(n, e, seed):
    row, col = _edges(n, e, seed)
    before = native.lexsort_edges.runs
    order = native.lexsort_edges(row, col)
    assert native.lexsort_edges.runs == before + 1
    assert order.dtype == np.int64
    np.testing.assert_array_equal(order, np.lexsort((col, row)))


def test_lexsort_edges_of_no_edges():
    empty = np.zeros(0, np.int64)
    assert native.lexsort_edges(empty, empty).shape == (0,)


@pytest.mark.parametrize("k", [1, 4, 8, 32])
@pytest.mark.parametrize("ties", [True, False])
def test_build_ell_native_equals_numpy_and_jax(monkeypatch, k, ties):
    n = 4000
    row, col = _edges(n, 25000, k + ties, ties)
    before = native.build_ell_native.runs
    ours = build_ell(row, col, n, k, dedup=False)
    assert native.build_ell_native.runs == before + 1
    ref = jax_build_ell(row, col, n, k, dedup=False)
    monkeypatch.setattr(native, "_load", lambda: None)
    plain = build_ell(row, col, n, k, dedup=False)
    assert native.build_ell_native.runs == before + 1
    for name in ELL_FIELDS:
        a = getattr(ours, name)
        for other in (plain, ref):
            b = np.asarray(getattr(other, name))
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_build_ell_with_duplicates_builds_the_unique_pairs_natively():
    """Deduplication sorts in numpy, then builds the unique pairs' layout
    through the native path, as the JAX package does."""
    row, col = _edges(900, 8000, 4)
    before = native.build_ell_native.runs
    ours = build_ell(row, col, 900, 8)
    assert ours.n_unique < len(row)
    assert native.build_ell_native.runs == before + 1
    ref = jax_build_ell(row, col, 900, 8)
    for name in ELL_FIELDS + ("dup_order", "dup_seg"):
        np.testing.assert_array_equal(getattr(ours, name),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("native_sort", [True, False])
def test_from_edges_sorts_large_graphs_natively(request, native_sort):
    if not native_sort:
        request.getfixturevalue("no_library")
    src, dst = _edges(20000, 60000, 5)
    vals = np.random.RandomState(6).rand(len(src))
    before = native.lexsort_edges.runs
    pg = tt.from_edges(src, dst, vals, n_nodes=20000, directed=False,
                       device="cpu")
    assert pg.n_edges == 120000
    assert native.lexsort_edges.runs == before + native_sort
    jg = gt.from_edges(src, dst, vals, n_nodes=20000, directed=False)
    for name in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(pg, name).numpy(),
                                      np.asarray(getattr(jg, name)),
                                      err_msg=name)


def test_from_edges_below_the_threshold_sorts_in_numpy():
    src, dst = _edges(2000, 20000, 7)
    before = native.lexsort_edges.runs
    tt.from_edges(src, dst, n_nodes=2000, directed=False, device="cpu")
    assert native.lexsort_edges.runs == before


@pytest.mark.parametrize("normalized", ["symmetric", "row"])
def test_prepare_spmm_matches_jax(normalized):
    rng = np.random.RandomState(8)
    n = 3000
    src, dst = rng.randint(0, n, 40000), rng.randint(0, n, 40000)
    jg = gt.normalize_adjacency(
        gt.from_edges(src, dst, n_nodes=n, directed=False),
        normalized=normalized, graph_dropout=0.0, add_eye="after")
    pg = tt.normalize_adjacency(
        tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu"),
        normalized=normalized, graph_dropout=0.0, add_eye="after")
    x = rng.randn(n, 16).astype(np.float32)
    op = prepare_spmm(pg)
    assert isinstance(op, PreparedSpMM) and not op.hubs
    ref = np.asarray(jax_prepare_spmm(jg)(jnp.asarray(x)))
    out = op(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    assert prepare_spmm(pg, k=4).ell.k == 4
