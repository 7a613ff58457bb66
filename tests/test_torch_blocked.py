"""The port's blocked-COO layout, RCM reordering and ``spmm_pallas`` against
the JAX package (its Pallas kernel in interpret mode on the CPU).

Layouts and permutations are integer arrays and must be bit-equal.  SpMM
outputs and ``dx``: rtol=atol=1e-5 (float32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.graph.reorder import permute_graph as jax_permute
from gnntf_tpu.graph.reorder import rcm_order as jax_rcm
from gnntf_tpu.ops.pallas import block_coo as jax_block_coo
from gnntf_tpu.ops.pallas import spmm_pallas as jax_spmm_pallas
from gnntf_tpu.ops.spmm import spmm_impl as jax_impl
from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked_spmm,
                                 scatter_values, spmm_pallas)
from gnntf_tpu_torch.ops.blocked import edge_lists, work_units

TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("rows", "cols", "perm", "chunk_window", "chunk_tile")
STATIC = ("n_nodes", "window", "tile", "block_edges", "n_windows", "n_tiles")


def _edges(n, e, seed, weighted=True):
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, size=e)
    dst = rng.randint(0, n, size=e)
    vals = rng.rand(e).astype(np.float32) if weighted else None
    return src, dst, vals


def _pair(n, e, seed, weighted=True):
    src, dst, vals = _edges(n, e, seed, weighted)
    return (gt.from_edges(src, dst, vals, n_nodes=n, directed=False),
            tt.from_edges(src, dst, vals, n_nodes=n, directed=False,
                          device="cpu"))


def _assert_layouts_equal(ours, ref):
    for f in FIELDS:
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    for f in STATIC:
        assert getattr(ours, f) == getattr(ref, f), f


@pytest.mark.parametrize("n,e,w,t,be", [
    (100, 300, 64, 64, 128),
    (300, 50, 128, 64, 128),     # sparse: many empty windows
    (515, 2000, 256, 256, 256),  # n not a multiple of the window
    (40, 2000, 8, 16, 32),       # many duplicates, chunks cut inside a block
])
def test_block_coo_bit_equal_to_jax(n, e, w, t, be):
    src, dst, _ = _edges(n, e, seed=n + e)
    kw = dict(window=w, tile=t, block_edges=be)
    ours = block_coo(src, dst, n, **kw)
    _assert_layouts_equal(ours, jax_block_coo(src, dst, n, **kw))
    assert ours.fill_factor == jax_block_coo(src, dst, n, **kw).fill_factor


def test_block_coo_empty_graph_bit_equal():
    empty = np.zeros(0, np.int64)
    ours = block_coo(empty, empty, 50, window=32, tile=32, block_edges=128)
    _assert_layouts_equal(ours, jax_block_coo(empty, empty, 50, window=32,
                                              tile=32, block_edges=128))
    assert ours.n_chunks == 2 and ours.chunk_len.tolist() == [0, 0]
    for ptr, idx, eid in edge_lists(ours):
        assert ptr.tolist() == [0] * 51 and idx.shape == eid.shape == (0,)
        unit_row, unit_edge, split = work_units(ptr, 16)
        assert unit_row.tolist() == [0, 16, 32, 48, 50]
        assert not unit_edge.any() and split.shape == (0, 3)


def test_chunk_len_is_the_live_prefix():
    src, dst, _ = _edges(300, 900, seed=1)
    lay = block_coo(src, dst, 300, window=64, tile=64, block_edges=128)
    slots = np.zeros(lay.rows.shape[0], bool)
    slots[lay.perm] = True
    per_chunk = slots.reshape(lay.n_chunks, lay.block_edges)
    np.testing.assert_array_equal(per_chunk.sum(1), lay.chunk_len)
    prefix = np.arange(lay.block_edges)[None, :] < lay.chunk_len[:, None]
    np.testing.assert_array_equal(per_chunk, prefix)


@pytest.mark.parametrize("run", [1, 7, 64, 5000])
def test_work_partition_covers_each_live_slot_once(run):
    """The forward and transposed edge lists hold each live edge once, in
    (dst, src) and (src, dst) order, with ``eid`` the identity on a
    ``from_edges`` graph; ``work_units`` of ``run`` items tiles each list's
    edges and rows once."""
    src, dst, _ = _edges(300, 900, seed=2)
    g = tt.from_edges(src, dst, n_nodes=300, device="cpu")
    row, col = g.row.numpy(), g.col.numpy()
    lay = block_coo(row, col, 300, window=64, tile=64, block_edges=128)
    fwd, tr = edge_lists(lay)
    np.testing.assert_array_equal(fwd[2], np.arange(g.n_edges))
    for (ptr, idx, eid), (a, b) in ((fwd, (row, col)), (tr, (col, row))):
        assert ptr.dtype == idx.dtype == eid.dtype == np.int32
        np.testing.assert_array_equal(np.sort(eid), np.arange(g.n_edges))
        first = np.repeat(np.arange(300), np.diff(ptr))
        np.testing.assert_array_equal(first, a[eid])
        np.testing.assert_array_equal(idx, b[eid])
        key = first.astype(np.int64) * 300 + idx
        assert np.all(np.diff(key) >= 0)
        unit_row, unit_edge, split = work_units(ptr, run)
        assert unit_edge[0] == 0 and unit_edge[-1] == g.n_edges
        assert np.all(np.diff(unit_edge) >= 0) and unit_row[-1] == 300
        owned = np.zeros(300, int)
        for u in range(len(unit_row) - 1):
            r0, r1 = unit_row[u], unit_row[u + 1]
            r1 = ~r1 if r1 < 0 else r1
            if r0 < 0:  # a piece of one split row
                assert 0 < unit_edge[u + 1] - unit_edge[u] <= run
                assert ptr[~r0] <= unit_edge[u] < unit_edge[u + 1] \
                    <= ptr[~r0 + 1]
                continue
            assert r0 < r1 and unit_edge[u] == ptr[r0]
            assert unit_edge[u + 1] == ptr[r1]
            assert (ptr[r1] - ptr[r0]) + (r1 - r0) <= 2 * run
            owned[r0:r1] += 1
        for r, first_piece, count in split:
            assert ptr[r + 1] - ptr[r] > run and owned[r] == 0
            assert -(-(ptr[r + 1] - ptr[r]) // run) == count
            assert np.all(unit_row[first_piece:first_piece + count] == ~r)
            owned[r] += 1
        np.testing.assert_array_equal(owned, 1)


def test_edge_lists_after_add_self_loops():
    """Appended self-loops break the (row, col) order, so the forward list's
    ``eid`` is no identity; both directions still give ``A @ x`` and
    ``A^T @ x``."""
    _, pg = _pair(150, 500, seed=4)
    pg = tt.add_self_loops(pg, weight=0.5)
    prep = BlockedSpMM(block_coo(pg.row.numpy(), pg.col.numpy(), 150,
                                 window=32, tile=32, block_edges=64), "cpu")
    assert prep.forward.eid is not None and prep.transposed.eid is not None
    x = torch.from_numpy(np.random.RandomState(1).randn(150, 6)
                         .astype(np.float32))
    dense = pg.to_dense().double()
    for lst, a in ((prep.forward, dense), (prep.transposed, dense.T)):
        np.testing.assert_allclose(blocked_spmm(lst, pg.val, x).numpy(),
                                   (a @ x.double()).numpy(), **TOL)


def test_scatter_values_match_jax():
    jg, pg = _pair(200, 600, seed=3)
    ref = jax_block_coo(np.asarray(jg.row), np.asarray(jg.col), 200,
                        window=64, tile=64, block_edges=128)
    lay = block_coo(pg.row.numpy(), pg.col.numpy(), 200, window=64, tile=64,
                    block_edges=128)
    np.testing.assert_array_equal(scatter_values(lay, pg.val).numpy(),
                                  np.asarray(ref.scatter_values(jg.val)))


@pytest.mark.parametrize("seed,dup", [(0, False), (1, True)])
def test_rcm_and_permute_bit_equal_to_jax(seed, dup):
    rng = np.random.RandomState(seed)
    n = 400
    src = rng.randint(0, n, 1500)
    dst = (src + rng.randint(-20, 20, 1500)) % n  # a band, then shuffled
    if dup:
        src, dst = np.concatenate([src, src[:300]]), np.concatenate(
            [dst, dst[:300]])
    shuffle = rng.permutation(n)
    jg = gt.from_edges(shuffle[src], shuffle[dst], n_nodes=n, directed=False)
    pg = tt.from_edges(shuffle[src], shuffle[dst], n_nodes=n, directed=False,
                       device="cpu")
    perm = tt.rcm_order(pg)
    np.testing.assert_array_equal(perm, jax_rcm(jg))
    g2, inv = tt.permute_graph(pg, perm)
    j2, jinv = jax_permute(jg, perm)
    np.testing.assert_array_equal(inv, jinv)
    np.testing.assert_array_equal(g2.row.numpy(), np.asarray(j2.row))
    np.testing.assert_array_equal(g2.col.numpy(), np.asarray(j2.col))
    np.testing.assert_array_equal(g2.val.numpy(), np.asarray(j2.val))
    assert tt.bandwidth(g2) == gt.graph.reorder.bandwidth(j2)
    assert tt.bandwidth(g2) < tt.bandwidth(pg)


@pytest.mark.parametrize("n,e,w,t,be,f", [
    (100, 300, 64, 64, 128, 16),
    (300, 50, 128, 64, 128, 8),
    (515, 2000, 256, 256, 256, 40),
])
def test_spmm_pallas_scaled_graph_matches_jax(n, e, w, t, be, f):
    jg, pg = _pair(n, e, seed=n + e)
    jn = gt.normalize_adjacency(jg, graph_dropout=0.0, add_eye="after")
    pn = tt.normalize_adjacency(pg, graph_dropout=0.0, add_eye="after")
    x = np.random.RandomState(1).randn(n, f).astype(np.float32)
    kw = dict(window=w, tile=t, block_edges=be)
    ref = jax_spmm_pallas(jn, jnp.asarray(x), interpret=True, **kw)
    out = spmm_pallas(pn, torch.from_numpy(x), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_spmm_pallas_empty_graph():
    empty = np.zeros(0, np.int32)
    pg = tt.from_edges(empty, empty, np.zeros(0), n_nodes=50, directed=True,
                       device="cpu")
    out = spmm_pallas(pg, torch.ones(50, 8), window=32, tile=32,
                      block_edges=128)
    assert out.shape == (50, 8) and not out.any()


@pytest.mark.parametrize("salt", [(12345, 678), (0x9E3779B9, 0xDEADBEEF)])
def test_spmm_pallas_dropped_graph_and_dx_match_jax(salt):
    n, f = 300, 24
    jg, pg = _pair(n, 1500, seed=5)
    jg = gt.add_self_loops(jg)
    pg = tt.add_self_loops(pg)
    n_drop = pg.n_edges - pg.num_self_loop
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=0.5, drop_n=n_drop)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=0.5, drop_n=n_drop)
    jn = gt.normalize_adjacency(jd, rng=None)
    pn = tt.normalize_adjacency(pd, generator=None)
    assert pn.dropped and jn.dropped
    rng = np.random.RandomState(2)
    x = rng.randn(n, f).astype(np.float32)
    dy = rng.randn(n, f).astype(np.float32)
    with jax_impl("pallas"):
        ref, vjp = jax.vjp(lambda v: gt.spmm(jn, v), jnp.asarray(x))
        (ref_dx,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    with tt.spmm_impl("pallas"):
        out = tt.spmm(pn, xt)
    out.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_dx), **TOL)


def test_spmm_pallas_value_gradient_matches_segment():
    _, pg = _pair(120, 400, seed=6)
    x = torch.from_numpy(np.random.RandomState(3).randn(120, 8)
                         .astype(np.float32))
    dy = torch.from_numpy(np.random.RandomState(4).randn(120, 8)
                          .astype(np.float32))
    grads = []
    for fn in (spmm_pallas, tt.ops.spmm_segment):
        val = pg.val.clone().requires_grad_()
        g = dataclasses.replace(pg, val=val)
        fn(g, x).backward(dy)
        grads.append(val.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), **TOL)


def test_layout_is_cached_per_structure():
    _, pg = _pair(200, 600, seed=7)
    x = torch.ones(200, 4)
    before = len(tt.ops.blocked._BLOCK_CACHE)
    spmm_pallas(pg, x)
    spmm_pallas(dataclasses.replace(pg, val=pg.val * 3), x)
    assert len(tt.ops.blocked._BLOCK_CACHE) == before + 1


def test_pallas_epoch_runs_k2_both_ways_without_value_scatter(monkeypatch):
    """One epoch under ``pallas``: every propagation of the step's forward
    and of the validation forward walks the forward list, every one of the
    step's backward the transposed list (no ``dy[row]`` gather, no 2-D
    ``index_add_``), and nothing scatters values into the slot grid."""
    def refuse(*_):
        raise AssertionError("scatter_values on the hot path")

    calls = []
    wrapped = tt.ops.blocked.blocked_spmm

    def record(lst, val, x):
        prep = next(iter(tt.ops.blocked._BLOCK_CACHE._data.values()))[1]
        calls.append("T" if lst is prep.transposed else "A")
        return wrapped(lst, val, x)

    monkeypatch.setattr(tt.ops.blocked, "scatter_values", refuse)
    monkeypatch.setattr(tt.ops.blocked, "blocked_spmm", record)
    monkeypatch.setattr(tt.ops.blocked, "_BLOCK_CACHE",
                        type(tt.ops.blocked._BLOCK_CACHE)())
    _, pg = _pair(300, 1200, seed=11)
    feats = np.random.RandomState(1).randn(300, 8).astype(np.float32)
    labels = np.random.RandomState(2).randint(0, 3, 300)
    model = tt.APPNP(pg, feats, num_classes=3, iterations=3, device="cpu")
    hist = model.train(tt.NodeClassification(np.arange(100), labels[:100]),
                       tt.NodeClassification(np.arange(100, 200),
                                             labels[100:200]),
                       spmm_impl="pallas", epochs=1, patience=10, seed=0)
    assert np.isfinite(hist["train_loss"]).all()
    assert calls == ["A"] * 3 + ["T"] * 3 + ["A"] * 3


@pytest.mark.parametrize("impl", ["pallas", "segment", "auto"])
def test_clean_forward_under_each_impl_matches_jax(impl):
    jg, pg = _pair(400, 1600, seed=9)
    feats = np.random.RandomState(1).randn(400, 12).astype(np.float32)
    jm = gt.APPNP(jg, feats, num_classes=4, iterations=3)
    jm.reset(seed=0)
    pm = tt.APPNP(pg, feats, num_classes=4, iterations=3, device="cpu")
    tt.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, pm)
    with jax_impl(impl):
        ref = np.asarray(jm.apply(jm.params, jm.features))
    with tt.spmm_impl(impl):
        out = pm._activations()
        assert (("symmetric", "none", impl) in pm._adjacency)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
