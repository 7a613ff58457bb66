"""GAT's backward kernels A3 (``attn_bwd_rows``) and A4 (``attn_bwd_cols``,
``gnntf_tpu_torch/csrc/attention.cu``) through their plain versions on the
CPU, in the kernels' order: per-feature lanes, each slot's dot over a head
summed across the head's lanes in a fixed tree (``attention._dots``).

Against JAX (``gnntf_tpu/ops/attention.py::_make_gat_core``'s gradients by
``jax.vjp``, the same numpy inputs): ``dh``, ``ds_src`` and ``ds_dst`` at
GAT's layer shapes (8 heads of 8; one head of 40) and at widths whose heads
span several lane chunks (41 and 160 features), per-edge lists with
dropout and coalesced lists without, on lists cut into units of 4 items so
that a hub row and a hub column split over many pieces.  Tolerances are
``tests/test_torch_attention.py``'s: rtol=1e-4, atol=1e-5; atol=1e-4 with
dropout.

Exact: the dot's order against a loop written out lane by lane; a given
``rowdot`` equal to the row's own gives the own mode's bits; an isolated
node's outputs are zeros.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import attention as ja
from gnntf_tpu_torch.ops import attention as pa

GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DROP_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SALT = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
SLOPE = 0.2
KEEP = 0.6
# GAT's layers at GATConfig, a width that is not a multiple of 4, and heads
# of more than 32 vectors (several lane chunks)
SHAPES = [(8, 8), (1, 40), (3, 6), (1, 41), (2, 160)]


def _graphs(n=90, e=700, seed=0):
    """A random symmetrized graph with duplicate edges, a hub row and a hub
    column of 300 edges each, and node n - 1 isolated, in both packages."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, n - 1, e), np.zeros(300, np.int64),
                          rng.randint(0, n - 1, 300)])
    dst = np.concatenate([rng.randint(0, n - 1, e),
                          rng.randint(0, n - 1, 300), np.ones(300, np.int64)])
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False,
                          device="cpu"))


def _inputs(n, heads, feats, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, heads, feats).astype(np.float32),
            rng.randn(n, heads).astype(np.float32),
            rng.randn(n, heads).astype(np.float32),
            rng.randn(n, heads, feats).astype(np.float32))


def _jax_grads(jg, h, ss, sd, g, drop):
    salt = jnp.asarray(SALT) if drop else None
    fn = lambda *a: ja._gat_attention_ell(  # noqa: E731
        jg, *a, negative_slope=SLOPE, attn_dropout=1 - KEEP if drop else 0.0,
        salt=salt)
    _, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in (h, ss, sd)))
    return [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _backward(pg, h, ss, sd, g, drop, items=4):
    """A1 on the row list, then A3 and A4 as the autograd Function runs
    them, on lists of ``items`` items a unit: every output by name."""
    n, heads, feats = h.shape
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), n, "cpu",
                          dedup=not drop, items=items)
    tab = pa.pack_table(torch.from_numpy(h).reshape(n, -1),
                        torch.from_numpy(ss))
    sd = torch.from_numpy(sd)
    rmax0, dinv = pa.attn_stats(lists.rows, lists.mult, tab, sd, heads,
                                feats, SLOPE)
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    keep = KEEP if drop else 1.0
    outs = pa.attn_backward(lists, tab, sd, rmax0, dinv,
                            torch.from_numpy(g).reshape(n, -1), heads, feats,
                            SLOPE, salt, keep)
    outs["lists"] = lists
    return outs


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("heads,feats", SHAPES)
def test_backward_matches_jax(heads, feats, drop):
    """A3's ``ds_dst`` and A4's ``dh`` and ``ds_src`` against JAX's
    gradients, with the hub row and column split over many units."""
    jg, pg = _graphs()
    h, ss, sd, g = _inputs(pg.n_nodes, heads, feats)
    dh, ds_src, ds_dst = _jax_grads(jg, h, ss, sd, g, drop)
    outs = _backward(pg, h, ss, sd, g, drop)
    assert outs["lists"].rows.split.shape[0] > 0
    assert outs["lists"].cols.split.shape[0] > 0
    tol = DROP_GRAD_TOL if drop else GRAD_TOL
    np.testing.assert_allclose(outs["dh"].view(dh.shape).numpy(), dh, **tol)
    np.testing.assert_allclose(outs["ds_src"].numpy(), ds_src, **tol)
    np.testing.assert_allclose(outs["ds_dst"].numpy(), ds_dst, **tol)


@pytest.mark.parametrize("heads,feats", [(8, 8), (1, 40)])
def test_split_rows_match_whole_rows(heads, feats):
    """Lists of 4 items a unit (split rows) against one unit a row: the
    parts and the fix-up reorder the sums only."""
    _, pg = _graphs(seed=1)
    h, ss, sd, g = _inputs(pg.n_nodes, heads, feats, seed=4)
    split = _backward(pg, h, ss, sd, g, True)
    whole = _backward(pg, h, ss, sd, g, True, items=10**6)
    assert whole["lists"].rows.split.shape[0] == 0
    for name in ("rowdot", "ds_dst", "dh", "ds_src"):
        np.testing.assert_allclose(split[name].numpy(), whole[name].numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("feats", [1, 7, 8, 40, 41, 128, 160, 256])
def test_dots_follow_the_lanes(feats):
    """``_dots`` adds, from +0, each lane's vectors i, i + ne, ... (a
    vector's features in order), then the lanes in the shuffle tree."""
    rng = np.random.RandomState(feats)
    a = rng.randn(5, feats).astype(np.float32)
    b = rng.randn(5, feats).astype(np.float32)
    vec, ne, _ = pa.head_lanes(1, feats)
    nq = feats // vec
    want = np.zeros(5, np.float32)
    for row in range(5):
        lanes = [np.float32(0)] * ne
        for q in range(nq):
            for k in range(vec):
                f = q * vec + k
                lanes[q % ne] = np.float32(
                    lanes[q % ne] + np.float32(a[row, f] * b[row, f]))
        s = 1
        while s < ne:
            for i in range(0, ne - s, 2 * s):
                lanes[i] = np.float32(lanes[i] + lanes[i + s])
            s *= 2
        want[row] = lanes[0]
    got = pa._dots(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("heads,feats,lanes", [
    (8, 8, (4, 2, 16)), (1, 40, (4, 10, 10)), (4, 40, (4, 10, 30)),
    (3, 6, (1, 6, 18)), (1, 41, (1, 32, 32)), (2, 160, (4, 32, 32)),
    (64, 4, (4, 1, 32))])
def test_head_lanes(heads, feats, lanes):
    """A unit's lanes hold whole heads: ``(vec, ne, group)``."""
    assert pa.head_lanes(heads, feats) == lanes


@pytest.mark.parametrize("drop", [True, False])
def test_given_rowdot(drop):
    """A3 given the row's own ``rowdot`` gives the own mode's bits; given
    the sum over two slices of the edges, the slices' ``ds_dst`` add up to
    the whole list's (a gspmd edge shard's merge)."""
    _, pg = _graphs(seed=2)
    n, heads, feats = pg.n_nodes, 8, 8
    h, ss, sd, g = (torch.from_numpy(v.reshape(n, -1)) for v in
                    _inputs(n, heads, feats, seed=6))
    tab = pa.pack_table(h, ss)
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    keep = KEEP if drop else 1.0
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), n, "cpu",
                          items=4)
    rmax0, dinv = pa.attn_stats(lists.rows, None, tab, sd, heads, feats,
                                SLOPE)
    args = (tab, sd, rmax0, dinv, g, heads, feats, SLOPE, salt, keep)
    own, ds_dst = pa.attn_bwd_rows(lists.rows, None, *args)
    given = pa.attn_bwd_rows(lists.rows, None, *args,
                             rowdot=own.contiguous())[1]
    assert torch.equal(given, ds_dst)
    row, col = pg.row.numpy(), pg.col.numpy()
    half = len(row) // 2
    slices = [pa.attn_lists(row[s], col[s], n, "cpu", items=4,
                            id_base=s.start)
              for s in (slice(0, half), slice(half, len(row)))]
    merged = pa.sharded_backward(slices, tab, sd, rmax0, dinv, g, heads,
                                 feats, SLOPE, salt, keep, reduce=pa.folded)
    np.testing.assert_allclose(merged["rowdot"].numpy(), own.numpy(),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(merged["ds_dst"].numpy(), ds_dst.numpy(),
                               rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("heads,feats", [(8, 8), (1, 40)])
def test_isolated_node_gets_zeros(heads, feats):
    """Node n - 1 has no edge: A3's and A4's outputs there are zeros."""
    _, pg = _graphs(seed=5)
    h, ss, sd, g = _inputs(pg.n_nodes, heads, feats, seed=7)
    outs = _backward(pg, h, ss, sd, g, True)
    for name in ("rowdot", "ds_dst", "dh", "ds_src"):
        last = outs[name][-1]
        assert torch.equal(last, torch.zeros_like(last)), name
        assert torch.isfinite(outs[name]).all(), name
