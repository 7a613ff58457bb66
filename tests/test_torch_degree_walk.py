"""K1's degree walk (``csrc/degree_walk.cuh``: one segmented sum over equal
shares of a list's edges) on the CPU, where ``ell_degree_masked`` takes its
plain version, against the JAX package's ``stochastic_degree`` on the same
numpy graphs and draws, by column and by row, over float32 and bfloat16
grids (``GNNTF_GRID_VALUE_DTYPE``).

The graphs hold a column longer than a block's share (``DEGREE_SHARE``
edges), a column longer than a lane's run (``DEGREE_EDGES``) and empty rows
and columns; each case also runs at shares cut to 64 items (8 lanes of 8),
where most columns span lanes and blocks.

Tolerances: ``rtol=1e-6`` against JAX (``RTOL`` of test_torch_stochastic):
the values are quarters and ``1 / keep`` a power of two, so every sum is
exact in float32 whatever its order, and the tolerance holds the function,
not the order; the plain version against a float64 sum within ``1e-6 *
sum|w|`` a row, with random values and keep 0.3.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import stochastic as jst
from gnntf_tpu_torch.ops import blocked
from gnntf_tpu_torch.ops import ell_degree_masked, ell_degree_masked_plain
from gnntf_tpu_torch.ops import stochastic as pst
from _jax_budget import release_jax_layout_caches  # noqa: F401

RTOL = 1e-6
KNOB = "GNNTF_GRID_VALUE_DTYPE"
N = 3000
HUB, LONG = 33, 7  # the column of more than a share, of more than a lane
SALT = (0x9E3779B9, 0xDEADBEEF)


@pytest.fixture(params=["float32", "bfloat16"])
def values(request, monkeypatch):
    """The grids' value dtype (both packages read the knob)."""
    monkeypatch.setenv(KNOB, request.param)
    return request.param


@pytest.fixture(params=["walk", "small"])
def shares(request, monkeypatch):
    """The walk's shares, or shares of 64 items (8 lanes of 8 edges)."""
    if request.param == "small":
        monkeypatch.setattr(blocked, "DEGREE_LANES", 8)
        monkeypatch.setattr(blocked, "DEGREE_EDGES", 8)
        monkeypatch.setattr(blocked, "DEGREE_SHARE", 64)
    return blocked.DEGREE_SHARE


def _edges(seed, hub=5000, e=12_000, weighted=True):
    """Edges from even rows to columns that are multiples of 3 (the other
    rows and columns stay empty), ``hub`` more into column HUB and 40 into
    column LONG, shuffled; quarter values in [0.25, 2] (or random values
    in [0.5, 1.5] unless ``weighted``)."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, N // 2, e + hub + 40) * 2
    col = np.concatenate([rng.randint(0, N // 3, e) * 3, np.full(hub, HUB),
                          np.full(40, LONG)])
    order = rng.permutation(len(row))
    row, col = row[order], col[order]
    val = (rng.randint(1, 9, len(row)) / 4 if weighted
           else rng.rand(len(row)) + 0.5).astype(np.float32)
    return row, col, val


def _graphs(row, col, val):
    """The same directed graph in both packages."""
    kw = dict(n_nodes=N, directed=True, sort=False)
    return (gt.from_edges(row, col, val, **kw),
            tt.from_edges(row, col, val, device="cpu", **kw))


def _dropped(jg, pg, keep, n_drop=None, salt=SALT):
    n_drop = pg.n_edges if n_drop is None else n_drop
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=keep, drop_n=n_drop)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=keep, drop_n=n_drop)
    return jd, pd


def _shape_of(pg):
    """The graph's columns and rows hold what the cases need."""
    counts = np.bincount(pg.col.numpy(), minlength=N)
    assert counts[HUB] > blocked.DEGREE_SHARE
    assert counts[LONG] > blocked.DEGREE_EDGES
    assert (counts == 0).any()
    assert (np.bincount(pg.row.numpy(), minlength=N) == 0).any()


@pytest.mark.parametrize("by", ["col", "row"])
def test_degree_walk_matches_jax(values, shares, by):
    jg, pg = _graphs(*_edges(0))
    _shape_of(pg)
    jd, pd = _dropped(jg, pg, 0.5)
    ours = pst.stochastic_degree(pd, by=by).numpy()
    ref = np.asarray(jst.stochastic_degree(jd, by=by))
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    assert ours[HUB if by == "col" else 0] > 0


@pytest.mark.parametrize("case", ["all_dropped", "keep_1", "n_drop_below"])
@pytest.mark.parametrize("by", ["col", "row"])
def test_degree_walk_edge_cases_match_jax(values, shares, case, by):
    """Keep 1/16 (columns whose edges are all dropped, of a degree +0),
    keep 1.0, and ``n_drop`` below the edge count (the last 3,000 ids
    always kept, unscaled)."""
    jg, pg = _graphs(*_edges(1))
    keep, n_drop = {"all_dropped": (1 / 16, None), "keep_1": (1.0, None),
                    "n_drop_below": (0.25, pg.n_edges - 3000)}[case]
    jd, pd = _dropped(jg, pg, keep, n_drop)
    ours = pst.stochastic_degree(pd, by=by).numpy()
    ref = np.asarray(jst.stochastic_degree(jd, by=by))
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    held = np.bincount((pg.col if by == "col" else pg.row).numpy(),
                       minlength=N) > 0
    if case == "all_dropped":
        assert (held & (ours == 0)).any()
    if case == "keep_1":  # every edge kept: the graph's own sums
        line = (pg.col if by == "col" else pg.row).numpy()
        np.testing.assert_array_equal(ours, np.bincount(
            line, pg.val.numpy(), minlength=N).astype(np.float32))


@pytest.mark.parametrize("by", ["col", "row"])
def test_degree_walk_over_slices_matches_jax(values, shares, by):
    """Two slices of the edge list, as gspmd's ranks hold them: each
    slice's lists (``RankSlice.grids``' build) walked with ``id_base`` at
    its first edge, so the mask is the whole list's; their sum is the whole
    graph's degrees."""
    row, col, val = _edges(2)
    jg, pg = _graphs(row, col, val)
    jd, pd = _dropped(jg, pg, 0.5)
    cut = 7001
    total = torch.zeros(N)
    vals = pst._grid_values(val)
    vals = torch.from_numpy(vals.view(np.int16)).view(torch.bfloat16) \
        if vals.dtype == np.uint16 else torch.from_numpy(vals)
    for lo, hi in ((0, cut), (cut, len(row))):
        rows, cols = pst.build_train_grids(
            row[lo:hi], col[lo:hi], np.zeros(hi - lo, np.float32),
            N).lists("cpu")
        total += ell_degree_masked(cols if by == "col" else rows,
                                   vals[lo:hi].contiguous(), pd.drop_salt,
                                   0.5, pd.drop_n, id_base=lo)
    ref = np.asarray(jst.stochastic_degree(jd, by=by))
    np.testing.assert_allclose(total.numpy(), ref, rtol=RTOL)


@pytest.mark.parametrize("by", ["col", "row"])
def test_degree_plain_against_float64(values, shares, by):
    """Random values, keep 0.3 (``1 / keep`` not a power of two): each
    row within ``1e-6 * sum|w|`` of the float64 sum of its weights."""
    row, col, val = _edges(3, weighted=False)
    grids = pst.build_train_grids(row, col, val, N)
    rows, cols = grids.lists("cpu")
    lst = cols if by == "col" else rows
    base = grids.values("cpu").to(torch.float32)
    salt = torch.tensor(SALT)
    deg = ell_degree_masked_plain(lst, grids.values("cpu"), salt, 0.3,
                                  len(row))
    w = pst.dropped_values(base.double(), torch.arange(len(row)), salt, 0.3,
                           len(row))
    line = (col if by == "col" else row)
    want = np.zeros(N)
    np.add.at(want, line, w.numpy())
    mag = np.zeros(N)
    np.add.at(mag, line, np.abs(w.numpy()))
    assert (np.abs(deg.numpy() - want) <= 1e-6 * mag).all()
    assert (deg.numpy()[mag == 0] == 0).all()
