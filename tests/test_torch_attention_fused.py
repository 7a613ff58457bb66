"""GAT's forward as one walk (``attn_softmax_aggregate``,
``gnntf_tpu_torch/csrc/softmax_walk.cuh``) through its plain version on the
CPU, in the walk's order: each segment (a row of a unit, or a piece of a
split row) as A1 and A2 sum it, then a split row's pieces folded by
rescaling to the row's maximum, in runs of ``_RUN_PIECES`` pieces and
``_MERGE_WARPS`` parts.

Against JAX (``gnntf_tpu/ops/attention.py::_make_gat_core``, the same numpy
inputs): the whole graph's forward and its gradients at GAT's layer shapes
(8 heads of 8; one head of 40) and at 41 features, per-edge lists with
dropout and coalesced lists with multiplicities, on lists with split rows
(units of 32 items with a hub row, and of 4 items), with an isolated
destination.  Tolerances are ``tests/test_torch_attention.py``'s: forward
rtol=1e-5, atol=1e-5; gradients rtol=1e-4, atol=1e-5, and atol=1e-4 with
dropout.

Exact: a whole row's outputs equal A1's and A2's plain versions bit for
bit; the plan's tasks (runs first) and each split row's runs; the route.
Within ``1e-5 * sum|terms|`` of A1 and A2: split rows.
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
from _jax_budget import release_jax_layout_caches  # noqa: F401

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DROP_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SALT = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
SLOPE = 0.2
KEEP = 0.6
SHAPES = [(8, 8), (1, 40), (1, 41)]


def _graphs(n=90, e=700, hub=300, seed=0):
    """A random symmetrized graph with duplicate edges, a hub row and a hub
    column of ``hub`` edges each, and node n - 1 isolated, in both
    packages."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, n - 1, e), np.zeros(hub, np.int64),
                          rng.randint(0, n - 1, hub)])
    dst = np.concatenate([rng.randint(0, n - 1, e),
                          rng.randint(0, n - 1, hub), np.ones(hub, np.int64)])
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False,
                          device="cpu"))


def _inputs(n, heads, feats, seed=3):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, heads, feats).astype(np.float32),
            rng.randn(n, heads).astype(np.float32),
            rng.randn(n, heads).astype(np.float32),
            rng.randn(n, heads, feats).astype(np.float32))


def _jax(jg, h, ss, sd, g, drop):
    salt = jnp.asarray(SALT) if drop else None
    fn = lambda *a: ja._gat_attention_ell(  # noqa: E731
        jg, *a, negative_slope=SLOPE, attn_dropout=1 - KEEP if drop else 0.0,
        salt=salt)
    out, vjp = jax.vjp(fn, *(jnp.asarray(v) for v in (h, ss, sd)))
    return np.asarray(out), [np.asarray(v) for v in vjp(jnp.asarray(g))]


def _torch(pg, h, ss, sd, g, drop, items):
    """The autograd Function over lists of ``items`` items a unit: the
    output and the gradients of h, s_src and s_dst, and the lists."""
    n = pg.n_nodes
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), n, "cpu",
                          dedup=not drop, items=items)
    args = [torch.tensor(v, requires_grad=True) for v in (h, ss, sd)]
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    out = pa._AttnFn.apply(*args, lists, salt, KEEP if drop else 1.0, SLOPE)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [a.grad.numpy() for a in args], lists


@pytest.mark.parametrize("items", [32, 4])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("heads,feats", SHAPES)
def test_fused_forward_and_gradients_match_jax(heads, feats, drop, items,
                                               monkeypatch):
    """The forward takes the fused walk (its plain version here) on lists
    whose hub row is split, and its output and gradients match JAX's."""
    jg, pg = _graphs()
    h, ss, sd, g = _inputs(pg.n_nodes, heads, feats)
    ref, ref_grads = _jax(jg, h, ss, sd, g, drop)
    calls = []
    real = pa.attn_softmax_aggregate_plain
    monkeypatch.setattr(pa, "attn_softmax_aggregate_plain",
                        lambda *a: calls.append(1) or real(*a))
    out, grads, lists = _torch(pg, h, ss, sd, g, drop, items)
    assert calls == [1]
    assert lists.rows.split.shape[0] > 0 and lists.plan.n_runs > 0
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    assert np.array_equal(out[-1], np.zeros_like(out[-1]))
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want,
                                   **(DROP_GRAD_TOL if drop else GRAD_TOL))


@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("heads,feats", SHAPES)
def test_fused_forward_with_many_runs_matches_jax(heads, feats, drop):
    """A hub of 6,000 edges (about 3,500 distinct pairs) in units of 4
    items: more than 32 runs, so the merge's parts fold more than one run
    each."""
    jg, pg = _graphs(n=5000, e=2000, hub=6000, seed=4)
    h, ss, sd, g = _inputs(pg.n_nodes, heads, feats, seed=5)
    ref, ref_grads = _jax(jg, h, ss, sd, g, drop)
    out, grads, lists = _torch(pg, h, ss, sd, g, drop, 4)
    assert int(lists.plan.split_runs[:, 1].max()) > pa._MERGE_WARPS
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want,
                                   **(DROP_GRAD_TOL if drop else GRAD_TOL))


def _forwards(pg, heads, feats, drop, items):
    n = pg.n_nodes
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), n, "cpu",
                          dedup=not drop, items=items)
    h, ss, sd, _ = (torch.from_numpy(v.reshape(n, -1))
                    for v in _inputs(n, heads, feats, seed=8))
    tab = pa.pack_table(h, ss)
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    keep = KEEP if drop else 1.0
    fused = pa.attn_forward(lists, tab, sd, heads, feats, SLOPE, salt, keep,
                            fused=True)
    split = pa.attn_forward(lists, tab, sd, heads, feats, SLOPE, salt, keep,
                            fused=False)
    return lists, tab, sd, salt, keep, fused, split


@pytest.mark.parametrize("items", [32, 4])
@pytest.mark.parametrize("drop", [True, False])
@pytest.mark.parametrize("heads,feats", SHAPES + [(4, 8), (2, 3)])
def test_whole_rows_equal_a1_a2_and_split_rows_within_terms(heads, feats,
                                                           drop, items):
    """A row that no unit splits gets A1's and A2's bits; a split row is
    within ``1e-5 * sum|terms|`` of them (``attn_error_scales``)."""
    _, pg = _graphs(seed=6)
    lists, tab, sd, salt, keep, fused, split = _forwards(pg, heads, feats,
                                                         drop, items)
    n = pg.n_nodes
    whole = torch.ones(n, dtype=torch.bool)
    whole[lists.rows.split[:, 0].long()] = False
    assert 0 < int(whole.sum()) < n
    g = torch.zeros(n, heads * feats)
    scales = pa.attn_error_scales(lists, tab, sd, split["rmax0"],
                                  split["dinv"], g, split["rmax0"], heads,
                                  feats, SLOPE, salt, keep)
    for name in ("rmax0", "dinv", "out"):
        assert torch.equal(fused[name][whole], split[name][whole]), name
        diff = (fused[name] - split[name]).abs()
        assert bool((diff <= 1e-5 * scales[name]).all()), (
            name, float(diff.max()))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("items", [32, 4, 10**6])
def test_plan_runs_first_then_packed_rows(dedup, items):
    """The plan's tasks: each split row's pieces in runs of at most
    ``_RUN_PIECES``, in list order; then every row that no unit splits,
    once, in row order, in runs of consecutive rows of at most 32 slots
    and ``_TASK_ROWS`` rows; each split row's runs; no plan for units of
    more than 32 items."""
    _, pg = _graphs(seed=7)
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), pg.n_nodes, "cpu",
                          dedup=dedup, items=items)
    plan, lst = lists.plan, lists.rows
    if items > pa._SEGMENT_SLOTS:
        assert plan is None
        return
    task = plan.task.numpy().astype(np.int64)
    unit_row = lst.unit_row.numpy()
    split = lst.split.numpy()
    runs = task[:plan.n_runs]
    assert (runs[:, 1] >= 1).all() and (runs[:, 1] <= pa._RUN_PIECES).all()
    covered = np.concatenate([np.arange(f, f + c) for f, c in runs]
                             or [np.zeros(0, np.int64)])
    assert np.array_equal(covered, np.flatnonzero(unit_row[:-1] < 0))
    split_runs = plan.split_runs.numpy()
    assert split_runs.shape == (len(split), 2)
    assert np.array_equal(split_runs[:, 1],
                          -(-split[:, 2] // pa._RUN_PIECES))
    for (first, count), (_, piece, pieces) in zip(split_runs, split):
        mine = runs[first:first + count]
        assert mine[0, 0] == piece and mine[:, 1].sum() == pieces
    ptr = lst.ptr.numpy().astype(np.int64)
    rows = task[plan.n_runs:]
    whole = np.setdiff1d(np.arange(lst.n_rows), split[:, 0])
    listed = np.concatenate([np.arange(f, f + c) for f, c in rows])
    assert np.array_equal(listed, whole)
    assert (rows[:, 1] >= 1).all() and (rows[:, 1] <= pa._TASK_ROWS).all()
    ends = rows[:, 0] + rows[:, 1]
    slots = ptr[ends] - ptr[rows[:, 0]]
    assert (slots <= pa._SEGMENT_SLOTS).all()
    # packed greedily: a task stops only at a split row, the list's end, or
    # where its next row would pass a bound
    nxt = np.minimum(ends, lst.n_rows - 1)
    free = (ends < lst.n_rows) & ~np.isin(ends, split[:, 0])
    full = (rows[:, 1] == pa._TASK_ROWS) | (
        ptr[nxt + 1] - ptr[rows[:, 0]] > pa._SEGMENT_SLOTS)
    assert (full | ~free).all()


@pytest.mark.parametrize("heads,feats,fused", [
    (8, 8, True), (1, 40, True), (1, 41, True), (4, 8, True), (32, 4, True),
    (16, 8, True), (3, 6, True), (6, 8, True), (3, 64, False),
    (2, 320, False), (64, 1, False)])
def test_route(heads, feats, fused):
    """The fused walk takes at most 32 heads as whole heads of lanes in A2's
    group (``min(32, W / vec)`` lanes) and at most 128 feature vectors a
    row; lists cut into units of more than 32 items take A1 then A2."""
    _, pg = _graphs(seed=8)
    row, col, n = pg.row.numpy(), pg.col.numpy(), pg.n_nodes
    assert pa.softmax_route(pa.attn_lists(row, col, n, "cpu"), heads,
                            feats) == fused
    assert not pa.softmax_route(pa.attn_lists(row, col, n, "cpu",
                                              items=10**6), heads, feats)


@pytest.mark.parametrize("drop", [True, False])
def test_sharded_forward_equals_the_whole_lists(drop):
    """A1 and A2 over two slices of the edges (per-edge lists), merged
    (``sharded_forward`` with ``folded``), give the whole list's fused
    forward (coalesced without dropout)."""
    _, pg = _graphs(seed=9)
    n, heads, feats = pg.n_nodes, 8, 8
    lists, tab, sd, salt, keep, fused, _ = _forwards(pg, heads, feats, drop,
                                                     4)
    row, col = pg.row.numpy(), pg.col.numpy()
    half = len(row) // 2
    slices = [pa.attn_lists(row[s], col[s], n, "cpu", items=4,
                            id_base=s.start)
              for s in (slice(0, half), slice(half, len(row)))]
    merged = pa.sharded_forward(slices, tab, sd, heads, feats, SLOPE, salt,
                                keep, reduce=pa.folded)
    for name in ("rmax0", "dinv", "out"):
        np.testing.assert_allclose(merged[name].numpy(), fused[name].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_empty_rows_and_isolated_destination():
    """Rows without slots: rmax0 0, dinv 1e30, out 0, as A1 and A2 write
    them."""
    pg = tt.from_edges([0, 1, 2], [1, 2, 0], n_nodes=10, directed=False,
                       device="cpu")
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), 10, "cpu")
    rng = np.random.RandomState(1)
    h = torch.from_numpy(rng.randn(10, 8).astype(np.float32))
    s = torch.from_numpy(rng.randn(10, 2).astype(np.float32))
    tab = pa.pack_table(h, s)
    rmax0, dinv, out = pa.attn_softmax_aggregate(
        lists.rows, lists.plan, None, tab, s, 2, 4, SLOPE)
    assert torch.equal(rmax0[3:], torch.zeros(7, 2))
    assert torch.equal(dinv[3:], torch.full((7, 2), 1e30))
    assert torch.equal(out[3:], torch.zeros(7, 8))
    assert torch.isfinite(out).all()


def test_wrapper_counts_only_card_launches():
    """On the CPU the fused wrapper runs its plain version and counts
    nothing."""
    _, pg = _graphs()
    before = pa.attn_softmax_aggregate.launches
    h, ss, sd, _ = (torch.tensor(v, requires_grad=True)
                    for v in _inputs(pg.n_nodes, 8, 8))
    from gnntf_tpu_torch.ops import stochastic
    with stochastic.min_edges_scope(0):
        pa.gat_attention(pg, h, ss, sd).sum().backward()
    assert pa.attn_softmax_aggregate.launches == before
