"""The ELL gather-reduce wrapper (K1) of the torch port, without JAX, so the
card tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ell_gather.py

K1 walks a list of the ELL grid's live slots (``ell_list``) and adds each
row's sum into a base.  On the CPU the wrapper takes the plain version,
which is held here against a dense product (rtol=atol=1e-5: float32 against
float64) and, bit for bit, against a one-sum-at-a-time float32 emulation of
the kernel's order.  On the card the kernel is held bit for bit against the
plain version run on the CPU: both round each product and each sum apart,
in that order.

K1's scaled walk (``ell_gather_scaled``, the prepared operator's route
under ``auto``) walks ``whole_list`` (the same slots, ``ptr`` over every
row) in store mode and writes ``rs * sum + w * x`` with the gathered rows
scaled by ``cs``: its plain version is held against a float64 dense
product on the CPU (rtol=atol=1e-5), the kernel against the plain version
on the card (within ``1e-5 * sum|terms|``) and bit for bit against the CPU.

K1's backward ``dx = A_rest^T dy`` walks the transposed list
(``ell_transposed_list``) in the walk's store mode (``ell_gather_transposed``):
on the CPU its plain version is held against autograd of the dense product
(rtol=atol=1e-5), on the card the kernel bit for bit against the CPU.  The
scaled walk's backward (``ell_gather_scaled_backward``, ``dx = cs * (A^T
(rs * dy)) + w * dy`` in one launch over the transposed list): its plain
version bit for bit the composition it replaced (``rs * dy``, the
transposed walk's sum, ``* cs``, ``+ w * dy``) on the CPU; on the card
both scaled walks bit for bit their plain versions on the CPU, twice in a
row and in a replayed CUDA graph (the split rows' counters come back to
zero), on lists with rows split into 2 to 3,000 pieces.

The two dropout walks (``ell_gather_masked``, ``csrc/drop_walk.cuh``, over
lists cut into tiles by ``drop_tiles``; ``ell_degree_masked``,
``csrc/degree_walk.cuh``, over equal shares of a list's edges) run over the
training grids' row and column lists of a dropped graph; they are held the
same way, the plain versions against the dense dropped matrix on the CPU,
the kernels against the plain versions on the card (within ``1e-5 *
sum|terms|`` per element, and bit for bit against the CPU and a relaunch),
also with other piece and tile sizes and with an inf and a NaN on dropped
edges' sources (NaNs where the plain version's are).  On the CPU, a
one-addition-at-a-time sum of the kept edges alone, in each walk's order,
equals the plain version bit for bit: leaving the dropped edges out
changes no bit.
"""
import dataclasses
import importlib
from unittest import mock

import numpy as np
import pytest
import torch

import gnntf_tpu_torch.ops.blocked as blocked_ops
from gnntf_tpu_torch.ops import (blocked_spmm_plain, build_train_grids,
                                 ell_degree_masked, ell_degree_masked_plain,
                                 ell_edge_list, ell_gather, ell_gather_list,
                                 ell_gather_masked, ell_gather_masked_plain,
                                 ell_gather_plain, ell_list)
from gnntf_tpu_torch.ops.ell_gather import (ell_gather_scaled,
                                           ell_gather_scaled_backward,
                                           ell_gather_scaled_backward_plain,
                                           ell_gather_scaled_plain,
                                           whole_list)
from gnntf_tpu_torch.ops.spmm import PreparedSpMM, _ELLGatherFn, build_ell
from gnntf_tpu_torch.ops.stochastic import drawn_values, keep_mask

# the module, not the function that ``gnntf_tpu_torch.ops`` exports as
# ``ell_gather``
k1_ops = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
TOL = dict(rtol=1e-5, atol=1e-5)


def _ell_inputs(seed, n=500, e=4000, f=16, heavy=0, dedup=True):
    """An ELL layout with duplicates and empty (odd) rows; ``heavy`` extra
    edges all land on row 0, so that row is split over many units."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e) * 2
    col = rng.randint(0, n, size=e)
    if heavy:
        row = np.concatenate([row, np.zeros(heavy, row.dtype)])
        col = np.concatenate([col, rng.randint(0, n, size=heavy)])
    layout = build_ell(row, col, n, 8, dedup=dedup)
    vals = rng.randn(layout.n_vrows, layout.k).astype(np.float32)
    vals[layout.idx == n] = 0.0
    x = rng.randn(n, f).astype(np.float32)
    return layout, vals, x


def _tensors(layout, vals, x, device="cpu"):
    return [torch.from_numpy(a).to(device)
            for a in (layout.idx, vals, x, layout.vrow_row)]


def _dense_reference(layout, vals, x):
    n = layout.n_nodes
    a = np.zeros((n, n + 1), np.float64)
    rows = np.repeat(layout.vrow_row, layout.k)
    np.add.at(a, (rows, layout.idx.reshape(-1)), vals.reshape(-1))
    return a[:, :n] @ x.astype(np.float64)


@pytest.mark.parametrize("f", [1, 6, 16, 40])
def test_plain_matches_dense(f):
    layout, vals, x = _ell_inputs(0, f=f, heavy=300)
    out = ell_gather_plain(*_tensors(layout, vals, x), layout.n_nodes)
    np.testing.assert_allclose(out.numpy(), _dense_reference(layout, vals, x),
                               **TOL)


@pytest.mark.parametrize("dedup", [True, False])
def test_ell_list_keeps_live_slots_in_grid_order(dedup):
    """Rows without a slot (the odd ones) are dropped, pads are gone, and
    the slots of a row keep the grid's order (virtual row, then slot);
    without dedup a duplicate pair keeps a slot of its own.  The heavy row
    is split over many units."""
    n = 500
    layout, _, _ = _ell_inputs(1, n=n, heavy=1200, dedup=dedup)
    rows, ptr, src, slot = ell_list(layout.idx, layout.vrow_row, n)
    assert rows.dtype == ptr.dtype == src.dtype == np.int32
    live = layout.idx < n
    held = np.unique(np.repeat(layout.vrow_row, layout.k)[live.reshape(-1)])
    np.testing.assert_array_equal(rows, held)
    assert not np.any(rows % 2) and np.all(np.diff(ptr) > 0)
    np.testing.assert_array_equal(slot, np.flatnonzero(live))
    np.testing.assert_array_equal(src, layout.idx.reshape(-1)[slot])
    assert ptr[-1] == int(live.sum()) and np.all(src < n)
    per_row = np.bincount(layout.vrow_row[slot // layout.k], minlength=n)
    np.testing.assert_array_equal(np.diff(ptr), per_row[rows])
    lst, _ = ell_edge_list(layout.idx, layout.vrow_row, n, "cpu")
    split = lst.split.numpy()
    assert lst.rows is not None and lst.eid is None
    assert split[0, 0] == 0 and split[0, 2] > 5  # row 0, 400+ slots


def test_ell_list_groups_an_unsorted_grid():
    """Virtual rows in any order: a row's slots are gathered in grid
    order, and the product is unchanged."""
    layout, vals, x = _ell_inputs(2, heavy=100)
    order = np.random.RandomState(0).permutation(layout.n_vrows)
    idx, vrow = layout.idx[order], layout.vrow_row[order]
    rows, ptr, src, slot = ell_list(idx, vrow, layout.n_nodes)
    row_of = vrow[slot // layout.k]
    np.testing.assert_array_equal(row_of, np.repeat(rows, np.diff(ptr)))
    assert np.all(np.diff(slot)[np.diff(row_of) == 0] > 0)
    out = ell_gather_plain(*[torch.from_numpy(a) for a in
                             (idx, vals[order], x, vrow)], layout.n_nodes)
    np.testing.assert_allclose(out.numpy(), _dense_reference(layout, vals, x),
                               **TOL)


@pytest.mark.parametrize("f", [1, 6, 40])
def test_plain_with_base_matches_base_plus_dense(f):
    layout, vals, x = _ell_inputs(3, f=f, heavy=300)
    base = np.random.RandomState(9).randn(layout.n_nodes, f).astype(
        np.float32)
    out = ell_gather_plain(*_tensors(layout, vals, x), layout.n_nodes,
                           out=torch.from_numpy(base.copy()))
    np.testing.assert_allclose(
        out.numpy(), base + _dense_reference(layout, vals, x), **TOL)
    # odd rows hold no slot: left as they were, bit for bit
    np.testing.assert_array_equal(out.numpy()[1::2], base[1::2])


@pytest.mark.parametrize("parts", [1, 5, 64])
def test_plain_sums_split_rows_in_fixed_parts(monkeypatch, parts):
    """The kernel's order over K1's list: a row, or a piece of a split row,
    in slot order; a split row's pieces in ``_FIXUP_PARTS`` parts (part g
    sums pieces g, g + P, ... in turn), the parts in order; then one
    addition into the base.  Emulated here one float32 sum at a time; on
    the CPU the plain version equals it bit for bit."""
    monkeypatch.setattr(blocked_ops, "_FIXUP_PARTS", parts)
    monkeypatch.setattr(k1_ops, "_UNIT_ITEMS", 8)
    layout, vals, x = _ell_inputs(4, f=6, heavy=400)
    n = layout.n_nodes
    base = np.random.RandomState(5).randn(n, 6).astype(np.float32)
    lst, slot = ell_edge_list(layout.idx, layout.vrow_row, n, "cpu")
    val = vals.reshape(-1)[slot]
    assert lst.split.shape[0] > 1 and lst.split[:, 2].max() > 30
    ptr, src = lst.ptr.numpy(), lst.idx.numpy()
    unit_edge = lst.unit_edge.numpy()

    def run(e0, e1):
        acc = np.zeros(6, np.float32)
        for e in range(e0, e1):
            acc = acc + x[src[e]] * val[e]
        return acc

    sums = np.stack([run(ptr[r], ptr[r + 1]) for r in range(lst.n_rows)])
    for r, first, count in lst.split.numpy():
        part = np.zeros((parts, 6), np.float32)
        for k in range(count):
            part[k % parts] += run(unit_edge[first + k],
                                   unit_edge[first + k + 1])
        sums[r] = np.zeros(6, np.float32)
        for g in range(parts):
            sums[r] = sums[r] + part[g]
    want = base.copy()
    rows = lst.rows.numpy()
    want[rows] = base[rows] + sums
    out = ell_gather_list(lst, torch.from_numpy(val), torch.from_numpy(x),
                          torch.from_numpy(base.copy()))
    np.testing.assert_array_equal(out.numpy(), want)


def test_gradient_for_x_and_base():
    """``_ELLGatherFn``'s backward: ``A^T dy`` for ``x`` (against a dense
    product) and ``dy`` itself for a base that requires grad."""
    layout, vals, x = _ell_inputs(5, f=6, heavy=200)
    n = layout.n_nodes
    lst, slot = ell_edge_list(layout.idx, layout.vrow_row, n, "cpu")
    val = torch.from_numpy(vals.reshape(-1)[slot])
    rng = np.random.RandomState(6)
    dy = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    leaf = torch.from_numpy(rng.randn(n, 6).astype(np.float32))
    leaf.requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = _ELLGatherFn.apply(xt, leaf * 1.0, lst, val)
    np.testing.assert_allclose(
        out.detach().numpy(),
        leaf.detach().numpy() + _dense_reference(layout, vals, x), **TOL)
    out.backward(dy)
    a = np.zeros((n, n + 1), np.float64)
    np.add.at(a, (np.repeat(layout.vrow_row, layout.k),
                  layout.idx.reshape(-1)), vals.reshape(-1))
    np.testing.assert_allclose(xt.grad.numpy(),
                               a[:, :n].T @ dy.numpy().astype(np.float64),
                               **TOL)
    assert torch.equal(leaf.grad, dy)


def _transposed_inputs(seed, n=600, f=6, hub_col=0):
    """K1's list of an ELL with duplicates, empty (odd) rows, a column no
    slot references (n - 1) and ``hub_col`` extra slots on column 5, which
    split that column over many units of the transposed list."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=5 * n) * 2
    col = rng.randint(0, n - 1, size=5 * n)
    row = np.concatenate([row, rng.randint(0, n // 2, hub_col) * 2])
    col = np.concatenate([col, np.full(hub_col, 5)])
    layout = build_ell(row, col, n, 8)
    lst, slot = ell_edge_list(layout.idx, layout.vrow_row, n, "cpu")
    val = torch.from_numpy(rng.randn(len(slot)).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    dy = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    return layout, lst, slot, val, x, dy


def test_transposed_list_sorts_slots_by_source():
    layout, lst, _, val, _, _ = _transposed_inputs(7, hub_col=300)
    n = layout.n_nodes
    lst_t = k1_ops.ell_transposed_list(lst, n)
    ptr, src = lst.ptr.numpy(), lst.idx.numpy()
    dst = np.repeat(lst.rows.numpy(), np.diff(ptr))
    order = np.lexsort((np.arange(len(src)), dst, src))
    assert lst_t.rows is None and lst_t.n_rows == n
    np.testing.assert_array_equal(lst_t.eid.numpy(), order)
    np.testing.assert_array_equal(lst_t.idx.numpy(), dst[order])
    np.testing.assert_array_equal(lst_t.ptr.numpy(), np.concatenate(
        [[0], np.cumsum(np.bincount(src, minlength=n))]))
    assert lst_t.ptr[n] == lst_t.ptr[n - 1]  # column n - 1 holds no slot
    assert lst_t.split.shape[0] >= 1  # column 5 is split


@pytest.mark.parametrize("f", [1, 6, 40])
@pytest.mark.parametrize("hub_col", [0, 400])
def test_backward_walk_matches_dense_autograd(f, hub_col):
    """``_ELLGatherFn``'s ``dx``, one walk over the transposed list, against
    autograd of the dense ``base + A_rest @ x`` in float64; the CPU counts
    no launch."""
    layout, lst, slot, val, x, dy = _transposed_inputs(8, f=f,
                                                       hub_col=hub_col)
    n = layout.n_nodes
    vals = np.zeros(layout.n_vrows * layout.k, np.float32)
    vals[slot] = val.numpy()
    a = np.zeros((n, n + 1), np.float64)
    np.add.at(a, (np.repeat(layout.vrow_row, layout.k),
                  layout.idx.reshape(-1)), vals)
    xd = x.double().requires_grad_()
    (torch.from_numpy(a[:, :n]) @ xd).backward(dy.double())
    before = (ell_gather.launches, ell_gather.backward_launches)
    transposed = lambda: k1_ops.ell_transposed_list(lst, n)
    xt = x.clone().requires_grad_()
    _ELLGatherFn.apply(xt, torch.zeros(n, f), lst, val,
                       transposed).backward(dy)
    np.testing.assert_allclose(xt.grad.numpy(), xd.grad.numpy(), **TOL)
    assert (ell_gather.launches, ell_gather.backward_launches) == before
    # the walk's plain version over the same list, bit for bit
    assert torch.equal(xt.grad, blocked_spmm_plain(transposed(), val, dy))


def test_prepared_builds_the_transposed_list_once():
    import gnntf_tpu_torch as tt
    rng = np.random.RandomState(9)
    n = 3000
    g = tt.normalize_adjacency(tt.from_edges(
        rng.randint(0, n, 40_000), rng.randint(0, n, 40_000), n_nodes=n,
        directed=False, device="cpu"), graph_dropout=0.0)
    prep = PreparedSpMM(g)
    routed = prep._routed
    assert routed._transposed is None  # nothing built before a backward
    built = []
    for _ in range(3):
        xt = torch.from_numpy(rng.randn(n, 4).astype(np.float32))
        xt.requires_grad_()
        prep(xt).sum().backward()
        built.append(routed._transposed)
    assert built[0] is not None and all(b is built[0] for b in built)
    assert built[0].n_edges == prep.k1_list.n_edges


def test_empty_grid_leaves_the_base():
    layout = build_ell(np.zeros(0, np.int64), np.zeros(0, np.int64), 40, 8)
    vals = np.zeros(layout.idx.shape, np.float32)
    x = np.ones((40, 8), np.float32)
    base = torch.arange(320, dtype=torch.float32).view(40, 8)
    out = ell_gather(*_tensors(layout, vals, x), 40, out=base.clone())
    assert torch.equal(out, base)
    assert not ell_gather(*_tensors(layout, vals, x), 40).any()


def test_wrapper_rejects_bad_inputs():
    layout, vals, x = _ell_inputs(1)
    args = _tensors(layout, vals, x)
    bad = list(args)
    bad[0] = bad[0].long()
    with pytest.raises(TypeError):
        ell_gather(*bad, layout.n_nodes)
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError):
        ell_gather(*bad, layout.n_nodes)
    bad = list(args)
    bad[2] = torch.from_numpy(np.asfortranarray(x))
    with pytest.raises(ValueError):
        ell_gather(*bad, layout.n_nodes)
    with pytest.raises(TypeError):
        ell_gather(*args, layout.n_nodes + 1)
    with pytest.raises(TypeError):
        ell_gather(*args, layout.n_nodes, out=torch.zeros(3, x.shape[1]))
    with pytest.raises(TypeError):
        ell_gather(*args, layout.n_nodes, out=args[2].double())
    with pytest.raises(ValueError):  # the kernel would read what it writes
        ell_gather(*args, layout.n_nodes, out=args[2])
    lst, slot = ell_edge_list(layout.idx, layout.vrow_row, layout.n_nodes,
                              "cpu")
    val = args[1].reshape(-1)[torch.from_numpy(slot)]
    with pytest.raises(TypeError):
        ell_gather_list(lst, val[:-1], args[2], torch.zeros_like(args[2]))
    with pytest.raises(TypeError):
        ell_gather_list(lst, val, args[2], torch.zeros(layout.n_nodes, 3))


def _masked_inputs(seed, n=600, e=5000, f=8, heavy=0, n_loops=0):
    """A graph's training-grid lists: edges from even rows to columns that
    are multiples of 3 (other rows and columns stay empty); ``heavy`` more
    edges from row 0 and as many into column 33 (each split over many
    units); ``n_loops`` trailing self-loops past ``n_drop``.  Returns the
    lists, random values, x and the draw's ``n_drop``."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e) * 2
    col = rng.randint(0, n // 3, size=e) * 3
    row = np.concatenate([row, np.zeros(heavy, np.int64),
                          rng.randint(0, n // 2, heavy) * 2])
    col = np.concatenate([col, rng.randint(0, n // 3, heavy) * 3,
                          np.full(heavy, 33)])
    n_drop = len(row)
    loops = np.arange(n_loops) % n
    row, col = np.concatenate([row, loops]), np.concatenate([col, loops])
    val = rng.rand(len(row)).astype(np.float32) + 0.5
    grids = build_train_grids(row, col, val, n)
    rows, cols = grids.lists("cpu")
    x = rng.randn(n, f).astype(np.float32)
    return (rows, cols), torch.from_numpy(val), torch.from_numpy(x), n_drop, \
        (row, col)


def _dropped_dense(edges, val, salt, keep, n_drop, n):
    row, col = edges
    kept = keep_mask(torch.arange(len(row)), torch.tensor(salt), keep,
                     n_drop).numpy()
    w = np.where(kept, val.numpy().astype(np.float64)
                 * np.where(np.arange(len(row)) < n_drop, 1 / keep, 1), 0)
    a = np.zeros((n, n))
    np.add.at(a, (row, col), w)
    return a


@pytest.mark.parametrize("keep", [0.5, 0.2, 1.0])
@pytest.mark.parametrize("f", [1, 8, 40])
def test_masked_plain_matches_dense(keep, f):
    """Over the row list the dropped A @ x, over the column list A^T @ x;
    the degree mode gives the row and column sums."""
    (rows, cols), val, x, n_drop, edges = _masked_inputs(
        1, f=f, heavy=700, n_loops=50)
    salt = (123, 0xDEADBEEF)
    a = _dropped_dense(edges, val, salt, keep, n_drop, 600)
    for lst, m in ((rows, a), (cols, a.T)):
        assert lst.n_rows == 600 and lst.rows is None
        out = ell_gather_masked(lst, val, torch.tensor(salt), keep, n_drop, x)
        np.testing.assert_allclose(out.numpy(), m @ x.numpy(), **TOL)
        deg = ell_degree_masked(lst, val, torch.tensor(salt), keep, n_drop)
        np.testing.assert_allclose(deg.numpy(), m.sum(1), **TOL)
    # the edges are not sorted by row: both lists read their edge ids
    assert rows.eid is not None and cols.eid is not None
    assert rows.split.shape[0] and cols.split.shape[0]


def _share_order_sums(lst, w, kept_only=False):
    """The degree walk's order (``csrc/degree_walk.cuh``), one float32
    addition at a time: a lane's run (``DEGREE_EDGES`` items) of a row from
    +0, a row's runs in a block (``DEGREE_SHARE`` items) in lane order, a
    row's blocks' sums in block order; ``kept_only``: the dropped edges
    (w == 0) left out."""
    ptr = lst.ptr.numpy()
    eid = np.arange(lst.n_edges) if lst.eid is None else lst.eid.numpy()
    w = w.numpy()
    lane, share = blocked_ops.DEGREE_EDGES, blocked_ops.DEGREE_SHARE
    out = np.zeros(lst.n_rows, np.float32)
    for r in range(lst.n_rows):
        a, b = int(ptr[r]), int(ptr[r + 1])
        total = None
        for blk in range(a // share, (b - 1) // share + 1 if b > a else 0):
            lo, hi = max(a, blk * share), min(b, (blk + 1) * share)
            block_sum = None
            for ln in range(lo // lane, (hi - 1) // lane + 1):
                acc = np.float32(0)
                for e in range(max(lo, ln * lane), min(hi, (ln + 1) * lane)):
                    if not kept_only or w[eid[e]] != 0:
                        acc = np.float32(acc + np.float32(w[eid[e]]))
                block_sum = acc if block_sum is None else np.float32(
                    block_sum + acc)
            total = block_sum if total is None else np.float32(
                total + block_sum)
        if total is not None:
            out[r] = total
    return torch.from_numpy(out)


def _small_shares(monkeypatch, lanes=8, edges=4):
    """The degree walk's shares cut small (``lanes`` x ``edges`` items), so
    a test list's rows span lanes and blocks."""
    monkeypatch.setattr(blocked_ops, "DEGREE_LANES", lanes)
    monkeypatch.setattr(blocked_ops, "DEGREE_EDGES", edges)
    monkeypatch.setattr(blocked_ops, "DEGREE_SHARE", lanes * edges)


@pytest.mark.parametrize("shares", [(128, 16), (8, 4)])
def test_masked_plain_rounds_as_the_walk(monkeypatch, shares):
    """The masked plain version is the walk's plain version over the
    draw's per-edge values; the degree's is the degree walk's order over
    them, one addition at a time, bit for bit (at the walk's shares and at
    shares of 32 items, where rows span lanes and blocks)."""
    _small_shares(monkeypatch, *shares)
    (rows, cols), val, x, n_drop, _ = _masked_inputs(2, heavy=400,
                                                     n_loops=20)
    salt = torch.tensor((9, 10))
    w = torch.where(keep_mask(torch.arange(len(val)), salt, 0.5, n_drop),
                    val * torch.where(torch.arange(len(val)) < n_drop,
                                      torch.tensor(2.0), torch.tensor(1.0)),
                    torch.zeros(()))
    for lst in (rows, cols):
        assert torch.equal(ell_gather_masked_plain(lst, val, salt, 0.5,
                                                   n_drop, x),
                           blocked_spmm_plain(lst, w, x))
        assert torch.equal(
            ell_degree_masked_plain(lst, val, salt, 0.5, n_drop),
            _share_order_sums(lst, w))


def test_masked_wrappers_reject_bad_inputs():
    (rows, _), val, x, n_drop, _ = _masked_inputs(3)
    salt = torch.tensor((1, 2))
    with pytest.raises(TypeError):
        ell_gather_masked(rows, val[:-1], salt, 0.5, n_drop, x)
    with pytest.raises(TypeError):
        ell_degree_masked(rows, val.double(), salt, 0.5, n_drop)
    with pytest.raises(TypeError):
        ell_gather_masked(rows, val, salt, 0.5, n_drop, x[:-1])
    layout, _, _ = _ell_inputs(1)
    k1_list, _ = ell_edge_list(layout.idx, layout.vrow_row, layout.n_nodes,
                               "cpu")
    with pytest.raises(ValueError):  # a list with row ids is K1's
        ell_degree_masked(k1_list, torch.zeros(k1_list.n_edges), salt, 0.5,
                          n_drop)


@pytest.mark.parametrize("items,tile_items", [(128, 128), (32, 64),
                                              (16, 300), (64, 8)])
def test_drop_tiles_cover_the_list_in_order(items, tile_items):
    """The dropout walks' segments are the rows of the units of whole rows
    and the pieces of the split rows, in list order, each ending where the
    next starts; tiles are runs of them of about ``tile_items`` items."""
    row, col = _masked_inputs(7, heavy=700, n_loops=50)[-1]
    grids = build_train_grids(row, col, np.ones(len(row), np.float32), 600)
    for idx, vrow, eid in ((grids.r_idx, grids.r_vrow, grids.r_eid),
                           (grids.c_idx, grids.c_vrow, grids.c_eid)):
        rows, ptr, _, _ = ell_list(idx, vrow, 600)
        full = np.zeros(601, np.int64)
        full[rows + 1] = np.diff(ptr)
        full = np.cumsum(full)
        unit_row, unit_edge, split = blocked_ops.work_units(full, items)
        tile_seg, tile_edge, seg_end, seg_out, cap_e, cap_s = \
            blocked_ops.drop_tiles(full, unit_row, unit_edge, tile_items)
        want_end, want_out = [], []
        for u in range(len(unit_row) - 1):
            if unit_row[u] < 0:
                want_end.append(unit_edge[u + 1])
                want_out.append(~u)
            else:
                nxt = unit_row[u + 1]
                for r in range(unit_row[u], ~nxt if nxt < 0 else nxt):
                    want_end.append(full[r + 1])
                    want_out.append(r)
        assert seg_end.tolist() == want_end and seg_out.tolist() == want_out
        # every row once, as itself or as its pieces
        split_rows = set(split[:, 0].tolist())
        assert sorted(set(seg_out[seg_out >= 0].tolist()) | split_rows) == \
            list(range(600))
        assert not split_rows & set(seg_out[seg_out >= 0].tolist())
        starts = np.concatenate([[0], seg_end[:-1]])
        assert tile_seg[0] == 0 and tile_seg[-1] == len(seg_end)
        assert (np.diff(tile_seg) > 0).all()
        assert tile_edge.tolist() == starts[tile_seg[:-1]].tolist() + [
            full[-1]]
        cost = seg_end - starts + 1
        for t in range(len(tile_seg) - 1):
            first, last = tile_seg[t], tile_seg[t + 1] - 1
            # a tile's segments start inside one run of tile_items items
            before = int(cost[:first].sum())
            assert before // tile_items == int(
                cost[:last].sum()) // tile_items
        assert cap_e == np.diff(tile_edge).max()
        assert cap_s == np.diff(tile_seg).max()


def test_drop_tiles_of_an_empty_list():
    unit_row, unit_edge, _ = blocked_ops.work_units(np.zeros(1, np.int64),
                                                     128)
    tile_seg, tile_edge, seg_end, seg_out, cap_e, cap_s = \
        blocked_ops.drop_tiles(np.zeros(1, np.int64), unit_row, unit_edge,
                               128)
    assert tile_seg.tolist() == [0] and tile_edge.tolist() == [0]
    assert len(seg_end) == len(seg_out) == 0
    assert (cap_e, cap_s) == (0, 0)


def _kept_only_sums(lst, w, x):
    """The dropout walks' order, one float32 addition at a time: each
    segment (a row, or a piece of a split row) sums its kept edges (w != 0)
    in list order, then a split row's pieces in ``lst.parts`` parts and the
    parts in order."""
    ptr, idx = lst.ptr.numpy(), lst.idx.numpy()
    eid = np.arange(lst.n_edges) if lst.eid is None else lst.eid.numpy()
    w, x = w.numpy(), x.numpy()
    seg_end, seg_out = lst.seg_end.numpy(), lst.seg_out.numpy()
    out = np.zeros((lst.n_rows, x.shape[1]), np.float32)
    carry = np.zeros((lst.n_units, x.shape[1]), np.float32)
    start = 0
    for end, to in zip(seg_end, seg_out):
        acc = np.zeros(x.shape[1], np.float32)
        for e in range(start, end):
            if w[eid[e]] != 0:
                acc = acc + np.float32(w[eid[e]]) * x[idx[e]]
        if to >= 0:
            out[to] = acc
        else:
            carry[~to] = acc
        start = end
    for r, first, count in lst.split.numpy():
        parts = np.zeros((lst.parts, x.shape[1]), np.float32)
        for k in range(count):
            parts[k % lst.parts] = parts[k % lst.parts] + carry[first + k]
        acc = np.zeros(x.shape[1], np.float32)
        for g in range(min(count, lst.parts)):
            acc = acc + parts[g]
        out[r] = acc
    assert ptr[-1] == lst.n_edges
    return torch.from_numpy(out)


@pytest.mark.parametrize("keep", [0.5, 0.05])
def test_kept_edges_alone_give_the_plain_sums(monkeypatch, keep):
    """What the masked walk computes, leaving the dropped edges out, is
    the plain version bit for bit (which adds their +0 * x terms), for
    finite x: a sum that starts at +0 is never -0, so adding +-0 changes
    no bit.  So is the degree walk's order over the kept edges alone (the
    walk adds a dropped edge's +0, as its plain version does)."""
    monkeypatch.setattr(blocked_ops, "_FIXUP_PARTS", 3)
    _small_shares(monkeypatch)
    (rows, cols), val, x, n_drop, _ = _masked_inputs(8, e=3000, f=3,
                                                     heavy=500, n_loops=20)
    x[::7] = -x[::7]
    x[::11] = 0.0
    x[::13] = -0.0
    salt = torch.tensor((3, 4))
    w = drawn_values(val, salt, keep, n_drop)
    for lst in (rows, cols):
        assert lst.split.shape[0] and lst.parts == 3
        want = ell_gather_masked_plain(lst, val, salt, keep, n_drop, x)
        assert torch.equal(_kept_only_sums(lst, w, x), want)
        assert torch.equal(_share_order_sums(lst, w, kept_only=True),
                           ell_degree_masked_plain(lst, val, salt, keep,
                                                   n_drop))


def test_dropout_walks_need_a_list_with_tiles():
    """A list built without tiles is refused by the masked walk (and its
    tile addresses do not exist); the training grids' lists have them.  The
    degree walk takes equal shares of any list's edges: over the bare list
    it gives the tiled list's degrees."""
    (rows, _), val, x, n_drop, _ = _masked_inputs(9)
    assert rows.tile_seg is not None and rows.n_tiles > 0
    bare = blocked_ops.EdgeList.build(
        rows.ptr.numpy(), rows.idx.numpy(),
        None if rows.eid is None else rows.eid.numpy(), "cpu")
    assert bare.tile_seg is None and bare.n_tiles == 0
    salt = torch.tensor((1, 2))
    with pytest.raises(ValueError, match="tiles"):
        ell_gather_masked(bare, val, salt, 0.5, n_drop, x)
    assert torch.equal(ell_degree_masked(bare, val, salt, 0.5, n_drop),
                       ell_degree_masked(rows, val, salt, 0.5, n_drop))
    with pytest.raises(ValueError, match="tiles"):
        bare.tile_addresses


def test_entry_args_follow_the_list():
    """The C arguments of a dropout walk: the list's, x and out, the
    scratch of a split row's pieces and parts, the widths, then the tiles,
    the draw, the flag and x's size."""
    (rows, _), val, x, n_drop, _ = _masked_inputs(10, f=8, heavy=700)
    out = torch.empty(600, 8)
    flag = torch.zeros(1, dtype=torch.int32)
    salt = torch.tensor((5, 6))
    extra = k1_ops.drop_args(rows, salt, 0.5, n_drop, flag, x)
    args, carry = blocked_ops.entry_args(rows, val, x, out, extra)
    addresses, (n_units, n_split, n_items) = rows.addresses
    assert args[:8] == addresses
    assert args[8:11] == (val.data_ptr(), x.data_ptr(), out.data_ptr())
    assert carry.shape == (n_units + n_split * rows.parts, 8)
    assert args[11] == carry.data_ptr()
    vec = 4 if x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0 else 1
    assert args[12:19] == (n_units, n_split, n_items, 8, vec, 8 // vec,
                           rows.parts)
    assert args[19:26] == (rows.tile_seg.data_ptr(),
                           rows.tile_edge.data_ptr(),
                           rows.seg_end.data_ptr(), rows.seg_out.data_ptr(),
                           rows.n_tiles, *rows.tile_caps)
    from gnntf_tpu_torch.ops.stochastic import draw_scalars
    assert args[26:] == (salt.data_ptr(), *draw_scalars(0.5, n_drop),
                         flag.data_ptr(), 600 * 8)
    assert len(args) == len(blocked_ops.DROP_ARGTYPES) - 1
    # the degree walk: the list's ptr and eid, its values in list order,
    # out, a call's scratch (three rows of one int32 a block), the counts,
    # the walk's shares, whether a row crosses one, then the draw
    deg = torch.empty(600)
    ordered = k1_ops.list_values(rows, val)
    deg_args, scratch = k1_ops.degree_args(rows, ordered, deg, salt, 0.5,
                                           n_drop, 7)
    blocks = -(-rows.n_edges // blocked_ops.DEGREE_SHARE)
    assert scratch.shape == (3, blocks) and scratch.dtype == torch.int32
    assert deg_args == (
        rows.ptr.data_ptr(),
        None if rows.eid is None else rows.eid.data_ptr(),
        ordered.data_ptr(), deg.data_ptr(),
        *(scratch[k].data_ptr() for k in range(3)), 600, rows.n_edges,
        blocks, blocked_ops.DEGREE_LANES, blocked_ops.DEGREE_EDGES,
        int(rows.share_folds > 0), salt.data_ptr(),
        *draw_scalars(0.5, n_drop, 7))
    assert len(deg_args) == len(k1_ops.DEGREE_ARGTYPES) - 1


def _scaled_inputs(seed, f, scaled, n=3000, e=60_000, heavy=20_000):
    """The whole list of an ELL with duplicates, empty rows and a row split
    over many units, its slot values, x, and (``scaled``) positive row and
    column scales and an identity weight."""
    layout, vals, x = _ell_inputs(seed, n=n, e=e, f=f, heavy=heavy)
    rows, ptr, src, slot = ell_list(layout.idx, layout.vrow_row, n)
    lst = whole_list(rows, ptr, src, n, "cpu")
    val = torch.from_numpy(vals.reshape(-1)[slot])
    rng = np.random.RandomState(seed + 1)
    rs = cs = None
    w = 0.0
    if scaled:
        rs, cs = (torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(
            np.float32)) for _ in range(2))
        w = 0.75
    return layout, lst, val, torch.from_numpy(x), rs, cs, w


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("f", [1, 6, 40])
def test_scaled_plain_matches_dense(f, scaled):
    layout, lst, val, x, rs, cs, w = _scaled_inputs(5, f, scaled, n=500,
                                                    e=4000, heavy=600)
    a = np.zeros((500, 501), np.float64)
    np.add.at(a, (np.repeat(layout.vrow_row, layout.k),
                  layout.idx.reshape(-1)), _ell_vals(layout, val))
    x64 = x.numpy().astype(np.float64)
    ones = np.ones(500)
    r64 = ones if rs is None else rs.numpy().astype(np.float64)
    c64 = ones if cs is None else cs.numpy().astype(np.float64)
    ref = r64[:, None] * (a[:, :500] @ (c64[:, None] * x64)) + w * x64
    out = ell_gather_scaled(lst, val, x, rs, cs, w)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def _ell_vals(layout, val):
    """The grid's values of a whole list's slot values (zeros in pads)."""
    rows, ptr, src, slot = ell_list(layout.idx, layout.vrow_row,
                                    layout.n_nodes)
    grid = np.zeros(layout.idx.size, np.float64)
    grid[slot] = val.numpy()
    return grid


def test_whole_list_holds_k1_slots_over_every_row():
    """The whole list holds K1's slots in K1's order, ``ptr`` over every
    row (rows without a slot empty), no row ids; its transposed list is
    K1's."""
    layout, vals, x = _ell_inputs(6, n=400, e=3000, heavy=500)
    rows, ptr, src, slot = ell_list(layout.idx, layout.vrow_row, 400)
    lst = whole_list(rows, ptr, src, 400, "cpu")
    k1 = ell_edge_list(layout.idx, layout.vrow_row, 400, "cpu")[0]
    assert lst.rows is None and lst.n_rows == 400
    assert torch.equal(lst.idx, k1.idx)
    count = np.zeros(400, np.int64)
    count[rows] = np.diff(ptr)
    assert np.array_equal(lst.ptr.diff().numpy(), count)
    assert (count[1::2] == 0).all()
    assert len(lst.split) and lst.split[:, 0].tolist() == [0]
    a, b = (k1_ops.ell_transposed_list(t, 400) for t in (lst, k1))
    for name in ("ptr", "idx", "eid"):
        assert torch.equal(getattr(a, name), getattr(b, name))


def _split_list(seed, f, pieces, items=8, n=2000):
    """A whole list of short rows (0-6 slots, every third row empty), row 3
    split into ``pieces`` pieces of ``items`` slots and row n/2 into two;
    its transposed list (a hub column split too), values, x, dy, positive
    scales."""
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, 7, n)
    deg[::3] = 0
    deg[3] = pieces * items - items // 2
    deg[n // 2] = items + 1
    ptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.randint(0, n, ptr[-1])
    src[ptr[5]:ptr[5] + deg[5]] = 7
    src[rng.rand(len(src)) < 0.05] = 11  # column 11 a hub of A^T
    lst = blocked_ops.EdgeList.build(ptr, src, None, "cpu", items=items)
    with mock.patch.object(k1_ops, "_UNIT_ITEMS", items):
        lst_t = k1_ops.ell_transposed_list(lst, n)
    val = torch.from_numpy(rng.randn(len(src)).astype(np.float32))
    x, dy = (torch.from_numpy(rng.randn(n, f).astype(np.float32))
             for _ in range(2))
    rs, cs = (torch.from_numpy(rng.uniform(0.1, 2.0, n).astype(np.float32))
              for _ in range(2))
    return lst, lst_t, val, x, dy, rs, cs


@pytest.mark.parametrize("f", [1, 7, 40])
@pytest.mark.parametrize("rs_on,cs_on,w", [(True, True, 0.0),
                                           (False, True, 0.5),
                                           (True, False, -0.25),
                                           (False, False, 1.5)])
def test_scaled_backward_plain_is_the_old_composition(f, rs_on, cs_on, w):
    """The one-launch backward's plain version is, bit for bit, the
    composition the prepared operator's backward ran before it: ``dy *
    rs``, the transposed list's store-mode sum (``blocked_spmm_plain``),
    ``* cs``, then ``+ w * dy``; hub columns split over many units."""
    lst, lst_t, val, _, dy, rs, cs = _split_list(3, f, pieces=40)
    assert lst_t.split.shape[0] and int(lst_t.split[:, 2].max()) > 10
    rs, cs = (rs if rs_on else None), (cs if cs_on else None)
    g = dy if rs is None else dy * rs[:, None]
    old = blocked_spmm_plain(lst_t, val, g.contiguous())
    if cs is not None:
        old = old * cs[:, None]
    if w != 0.0:
        old = old + w * dy
    for call in (ell_gather_scaled_backward_plain,
                 ell_gather_scaled_backward):
        assert torch.equal(call(lst_t, val, dy, rs, cs, w), old)


def test_scaled_lists_carry_zeroed_counters():
    """A list that splits a row (the whole list, its transposed list)
    holds a counter store whose sets are ``n_split * (parts + 1)`` int32
    zeros (one a part of each split row, one a split row), the scaled
    walk's, one set a stream: a stream's first take makes its set zeroed,
    a second take gives the same set, another stream's take another; one
    that splits no row holds none."""
    lst, lst_t, *_ = _split_list(4, 8, pieces=5)
    cpu = torch.device("cpu")
    for one in (lst, lst_t):
        n_split = one.split.shape[0]
        assert n_split
        store = one.counters
        assert store.size == n_split * (one.parts + 1)
        first = store.take((cpu, 1), cpu)
        assert first.dtype == torch.int32
        assert first.shape == (store.size,)
        assert not first.any()
        assert store.take((cpu, 1), cpu) is first
        other = store.take((cpu, 2), cpu)
        assert other is not first and not other.any()
        assert store.zero()
    assert whole_list(np.arange(3), np.arange(4), np.arange(3), 3,
                      "cpu").counters is None


def test_counter_store_keys_sets_apart():
    """The counter store on the CPU with stand-in keys: a new stream gets
    a fresh zeroed set, the same stream the same set; a capture on a
    stream gets a set apart from the stream's, the same one while the
    capture lasts and another for another stream of the capture; the
    first take of another capture lets go of the last capture's sets, and
    an eager take of every capture's, so the store holds one stream's set
    a stream and the sets of one capture at most; a set written nonzero
    shows in ``zero()``."""
    cpu = torch.device("cpu")
    store = blocked_ops.Counters(12)
    eager = store.take("stream a", cpu)
    assert eager.shape == (12,) and not eager.any()
    assert store.take("stream a", cpu) is eager
    other = store.take("stream b", cpu)
    assert other is not eager
    captured = store.take("stream a", cpu, capture=7)
    assert captured is not eager and not captured.any()
    assert store.take("stream a", cpu, capture=7) is captured
    fork = store.take("stream c", cpu, capture=7)
    assert fork is not captured and len(store.captured) == 2
    later = store.take("stream a", cpu, capture=8)
    assert later is not captured and later is not eager
    assert list(store.captured.values()) == [later]
    assert store.take("stream a", cpu) is eager
    assert not store.captured and len(store.sets) == 2
    for capture in range(9, 40):
        store.take("stream a", cpu, capture=capture)
    assert len(store.captured) == 1 and len(store.sets) == 2
    assert store.zero()
    other[3] = 1
    assert not store.zero()


def test_dropout_lists_report_counters_as_scaled_lists():
    """``pair_lists``' row and column lists (the dropout walks') carry a
    counter store and hand their split table to the C entry points as the
    scaled walk's whole list does: a set of counters in the place of
    ``rows`` where one is given, the split rows' count beside the units,
    one counter a part of each split row and one a split row, and the
    pieces' and parts' scratch."""
    rng = np.random.RandomState(12)
    n = 400
    dst = np.concatenate([rng.randint(0, n, 3000), np.full(900, 5)])
    src = np.concatenate([rng.randint(0, n, 3000), rng.randint(0, n, 900)])
    src[:300] = 9  # column 9 a hub of the column list
    rows, cols = k1_ops.pair_lists(dst, src, None, n, n, "cpu")
    lst, *_ = _split_list(4, 8, pieces=5)
    cpu = torch.device("cpu")
    for one in (rows, cols, lst):
        n_split = int(one.split.shape[0])
        assert n_split
        assert one.counters.size == n_split * (one.parts + 1)
        counters = one.counters.take((cpu, 0), cpu)
        x = torch.zeros(one.n_in, 4)
        out = torch.empty(one.n_rows, 4)
        val = torch.ones(one.n_values)
        args, carry = blocked_ops.entry_args(one, val, x, out,
                                             counters=counters)
        addresses, (n_units, n_split_arg, n_items) = one.addresses
        assert args[:3] == addresses[:3] and args[4:8] == addresses[4:]
        assert args[3] == counters.data_ptr()
        assert n_split_arg == n_split
        assert args[6] == one.split.data_ptr()
        assert args[12:15] == (n_units, n_split, n_items)
        assert carry.shape == (n_units + n_split * one.parts, 4)
        plain, _ = blocked_ops.entry_args(one, val, x, out)
        assert (plain[:3], plain[4:11], plain[12:]) == (
            args[:3], args[4:11], args[12:])
        assert plain[3] == addresses[3]


def test_scaled_wrapper_rejects_bad_inputs():
    layout, lst, val, x, rs, cs, w = _scaled_inputs(7, 8, True, n=300,
                                                    e=2000, heavy=0)
    k1 = ell_edge_list(layout.idx, layout.vrow_row, 300, "cpu")[0]
    with pytest.raises(ValueError):
        ell_gather_scaled(k1, val, x, rs, cs, w)
    with pytest.raises(TypeError):
        ell_gather_scaled(lst, val, x, rs[:-1], cs, w)
    with pytest.raises(TypeError):
        ell_gather_scaled(lst, val, x, rs, cs.double(), w)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(args, n_nodes, base):
    """The kernel adding into ``base`` equals the plain version on the CPU
    bit for bit, and leaves the rows without a slot as they were."""
    before = ell_gather.launches
    out = ell_gather(*args, n_nodes, out=base.clone())
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 1
    ref = ell_gather_plain(*[a.cpu() for a in args], n_nodes,
                           out=base.cpu().clone())
    assert torch.equal(out.cpu(), ref)
    idx, _, _, vrow_row = (a.cpu().numpy() for a in args)
    rows, _, _, _ = ell_list(idx, vrow_row, n_nodes)
    untouched = np.setdiff1d(np.arange(n_nodes), rows)
    assert torch.equal(out.cpu()[untouched], base.cpu()[untouched])


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
def test_kernel_matches_plain_on_card(cuda, f):
    layout, vals, x = _ell_inputs(2, n=3000, e=60_000, f=f, heavy=20_000)
    base = torch.from_numpy(np.random.RandomState(f).randn(3000, f).astype(
        np.float32)).to(cuda)
    _check_kernel(_tensors(layout, vals, x, cuda), layout.n_nodes, base)


@pytest.mark.cuda
def test_kernel_takes_unaligned_rows_on_card(cuda):
    # x, then the base, start one float into their buffers: F = 16 would
    # take float4 loads, but the rows are not 16-byte aligned, so the
    # wrapper takes scalar ones
    layout, vals, x = _ell_inputs(3, n=2000, e=30_000, f=16)
    idx, v, xa, vr = _tensors(layout, vals, x, cuda)

    def unaligned(t):
        buf = torch.empty(t.numel() + 1, dtype=torch.float32, device=cuda)
        u = buf[1:].view(t.shape)
        u.copy_(t)
        assert u.is_contiguous() and u.data_ptr() % 16 != 0
        return u

    base = torch.randn(2000, 16, device=cuda)
    _check_kernel([idx, v, unaligned(xa), vr], layout.n_nodes, base)
    _check_kernel([idx, v, xa, vr], layout.n_nodes, unaligned(base))


@pytest.mark.cuda
def test_kernel_empty_graph_on_card(cuda):
    layout = build_ell(np.zeros(0, np.int64), np.zeros(0, np.int64), 40, 8)
    vals = np.zeros(layout.idx.shape, np.float32)
    args = _tensors(layout, vals, np.ones((40, 8), np.float32), cuda)
    base = torch.randn(40, 8, device=cuda)
    assert torch.equal(ell_gather(*args, 40, out=base.clone()), base)


@pytest.mark.cuda
def test_kernel_leaves_rows_it_does_not_hold_on_card(cuda):
    # only rows 0 and 2 hold slots; every other row keeps the base's bits,
    # NaN included
    layout = build_ell(np.array([0, 0, 2]), np.array([1, 5, 3]), 300, 8)
    vals = np.ones(layout.idx.shape, np.float32)
    args = _tensors(layout, vals, np.ones((300, 4), np.float32), cuda)
    base = torch.full((300, 4), float("nan"), device=cuda)
    base[0] = base[2] = 1.0
    out = ell_gather(*args, 300, out=base.clone()).cpu()
    assert out[0].tolist() == [3.0] * 4 and out[2].tolist() == [2.0] * 4
    assert torch.isnan(out[1]).all() and torch.isnan(out[3:]).all()


@pytest.mark.cuda
def test_kernel_raises_on_mixed_devices(cuda):
    layout, vals, x = _ell_inputs(4)
    args = _tensors(layout, vals, x, cuda)
    cpu_x = list(args)
    cpu_x[2] = cpu_x[2].cpu()
    with pytest.raises(ValueError):
        ell_gather(*cpu_x, layout.n_nodes)
    with pytest.raises(ValueError):
        ell_gather(*args, layout.n_nodes, out=torch.zeros(x.shape))


@pytest.mark.cuda
def test_prepared_without_hub_slice_on_card_matches_cpu(cuda):
    """Uniform sources give no hub slice: K1 adds into zeros."""
    import gnntf_tpu_torch as tt
    rng = np.random.RandomState(3)
    n = 6000
    src, dst = rng.randint(0, n, size=(2, 40_000))
    x = rng.randn(n, 24).astype(np.float32)
    out = {}
    for device in ("cpu", cuda):
        g = tt.normalize_adjacency(tt.from_edges(
            src, dst, n_nodes=n, directed=False, device=device),
            graph_dropout=0.0)
        prep = PreparedSpMM(g)
        assert prep.dense is None
        out[str(device)] = prep(torch.from_numpy(x).to(device)).cpu()
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_appnp_forward_on_card_matches_cpu(cuda):
    """The serving forward through PreparedSpMM: 10 launches of K1's scaled
    walk on the card,
    logits close to the CPU run of the plain versions (float32, sums in
    another order over ten propagation steps)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    features = np.random.RandomState(1).randn(n, 32).astype(np.float32)
    out = {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.APPNP(graph, features, num_classes=6, device=device)
        model.reset(seed=0)
        before = k1_ops.ell_gather_scaled.launches
        out[str(device)] = model._activations().cpu()
        launched = k1_ops.ell_gather_scaled.launches - before
        assert launched == (10 if model.device.type == "cuda" else 0)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_prepared_gradient_on_card_matches_cpu(cuda):
    """Training without edge dropout under the default impl runs K1's
    scaled walk in the step too, with its transposed backward: 20 launches
    an epoch, and
    the losses close to the CPU run (float32, sums in another order)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    rng = np.random.RandomState(1)
    features = rng.randn(n, 32).astype(np.float32)
    labels = rng.randint(0, 6, n)
    hist = {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.GNN(graph, features, device=device)
        model.add(tt.Dense(16, activation=torch.relu))
        h0 = model.add(tt.Dense(6, regularize=False))
        for _ in range(10):
            model.add(tt.PPRIteration(h0, 0.1, graph_dropout=0.0))
        before = k1_ops.ell_gather_scaled.launches
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0)
        launched = k1_ops.ell_gather_scaled.launches - before
        assert launched == (40 if model.device.type == "cuda" else 0)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)


def _check_masked_kernels(lists, val, x, salt, keep, n_drop, cuda):
    """Each list's masked product and degree on the card: within 1e-5 of
    the sum of the terms' magnitudes of the plain version run on the card,
    bit-equal to the plain version run on the CPU and to a relaunch."""
    salt = torch.tensor(salt)
    for lst in lists:
        on = dataclasses.replace(lst, **{
            f.name: getattr(lst, f.name).to(cuda)
            for f in dataclasses.fields(lst)
            if isinstance(getattr(lst, f.name), torch.Tensor)})
        val_c, x_c = val.to(cuda), x.to(cuda)
        before = (ell_gather_masked.launches, ell_degree_masked.launches)
        out = ell_gather_masked(on, val_c, salt, keep, n_drop, x_c)
        deg = ell_degree_masked(on, val_c, salt, keep, n_drop)
        torch.cuda.synchronize()
        assert (ell_gather_masked.launches, ell_degree_masked.launches) == (
            before[0] + 1, before[1] + 1)
        plain = ell_gather_masked_plain(on, val_c, salt, keep, n_drop, x_c)
        scale = ell_gather_masked_plain(on, val_c, salt, keep, n_drop,
                                        x_c.abs())
        assert bool(((out - plain).abs() <= 1e-5 * scale).all())
        plain_deg = ell_degree_masked_plain(on, val_c, salt, keep, n_drop)
        assert bool(((deg - plain_deg).abs() <= 1e-5 * plain_deg).all())
        assert torch.equal(out.cpu(), ell_gather_masked_plain(
            lst, val, salt, keep, n_drop, x))
        assert torch.equal(deg.cpu(), ell_degree_masked_plain(
            lst, val, salt, keep, n_drop))
        # a relaunch is the same
        assert torch.equal(ell_gather_masked(on, val_c, salt, keep, n_drop,
                                             x_c), out)
        assert torch.equal(ell_degree_masked(on, val_c, salt, keep, n_drop),
                           deg)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
@pytest.mark.parametrize("keep,n_loops", [(0.5, 0), (0.3, 300), (1.0, 300),
                                          (0.05, 300)])
def test_masked_kernels_match_plain_on_card(cuda, f, keep, n_loops):
    """Empty rows and columns, a hub row and a hub column split over many
    units, ``n_drop < E`` (trailing self-loops) and ``keep = 1``; at keep
    0.05 many tiles keep no edge at all."""
    lists, val, x, n_drop, _ = _masked_inputs(
        4, n=3000, e=60_000, f=f, heavy=20_000, n_loops=n_loops)
    assert lists[0].split.shape[0] and lists[1].split.shape[0]
    _check_masked_kernels(lists, val, x, (0x9E3779B9, 77), keep, n_drop,
                          cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("items,tile_items", [(32, 64), (16, 300), (64, 8),
                                              (128, 256)])
@pytest.mark.parametrize("f", [6, 40])
def test_masked_kernels_follow_the_list_cut_on_card(cuda, monkeypatch, items,
                                                    tile_items, f):
    """Other piece and tile sizes: tiles of a segment or two, and tiles of
    more than 128 edges, which a warp stages in turns."""
    monkeypatch.setattr(k1_ops, "_DROP_ITEMS", items)
    monkeypatch.setattr(k1_ops, "_TILE_ITEMS", tile_items)
    lists, val, x, n_drop, _ = _masked_inputs(
        5, n=3000, e=60_000, f=f, heavy=20_000, n_loops=300)
    assert lists[0].tile_caps[0] > 128 or tile_items < 128
    _check_masked_kernels(lists, val, x, (5, 0xDEADBEEF), 0.5, n_drop, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 40])
def test_masked_kernels_over_fully_dropped_tiles_on_card(cuda, f):
    """Keep 1e-4: most tiles keep no edge at all (their rows are written as
    zeros, their pieces' carries as zeros) and a few keep one."""
    lists, val, x, n_drop, _ = _masked_inputs(
        7, n=3000, e=60_000, f=f, heavy=20_000)
    salt, keep = (11, 12), 1e-4
    for lst in lists:
        eids = (torch.arange(lst.n_edges) if lst.eid is None
                else lst.eid.long())
        kept = keep_mask(eids, torch.tensor(salt), keep, n_drop)
        per_tile = torch.zeros(lst.n_tiles, dtype=torch.int64).index_add_(
            0, torch.searchsorted(lst.tile_edge.long(),
                                  torch.arange(lst.n_edges), right=True) - 1,
            kept.long())
        assert (per_tile == 0).any() and kept.any()
    _check_masked_kernels(lists, val, x, salt, keep, n_drop, cuda)


def _only_dropped_sources(lst, salt, keep, n_drop):
    """Sources that only dropped edges of ``lst`` reference."""
    eids = (torch.arange(lst.n_edges) if lst.eid is None
            else lst.eid.long())
    kept = keep_mask(eids, torch.tensor(salt), keep, n_drop)
    src = lst.idx.long()
    return np.setdiff1d(src[~kept].numpy(), src[kept].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("f", [6, 40, 64, 128])
@pytest.mark.parametrize("keep", [0.3, 0.5])
def test_masked_walk_keeps_nan_of_dropped_sources_on_card(cuda, f, keep):
    """An inf and a NaN in x rows that only dropped edges reference: the
    walk gathers every edge's row then, so its NaNs are where the plain
    version's are (``+0 * inf``), and every other element is bit-equal to
    the plain version run on the CPU.  A sparse graph (~5 edges a source),
    so some sources only dropped edges read, with a hub row and column."""
    lists, val, x, n_drop, _ = _masked_inputs(
        6, n=3000, e=3000, f=f, heavy=2000)
    salt = (77, 0x9E3779B9)
    for lst in lists:
        bad = _only_dropped_sources(lst, salt, keep, n_drop)
        assert len(bad) >= 2
        xb = x.clone()
        xb[bad[0], 0] = float("inf")
        xb[bad[-1], f - 1] = float("nan")
        on = dataclasses.replace(lst, **{
            fl.name: getattr(lst, fl.name).to(cuda)
            for fl in dataclasses.fields(lst)
            if isinstance(getattr(lst, fl.name), torch.Tensor)})
        assert lst.split.shape[0]
        out = ell_gather_masked(on, val.to(cuda), torch.tensor(salt), keep,
                                n_drop, xb.to(cuda)).cpu()
        ref = ell_gather_masked_plain(lst, val, torch.tensor(salt), keep,
                                      n_drop, xb)
        assert torch.isnan(ref).any()
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        finite = ~torch.isnan(ref)
        assert torch.equal(out[finite], ref[finite])


@pytest.mark.cuda
def test_stochastic_training_on_card_matches_cpu(cuda):
    """Training under the default impl on a dropped graph above
    ``min_edges()``: every propagation step of the step runs the masked
    walk forward and backward and the degree walk, the validation forward
    K1's scaled walk (the prepared operator); the grids are built once per
    device; the losses agree with the CPU
    run (float32; the degrees and products are bit-equal, the dense layers
    and Adam are not)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import stochastic
    n = 20_000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    rng = np.random.RandomState(1)
    features = rng.randn(n, 16).astype(np.float32)
    labels = rng.randint(0, 6, n)
    hist = {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.GNN(graph, features, device=device)
        model.add(tt.Dense(16, activation=torch.relu))
        h0 = model.add(tt.Dense(6, regularize=False))
        for _ in range(10):
            model.add(tt.PPRIteration(h0, 0.1, graph_dropout=0.5))
        counts = lambda: (ell_gather_masked.launches,
                          ell_degree_masked.launches,
                          k1_ops.ell_gather_scaled.launches,
                          stochastic.train_grids.builds)
        before = counts()
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0)
        launched = [a - b for a, b in zip(counts(), before)]
        assert launched == ([40, 20, 20, 1] if model.device.type == "cuda"
                            else [0, 0, 0, 1])
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128])
@pytest.mark.parametrize("hub_col", [0, 20_000])
def test_backward_walk_matches_plain_on_card(cuda, f, hub_col):
    """The backward walk over the transposed list on the card: one launch
    counted in ``ell_gather.backward_launches`` (not in K2's count), ``dx``
    bit-equal to the plain version on the CPU."""
    layout, lst, slot, val, x, dy = _transposed_inputs(
        10, n=3000, f=f, hub_col=hub_col)
    n = layout.n_nodes
    lst_t = k1_ops.ell_transposed_list(lst, n)
    on = dataclasses.replace(lst, **{
        fd.name: getattr(lst, fd.name).to(cuda)
        for fd in dataclasses.fields(lst)
        if isinstance(getattr(lst, fd.name), torch.Tensor)})
    lst_t_card = k1_ops.ell_transposed_list(on, n)
    assert torch.equal(lst_t_card.eid.cpu(), lst_t.eid)
    before = (ell_gather.backward_launches, blocked_ops.blocked_spmm.launches)
    xt = x.to(cuda).requires_grad_()
    _ELLGatherFn.apply(xt, torch.zeros(n, f, device=cuda), on, val.to(cuda),
                       lambda: lst_t_card).backward(dy.to(cuda))
    torch.cuda.synchronize()
    assert (ell_gather.backward_launches,
            blocked_ops.blocked_spmm.launches) == (before[0] + 1, before[1])
    assert torch.equal(xt.grad.cpu(), blocked_spmm_plain(lst_t, val, dy))


@pytest.mark.cuda
def test_gcnii_training_on_card_matches_cpu(cuda):
    """GCNII trains through the prepared operator (``graph_dropout=0``):
    each of its convolutions launches K1's scaled walk forward and the
    backward walk in
    the step, K1 again in the validation forward; no feature dropout, so
    the losses agree with the CPU run (float32)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    rng = np.random.RandomState(1)
    features = rng.randn(n, 16).astype(np.float32)
    labels = rng.randint(0, 6, n)
    init = None
    hist = {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.GCNII(graph, features, num_classes=6, iterations=4,
                         latent_dims=(16,), dropout=0.0, device=device)
        if init is None:
            init = {s.name: rng.uniform(-0.2, 0.2, s.shape).astype(
                np.float32) for s in model.param_specs}
        before = (k1_ops.ell_gather_scaled.launches,
                  ell_gather.backward_launches)
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0, init_params=dict(init))
        launched = (k1_ops.ell_gather_scaled.launches - before[0],
                    ell_gather.backward_launches - before[1])
        assert launched == ((16, 8) if model.device.type == "cuda"
                            else (0, 0))
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
def test_scaled_kernel_matches_plain_on_card(cuda, f, scaled):
    """K1's scaled walk over a whole list with split rows: within ``1e-5 *
    sum|terms|`` of its plain version on the card, bit for bit the plain
    version on the CPU, one launch a call."""
    _, lst, val, x, rs, cs, w = _scaled_inputs(8, f, scaled)
    on = dataclasses.replace(lst, **{
        fl.name: getattr(lst, fl.name).to(cuda)
        for fl in dataclasses.fields(lst)
        if isinstance(getattr(lst, fl.name), torch.Tensor)})
    to = lambda t: None if t is None else t.to(cuda)
    args = (to(val), to(x), to(rs), to(cs), w)
    before = k1_ops.ell_gather_scaled.launches
    out = ell_gather_scaled(on, *args)
    torch.cuda.synchronize()
    assert k1_ops.ell_gather_scaled.launches == before + 1
    plain = ell_gather_scaled_plain(on, *args)
    scale = ell_gather_scaled_plain(
        on, *(None if t is None else t.abs() for t in args[:4]), abs(w))
    assert bool(((out - plain).abs() <= 1e-5 * scale).all())
    assert torch.equal(out.cpu(), ell_gather_scaled_plain(
        lst, val, x, rs, cs, w))


def _on(lst, device):
    """A list with every tensor on ``device``."""
    return dataclasses.replace(lst, **{
        fl.name: getattr(lst, fl.name).to(device)
        for fl in dataclasses.fields(lst)
        if isinstance(getattr(lst, fl.name), torch.Tensor)})


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 7, 16, 40, 64, 128])
@pytest.mark.parametrize("pieces", [2, 3000])
def test_scaled_walks_match_plain_on_card(cuda, f, pieces):
    """Both scaled walks on the card, the forward over the whole list and
    the backward over its transposed list (rows split into 2 and into
    ``pieces`` pieces, rows without slots, ``w != 0``): bit for bit their
    plain versions on the CPU, twice in a row, each call one launch, the
    counters back at zero after each."""
    lst, lst_t, val, x, dy, rs, cs = _split_list(5, f, pieces)
    w = 0.5
    on, on_t = _on(lst, cuda), _on(lst_t, cuda)
    val_c, x_c, dy_c, rs_c, cs_c = (t.to(cuda) for t in (val, x, dy, rs,
                                                          cs))
    ref = ell_gather_scaled_plain(lst, val, x, rs, cs, w)
    ref_t = ell_gather_scaled_backward_plain(lst_t, val, dy, rs, cs, w)
    before = (k1_ops.ell_gather_scaled.launches,
              ell_gather.backward_launches)
    for _ in range(2):
        out = ell_gather_scaled(on, val_c, x_c, rs_c, cs_c, w)
        out_t = ell_gather_scaled_backward(on_t, val_c, dy_c, rs_c, cs_c, w)
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(), ref)
        assert torch.equal(out_t.cpu(), ref_t)
        assert on.counters.zero() and on_t.counters.zero()
    assert (k1_ops.ell_gather_scaled.launches,
            ell_gather.backward_launches) == (before[0] + 2, before[1] + 2)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 40])
def test_scaled_walks_replay_in_a_cuda_graph_on_card(cuda, f):
    """Both scaled walks captured in a CUDA graph: each replay, on new x
    and dy written in place, gives the plain versions' bits, so the split
    rows' counters were zero again after each replay."""
    lst, lst_t, val, x, dy, rs, cs = _split_list(6, f, pieces=300)
    on, on_t = _on(lst, cuda), _on(lst_t, cuda)
    val_c, x_c, dy_c, rs_c, cs_c = (t.to(cuda) for t in (val, x, dy, rs,
                                                          cs))
    ell_gather_scaled(on, val_c, x_c, rs_c, cs_c, 0.5)
    ell_gather_scaled_backward(on_t, val_c, dy_c, rs_c, cs_c, 0.5)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ell_gather_scaled(on, val_c, x_c, rs_c, cs_c, 0.5)
        out_t = ell_gather_scaled_backward(on_t, val_c, dy_c, rs_c, cs_c, 0.5)
    rng = np.random.RandomState(7)
    for _ in range(3):
        x, dy = (torch.from_numpy(rng.randn(*x.shape).astype(np.float32))
                 for _ in range(2))
        x_c.copy_(x)
        dy_c.copy_(dy)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out.cpu(),
                           ell_gather_scaled_plain(lst, val, x, rs, cs, 0.5))
        assert torch.equal(out_t.cpu(), ell_gather_scaled_backward_plain(
            lst_t, val, dy, rs, cs, 0.5))
        assert on.counters.zero() and on_t.counters.zero()


@pytest.mark.cuda
def test_prepared_backward_is_one_walk_on_card(cuda):
    """The ``auto`` operator's ``dx`` on the card: one launch of the scaled
    walk's backward (``ell_gather_scaled_bwd_walk``, nothing else in its
    profile), counted in ``ell_gather.backward_launches``, bit for bit the
    plain version on the CPU over the operator's own list, values and
    scales (the card's degrees, and so its scales, may differ from the
    CPU's in their last bits)."""
    import chip_smoke
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 20_000
    src, dst = random_power_law_edges(n, 100_000, seed=1)
    rng = np.random.RandomState(2)
    x, dy = (torch.from_numpy(rng.randn(n, 40).astype(np.float32))
             for _ in range(2))
    g = tt.normalize_adjacency(tt.from_edges(
        src, dst, n_nodes=n, directed=False, device=cuda),
        graph_dropout=0.0, add_eye="after")
    op = tt.ops.prepare(g)
    assert isinstance(op, PreparedSpMM) and op.eye_weight != 0.0
    xt = x.to(cuda).requires_grad_()
    y = op(xt)
    dy_c = dy.to(cuda)
    run = lambda: torch.autograd.grad(y, xt, dy_c, retain_graph=True)[0]
    dx = run().cpu()
    lst_t = op._routed.transposed()
    assert len(lst_t.split)
    rows, _, _, counted = chip_smoke.device_profile(run)
    assert counted == dict(chip_smoke.NO_LAUNCHES, backward=1)
    names = [chip_smoke.kernel_name(key) for key, _, _ in rows]
    assert names == ["ell_gather_scaled_bwd_walk"], names
    rs, cs = (t.cpu() for t in op._scales)
    assert torch.equal(dx, ell_gather_scaled_backward_plain(
        _on(lst_t, "cpu"), op.k1_val.cpu(), dy, rs, cs, op.eye_weight))


@pytest.mark.cuda
def test_auto_spmm_is_one_walk_without_gemm_on_card(cuda):
    """One SpMM of a normalized power-law graph under ``auto``: no hub
    slice, one wrapper launch, and in its profile K1's scaled walk alone (a
    hub row is split, and finished inside the walk) and no GEMM."""
    import chip_smoke
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 20_000
    src, dst = random_power_law_edges(n, 200_000, seed=0)
    g = tt.normalize_adjacency(tt.from_edges(src, dst, n_nodes=n,
                                             directed=False, device=cuda),
                               graph_dropout=0.0)
    op = tt.ops.prepare(g)
    assert isinstance(op, PreparedSpMM) and op.dense is None
    assert len(op.k1_list.split)
    x = torch.randn(n, 40, device=cuda)
    op(x)
    torch.cuda.synchronize()
    # chip_smoke's profile, whose primer kernels and wait make sure that the
    # profiler kept the session's device events (a session that lost some
    # is taken again), with the wrappers' launches in the session kept
    rows, _, _, counted = chip_smoke.device_profile(lambda: op(x))
    assert counted == dict(chip_smoke.NO_LAUNCHES, k1s=1), counted
    names = [chip_smoke.kernel_name(key) for key, _, _ in rows]
    assert not [k for k in names if "gemm" in k.lower()], names
    # the split rows are finished inside the walk's launch
    assert names == ["ell_gather_scaled_walk"], names
    assert [count for _, _, count in rows] == [1], rows
