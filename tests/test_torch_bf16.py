"""K2's bfloat16 mode, ``spmm_pallas(graph, x, bf16=True)``, against the JAX
package's (its Pallas kernel in interpret mode on the CPU), and the
kernel's wrapper and plain version.

Each term is ``fp32(bf16_rn(fp32(val * fp32(bf16_rn(x)))))`` in both
packages, bit for bit; only the order of the float32 sums differs (JAX's
one-hot product, the port's walk order).  So outputs are held within
``1e-6 * sum|terms|`` element by element (``sum|terms|`` in float64 from the
absolute values); a bfloat16 output, rounded from sums that may differ in
their last float32 bit, within that plus one bfloat16 rounding (``2**-8``
of the value).  The backward is float32 in both packages (``dx = A^T dy``,
``dval = <dy[row], x[col]>`` over the unrounded ``x``): within ``1e-6``
of the sum of its terms' magnitudes as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops.pallas import spmm_pallas as jax_spmm_pallas
from gnntf_tpu_torch.ops import (blocked, blocked_spmm_bf16,
                                 blocked_spmm_bf16_plain, spmm_pallas)

BLOCKING = dict(window=64, tile=64, block_edges=128)
TERM_RTOL = 1e-6
N = 300


def _graphs(seed, hub=True):
    """A weighted directed graph in both packages: duplicate pairs, row 3
    without edges, and (``hub``) row 5 with 400 edges, which the port's
    walk splits into pieces."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, N, 2000)
    dst = rng.randint(0, 60, 2000) * 5  # columns repeat: duplicate pairs
    if hub:
        src = np.concatenate([src, np.full(400, 5)])
        dst = np.concatenate([dst, rng.randint(0, N, 400)])
    keep = src != 3
    src, dst = src[keep], dst[keep]
    vals = rng.uniform(-1.5, 2.0, len(src))
    kw = dict(n_nodes=N, directed=True)
    return (gt.from_edges(src, dst, vals, **kw),
            tt.from_edges(src, dst, vals, device="cpu", **kw))


def _magnitudes(pg, x):
    """``sum|terms|`` of each output element: the float32 product of the
    graph with every value and every element of ``x`` made absolute, its
    scales and identity as they are (positive)."""
    absolute = dataclasses.replace(pg, val=pg.val.abs())
    return spmm_pallas(absolute, torch.from_numpy(np.abs(x)),
                       **BLOCKING).double().numpy()


def _jax(jg, x, **kw):
    return np.asarray(jax_spmm_pallas(jg, jnp.asarray(x), interpret=True,
                                      **BLOCKING, **kw))


def _within(out, ref, scale, extra=0.0):
    err = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    limit = TERM_RTOL * scale + extra
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("f", [1, 7, 16, 40, 64, 128])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_product_matches_jax(seed, f):
    jg, pg = _graphs(seed)
    x = np.random.RandomState(seed + 10).randn(N, f).astype(np.float32)
    ref = _jax(jg, x, bf16=True)
    out = spmm_pallas(pg, torch.from_numpy(x), bf16=True, **BLOCKING)
    assert out.dtype == torch.float32 and out.shape == (N, f)
    _within(out.numpy(), ref, _magnitudes(pg, x))
    assert not out[3].any()
    # the mode rounds: it is not the float32 product
    assert not np.array_equal(out.numpy(), _jax(jg, x))


# the share walk's share and fold range: its own, and a small share whose
# hub row (406 edges) crosses 3-4 shares and 2-3 ranges
SHARES = {"walk": None, "small": (128, 2)}


@pytest.mark.parametrize("share", sorted(SHARES))
@pytest.mark.parametrize("f", [64, 96, 128, 256])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_share_walk_matches_jax(monkeypatch, seed, f, share):
    """The share walk's order (``share_row_sums``), which the card takes at
    F = 64-256 on large lists, given this list through
    ``_BF16_SHARE_LISTS``: held against JAX at the same tolerance."""
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS",
                        dict.fromkeys((8, 16, 32), (0, 0)))
    if SHARES[share]:
        monkeypatch.setattr(blocked, "BF16_SHARE", SHARES[share][0])
        monkeypatch.setattr(blocked, "BF16_FOLD_RANGE", SHARES[share][1])
    orders = []
    row_sums = blocked.share_row_sums

    def spy(ptr, terms, *order):
        orders.append(order)
        return row_sums(ptr, terms, *order)

    monkeypatch.setattr(blocked, "share_row_sums", spy)
    jg, pg = _graphs(seed)
    x = np.random.RandomState(seed + 10).randn(N, f).astype(np.float32)
    out = spmm_pallas(pg, torch.from_numpy(x), bf16=True, **BLOCKING)
    assert orders == [(blocked.bf16_share_run(f), blocked.BF16_SHARE,
                       blocked.BF16_FOLD_RANGE)]
    assert out.dtype == torch.float32 and out.shape == (N, f)
    _within(out.numpy(), _jax(jg, x, bf16=True), _magnitudes(pg, x))
    assert not out[3].any()


@pytest.mark.parametrize("add_eye", ["none", "after"])
def test_bf16_product_of_a_normalized_graph_matches_jax(add_eye):
    """The lazy scales and identity apply around the kernel in float32, so
    the mode rounds ``cs * x``."""
    jg, pg = _graphs(2)
    jn = gt.normalize_adjacency(jg, graph_dropout=0.0, add_eye=add_eye)
    pn = tt.normalize_adjacency(pg, graph_dropout=0.0, add_eye=add_eye)
    assert pn.scaled
    x = np.random.RandomState(3).randn(N, 16).astype(np.float32)
    out = spmm_pallas(pn, torch.from_numpy(x), bf16=True, **BLOCKING)
    _within(out.numpy(), _jax(jn, x, bf16=True), _magnitudes(pn, x))


def test_bf16_product_of_a_dropped_graph_matches_jax():
    jg, pg = _graphs(4)
    salt = (12345, 678)
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=0.5, drop_n=pg.n_edges)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=0.5, drop_n=pg.n_edges)
    assert pd.dropped
    x = np.random.RandomState(5).randn(N, 24).astype(np.float32)
    out = spmm_pallas(pd, torch.from_numpy(x), bf16=True, **BLOCKING)
    _within(out.numpy(), _jax(jd, x, bf16=True),
            _magnitudes(pd.materialized(), x))


def test_bf16_input_gives_a_bf16_output():
    jg, pg = _graphs(6)
    xb = torch.from_numpy(np.random.RandomState(7).randn(N, 16).astype(
        np.float32)).to(torch.bfloat16)
    x32 = xb.to(torch.float32).numpy()
    ref = np.asarray(jax_spmm_pallas(
        jg, jnp.asarray(x32).astype(jnp.bfloat16), interpret=True, bf16=True,
        **BLOCKING)).astype(np.float32)
    out = spmm_pallas(pg, xb, bf16=True, **BLOCKING)
    assert out.dtype == torch.bfloat16
    _within(out.to(torch.float32).numpy(), ref, _magnitudes(pg, x32),
            extra=2.0 ** -8 * np.abs(ref))
    # the float32 input's product, rounded: the same terms
    out32 = spmm_pallas(pg, torch.from_numpy(x32), bf16=True, **BLOCKING)
    assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("f", [7, 40])
def test_bf16_gradients_match_jax(f):
    """``jax.grad`` through the custom VJP (float32, the unrounded ``x``)
    against the port's backward."""
    jg, pg = _graphs(8)
    rng = np.random.RandomState(9)
    x = rng.randn(N, f).astype(np.float32)
    dy = rng.randn(N, f).astype(np.float32)

    def loss(v, xx):
        g = dataclasses.replace(jg, val=v)
        out = jax_spmm_pallas(g, xx, interpret=True, bf16=True, **BLOCKING)
        return jnp.sum(out * jnp.asarray(dy))

    ref_dval, ref_dx = jax.grad(loss, argnums=(0, 1))(jg.val, jnp.asarray(x))
    val = pg.val.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm_pallas(dataclasses.replace(pg, val=val), xt, bf16=True,
                      **BLOCKING)
    out.backward(torch.from_numpy(dy))
    row, col = pg.row.numpy(), pg.col.numpy()
    dx_scale = np.zeros((N, f))
    np.add.at(dx_scale, col, np.abs(pg.val.numpy())[:, None]
              * np.abs(dy[row]))
    _within(xt.grad.numpy(), np.asarray(ref_dx), dx_scale)
    dval_scale = (np.abs(dy[row]) * np.abs(x[col])).sum(1)
    _within(val.grad.numpy(), np.asarray(ref_dval), dval_scale)


def test_plain_version_rounds_each_term():
    """The plain version's terms are float32 products rounded to bfloat16
    (to nearest even), summed in the walk's order: a row of one edge holds
    its term exactly."""
    _, pg = _graphs(10, hub=False)
    prep = blocked.blocked_layout(pg)
    xb = torch.from_numpy(np.random.RandomState(11).randn(N, 8).astype(
        np.float32)).to(torch.bfloat16)
    val = pg.val.to(torch.float32)
    out = blocked_spmm_bf16_plain(prep.forward, val, xb)
    row, col = pg.row.numpy(), pg.col.numpy()
    single = np.flatnonzero(np.bincount(row, minlength=N) == 1)
    e = np.flatnonzero(np.isin(row, single))
    term = (xb[col[e]].to(torch.float32) * val[e, None]).to(
        torch.bfloat16).to(torch.float32)
    assert len(e) and torch.equal(out[row[e]], term)
    before = blocked_spmm_bf16.launches
    assert torch.equal(blocked_spmm_bf16(prep.forward, val, xb), out)
    assert blocked_spmm_bf16.launches == before  # the CPU counts nothing


def test_wrapper_checks_its_inputs():
    _, pg = _graphs(12, hub=False)
    lst = blocked.blocked_layout(pg).forward
    val = pg.val.to(torch.float32)
    xb = torch.zeros(N, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val, xb.to(torch.float32))
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val, xb[:-1])
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val.to(torch.float64), xb)
    with pytest.raises(ValueError):
        blocked_spmm_bf16(lst, val, torch.zeros(8, N,
                                                dtype=torch.bfloat16).t())


@pytest.mark.parametrize("widest", [8, 4, 2, 1])
def test_forced_loads_follow_width_and_alignment(monkeypatch, widest):
    """``_BF16_VEC`` set: a lane loads the most bfloat16 that the width,
    both addresses and ``_BF16_VEC`` allow, whatever the lanes."""
    monkeypatch.setattr(blocked, "_BF16_VEC", widest)
    cases = {  # (f, x address, out address): widest load allowed
        (40, 0, 0): 8, (40, 8, 16): 4, (40, 4, 8): 2, (40, 2, 4): 1,
        (12, 0, 0): 4, (6, 0, 0): 2, (7, 0, 0): 1, (1, 0, 0): 1,
        (64, 16, 8): 2}
    for (f, x_at, out_at), most in cases.items():
        assert blocked.bf16_vec(f, x_at, out_at) == min(most, widest), (
            f, x_at, out_at)


def test_loads_keep_the_wide_walk():
    """By default a lane loads the most bfloat16 that leaves a row at least
    8 loads, as the sweep chose: 2 at F=16, 4 at F=40, 8 at F=64 and 128;
    1 where no load does (the narrow walk)."""
    assert blocked._BF16_VEC is None
    cases = {(16, 0, 0): 2, (40, 0, 0): 4, (64, 0, 0): 8, (128, 0, 0): 8,
             (24, 0, 0): 2, (128, 8, 0): 4, (128, 0, 8): 2, (8, 0, 0): 1,
             (7, 0, 0): 1, (1, 0, 0): 1}
    for (f, x_at, out_at), vec in cases.items():
        assert blocked.bf16_vec(f, x_at, out_at) == vec, (f, x_at, out_at)


def test_pallas_impl_keeps_float32():
    """``spmm_impl("pallas")`` calls K2 without ``bf16``, as JAX's
    dispatcher does."""
    jg, pg = _graphs(13)
    x = np.random.RandomState(14).randn(N, 8).astype(np.float32)
    with tt.spmm_impl("pallas"):
        out = tt.spmm(pg, torch.from_numpy(x))
    assert torch.equal(out, spmm_pallas(pg, torch.from_numpy(x)))


# K2's bfloat16 mode's host rule (bf16_plan) and the staged walk
# (csrc/bf16_walk.cuh) through a Python twin of its copies and its sum.

STAGED_WIDTHS = (16, 24, 32, 40)
# a Cora-scale list's edges and the RCM bench graph's forward list's, and
# their rows
EDGES = {"cora": 10_556, "bench": 2_332_478}
ROWS = {"cora": 2_708, "bench": 169_343}


@pytest.mark.parametrize("edges", sorted(EDGES))
@pytest.mark.parametrize("x_at", [0, 2, 4, 8, 16])
@pytest.mark.parametrize("out_at", [0, 8])
def test_plan_for_each_width_and_alignment(edges, x_at, out_at):
    """F = 1-136: the staged walk at F = 32 and 40 on any list, at F = 24
    and 16 on lists of 150,000 and 1,000,000 edges on (the bench list, not
    the Cora-scale one), with ``x`` and ``out`` 16-byte aligned; the share
    walk at F % 8 == 0 from 64 where the list and the alignment take it
    (``tests/test_torch_bf16_shares.py``); else the generic walk at
    ``bf16_vec``'s load."""
    assert blocked._BF16_VEC is None and blocked._BF16_RING is None
    least = blocked._BF16_STAGED_EDGES
    assert least == {16: 1_000_000, 24: 150_000, 32: 0, 40: 0}
    n_edges, n_rows = EDGES[edges], ROWS[edges]
    aligned = x_at % 16 == 0 and out_at % 16 == 0
    for f in range(1, 137):
        plan = blocked.bf16_plan(f, x_at, out_at, n_edges, n_rows)
        staged = aligned and f in least and n_edges >= least[f]
        assert plan.staged == staged, (f, plan)
        assert staged == (aligned and (f in (32, 40) or (
            edges == "bench" and f in (16, 24)))), f
        if f >= 64:
            fewest, per_row = blocked._BF16_SHARE_LISTS[
                blocked.bf16_share_lanes(f)]
        assert plan.share == (aligned and f % 8 == 0 and f >= 64 and (
            n_edges >= fewest and n_edges >= per_row * n_rows)), f
        if staged:
            assert (plan.vec, plan.group, plan.depth, plan.rows) == (
                4, f // 4, blocked._BF16_DEPTH,
                blocked.bf16_rows(f, blocked._BF16_DEPTH))
        elif plan.share:
            assert (plan.vec, plan.group) == (8, f // 8)
        else:
            vec = blocked.bf16_vec(f, x_at, out_at)
            assert (plan.vec, plan.group) == (vec, max(1, min(32, f // vec)))
    # each width's crossover: the first list size that takes the staged walk
    for f, at in least.items():
        if at:
            assert not blocked.bf16_plan(f, 0, 0, at - 1, 1).staged
        assert blocked.bf16_plan(f, x_at, out_at, at, 1).staged == aligned


def test_forced_walks(monkeypatch):
    """``_BF16_VEC`` forces the generic walk at any width and list size;
    ``_BF16_STAGED_EDGES`` of zeros gives the staged walk any list at its
    widths, and empty none; ``_BF16_RING`` forces its ring, within what the
    kernel takes."""
    big, cora = (EDGES["bench"], ROWS["bench"]), (EDGES["cora"], ROWS["cora"])
    monkeypatch.setattr(blocked, "_BF16_VEC", 8)
    plan = blocked.bf16_plan(40, 0, 0, *big)
    assert (plan.staged, plan.vec, plan.group) == (False, 8, 5)
    monkeypatch.setattr(blocked, "_BF16_VEC", None)
    assert not blocked.bf16_plan(16, 0, 0, *cora).staged
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES",
                        dict.fromkeys((16, 24, 32, 40), 0))
    assert blocked.bf16_plan(16, 0, 0, *cora).staged
    assert not blocked.bf16_plan(48, 0, 0, *big).staged  # past kMaxF
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", {})
    assert not blocked.bf16_plan(40, 0, 0, *big).staged
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", {40: 0})
    monkeypatch.setattr(blocked, "_BF16_RING", (3, 8))
    plan = blocked.bf16_plan(40, 0, 0, *big)
    assert (plan.staged, plan.depth, plan.rows) == (True, 3, 8)
    # past 48 KB a block at F=40 (2 x 32, 3 x 16), more edges a batch than
    # 8 a lane at F=16, depth * rows not a multiple of 4, depths 1 and 5
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", {16: 0, 40: 0})
    for f, ring in ((40, (2, 32)), (40, (3, 16)), (16, (2, 36)),
                    (40, (3, 6)), (40, (2, 0)), (40, (1, 8)), (40, (5, 4))):
        monkeypatch.setattr(blocked, "_BF16_RING", ring)
        with pytest.raises(ValueError):
            blocked.bf16_plan(f, 0, 0, *big)


@pytest.mark.parametrize("depth", [2, 3, 4])
@pytest.mark.parametrize("f", STAGED_WIDTHS)
def test_ring_fits_shared_memory(f, depth):
    """The staged walk's ring, kWarps warps a block: whole 16-byte rows and
    values after them, within the 48 KB a block takes without opting in at
    the default depth; another depth's ring at the default rows is refused
    where it does not fit."""
    rows = blocked.bf16_rows(f, depth)
    assert 4 <= rows <= 32 and rows % 4 == 0 and 2 * f % 16 == 0
    smem = blocked.bf16_ring_bytes(f, depth, rows) * blocked._BF16_WARPS
    assert smem <= blocked._BF16_SMEM, (f, depth, smem)
    assert blocked.bf16_ring_bytes(f, depth, rows + 4) * \
        blocked._BF16_WARPS > blocked._BF16_SMEM or rows == 32
    if depth == blocked._BF16_DEPTH:
        plan = blocked.bf16_plan(f, 0, 0, EDGES["bench"], ROWS["bench"])
        assert plan.staged and plan.smem(f) == smem
    assert [blocked.bf16_rows(g, 2) for g in STAGED_WIDTHS] == [16, 20, 20,
                                                                  20]


def staged_copies(f, rows, n):
    """bf16_walk.cuh's stage(), lane by lane over a unit's group of lanes:
    the (edge, 16-byte chunk) copies a lane issues for a batch of ``n`` of
    ``rows`` edges, each with the lane that fetched its edge's source."""
    group = f // 4
    chunks = f * 2 // 16
    rounds = -(-rows * chunks // group)
    dk, dp = group // chunks, group - (group // chunks) * chunks
    copies = []
    for lane in range(group):
        k, part = divmod(lane, chunks)
        for _ in range(rounds):
            if k < n:
                copies.append((lane, k % group, k, part))
            k += dk
            part += dp
            if part >= chunks:
                part -= chunks
                k += 1
    return copies


@pytest.mark.parametrize("ring", ["default", "2x8", "3x12"])
@pytest.mark.parametrize("f", STAGED_WIDTHS)
def test_staged_copies_cover_a_batch_once(f, ring):
    """Every (edge, chunk) of a batch is copied once, for full and partial
    batches; a lane fetches at most 8 edges' sources (``kEdges``)."""
    chunks = f * 2 // 16
    rows = {"default": blocked.bf16_rows(f, 2), "2x8": 8, "3x12": 12}[ring]
    for n in {1, rows // 2, rows - 1, rows} - {0}:
        copies = staged_copies(f, rows, n)
        seen = sorted((k, part) for _, _, k, part in copies)
        assert seen == [(k, c) for k in range(n) for c in range(chunks)]
        assert -(-rows // (f // 4)) <= 8


def staged_walk_twin(lst, val, xb, depth, rows):
    """bf16_walk.cuh's walk in torch: each unit's batches staged into a
    ring by the copies of :func:`staged_copies`, summed edge by edge, lane
    by lane (each lane's pairs of elements: two terms rounded apart, added
    to float32 sums), rows written at their ends; then edge_walk's parts
    and fix-up over a split row's pieces."""
    f = xb.shape[1]
    raw = xb.contiguous().view(torch.uint8).reshape(xb.shape[0], -1)
    ptr, idx = lst.ptr.long().tolist(), lst.idx.long()
    eid = (torch.arange(lst.n_edges) if lst.eid is None
           else lst.eid.long())
    unit_row, unit_edge = lst.unit_row.tolist(), lst.unit_edge.tolist()
    out = torch.full((lst.n_rows, f), float("nan"))
    carry = torch.zeros(lst.n_units, f)
    row_bytes = f * 2
    for u in range(lst.n_units):
        head, r1 = unit_row[u], unit_row[u + 1]
        piece, r1 = head < 0, (~r1 if r1 < 0 else r1)
        e0, e1 = unit_edge[u], unit_edge[u + 1]
        row = ~head if piece else head
        ring = torch.zeros(depth, rows, row_bytes, dtype=torch.uint8)
        acc = torch.zeros(f)
        for b in range(-(-(e1 - e0) // rows)):
            b0 = e0 + b * rows
            n = min(rows, e1 - b0)
            for _, _, k, part in staged_copies(f, rows, n):
                at = slice(16 * part, 16 * part + 16)
                ring[b % depth, k, at] = raw[idx[b0 + k], at]
            staged = ring[b % depth].view(torch.bfloat16)
            for k in range(n):
                while not piece and b0 + k >= ptr[row + 1]:
                    out[row], acc = acc, torch.zeros(f)
                    row += 1
                w = val[eid[b0 + k]].reshape(())
                xk = staged[k].to(torch.float32)
                acc = acc + (w * xk).to(torch.bfloat16).to(torch.float32)
        if piece:
            carry[u] = acc
            continue
        for r in range(row, r1):
            out[r], acc = acc, torch.zeros(f)
    parts = lst.parts
    for s, first, count in lst.split.tolist():
        sums = []
        for g in range(min(parts, count)):
            part = torch.zeros(f)
            for k in range(g, count, parts):
                part = part + carry[first + k]
            sums.append(part)
        total = torch.zeros(f)
        for part in sums:
            total = total + part
        out[s] = total
    return out


@pytest.mark.parametrize("f", STAGED_WIDTHS)
def test_staged_walk_twin_equals_plain(f):
    """The twin of the staged walk over a power-law list (split rows, rows
    without edges, inf and NaN in x), forward and transposed (values
    through ``eid``), at two rings: bit-equal to the plain version (NaN
    where it has NaN)."""
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 300
    src, dst = random_power_law_edges(n, 1500, seed=3)
    graph = tt.from_edges(src, dst, np.random.RandomState(4).uniform(
        -1.0, 2.0, len(src)), n_nodes=n, directed=True, device="cpu")
    prep = blocked.BlockedSpMM(blocked.graph_lists(
        graph.row.numpy(), graph.col.numpy(), n), "cpu", items=32)
    assert prep.forward.split.shape[0] > 0
    assert (prep.forward.ptr.diff() == 0).any()
    x = torch.from_numpy(np.random.RandomState(f).randn(n, f).astype(
        np.float32))
    for lst in (prep.forward, prep.transposed):  # in rows each gathers
        a, b, c = lst.idx[[0, 50, 100]].tolist()
        x[a, 3], x[b, 0], x[c, 1] = (float("inf"), float("-inf"),
                                     float("nan"))
    xb = x.to(torch.bfloat16)
    val = graph.val.to(torch.float32)
    for lst in (prep.forward, prep.transposed):
        ref = blocked_spmm_bf16_plain(lst, val, xb)
        for depth, rows in ((2, blocked.bf16_rows(f, 2)), (3, 4)):
            out = staged_walk_twin(lst, val, xb, depth, rows)
            torch.testing.assert_close(out, ref, rtol=0, atol=0,
                                       equal_nan=True)
        assert torch.isnan(ref).any()
