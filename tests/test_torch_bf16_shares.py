"""The order of K2's bfloat16 share walk (``csrc/share_walk.cuh``) on the
CPU: ``ops/blocked.py::share_row_sums`` against a model of the walk that
adds one term at a time (blocks, their groups' runs, the runs' partials
folded after the block's barrier, the blocks' partials folded by ranges),
bit for bit, at the walk's share and at a small one; against a float64 sum
of the same rounded terms; and ``bf16_plan``'s route.  No card and no JAX:

    python -m pytest -q tests/test_torch_bf16_shares.py
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from gnntf_tpu_torch.ops import blocked

F = 4
# (run, groups, fold_range): the walk's at its three group sizes (F = 64,
# 128, 256), and a small share whose hub row crosses many blocks and ranges
SHARES = {f"walk_f{f}": (blocked.bf16_share_run(f),
                         blocked.BF16_SHARE // blocked.bf16_share_run(f),
                         blocked.BF16_FOLD_RANGE) for f in (64, 128, 256)}
SHARES["small"] = (4, 4, 3)


def walk_model(ptr, terms, run, groups, fold_range):
    """The share walk, one float32 addition at a time: each block's groups
    sum their runs of each row from +0 in edge order, writing a row that
    starts and ends in a run at once; after the block's barrier the group
    that ends a row that came from an earlier run folds its runs' sums in
    run order, and the group with the block's last edge folds the row that
    goes on into carry_in (a row that came from the block before) or
    carry_out; empty rows are written as +0 by the block whose chunk of
    the rows (``ceil(n / n_blocks)`` rows a block) holds them; then each
    row that crosses a block's end is folded from its
    first block's carry_out and the later blocks' carry_in, by ranges of
    ``fold_range`` partials.  Rows never written stay NaN."""
    ptr = np.asarray(ptr, np.int64)
    terms = np.asarray(terms, np.float32)
    n, (n_edges, f) = len(ptr) - 1, terms.shape
    share = run * groups
    n_blocks = max(1, -(-n_edges // share))
    out = np.full((n, f), np.nan, np.float32)
    carry_in = np.full((n_blocks, f), np.nan, np.float32)
    carry_out = np.full((n_blocks, f), np.nan, np.float32)
    col_in = np.full(n_blocks, -7)

    def row_of(e):  # the first row r with ptr[r + 1] > e (n for the end)
        return int(np.searchsorted(ptr[1:], e, side="right"))

    def fold(first, last, start, came_in, to):
        acc = (first[0] if came_in else last[start]).copy()
        for u in range(1 if came_in else start + 1, to + 1):
            acc = acc + first[u]
        return acc

    chunk = -(-n // n_blocks)
    for b in range(n_blocks):
        e_block, e_end = b * share, min(n_edges, (b + 1) * share)
        lo = row_of(e_block)
        for r in range(b * chunk, min(n, (b + 1) * chunk)):
            if ptr[r] == ptr[r + 1]:
                out[r] = 0.0
        col_in[b] = lo if lo < n and ptr[lo] < e_block else -1
        first, last, state = {}, {}, []
        for g in range(groups):
            r0 = e_block + g * run
            count = max(0, min(run, e_end - r0))
            if count == 0:
                continue
            row = head_row = row_of(r0)
            head_start = ptr[row]
            came = head_start < r0
            row_end = ptr[row + 1]
            acc = np.zeros(f, np.float32)
            first_row, ends_here = True, False
            for e in range(r0, r0 + count):
                if e >= row_end:
                    if first_row:
                        first[g], ends_here = acc.copy(), came
                    if not (first_row and came):
                        out[row] = acc
                    first_row = False
                    acc = np.zeros(f, np.float32)
                    row += 1
                    while ptr[row + 1] <= e:
                        row += 1
                    row_end = ptr[row + 1]
                acc = acc + terms[e]
            if first_row:
                first[g] = acc.copy()
            last[g] = acc.copy()
            if row_end == r0 + count:
                if first_row:
                    ends_here = came
                if not (first_row and came):
                    out[row] = acc
            state.append((g, r0, count, head_row, head_start, first_row,
                          ends_here, row_end))
        for g, r0, count, head_row, head_start, first_row, ends_here, \
                row_end in state:
            if ends_here:
                came_in = head_start < e_block
                total = fold(first, last, 0 if came_in
                             else (head_start - e_block) // run, came_in, g)
                if came_in:
                    carry_in[b] = total
                else:
                    out[head_row] = total
            if r0 + count == e_end and row_end > e_end:
                came_in = first_row and head_start < e_block
                start = (g if not first_row else 0 if came_in
                         else (head_start - e_block) // run)
                total = fold(first, last, start, came_in, g)
                (carry_in if came_in else carry_out)[b] = total
    for b in range(1, n_blocks):
        r = col_in[b]
        if r < 0 or ptr[r] < (b - 1) * share:
            continue
        count = (ptr[r + 1] - 1) // share - b + 2
        partials = [carry_out[b - 1]] + [carry_in[b - 1 + k]
                                         for k in range(1, count)]
        total = None
        for q in range(0, count, fold_range):
            acc = partials[q].copy()
            for p in partials[q + 1:q + fold_range]:
                acc = acc + p
            total = acc if total is None else total + acc
        out[r] = total
    return out


def _degrees(case, share, fold_range, rng):
    """Row lengths of one case, at a share of ``share`` edges and ranges of
    ``fold_range`` blocks."""
    if case == "shorter_than_a_share":
        return rng.randint(0, 5, max(1, share // 8))
    if case == "row_over_runs":  # rows of one to three runs, inside blocks
        return rng.randint(share // 40 + 1, share // 5 + 2, 60)
    if case == "row_over_shares":  # a row of 2.5 shares among short ones
        deg = rng.randint(1, 20, 200)
        deg[77] = 5 * share // 2
        return deg
    if case == "empty_rows":  # leading, trailing and runs of empty rows,
        deg = rng.randint(0, 9, 400)  # some at run and block starts
        deg[:7] = deg[-9:] = deg[100:130] = 0
        return deg
    if case == "hub":  # the bench graph's hub: a quarter of the edges or
        deg = rng.randint(1, 30, 1500)  # more, over several ranges
        deg[700] = max(int(deg.sum() * 0.37), (fold_range + 3) * share)
        return deg
    if case == "whole_shares":  # every row ends on a run's end
        return np.full(40, share // 4)
    raise ValueError(case)


CASES = ("shorter_than_a_share", "row_over_runs", "row_over_shares",
         "empty_rows", "hub", "whole_shares")


def _case(case, name, seed=0):
    run, groups, fold_range = SHARES[name]
    rng = np.random.RandomState(seed)
    deg = _degrees(case, run * groups, fold_range, rng)
    ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    terms = rng.randn(int(ptr[-1]), F).astype(np.float32)
    # terms rounded to bfloat16, as the walk's are
    terms = torch.from_numpy(terms).to(torch.bfloat16).float()
    return torch.from_numpy(ptr), terms, (run, groups, fold_range)


@pytest.mark.parametrize("name", sorted(SHARES))
@pytest.mark.parametrize("case", CASES)
def test_share_row_sums_equal_the_walk_model(case, name):
    ptr, terms, (run, groups, fold_range) = _case(case, name)
    model = walk_model(ptr.numpy(), terms.numpy(), run, groups, fold_range)
    assert not np.isnan(model).any()  # every row written
    out = blocked.share_row_sums(ptr, terms, run, run * groups, fold_range)
    assert np.array_equal(out.numpy(), model), case
    share = run * groups
    crossing = blocked.share_folds(ptr.numpy(), share)
    if case in ("row_over_shares", "hub"):
        assert crossing > 0
        longest = int(ptr.diff().max())
        if case == "hub":  # the hub's partials span several ranges
            assert longest // share > fold_range


@pytest.mark.parametrize("case", CASES)
def test_share_row_sums_against_float64(case):
    """Within ``1e-6 * sum|terms|`` of the float64 sum of the same terms."""
    ptr, terms, (run, groups, fold_range) = _case(case, "walk_f128", seed=3)
    out = blocked.share_row_sums(ptr, terms, run, run * groups, fold_range)
    rows = torch.repeat_interleave(torch.arange(ptr.numel() - 1),
                                   ptr.diff().long())
    exact = torch.zeros(ptr.numel() - 1, F, dtype=torch.float64).index_add_(
        0, rows, terms.double())
    scale = torch.zeros_like(exact).index_add_(0, rows, terms.double().abs())
    assert bool(((out.double() - exact).abs() <= 1e-6 * scale).all())


def test_order_differs_from_a_plain_row_sum():
    """The hub's sum is not the edge-order sum: the order is the walk's."""
    ptr, terms, (run, groups, fold_range) = _case("hub", "walk_f128")
    out = blocked.share_row_sums(ptr, terms, run, run * groups, fold_range)
    rows = torch.repeat_interleave(torch.arange(ptr.numel() - 1),
                                   ptr.diff().long())
    in_order = torch.zeros(ptr.numel() - 1, F).index_add_(0, rows, terms)
    assert not torch.equal(out, in_order)


def test_constants_match_the_kernel():
    """``BF16_SHARE``, ``BF16_SHARE_THREADS``, ``BF16_FOLD_RANGE`` and the
    widths are the CUDA source's defaults (the C entry checks the share
    and the range at every launch), and each width's run is the kernel's
    ``kShare * L / kThreads`` at its group of L lanes."""
    src = (Path(blocked.__file__).parents[1] / "csrc"
           / "share_walk.cuh").read_text()

    def value(name):
        return int(re.search(rf"{name} = (\d+);", src).group(1))

    assert (value("kShare"), value("kThreads"),
            value("kFoldRange")) == (blocked.BF16_SHARE,
                                     blocked.BF16_SHARE_THREADS,
                                     blocked.BF16_FOLD_RANGE)
    assert (value("kMinF"), value("kMaxF")) == blocked.BF16_SHARE_WIDTHS
    for f in range(64, 257, 8):
        lanes = min(l for l in (8, 16, 32) if l >= f // 8)
        assert blocked.bf16_share_run(f) == (
            blocked.BF16_SHARE * lanes // blocked.BF16_SHARE_THREADS)


# a Cora-scale list's edges and rows, and the RCM bench graph's forward
# list's
LISTS = {"cora": (10_556, 2_708), "bench": (2_332_478, 169_343)}


@pytest.mark.parametrize("name", sorted(LISTS))
@pytest.mark.parametrize("x_at", [0, 2, 8, 16])
@pytest.mark.parametrize("out_at", [0, 8])
def test_plan_routes_the_share_walk(name, x_at, out_at):
    """The share walk at F % 8 == 0 from 64 to 256, with ``x`` and ``out``
    16-byte aligned, on the lists of ``_BF16_SHARE_LISTS`` at its group
    size (40,000 edges on at F = 64; 150,000 and 4 edges a row on at F =
    72-128; 300,000 at F = 136-256: the bench list, not the Cora-scale
    one); every other width, alignment and list keeps the staged or the
    generic walk."""
    lists = blocked._BF16_SHARE_LISTS
    assert lists == {8: (40_000, 0), 16: (150_000, 4), 32: (300_000, 0)}
    n_edges, n_rows = LISTS[name]
    aligned = x_at % 16 == 0 and out_at % 16 == 0
    for f in range(1, 300):
        plan = blocked.bf16_plan(f, x_at, out_at, n_edges, n_rows)
        share = aligned and f % 8 == 0 and 64 <= f <= 256
        if share:
            fewest, per_row = lists[blocked.bf16_share_lanes(f)]
            share = n_edges >= fewest and n_edges >= per_row * n_rows
        assert plan.share == share, (f, plan)
        assert share == (aligned and f % 8 == 0 and 64 <= f <= 256
                         and name == "bench"), f
        if share:
            assert (plan.walk, plan.vec, plan.group) == ("share", 8, f // 8)
    # each group size's crossover: the first list size that takes the walk
    for f, lanes in ((64, 8), (72, 16), (128, 16), (136, 32), (256, 32)):
        assert blocked.bf16_share_lanes(f) == lanes
        fewest, per_row = lists[lanes]
        rows = fewest // max(1, per_row)
        assert not blocked.bf16_plan(f, 0, 0, fewest - 1, rows).share
        assert blocked.bf16_plan(f, x_at, out_at, fewest,
                                 rows).share == aligned
        if per_row:  # one row more than the edges allow
            assert not blocked.bf16_plan(f, 0, 0, fewest, rows + 1).share


# the lists of the crossover that set the route (k2_sweep.py --kernels
# k2bf16: edges, rows), and the widths of F = 64, 96, 128, 256 at which
# the share walk measured faster than the generic walk
CROSSOVER = {
    "cora_uniform": ((10_556, 2_708), ()),
    "cora_power_law": ((10_554, 2_708), ()),
    "power_law_20k": ((79_994, 20_000), (64,)),
    "power_law_40k": ((199_996, 40_000), (64, 96, 128)),
    "power_law_60k": ((359_998, 60_000), (64, 96, 128, 256)),
    "bench_quarter": ((583_119, 169_343), (64, 256)),
    "bench_rcm": ((2_332_478, 169_343), (64, 96, 128, 256)),
}


@pytest.mark.parametrize("name", sorted(CROSSOVER))
def test_plan_gives_the_share_walk_where_it_won(name):
    """On each list of the crossover, the route gives the share walk
    exactly the widths at which it measured faster."""
    (n_edges, n_rows), won = CROSSOVER[name]
    taken = tuple(f for f in (64, 96, 128, 256)
                  if blocked.bf16_plan(f, 0, 0, n_edges, n_rows).share)
    assert taken == won


def test_forced_loads_take_the_generic_walk(monkeypatch):
    monkeypatch.setattr(blocked, "_BF16_VEC", 8)
    plan = blocked.bf16_plan(128, 0, 0, *LISTS["bench"])
    assert plan.walk == "generic" and plan.vec == 8


def test_plain_version_takes_the_plans_order(monkeypatch):
    """``blocked_spmm_bf16_plain`` sums in the share walk's order where the
    plan gives it, else in the unit walk's (``ordered_row_sums``); both hold
    the same terms."""
    rng = np.random.RandomState(5)
    n = 400
    deg = rng.randint(0, 12, n)
    deg[9] = 3 * blocked.BF16_SHARE
    ptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.randint(0, n, int(ptr[-1]))
    lst = blocked.EdgeList.build(ptr, src, None, "cpu")
    assert blocked.bf16_folds(lst) == blocked.share_folds(
        ptr, blocked.BF16_SHARE) > 0
    val = torch.from_numpy(rng.uniform(-1, 2, lst.n_edges).astype(np.float32))
    xb = torch.from_numpy(rng.randn(n, 64).astype(np.float32)).to(
        torch.bfloat16)
    terms = (xb[lst.idx.long()].float() * val[:, None]).to(
        torch.bfloat16).float()
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", {8: (0, 0)})
    out = blocked.blocked_spmm_bf16_plain(lst, val, xb)
    assert torch.equal(out, blocked.share_row_sums(
        lst.ptr, terms, blocked.bf16_share_run(64), blocked.BF16_SHARE,
        blocked.BF16_FOLD_RANGE))
    assert torch.equal(blocked.blocked_spmm_bf16(lst, val, xb), out)
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS",
                        {8: (lst.n_edges + 1, 0)})
    generic = blocked.blocked_spmm_bf16_plain(lst, val, xb)
    assert torch.equal(generic, blocked.ordered_row_sums(lst, terms))
    assert not torch.equal(generic, out)
    torch.testing.assert_close(generic, out, rtol=1e-5, atol=1e-4)
