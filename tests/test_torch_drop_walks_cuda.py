"""K1's dropout walks on the card over lists with split rows (the masked
walk, ``csrc/drop_walk.cuh``: the walk, then edge_walk's parts and fix-up;
the degree walk, ``csrc/degree_walk.cuh``: equal shares of the list's
edges, then a fold of the rows that cross a block's share), and launches
over one list that run at the same time, without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_drop_walks_cuda.py

Every output is held bit for bit against the plain version run on the CPU
(the walks sum in its order: the masked walk a piece in list order, a split
row's pieces in ``parts`` parts, the parts in order; the degree walk a
lane's run of a row, a row's runs in a block in lane order, its blocks'
sums in block order), over float32 and bfloat16 values.  The degree walk
is also held to at most two kernels a call (the profiler), to a CUDA-graph
replay across draws, to two streams at once, and to allocating nothing
but its output and its call's scratch.
The scaled walk finishes split rows inside its launch with a set of its
list's counters, one for each CUDA stream and each graph capture
(``ops/blocked.py::Counters``): the last tests launch it (one
``PreparedSpMM``) and both dropout walks (one training grid's lists) on two
streams at once, and beside replays of a captured call.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import (PreparedSpMM, build_train_grids,
                                 ell_degree_masked, ell_degree_masked_plain,
                                 ell_gather_masked, ell_gather_masked_plain,
                                 normalize_adjacency)
from gnntf_tpu_torch.ops import blocked
from gnntf_tpu_torch.ops.ell_gather import ell_gather_scaled_plain
from gnntf_tpu_torch.ops.stochastic import keep_mask

k1_ops = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
SALT = (0x9E3779B9, 77)
REPS = 6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lists(seed, n=2000, e=30_000, hub=6000, n_loops=200):
    """A graph's training-grid lists on the CPU at the module's cut: random
    edges, ``hub`` more from row 0 and as many into column 33 (split over
    many pieces), ``n_loops`` trailing self-loops past ``n_drop``.  Returns
    the row and column lists, float32 values and ``n_drop``."""
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.randint(0, n, e), np.zeros(hub, np.int64),
                          rng.randint(0, n, hub)])
    col = np.concatenate([rng.randint(0, n, e), rng.randint(0, n, hub),
                          np.full(hub, 33)])
    n_drop = len(row)
    loops = np.arange(n_loops) % n
    row, col = np.concatenate([row, loops]), np.concatenate([col, loops])
    val = rng.rand(len(row)).astype(np.float32) + 0.5
    rows, cols = build_train_grids(row, col, val, n).lists("cpu")
    return rows, cols, torch.from_numpy(val), n_drop


def _on(lst, device):
    """A list with every tensor on ``device``."""
    return dataclasses.replace(lst, **{
        f.name: getattr(lst, f.name).to(device)
        for f in dataclasses.fields(lst)
        if isinstance(getattr(lst, f.name), torch.Tensor)})


def _x(seed, n, f):
    return torch.from_numpy(np.random.RandomState(seed).randn(n, f).astype(
        np.float32))


def _check(lst, val, x, salt, keep, n_drop, cuda, calls=2):
    """Both walks over ``lst`` on the card, ``calls`` times each: bit for
    bit the plain versions on the CPU, one launch a call."""
    on, val_c, x_c = _on(lst, cuda), val.to(cuda), x.to(cuda)
    salt_t = torch.tensor(salt)
    ref = ell_gather_masked_plain(lst, val, salt_t, keep, n_drop, x)
    ref_deg = ell_degree_masked_plain(lst, val, salt_t, keep, n_drop)
    counts = ((ell_gather_masked, "launches"), (ell_degree_masked,
                                                "launches"))
    if val.dtype == torch.bfloat16:
        counts = ((ell_gather_masked, "bf16_launches"),
                  (ell_degree_masked, "bf16_launches"))
    before = [getattr(f, a) for f, a in counts]
    for _ in range(calls):
        out = ell_gather_masked(on, val_c, salt_t, keep, n_drop, x_c)
        deg = ell_degree_masked(on, val_c, salt_t, keep, n_drop)
        torch.cuda.synchronize()
        nan = torch.isnan(ref)
        assert torch.equal(torch.isnan(out.cpu()), nan)
        assert torch.equal(out.cpu()[~nan], ref[~nan])
        assert torch.equal(deg.cpu(), ref_deg)
    assert [getattr(f, a) for f, a in counts] == [b + calls for b in before]
    return ref


@pytest.mark.cuda
@pytest.mark.parametrize("items,tile_items", [(4, 64), (16, 256),
                                              (128, 256)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 40, 136])
def test_drop_walks_finish_split_rows_on_card(cuda, monkeypatch, items,
                                              tile_items, dtype, f):
    """Pieces of 4, 16 and 128 edges (a hub of 6,000 edges: up to 1,500
    pieces, so parts of many pieces), tiles of 64 and 256 items, float32
    and bfloat16 values, F = 1, 40 and 136 (more than one pass of a
    sub-group's lanes over the features): both walks bit for bit their
    plain versions, twice in a row."""
    monkeypatch.setattr(k1_ops, "_DROP_ITEMS", items)
    monkeypatch.setattr(k1_ops, "_TILE_ITEMS", tile_items)
    rows, cols, val, n_drop = _lists(1)
    for lst in (rows, cols):
        assert lst.split.shape[0]
        if items == 4:
            assert int(lst.split[:, 2].max()) > 2 * lst.parts
        _check(lst, val.to(dtype), _x(2, 2000, f), SALT, 0.5, n_drop, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [1, 40])
def test_drop_walks_over_fully_dropped_tiles_on_card(cuda, monkeypatch,
                                                     dtype, f):
    """Keep 1e-4: most tiles, and most pieces, keep no edge (a piece's
    carry is then +0), a few keep one."""
    monkeypatch.setattr(k1_ops, "_DROP_ITEMS", 8)
    rows, cols, val, n_drop = _lists(3)
    salt, keep = (11, 12), 1e-4
    for lst in (rows, cols):
        eids = (torch.arange(lst.n_edges) if lst.eid is None
                else lst.eid.long())
        kept = keep_mask(eids, torch.tensor(salt), keep, n_drop)
        per_tile = torch.zeros(lst.n_tiles, dtype=torch.int64).index_add_(
            0, torch.searchsorted(lst.tile_edge.long(),
                                  torch.arange(lst.n_edges), right=True) - 1,
            kept.long())
        assert (per_tile == 0).any() and kept.any()
        _check(lst, val.to(dtype), _x(4, 2000, f), salt, keep, n_drop, cuda)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f", [6, 40])
def test_masked_walk_keeps_nan_of_dropped_sources_with_split_rows_on_card(
        cuda, monkeypatch, dtype, f):
    """An inf and a NaN in x rows that only dropped edges read, over lists
    with split rows: pass 1 walks again and the split rows are summed
    again; NaNs where the plain version's are, every other element
    bit-equal."""
    monkeypatch.setattr(k1_ops, "_DROP_ITEMS", 16)
    rows, cols, val, n_drop = _lists(5, e=8000, hub=3000)
    salt, keep = (21, 22), 0.3
    for lst in (rows, cols):
        eids = (torch.arange(lst.n_edges) if lst.eid is None
                else lst.eid.long())
        kept = keep_mask(eids, torch.tensor(salt), keep, n_drop)
        src = lst.idx.long()
        only = np.setdiff1d(src[~kept].numpy(), src[kept].numpy())
        assert len(only) >= 2
        x = _x(6, 2000, f)
        x[int(only[0]), 0] = float("inf")
        x[int(only[-1]), f - 1] = float("nan")
        ref = _check(lst, val.to(dtype), x, salt, keep, n_drop, cuda)
        assert torch.isnan(ref).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_drop_walks_replay_across_draws_on_card(cuda, monkeypatch, dtype):
    """Both walks over both lists captured in one CUDA graph with the salt
    pair in a device buffer, replayed under two draws (the buffer
    rewritten between them): each replay bit for bit the plain versions of
    its draw."""
    monkeypatch.setattr(k1_ops, "_DROP_ITEMS", 16)
    rows, cols, val, n_drop = _lists(7)
    val = val.to(dtype)
    lists = [_on(lst, cuda) for lst in (rows, cols)]
    val_c, x = val.to(cuda), _x(8, 2000, 40)
    x_c = x.to(cuda)
    buf = torch.tensor(SALT, device=cuda)

    def calls():
        return [f(lst) for lst in lists for f in (
            lambda l: ell_gather_masked(l, val_c, buf, 0.5, n_drop, x_c),
            lambda l: ell_degree_masked(l, val_c, buf, 0.5, n_drop))]

    calls()  # the kernels built and loaded before the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for salt in ((31, 32), (0xDEADBEEF, 5)):
        buf.copy_(torch.tensor(salt))
        graph.replay()
        torch.cuda.synchronize()
        salt_t = torch.tensor(salt)
        refs = [f(lst) for lst in (rows, cols) for f in (
            lambda l: ell_gather_masked_plain(l, val, salt_t, 0.5, n_drop,
                                              x),
            lambda l: ell_degree_masked_plain(l, val, salt_t, 0.5, n_drop))]
        for out, ref in zip(outs, refs):
            assert torch.equal(out.cpu(), ref)


def _stream_cases(cuda):
    """The calls over one list each: the scaled walk of one
    ``PreparedSpMM`` (a power-law graph, its hub rows split), and the
    masked and degree walks over one training grid's lists; each with the
    list it walks and its plain version on the CPU."""
    src, dst = random_power_law_edges(20_000, 150_000, seed=3)
    graph = tt.from_edges(src, dst, n_nodes=20_000, directed=False,
                          device=cuda)
    op = PreparedSpMM(normalize_adjacency(graph, graph_dropout=0.0))
    rs, cs = op._scales
    host = lambda t: None if t is None else t.cpu()
    w = float(op.eye_weight)
    k1_cpu = _on(op.k1_list, "cpu")
    rows, cols = build_train_grids(graph.row.cpu().numpy(),
                                   graph.col.cpu().numpy(),
                                   graph.val.cpu().numpy(),
                                   20_000).lists(cuda)
    val = graph.val.to(torch.float32).contiguous()
    salt = torch.tensor(SALT, dtype=torch.int64, device=cuda)
    draw, host_draw = (salt, 0.5, graph.n_edges), (salt.cpu(), 0.5,
                                                   graph.n_edges)
    rows_cpu, cols_cpu = _on(rows, "cpu"), _on(cols, "cpu")
    return {
        "scaled": (op.k1_list, op, lambda x: ell_gather_scaled_plain(
            k1_cpu, op.k1_val.cpu(), x.cpu(), host(rs), host(cs), w)),
        "masked_rows": (
            rows, lambda x: ell_gather_masked(rows, val, *draw, x),
            lambda x: ell_gather_masked_plain(rows_cpu, val.cpu(),
                                              *host_draw, x.cpu())),
        "masked_cols": (
            cols, lambda x: ell_gather_masked(cols, val, *draw, x),
            lambda x: ell_gather_masked_plain(cols_cpu, val.cpu(),
                                              *host_draw, x.cpu())),
        "degree": (
            cols, lambda x: ell_degree_masked(cols, val, *draw),
            lambda x: ell_degree_masked_plain(cols_cpu, val.cpu(),
                                              *host_draw))}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["scaled", "masked_rows", "masked_cols",
                                  "degree"])
def test_launches_on_two_streams_and_beside_a_replay_on_card(cuda, case):
    """Calls over one list on two streams, enqueued in turn, and replays
    of a captured call on one stream each beside an eager call on
    another: every output bit for bit the plain version on the CPU.  The
    scaled walk's list holds a set of counters for each stream and one for
    the capture, apart from them; the next eager call lets go of the
    capture's, and every set reads zero after."""
    lst, call, plain = _stream_cases(cuda)[case]
    assert lst.split.shape[0]
    xs = {"a": _x(9, 20_000, 40).to(cuda), "b": _x(10, 20_000, 40).to(cuda)}
    refs = {key: plain(x) for key, x in xs.items()}
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in side:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(REPS):
        for s, key in zip(side, "ab"):
            with torch.cuda.stream(s):
                got.append((key, call(xs[key])))
    torch.cuda.synchronize()
    for key, out in got:
        assert torch.equal(out.cpu(), refs[key])
    cap = torch.cuda.Stream()
    cap.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=cap):
        static = call(xs["a"])
    store = lst.counters if case == "scaled" else None
    if store is not None:
        assert len(store.sets) >= 2 and len(store.captured) == 1
        eager = {id(t) for t in store.sets.values()}
        assert not eager & {id(t) for t in store.captured.values()}
    got = []
    for _ in range(REPS):
        with torch.cuda.stream(side[0]):
            graph.replay()
        with torch.cuda.stream(side[1]):
            got.append(call(xs["b"]))
    torch.cuda.synchronize()
    assert torch.equal(static.cpu(), refs["a"])
    for out in got:
        assert torch.equal(out.cpu(), refs["b"])
    if store is not None:
        assert store.zero() and not store.captured


def _hub_lists(seed, n=3000, e=40_000, hubs=(0, 3)):
    """A training grid's lists on the CPU whose hub row and hub column hold
    ``hubs[1]`` shares of the degree walk and more (each spans several
    blocks), with empty rows and columns (odd rows, columns not a multiple
    of 3), a column of more than a lane's run, and 300 trailing self-loops
    past ``n_drop``; returns the row and column lists, values and
    ``n_drop``."""
    rng = np.random.RandomState(seed)
    share = blocked.DEGREE_SHARE
    hub = hubs[1] * share + 77
    row = np.concatenate([rng.randint(0, n // 2, e) * 2,
                          np.full(hub, hubs[0]),
                          rng.randint(0, n // 2, hub + 50) * 2])
    col = np.concatenate([rng.randint(0, n // 3, e) * 3,
                          rng.randint(0, n // 3, hub) * 3,
                          np.full(hub, 33), np.full(50, 7)])
    order = rng.permutation(len(row))
    row, col = row[order], col[order]
    n_drop = len(row)
    loops = np.arange(300) % (n // 6)
    row, col = np.concatenate([row, loops * 2]), np.concatenate([col,
                                                                 loops * 3])
    val = rng.rand(len(row)).astype(np.float32) + 0.5
    rows, cols = build_train_grids(row, col, val, n).lists("cpu")
    return rows, cols, torch.from_numpy(val), n_drop


def _degrees(lst, val, salt, keep, n_drop, cuda, id_base=0):
    """The degree walk over ``lst`` on the card (twice) and its plain
    versions on the card and on the CPU."""
    on, val_c = _on(lst, cuda), val.to(cuda)
    salt_t = torch.tensor(salt)
    got = ell_degree_masked(on, val_c, salt_t, keep, n_drop, id_base)
    again = ell_degree_masked(on, val_c, salt_t, keep, n_drop, id_base)
    plain = ell_degree_masked_plain(on, val_c, salt_t.to(cuda), keep, n_drop,
                                    id_base)
    cpu = ell_degree_masked_plain(lst, val, salt_t, keep, n_drop, id_base)
    return got, again, plain, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["half", "all_dropped", "keep_1",
                                  "n_drop_below", "id_base"])
def test_degree_walk_bit_equal_to_plain_on_card(cuda, dtype, case):
    """The CPU file's cases at a size where the hubs span several blocks:
    keep 0.5, keep 1/16 (rows whose edges are all dropped), keep 1, ``n_drop``
    below the edge count, and a slice's ``id_base``: the walk bit for bit its
    plain version on the card and on the CPU, and a relaunch."""
    rows, cols, val, n_drop = _hub_lists(11)
    keep, base = {"half": (0.5, 0), "all_dropped": (1 / 16, 0),
                  "keep_1": (1.0, 0), "n_drop_below": (0.3, 0),
                  "id_base": (0.5, 12_345)}[case]
    if case == "n_drop_below":
        n_drop -= 5000
    for lst in (rows, cols):
        assert lst.share_folds > 0
        assert int(lst.ptr.diff().max()) > 2 * blocked.DEGREE_SHARE
        got, again, plain, cpu = _degrees(lst, val.to(dtype), SALT, keep,
                                          n_drop, cuda, base)
        assert torch.equal(got, plain) and torch.equal(got, again)
        assert torch.equal(got.cpu(), cpu)
        if case == "all_dropped":
            held = lst.ptr.diff() > 0
            assert (held & (cpu == 0)).any()


def _kernels(fn):
    """The device kernels ``fn()`` launches, by name (torch.profiler; the
    session opened with spin kernels and closed 2 ms a 256 of them after
    ``fn``'s end, and taken again with 4x as many when it kept none of
    them, or no walk: the profiler can drop a session's first and last
    device events)."""
    import time
    from torch.profiler import ProfilerActivity, profile
    primer = 256
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002 * primer / 256)
        got = {e.key: e.count for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA}
        kept = {k: n for k, n in got.items() if "spin_kernel" not in k}
        if len(kept) < len(got) and any("_walk" in k for k in kept):
            return kept
        primer *= 4
    raise RuntimeError("the profiler kept no primer kernel or no walk in 3 "
                       "sessions")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_degree_walk_launches_at_most_two_kernels_on_card(cuda, dtype):
    """A call over lists whose hubs cross blocks' shares runs the walk and
    the fold, one launch each; over a list none of whose rows crosses one
    (a list within one block), the walk alone."""
    rows, cols, val, n_drop = _hub_lists(12)
    small_rows, _, small_val, small_drop = _hub_lists(13, n=300, e=800,
                                                      hubs=(0, 0))
    cases = [(rows, val, n_drop, 2), (cols, val, n_drop, 2),
             (small_rows, small_val, small_drop, 1)]
    for lst, v, nd, want in cases:
        on, v_c = _on(lst, cuda), v.to(dtype).to(cuda)
        salt = torch.tensor(SALT, device=cuda)
        ell_degree_masked(on, v_c, salt, 0.5, nd)  # the values' copy made
        got = _kernels(lambda: ell_degree_masked(on, v_c, salt, 0.5, nd))
        names = {k.split("(anonymous namespace)::")[-1].split("<")[0]
                 .split("(")[0]: n for k, n in got.items()}
        assert sum(got.values()) == want, got
        assert names.get("ell_degree_share_walk") == 1, got
        assert names.get("ell_degree_share_fold", 0) == want - 1, got


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_degree_walk_replays_across_draws_on_card(cuda, dtype):
    """The degree walk over both lists captured in one CUDA graph with the
    salt pair in a device buffer, replayed under two draws: each replay bit
    for bit the plain versions of its draw on the CPU."""
    rows, cols, val, n_drop = _hub_lists(14)
    val = val.to(dtype)
    lists, val_c = [_on(lst, cuda) for lst in (rows, cols)], val.to(cuda)
    buf = torch.tensor(SALT, device=cuda)
    calls = lambda: [ell_degree_masked(l, val_c, buf, 0.5, n_drop)
                     for l in lists]
    calls()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = calls()
    for salt in ((41, 42), (0xDEADBEEF, 6)):
        buf.copy_(torch.tensor(salt))
        graph.replay()
        torch.cuda.synchronize()
        for out, lst in zip(outs, (rows, cols)):
            assert torch.equal(out.cpu(), ell_degree_masked_plain(
                lst, val, torch.tensor(salt), 0.5, n_drop))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_degree_walk_on_two_streams_on_card(cuda, dtype):
    """Calls over one list on two streams at once (each call's scratch its
    own): the same bits on each, those of the plain version on the CPU."""
    _, cols, val, n_drop = _hub_lists(15)
    val = val.to(dtype)
    on, val_c = _on(cols, cuda), val.to(cuda)
    draws = {"a": (51, 52), "b": (53, 54)}
    refs = {k: ell_degree_masked_plain(cols, val, torch.tensor(d), 0.5,
                                       n_drop) for k, d in draws.items()}
    salts = {k: torch.tensor(d, device=cuda) for k, d in draws.items()}
    ell_degree_masked(on, val_c, salts["a"], 0.5, n_drop)
    side = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in side:
        s.wait_stream(torch.cuda.current_stream())
    got = []
    for _ in range(REPS):
        for s, key in zip(side, "ab"):
            with torch.cuda.stream(s):
                got.append((key, ell_degree_masked(on, val_c, salts[key],
                                                   0.5, n_drop)))
    torch.cuda.synchronize()
    for key, out in got:
        assert torch.equal(out.cpu(), refs[key])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_degree_walk_allocates_only_out_and_scratch_on_card(cuda, dtype):
    """After the first call (which makes the list's copy of the values, once),
    a call allocates two tensors: its output and its scratch (the blocks'
    sums and rows, three int32 a block); nothing lasts past the call but the
    output."""
    _, cols, val, n_drop = _hub_lists(16)
    on, val_c = _on(cols, cuda), val.to(dtype).to(cuda)
    salt = torch.tensor(SALT, device=cuda)
    ell_degree_masked(on, val_c, salt, 0.5, n_drop)
    torch.cuda.synchronize()
    stats = torch.cuda.memory_stats(cuda)
    count = stats["allocation.all.allocated"]
    held = torch.cuda.memory_allocated(cuda)
    out = ell_degree_masked(on, val_c, salt, 0.5, n_drop)
    torch.cuda.synchronize()
    assert torch.cuda.memory_stats(cuda)["allocation.all.allocated"] \
        - count == 2
    # the caching allocator rounds a block up to 512 bytes
    kept = torch.cuda.memory_allocated(cuda) - held
    assert out.untyped_storage().nbytes() <= kept < \
        out.untyped_storage().nbytes() + 512
