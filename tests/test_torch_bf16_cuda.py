"""K2's bfloat16 mode and K1's dropout walks over bfloat16 values on the
card, against their plain versions, without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_bf16_cuda.py

* ``blocked_spmm_bf16`` over a random graph's lists (duplicate pairs, empty
  rows, a hub row split over many units) at F = 1, 4, 7, 16, 40, 64, 128
  with the program's walk (``bf16_plan``: on these lists the staged walk
  at F = 40, the generic walk elsewhere) and with the generic walk
  forced (``_BF16_VEC`` 8, 4, 2, 1; the narrow walk where a row has fewer
  than 8 loads): within ``1e-5 * sum|terms|`` of the plain version on the
  card, and bit-equal to it on the CPU (the same terms, summed in the same
  order); the share is logged;
* the staged walk (``csrc/bf16_walk.cuh``, given every list at its
  widths through ``_BF16_STAGED_EDGES``) at F = 16, 24, 32, 40, and the mode at 64
  and 128 where the share walk or the generic walk takes it, over the forward list, the
  transposed one (values through ``eid``) and a power-law list with split
  rows, ``x`` holding inf and NaN: bit-equal to the plain version on the
  CPU (NaN where it has NaN) and within ``1e-5 * sum|terms|`` of it on the
  card (whose ``index_add_`` adds in no fixed order); at other rings; ``x``
  views that are not 16-byte aligned, which the host rule sends to the
  generic walk;
* the share walk (``csrc/share_walk.cuh``, given every list through
  ``_BF16_SHARE_LISTS``) at F = 64, 96, 128 and 256 over small lists, a
  list shorter than one share and lists with a row of more than one share:
  ``torch.equal`` to the plain version on the card and on the CPU; at most
  2 kernels a call (the walk, and its fold where a row crosses a share),
  none without a crossing row; a CUDA-graph replay; two streams at once;
* the masked and degree walks over bfloat16 base values (the training grids
  of ``GNNTF_GRID_VALUE_DTYPE=bfloat16``): the same two checks;
* ``spmm_pallas(bf16=True)`` forward and backward (``dx``, ``dval``) on the
  card against the CPU; the masked product and the degrees under the knob
  on the card against the CPU; APPNP trained under the knob equal to APPNP
  without it (unit values).

Every test skips without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.ops import blocked, stochastic
from gnntf_tpu_torch.ops.ell_gather import (ell_degree_masked,
                                            ell_degree_masked_plain,
                                            ell_gather_masked,
                                            ell_gather_masked_plain)

N = 3000
KNOB = "GNNTF_GRID_VALUE_DTYPE"
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(device, weighted=True):
    """Duplicate pairs, rows without edges (the odd ones), a hub row."""
    rng = np.random.RandomState(0)
    src = np.concatenate([rng.randint(0, N // 2, 40000) * 2,
                          np.full(6000, 10)])
    dst = rng.randint(0, N // 4, len(src)) * 4
    vals = rng.uniform(-1.0, 2.0, len(src)) if weighted else None
    return tt.from_edges(src, dst, vals, n_nodes=N, directed=True,
                         device=device)


def _list_to(lst, device):
    return dataclasses.replace(lst, **{
        f.name: getattr(lst, f.name).to(device)
        for f in dataclasses.fields(lst)
        if isinstance(getattr(lst, f.name), torch.Tensor)})


def _same(label, out, ref_card, scale, ref_cpu):
    """Within ``RTOL * scale`` of the plain version on the card and
    bit-equal to it on the CPU."""
    diff = (out - ref_card).abs()
    assert bool((diff <= RTOL * scale).all()), (label, diff.max().item())
    share = (out.cpu() == ref_cpu).double().mean().item()
    print(f"{label}: bit-equal share {share} against the CPU plain version")
    assert share == 1.0, label


def _walk_kernels(fn):
    """The walk kernels that ``fn`` ran (:func:`_kernels`)."""
    return {n for n in _kernels(fn) if "_walk" in n}


def _kernels(fn):
    """The kernels that ``fn`` ran, by name (one profile, opened with spin
    kernels and closed 2 ms a 256 of them after ``fn``'s end; taken again
    when it kept none of them, or no walk: the profiler can drop a
    session's first and last device events)."""
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
        keys = [e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        names = {k.split("(anonymous namespace)::")[-1].split("<")[0]
                 .split("(")[0] for k in keys if "spin_kernel" not in k}
        if (any("spin_kernel" in k for k in keys)
                and any("_walk" in n for n in names)):
            return names
        primer *= 4
    raise RuntimeError("the profiler kept no primer kernel or no walk in 3 "
                       "sessions")


@pytest.mark.cuda
@pytest.mark.parametrize("widest", [None, 8, 4, 2, 1])
@pytest.mark.parametrize("f", [1, 4, 7, 16, 40, 64, 128])
def test_bf16_walk_matches_plain(cuda, monkeypatch, f, widest):
    monkeypatch.setattr(blocked, "_BF16_VEC", widest)
    graph = _graph(cuda)
    prep = blocked.blocked_layout(graph)
    assert prep.forward.split.shape[0] > 0
    val = graph.val.to(torch.float32).contiguous()
    x = torch.from_numpy(np.random.RandomState(f).randn(N, f).astype(
        np.float32)).to(cuda).to(torch.bfloat16)
    plan = blocked.bf16_plan(f, x.data_ptr(), 0, prep.forward.n_edges,
                             prep.forward.n_rows)
    vec = plan.vec
    for name in ("forward", "transposed"):
        lst = getattr(prep, name)
        before = blocked.blocked_spmm_bf16.launches
        out = blocked.blocked_spmm_bf16(lst, val, x)
        torch.cuda.synchronize()
        assert blocked.blocked_spmm_bf16.launches == before + 1
        scale = blocked.blocked_spmm_plain(lst, val.abs(),
                                           x.to(torch.float32).abs())
        _same(f"bf16 walk {name} F={f} vec={vec}", out,
              blocked.blocked_spmm_bf16_plain(lst, val, x), scale,
              blocked.blocked_spmm_bf16_plain(_list_to(lst, "cpu"),
                                              val.cpu(), x.cpu()))
    walks = _walk_kernels(lambda: blocked.blocked_spmm_bf16(prep.forward,
                                                            val, x))
    narrow = min(32, f // vec) < 8
    assert walks == ({"blocked_spmm_bf16_walk"} if plan.staged
                     else {"blocked_spmm_bf16_share_walk"} if plan.share
                     else {"blocked_spmm_walk_narrow"} if narrow
                     else {"blocked_spmm_walk"}), walks
    least = blocked._BF16_STAGED_EDGES
    assert plan.staged == (widest is None and f in least
                           and prep.forward.n_edges >= least[f])


@pytest.mark.cuda
@pytest.mark.parametrize("f", [6, 40, 128])
def test_masked_and_degree_walks_over_bf16_values(cuda, f):
    graph = _graph(cuda)
    grids = stochastic.build_train_grids(
        graph.row.cpu().numpy(), graph.col.cpu().numpy(),
        graph.val.cpu().numpy(), N)
    rows, cols = grids.lists(cuda)
    val = graph.val.to(torch.bfloat16)
    n_drop = graph.n_edges - 500  # the last edges are never dropped
    draw = (torch.tensor([0x9E3779B9, 77], device=cuda), 0.3, n_drop)
    x = torch.from_numpy(np.random.RandomState(f).randn(N, f).astype(
        np.float32)).to(cuda)
    w = stochastic.drawn_values(val, *draw)
    for name, lst in (("row", rows), ("column", cols)):
        cpu = _list_to(lst, "cpu")
        before = ell_gather_masked.bf16_launches, ell_gather_masked.launches
        out = ell_gather_masked(lst, val, *draw, x)
        torch.cuda.synchronize()
        assert (ell_gather_masked.bf16_launches,
                ell_gather_masked.launches) == (before[0] + 1, before[1])
        scale = blocked.blocked_spmm_plain(lst, w.abs(), x.abs())
        _same(f"masked {name} list bf16 values F={f}", out,
              ell_gather_masked_plain(lst, val, *draw, x), scale,
              ell_gather_masked_plain(cpu, val.cpu(), *draw, x.cpu()))
        before = ell_degree_masked.bf16_launches
        deg = ell_degree_masked(lst, val, *draw)
        torch.cuda.synchronize()
        assert ell_degree_masked.bf16_launches == before + 1
        ones = torch.ones(N, 1, device=cuda)
        _same(f"degree {name} list bf16 values", deg,
              ell_degree_masked_plain(lst, val, *draw),
              blocked.blocked_spmm_plain(lst, w.abs(), ones)[:, 0],
              ell_degree_masked_plain(cpu, val.cpu(), *draw))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [7, 40])
def test_spmm_pallas_bf16_step_card_vs_cpu(cuda, f):
    """A training step through the mode on the normalized graph (its scales
    computed once, on the card): the forward bit-equal to the CPU's (the
    same terms in the same order), ``dx`` (K2's transposed walk) and
    ``dval`` allclose (``dval``'s float32 dot sums by another order)."""
    rng = np.random.RandomState(f)
    x = rng.randn(N, f).astype(np.float32)
    dy = rng.randn(N, f).astype(np.float32)
    norm = tt.normalize_adjacency(_graph(cuda), graph_dropout=0.0,
                                  add_eye="after")
    res = {}
    for dev in (cuda, torch.device("cpu")):
        graph = norm.to(dev)
        val = graph.val.clone().requires_grad_()
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        before = blocked.blocked_spmm_bf16.launches
        out = blocked.spmm_pallas(dataclasses.replace(graph, val=val), xt,
                                  bf16=True)
        out.backward(torch.from_numpy(dy).to(dev))
        assert blocked.blocked_spmm_bf16.launches == before + (
            dev.type == "cuda")
        res[dev.type] = (out.detach().cpu(), xt.grad.cpu(), val.grad.cpu())
    assert torch.equal(res["cuda"][0], res["cpu"][0])
    for a, b in zip(res["cuda"][1:], res["cpu"][1:]):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_masked_product_under_the_knob_card_vs_cpu(cuda, monkeypatch):
    monkeypatch.setenv(KNOB, "bfloat16")
    rng = np.random.RandomState(1)
    x = rng.randn(N, 40).astype(np.float32)
    res = {}
    with stochastic.min_edges_scope(0):
        for dev in (cuda, torch.device("cpu")):
            graph = _graph(dev)
            dropped = dataclasses.replace(
                graph, drop_salt=torch.tensor([5, 6]), drop_keep=0.5,
                drop_n=graph.n_edges)
            before = (ell_gather_masked.bf16_launches,
                      ell_degree_masked.bf16_launches)
            out = stochastic.stochastic_spmm(dropped,
                                             torch.from_numpy(x).to(dev))
            deg = stochastic.stochastic_degree(dropped)
            if dev.type == "cuda":
                assert (ell_gather_masked.bf16_launches,
                        ell_degree_masked.bf16_launches) == (
                            before[0] + 1, before[1] + 1)
            res[dev.type] = out.cpu(), deg.cpu()
            grids = stochastic.train_grids(dropped)
            assert grids.values(dev).dtype == torch.bfloat16
    for a, b in zip(res["cuda"], res["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_appnp_under_the_knob_equals_float32(cuda, monkeypatch):
    graph = _graph(cuda, weighted=False)
    rng = np.random.RandomState(2)
    feats = rng.randn(N, 16).astype(np.float32)
    labels = rng.randint(0, 4, N)
    tasks = dict(train=tt.NodeClassification(np.arange(500), labels[:500]),
                 valid=tt.NodeClassification(np.arange(500, 900),
                                             labels[500:900]))
    hist = {}
    with stochastic.min_edges_scope(0):
        for name in ("float32", "bfloat16"):
            monkeypatch.setenv(KNOB, name)
            model = tt.APPNP(graph, feats, num_classes=4, device=cuda)
            before = ell_gather_masked.bf16_launches
            hist[name] = model.train(**tasks, epochs=3, seed=3)
            assert (ell_gather_masked.bf16_launches > before) == (
                name == "bfloat16")
    for key in ("train_loss", "valid_loss"):
        assert hist["bfloat16"][key] == hist["float32"][key], key


def _power_law(device):
    from gnntf_tpu_torch.data import random_power_law_edges
    src, dst = random_power_law_edges(N, 20000, seed=1)
    vals = np.random.RandomState(5).uniform(-1.0, 2.0, len(src))
    return tt.from_edges(src, dst, vals, n_nodes=N, directed=True,
                         device=device)


def _nonfinite_x(f, lists, seed):
    """(N, F) float32 on the CPU, with inf, -inf and NaN in rows that each
    list gathers."""
    x = torch.from_numpy(np.random.RandomState(seed).randn(N, f).astype(
        np.float32))
    for lst in lists:
        a, b, c = lst.idx[[0, lst.n_edges // 2, -1]].tolist()
        x[a, f - 1], x[b, 0], x[c, f // 2] = (float("inf"), float("-inf"),
                                              float("nan"))
    return x


def _bit_equal(label, out, ref_card, scale, ref_cpu):
    """Bit-equal to the plain version on the CPU, NaN where it has NaN; on
    the card, whose ``index_add_`` adds in no fixed order, non-finite where
    it is and elsewhere within ``RTOL * scale``."""
    out, ref_card, scale = out.cpu(), ref_card.cpu(), scale.cpu()
    torch.testing.assert_close(out, ref_cpu, rtol=0, atol=0, equal_nan=True,
                               msg=lambda m: f"{label}: {m}")
    finite = torch.isfinite(ref_card)
    assert torch.equal(finite, torch.isfinite(out)), label
    diff = (out - ref_card).abs()[finite]
    assert bool((diff <= RTOL * scale[finite]).all()), (label, diff.max())
    print(f"{label}: bit-equal to the plain version on the CPU")


def _scale(lst, val, xb):
    """``sum|terms|`` of each output element."""
    return blocked.blocked_spmm_plain(lst, val.abs(),
                                      xb.to(torch.float32).abs())


# the staged walk at each of its widths on any list
EVERY_LIST = dict.fromkeys((16, 24, 32, 40), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 24, 32, 40, 64, 128])
def test_staged_walk_bit_equal_to_plain(cuda, monkeypatch, f):
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", EVERY_LIST)
    staged = f <= 40  # the widths the staged walk takes
    for graph in (_graph(cuda), _power_law(cuda)):
        prep = blocked.blocked_layout(graph)
        assert prep.forward.split.shape[0] > 0
        assert (prep.forward.ptr.diff() == 0).any()
        val = graph.val.to(torch.float32).contiguous()
        x = _nonfinite_x(f, (prep.forward, prep.transposed), f)
        xb = x.to(torch.bfloat16).to(cuda)
        for name in ("forward", "transposed"):
            lst = getattr(prep, name)
            plan = blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                                     lst.n_rows)
            assert plan.staged == staged
            before = (blocked.blocked_spmm_bf16.launches,
                      blocked.blocked_spmm_bf16.staged_launches)
            out = blocked.blocked_spmm_bf16(lst, val, xb)
            torch.cuda.synchronize()
            assert (blocked.blocked_spmm_bf16.launches,
                    blocked.blocked_spmm_bf16.staged_launches) == (
                        before[0] + 1, before[1] + staged)
            _bit_equal(f"bf16 mode staged={staged} {name} F={f} "
                       f"split={lst.split.shape[0]}", out,
                       blocked.blocked_spmm_bf16_plain(lst, val, xb),
                       _scale(lst, val, xb),
                       blocked.blocked_spmm_bf16_plain(
                           _list_to(lst, "cpu"), val.cpu(), xb.cpu()))
            assert torch.isnan(out).any()
        walks = _walk_kernels(lambda: blocked.blocked_spmm_bf16(
            prep.forward, val, xb))
        share = blocked.bf16_plan(f, xb.data_ptr(), 0,
                                  prep.forward.n_edges,
                                  prep.forward.n_rows).share
        assert walks == ({"blocked_spmm_bf16_walk"} if staged
                         else {"blocked_spmm_bf16_share_walk"} if share
                         else {"blocked_spmm_walk"}), walks


@pytest.mark.cuda
@pytest.mark.parametrize("ring", [(2, 16), (2, 4), (3, 8), (4, 8), (3, 12)])
@pytest.mark.parametrize("f", [16, 40])
def test_staged_walk_at_other_rings(cuda, monkeypatch, f, ring):
    monkeypatch.setattr(blocked, "_BF16_RING", ring)
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", EVERY_LIST)
    graph = _power_law(cuda)
    prep = blocked.blocked_layout(graph)
    val = graph.val.to(torch.float32).contiguous()
    x = _nonfinite_x(f, (prep.forward,), 7)
    xb = x.to(torch.bfloat16).to(cuda)
    plan = blocked.bf16_plan(f, xb.data_ptr(), 0, prep.forward.n_edges,
                             prep.forward.n_rows)
    assert plan.staged and (plan.depth, plan.rows) == ring
    out = blocked.blocked_spmm_bf16(prep.forward, val, xb)
    _bit_equal(f"staged walk ring {ring} F={f}", out,
               blocked.blocked_spmm_bf16_plain(prep.forward, val, xb),
               _scale(prep.forward, val, xb),
               blocked.blocked_spmm_bf16_plain(
                   _list_to(prep.forward, "cpu"), val.cpu(), xb.cpu()))


@pytest.mark.cuda
@pytest.mark.parametrize("f", [16, 40])
def test_unaligned_views_take_a_walk_that_reads_them(cuda, monkeypatch, f):
    """A bfloat16 view 2 bytes past a 16-byte boundary takes the generic
    walk at loads of one bfloat16, on a list the staged walk would take."""
    monkeypatch.setattr(blocked, "_BF16_STAGED_EDGES", EVERY_LIST)
    graph = _graph(cuda)
    prep = blocked.blocked_layout(graph)
    val = graph.val.to(torch.float32).contiguous()
    x = _nonfinite_x(f, (prep.forward,), 8)
    flat = torch.empty(N * f + 1, dtype=torch.bfloat16, device=cuda)
    xd = flat[1:].view(N, f)
    xd.copy_(x.to(torch.bfloat16))
    assert xd.data_ptr() % 16 and xd.is_contiguous()
    plan = blocked.bf16_plan(f, xd.data_ptr(), 0, prep.forward.n_edges,
                             prep.forward.n_rows)
    assert (plan.staged, plan.vec) == (False, 1)
    out = blocked.blocked_spmm_bf16(prep.forward, val, xd)
    xb = x.to(torch.bfloat16).to(cuda)
    _bit_equal(f"unaligned view F={f}", out,
               blocked.blocked_spmm_bf16_plain(prep.forward, val, xb),
               _scale(prep.forward, val, xb),
               blocked.blocked_spmm_bf16_plain(
                   _list_to(prep.forward, "cpu"), val.cpu(), xb.cpu()))
    walks = _walk_kernels(lambda: blocked.blocked_spmm_bf16(
        prep.forward, val, xd))
    assert walks == {"blocked_spmm_walk"}, walks


# the share walk on any list at its widths
SHARE_WIDTHS = (64, 96, 128, 256)
EVERY_SHARE = dict.fromkeys((8, 16, 32), (0, 0))


def _share_lists(device):
    """(name, forward list) of graphs for the share walk: the random graph
    (a hub row of 6,000 edges: several shares) and its transposed list
    (values through ``eid``), a power-law graph, a Cora-scale list, and a
    list shorter than one share with empty rows."""
    out = []
    prep = blocked.blocked_layout(_graph(device))
    out += [("random", prep.forward), ("random_t", prep.transposed)]
    out.append(("power_law", blocked.blocked_layout(_power_law(device))
                .forward))
    rng = np.random.RandomState(11)
    cora = tt.from_edges(rng.randint(0, 2708, 5278), rng.randint(0, 2708,
                                                                 5278),
                         n_nodes=2708, directed=False, device=device)
    out.append(("cora", blocked.blocked_layout(cora).forward))
    tiny = tt.from_edges(np.array([0, 0, 4, 4, 4, 9]),
                         np.array([1, 2, 3, 5, 6, 0]), n_nodes=12,
                         directed=True, device=device)
    out.append(("shorter_than_a_share", blocked.blocked_layout(tiny)
                .forward))
    return out


def _share_inputs(lst, f, seed):
    rng = np.random.RandomState(seed)
    val = torch.from_numpy(rng.uniform(-1.0, 2.0, lst.n_values).astype(
        np.float32)).to(lst.device)
    xb = torch.from_numpy(rng.randn(lst.n_in, f).astype(np.float32)).to(
        lst.device).to(torch.bfloat16)
    return val, xb


@pytest.mark.cuda
@pytest.mark.parametrize("f", SHARE_WIDTHS)
def test_share_walk_equal_to_plain(cuda, monkeypatch, f):
    """Bit-equal (``torch.equal``) to the plain version on the card and on
    the CPU; at most 2 kernels a call, the fold only where a row crosses a
    block's share."""
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", EVERY_SHARE)
    for name, lst in _share_lists(cuda):
        val, xb = _share_inputs(lst, f, f)
        assert blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                                 lst.n_rows).share
        before = (blocked.blocked_spmm_bf16.launches,
                  blocked.blocked_spmm_bf16.share_launches)
        out = blocked.blocked_spmm_bf16(lst, val, xb)
        torch.cuda.synchronize()
        assert (blocked.blocked_spmm_bf16.launches,
                blocked.blocked_spmm_bf16.share_launches) == (
                    before[0] + 1, before[1] + 1)
        card = blocked.blocked_spmm_bf16_plain(lst, val, xb)
        cpu = blocked.blocked_spmm_bf16_plain(_list_to(lst, "cpu"),
                                              val.cpu(), xb.cpu())
        assert torch.equal(out, card), (name, f)
        assert torch.equal(out.cpu(), cpu), (name, f)
        names = _kernels(lambda: blocked.blocked_spmm_bf16(lst, val, xb))
        want = {"blocked_spmm_bf16_share_walk"}
        if blocked.bf16_folds(lst):
            want.add("blocked_spmm_bf16_share_fold")
        assert names == want, (name, names)
        print(f"share walk {name} F={f}: {lst.n_edges} edges, "
              f"{blocked.bf16_folds(lst)} rows crossing a share, equal to "
              f"the plain "
              f"version on the card and on the CPU, kernels {sorted(names)}")


@pytest.mark.cuda
def test_share_walk_with_nonfinite_x(cuda, monkeypatch):
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", EVERY_SHARE)
    prep = blocked.blocked_layout(_power_law(cuda))
    val = torch.from_numpy(np.random.RandomState(3).uniform(
        -1.0, 2.0, prep.forward.n_values).astype(np.float32)).to(cuda)
    for f in (64, 128):
        xb = _nonfinite_x(f, (prep.forward,), f).to(torch.bfloat16).to(cuda)
        out = blocked.blocked_spmm_bf16(prep.forward, val, xb)
        ref = blocked.blocked_spmm_bf16_plain(
            _list_to(prep.forward, "cpu"), val.cpu(), xb.cpu())
        torch.testing.assert_close(out.cpu(), ref, rtol=0, atol=0,
                                   equal_nan=True)
        assert torch.isnan(out).any()


@pytest.mark.cuda
def test_share_walk_in_a_cuda_graph(cuda, monkeypatch):
    """Captured and replayed with x rewritten in place: each replay equal to
    a fresh call on the new x (the scratch is the graph's own)."""
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", EVERY_SHARE)
    lst = blocked.blocked_layout(_graph(cuda)).forward
    assert blocked.bf16_folds(lst) > 0
    val, xb = _share_inputs(lst, 128, 1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        blocked.blocked_spmm_bf16(lst, val, xb)  # warm: the library
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = blocked.blocked_spmm_bf16(lst, val, xb)
    for seed in (2, 3):
        xb.copy_(_share_inputs(lst, 128, seed)[1])
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, blocked.blocked_spmm_bf16(lst, val, xb))
        assert torch.equal(out, blocked.blocked_spmm_bf16_plain(lst, val,
                                                                xb))


@pytest.mark.cuda
def test_share_walk_on_two_streams(cuda, monkeypatch):
    """Two products over one list launched on two streams at once, each
    with its own scratch: each equal to its plain version."""
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", EVERY_SHARE)
    lst = blocked.blocked_layout(_graph(cuda)).forward
    val, xa = _share_inputs(lst, 128, 4)
    _, xc = _share_inputs(lst, 128, 5)
    want = [blocked.blocked_spmm_bf16_plain(lst, val, x) for x in (xa, xc)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(20):
        pair = []
        for s, x in zip(streams, (xa, xc)):
            with torch.cuda.stream(s):
                pair.append(blocked.blocked_spmm_bf16(lst, val, x))
        outs.append(pair)
    torch.cuda.synchronize()
    for pair in outs:
        for out, ref in zip(pair, want):
            assert torch.equal(out, ref)


@pytest.mark.cuda
def test_share_walk_raises_rather_than_fall_back(cuda, monkeypatch):
    """A share the kernel was not built with is refused by the C entry: the
    wrapper raises, and nothing else runs."""
    monkeypatch.setattr(blocked, "_BF16_SHARE_LISTS", EVERY_SHARE)
    lst = blocked.blocked_layout(_graph(cuda)).forward
    val, xb = _share_inputs(lst, 64, 6)
    monkeypatch.setattr(blocked, "BF16_SHARE", blocked.BF16_SHARE * 2)
    before = blocked.blocked_spmm_bf16.launches
    with pytest.raises(RuntimeError, match="gnntf_blocked_spmm_bf16_share"):
        blocked.blocked_spmm_bf16(lst, val, xb)
    assert blocked.blocked_spmm_bf16.launches == before
