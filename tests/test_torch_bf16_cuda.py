"""K2's bfloat16 mode and K1's dropout walks over bfloat16 values on the
card, against their plain versions, without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_bf16_cuda.py

* ``blocked_spmm_bf16`` over a random graph's lists (duplicate pairs, empty
  rows, a hub row split over many units) at F = 1, 4, 7, 16, 40, 64, 128
  with the program's load width and with each forced (``_BF16_VEC`` 8, 4,
  2, 1; the narrow walk where a row has fewer than 8 loads): within ``1e-5 * sum|terms|`` of the plain
  version on the card, and bit-equal to it on the CPU (the same terms,
  summed in the same order); the share is logged;
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
    """The walk kernels that ``fn`` ran (one profile, opened with spin
    kernels, taken again when it kept none of them)."""
    from torch.profiler import ProfilerActivity, profile
    primer = 256
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        keys = [e.key for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("spin_kernel" in k for k in keys):
            names = {k.split("(anonymous namespace)::")[-1].split("<")[0]
                     .split("(")[0] for k in keys}
            return {n for n in names if "_walk" in n}
        primer *= 4
    raise RuntimeError("the profiler kept no primer kernel in 3 sessions")


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
    vec = blocked.bf16_vec(f, x.data_ptr(), 0)
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
    assert walks == ({"blocked_spmm_walk_narrow"} if narrow
                     else {"blocked_spmm_walk"}), walks


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
