"""The attention kernels A1-A4 (``csrc/attention.cu``) on the card, without
JAX, so it runs where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_attention_cuda.py

* A1-A4 against their plain versions on the card, per output element
  within ``1e-5 * sum|terms|`` (``ops/attention.py::attn_error_scales``),
  on a random graph with duplicate edges, an isolated destination and a hub
  row and column split over many units, in both list flavours, with and
  without dropout, at GAT's layer shapes (8 heads of 8, one head of 40);
* two launches with the same arguments bit-equal, and a captured launch
  replayed after its salt buffer is rewritten equal to a fresh launch with
  the new salts;
* the backward kernels A3 (with the row's own ``rowdot`` and with a given
  one) and A4 against their plain versions on the card at GAT's layer
  shapes and at heads wider than a warp's lanes (41 and 160 features),
  per-edge with a salt and coalesced, with split rows; each A3 and A4 call
  launches at most three kernels (its walk, parts and fix-up, by a
  profile's kernel names);
* a GAT training run on the card against the CPU without dropout.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.ops import attention as pa
from gnntf_tpu_torch.ops import stochastic

KERNEL_RTOL = 1e-5
NAMES = [o for outs in pa.ATTN_OUTPUTS.values() for o in outs]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(n=3000, e=40_000, seed=0):
    """Row/col arrays: random edges with duplicates, a hub row (node 0) and
    a hub column (node 1) of 6,000 edges each, node n - 1 isolated."""
    rng = np.random.RandomState(seed)
    src = np.concatenate([rng.randint(0, n - 1, e), np.zeros(6000, np.int64),
                          rng.randint(0, n - 1, 6000)])
    dst = np.concatenate([rng.randint(0, n - 1, e), rng.randint(0, n - 1,
                                                                6000),
                          np.ones(6000, np.int64)])
    src = np.concatenate([src, src[:5000]])  # duplicates
    dst = np.concatenate([dst, dst[:5000]])
    return src, dst, n


def _inputs(n, heads, feats, device, seed=1):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(
        device)
    return t(n, heads, feats), t(n, heads), t(n, heads), t(n, heads * feats)


def _chain(lists, h, ss, sd, g, salt, keep, plain):
    """A1-A4 in the autograd Function's order, through the wrappers or the
    plain versions."""
    return pa.attn_chain(lists, h, ss, sd, g, 0.2, salt, keep, plain=plain)


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("heads,feats", [(8, 8), (1, 40)])
def test_kernels_match_plain_on_card(cuda, dedup, heads, feats):
    src, dst, n = _graph()
    row, col = np.concatenate([src, dst]), np.concatenate([dst, src])
    lists = pa.attn_lists(row, col, n, cuda, dedup=dedup)
    assert lists.rows.split.shape[0] > 0 and lists.cols.split.shape[0] > 0
    h, ss, sd, g = _inputs(n, heads, feats, cuda)
    salt, keep = ((None, 1.0) if dedup else
                  (torch.tensor([0x9E3779B9, 77], device=cuda), 0.4))
    got = _chain(lists, h, ss, sd, g, salt, keep, plain=False)
    torch.cuda.synchronize()
    ref = _chain(lists, h, ss, sd, g, salt, keep, plain=True)
    scales = pa.attn_error_scales(
        lists, pa.pack_table(h.reshape(n, -1), ss), sd, ref["rmax0"],
        ref["dinv"], g, ref["rowdot"], heads, feats, 0.2, salt, keep)
    for name in NAMES:
        assert torch.isfinite(got[name]).all(), name
        diff = (got[name] - ref[name]).abs()
        assert bool((diff <= KERNEL_RTOL * scales[name]).all()), (
            name, diff.max().item())
    # the isolated node: no slot in either list
    assert torch.equal(got["out"][n - 1], torch.zeros_like(got["out"][0]))
    assert torch.equal(got["dh"][n - 1], torch.zeros_like(got["dh"][0]))
    again = _chain(lists, h, ss, sd, g, salt, keep, plain=False)
    for name in NAMES:
        assert torch.equal(again[name], got[name]), name


def _kernel_launches(fn):
    """Launches by kernel (names without namespace and template arguments)
    of ``fn``.  The profiler on the card can drop a session's first device
    events, so a session opens with spin kernels, and is taken again with
    four times as many when it kept none of them (as ``chip_smoke.py``
    does)."""
    from torch.profiler import ProfilerActivity, profile
    primer = 256
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(primer):
                torch.cuda._sleep(1)
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if any("spin_kernel" in e.key for e in events):
            return {e.key.split("(anonymous namespace)::")[-1].split("<")[0]
                    .split("(")[0]: e.count for e in events
                    if "spin_kernel" not in e.key}
        primer *= 4
    raise RuntimeError("the profiler kept no primer kernel in 3 sessions")


def _backward_inputs(cuda, dedup, heads, feats):
    """Lists with split rows, inputs, A1's outputs and the draw."""
    src, dst, n = _graph(seed=5)
    lists = pa.attn_lists(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), n, cuda, dedup=dedup)
    assert lists.rows.split.shape[0] > 0 and lists.cols.split.shape[0] > 0
    h, ss, sd, g = _inputs(n, heads, feats, cuda, seed=6)
    tab = pa.pack_table(h.reshape(n, -1), ss)
    rmax0, dinv = pa.attn_stats(lists.rows, lists.mult, tab, sd, heads,
                                feats, 0.2)
    salt, keep = ((None, 1.0) if dedup else
                  (torch.tensor([0x2545F491, 9], device=cuda), 0.4))
    return lists, tab, sd, rmax0, dinv, g, salt, keep


def _within(name, got, ref, scale):
    assert torch.isfinite(got).all(), name
    diff = (got - ref).abs()
    assert bool((diff <= KERNEL_RTOL * scale).all()), (
        name, diff.max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("heads,feats", [(8, 8), (1, 40), (1, 41),
                                         (2, 160)])
def test_backward_kernels_match_plain_on_card(cuda, dedup, heads, feats):
    """A3 with its own ``rowdot`` and with a given one, and A4, against
    their plain versions on the kernels' inputs (``sum|terms|`` of the
    given mode: ``P + |rowdot| Q`` of the magnitudes); two launches give
    the same bits."""
    lists, tab, sd, rmax0, dinv, g, salt, keep = _backward_inputs(
        cuda, dedup, heads, feats)
    n = lists.rows.n_rows
    args = (tab, sd, rmax0, dinv, g, heads, feats, 0.2, salt, keep)
    rows = (lists.rows, lists.mult) + args
    own, ds_dst = pa.attn_bwd_rows(*rows)
    torch.cuda.synchronize()
    ref_own, ref_ds = pa.attn_bwd_rows_plain(*rows)
    tabc = pa.column_table(g, sd, rmax0, dinv, own)
    cols = (lists.cols, lists.mult, tab, tabc, heads, feats, 0.2, salt, keep)
    dh, ds_src = pa.attn_bwd_cols(*cols)
    torch.cuda.synchronize()
    ref_dh, ref_src = pa.attn_bwd_cols_plain(*cols)
    scales = pa.attn_error_scales(lists, tab, sd, rmax0, dinv, g, own,
                                  heads, feats, 0.2, salt, keep)
    for name, got, ref in (("rowdot", own, ref_own), ("ds_dst", ds_dst,
                                                       ref_ds),
                           ("dh", dh, ref_dh), ("ds_src", ds_src, ref_src)):
        _within(name, got, ref, scales[name])
    given = (ref_own * 1.5 + 0.25).contiguous()
    got = pa.attn_bwd_rows(*rows, rowdot=given)[1]
    ref = pa.attn_bwd_rows_plain(*rows, rowdot=given)[1]
    w = heads * feats
    abs_tab = pa.pack_table(tab[:, :w].abs(), tab[:, w:w + heads])
    sums = pa._row_pass_sums(lists.rows, lists.mult, abs_tab, sd, rmax0,
                             dinv, g.abs(), heads, feats, 0.2, salt, keep)
    _within("ds_dst given", got, ref, sums[:, heads:2 * heads]
            + given.abs() * sums[:, 2 * heads:])
    assert torch.equal(pa.attn_bwd_rows(*rows)[1], ds_dst)
    assert torch.equal(pa.attn_bwd_rows(*rows, rowdot=given)[1], got)
    again = pa.attn_bwd_cols(*cols)
    assert torch.equal(again[0], dh) and torch.equal(again[1], ds_src)
    assert torch.equal(dh[n - 1], torch.zeros_like(dh[n - 1]))
    assert float(ds_src[n - 1].abs().sum()) == 0.0


@pytest.mark.cuda
def test_backward_calls_launch_at_most_three_kernels(cuda):
    """One A3 call and one A4 call over lists with split rows: each its
    walk, its parts and its fix-up, once."""
    heads, feats = 8, 8
    lists, tab, sd, rmax0, dinv, g, salt, keep = _backward_inputs(
        cuda, False, heads, feats)
    args = (tab, sd, rmax0, dinv, g, heads, feats, 0.2, salt, keep)
    own = pa.attn_bwd_rows(lists.rows, lists.mult, *args)[0]
    tabc = pa.column_table(g, sd, rmax0, dinv, own)
    rows = _kernel_launches(
        lambda: pa.attn_bwd_rows(lists.rows, lists.mult, *args))
    cols = _kernel_launches(
        lambda: pa.attn_bwd_cols(lists.cols, lists.mult, tab, tabc, heads,
                                 feats, 0.2, salt, keep))
    assert rows == {"attn_bwd_rows_walk": 1, "attn_bwd_rows_parts": 1,
                    "attn_bwd_rows_fixup": 1}, rows
    assert cols == {"attn_bwd_cols_walk": 1, "attn_bwd_cols_parts": 1,
                    "attn_bwd_cols_fixup": 1}, cols


@pytest.mark.cuda
def test_replay_reads_the_salt_buffer(cuda):
    """A2 and A4 captured in a CUDA graph read the salts from device
    memory at each replay: after the buffer is rewritten, the replay equals
    a fresh launch with the new salts, bit for bit."""
    src, dst, n = _graph(seed=3)
    lists = pa.attn_lists(np.concatenate([src, dst]),
                          np.concatenate([dst, src]), n, cuda)
    h, ss, sd, g = _inputs(n, 8, 8, cuda, seed=4)
    buf = torch.tensor([5, 6], device=cuda)
    _chain(lists, h, ss, sd, g, buf, 0.4, plain=False)  # build, warm up
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = _chain(lists, h, ss, sd, g, buf, 0.4, plain=False)
    for salts in ([7, 8], [0xFFFFFFFF, 0]):
        buf.copy_(torch.tensor(salts))
        graph.replay()
        torch.cuda.synchronize()
        fresh = _chain(lists, h, ss, sd, g, torch.tensor(salts, device=cuda),
                       0.4, plain=False)
        for name in NAMES:
            assert torch.equal(outs[name], fresh[name]), (salts, name)


@pytest.mark.cuda
def test_gat_training_on_card_matches_cpu(cuda):
    """GAT without feature or attention dropout on a graph above the grid
    gate: 2 epochs on the card (A1 and A2 in each layer of a forward, A3
    and A4 in each layer of a step's backward) and on the CPU from the same
    weights; losses within rtol=1e-4 (float32, sums in another order)."""
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    rng = np.random.RandomState(1)
    features = rng.randn(n, 16).astype(np.float32)
    labels = rng.randint(0, 6, n)
    names = ("attn_stats", "attn_aggregate", "attn_bwd_rows",
             "attn_bwd_cols")
    init, hist = None, {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.GAT(graph, features, num_classes=6, latent_dims=(8,),
                       heads=4, dropout=0.0, attn_dropout=0.0, device=device)
        if init is None:
            init = {s.name: rng.uniform(-0.3, 0.3, s.shape).astype(
                np.float32) for s in model.param_specs}
        before = [getattr(pa, name).launches for name in names]
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0, init_params=dict(init))
        launched = [getattr(pa, name).launches - b
                    for name, b in zip(names, before)]
        # an epoch: two layers in the step's forward and backward and in
        # the validation forward
        assert launched == ([8, 8, 4, 4] if model.device.type == "cuda"
                            else [0, 0, 0, 0])
    assert stochastic.min_edges() <= 2 * 40_000
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)
