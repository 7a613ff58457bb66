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
