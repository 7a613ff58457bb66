"""Small graphs train reproducibly on the card (fault F7), without JAX:

    python -m pytest --noconftest -q -m cuda \
        tests/test_torch_small_graph_cuda.py

Below 65,536 counted edges (a random graph at Cora scale: 2,708 nodes,
10,556 counted edges) a fixed or eagerly dropped graph's products, and its
degrees, walk K2's lists in store mode (``ops/spmm.py::spmm_segment`` on a
card is ``spmm_pallas``), and GAT takes the attention kernels' lists,
so that nothing scatters with ``index_add_``'s atomics:

* a profiled training step of APPNP and of GAT (forward and backward, with
  every dropout on) launches no ``index_add_`` kernel, and K2's walk runs;
* two identical ``train(epochs=5, seed=1)`` runs are equal bit for bit;
* the product and its gradient agree with the CPU's plain product within
  ``rtol=1e-5, atol=1e-6``.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.ops.spmm import spmm_segment

N, EDGES, CLASSES = 2708, 5278, 7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _data(device, seed=0):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, N, EDGES), rng.randint(0, N, EDGES)
    g = tt.from_edges(src, dst, n_nodes=N, directed=False, device=device)
    return g, rng.rand(N, 64).astype(np.float32), rng.randint(0, CLASSES, N)


def _tasks(labels):
    return (tt.NodeClassification(np.arange(140), labels[:140]),
            tt.NodeClassification(np.arange(200, 700), labels[200:700]))


def _step_kernels(model, labels):
    """The device kernels of one training step (forward, loss, backward)."""
    from torch.profiler import ProfilerActivity, profile
    model.reset(seed=0)
    task = _tasks(labels)[0]
    generator = torch.Generator().manual_seed(3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = model.forward(model.features, training=True,
                            generator=generator)
        task.loss(out, task.batch()).backward()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


@pytest.mark.cuda
@pytest.mark.parametrize("name,walk", [("APPNP", "blocked_spmm_walk"),
                                       ("GAT", "attn_softmax_aggregate_walk")])
def test_small_graph_step_launches_no_index_add(cuda, name, walk):
    g, feats, labels = _data(cuda)
    model = getattr(tt, name)(g, feats, num_classes=CLASSES, device=cuda)
    kernels = _step_kernels(model, labels)
    assert not [k for k in kernels if "indexFunc" in k or "index_add" in k]
    assert any(walk in k for k in kernels), kernels


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["APPNP", "GAT"])
def test_two_identical_runs_are_bit_equal_on_the_card(cuda, name):
    g, feats, labels = _data(cuda)
    runs = []
    for _ in range(2):
        model = getattr(tt, name)(g, feats, num_classes=CLASSES, device=cuda)
        hist = model.train(*_tasks(labels), epochs=5, seed=1)
        runs.append((hist, {k: p.detach().cpu()
                            for k, p in model.params.items()}))
    assert runs[0][0] == runs[1][0]
    for k, p in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k]), k


@pytest.mark.cuda
def test_small_graph_walk_matches_the_cpu(cuda):
    g, _, _ = _data(cuda)
    adj = tt.normalize_adjacency(g)
    rng = np.random.RandomState(1)
    x0, dy = (rng.randn(N, 16).astype(np.float32) for _ in "ab")
    out = {}
    for device, graph in ((cuda, adj), ("cpu", adj.to("cpu"))):
        x = torch.tensor(x0, device=device, requires_grad=True)
        y = spmm_segment(graph, x)
        y.backward(torch.tensor(dy, device=device))
        out[str(device)] = (y.detach().cpu(), x.grad.cpu())
    for got, want in zip(out[str(cuda)], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
