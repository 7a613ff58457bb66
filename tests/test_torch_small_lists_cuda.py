"""K2's store-mode walk over small lists on the card, without JAX:

    python -m pytest --noconftest -q -m cuda \
        tests/test_torch_small_lists_cuda.py

At Cora's scale (2,708 nodes, 5,278 undirected edges: uniform random
edges, and power-law edges whose hub rows split) the program's lists
(``ops/blocked.py::blocked_layout``, units of ``unit_items``):

* K2 over both lists equals the plain version on the CPU bit for bit at
  F = 1, 4, 7, 16 and 64: the narrow walk (``blocked_spmm_walk_narrow``)
  wherever a group would have fewer than 8 lanes (F / vec < 8, with float4
  loads where F % 4 == 0), the wide walk (``blocked_spmm_walk``) at F=64;
* two APPNP runs (5 epochs, every dropout on) are equal bit for bit;
* a fused run (``block_epochs=5``) equals its host loop: its losses within
  ``rtol=1e-5`` (the rule of ``test_torch_fused_cuda.py``: the same kernels
  in the same order, but the capture may pick other library algorithms for
  the dense products), its best epoch and its predictions equal.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import blocked

N, EDGES, CLASSES = 2708, 5278, 7
GRAPHS = ("uniform", "power_law")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(kind, device):
    if kind == "uniform":
        rng = np.random.RandomState(0)
        src, dst = rng.randint(0, N, EDGES), rng.randint(0, N, EDGES)
    else:
        src, dst = random_power_law_edges(N, EDGES, seed=0)
    return tt.from_edges(src, dst, n_nodes=N, directed=False, device=device)


def _walk_kernels(fn):
    """The K2 walk kernels (without template arguments) that ``fn`` ran.
    The profiler on the card can drop a session's first device events, so
    a session opens with spin kernels, and is taken again with four times
    as many when it kept none of them (as ``chip_smoke.py`` does)."""
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
            return {k.split("(anonymous namespace)::")[-1].split("<")[0]
                    .split("(")[0] for k in keys if "blocked_spmm_walk" in k}
        primer *= 4
    raise RuntimeError("the profiler kept no primer kernel in 3 sessions")


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 4, 7, 16, 64])
@pytest.mark.parametrize("kind", GRAPHS)
def test_walks_bit_equal_to_cpu_plain(cuda, kind, f):
    adj = tt.normalize_adjacency(_graph(kind, cuda)).materialized()
    prep = blocked.blocked_layout(adj)
    cpu = blocked.blocked_layout(adj.to("cpu"))
    val = adj.val.to(torch.float32).contiguous()
    x = torch.from_numpy(np.random.RandomState(f).randn(N, f).astype(
        np.float32))
    xc = x.to(cuda)
    narrow = f // (4 if f % 4 == 0 else 1) < 8
    assert kind == "uniform" or prep.forward.split.shape[0] > 0
    for lst, ref in ((prep.forward, cpu.forward),
                     (prep.transposed, cpu.transposed)):
        assert lst.n_units == ref.n_units
        before = blocked.blocked_spmm.launches
        out = blocked.blocked_spmm(lst, val, xc)
        torch.cuda.synchronize()
        assert blocked.blocked_spmm.launches == before + 1
        assert torch.equal(out.cpu(),
                           blocked.blocked_spmm_plain(ref, val.cpu(), x))
        walks = _walk_kernels(lambda: blocked.blocked_spmm(lst, val, xc))
        assert walks == ({"blocked_spmm_walk_narrow"} if narrow
                         else {"blocked_spmm_walk"}), walks


def _tasks(seed=0):
    labels = np.random.RandomState(seed).randint(0, CLASSES, N)
    return (tt.NodeClassification(np.arange(140), labels[:140]),
            tt.NodeClassification(np.arange(200, 700), labels[200:700]))


def _trained(graph, **kw):
    """History, parameters and predictions of every node after training."""
    features = np.random.RandomState(1).rand(N, 64).astype(np.float32)
    model = tt.APPNP(graph, features, num_classes=CLASSES,
                     device=graph.device)
    hist = model.train(*_tasks(), epochs=5, seed=1, **kw)
    pred = model.predict(tt.NodeClassification(np.arange(N))).cpu()
    return hist, {k: p.detach().cpu() for k, p in model.params.items()}, \
        pred


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPHS)
def test_two_appnp_runs_bit_equal(cuda, kind):
    graph = _graph(kind, cuda)
    before = blocked.blocked_spmm.launches
    (h1, p1, y1), (h2, p2, y2) = _trained(graph), _trained(graph)
    assert blocked.blocked_spmm.launches > before
    assert h1 == h2 and torch.equal(y1, y2)
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", GRAPHS)
def test_fused_run_equals_host_loop(cuda, kind):
    graph = _graph(kind, cuda)
    host = _trained(graph, block_epochs=1)
    fused = _trained(graph, block_epochs=5)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(fused[0][key], host[0][key], rtol=1e-5)
    assert fused[0]["best_epoch"] == host[0]["best_epoch"]
    assert torch.equal(fused[2], host[2])
