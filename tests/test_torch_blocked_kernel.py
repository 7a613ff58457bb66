"""K2, the blocked-COO SpMM wrapper of the torch port, without JAX, so the
card tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_blocked_kernel.py

On the CPU the wrapper takes the plain version, which is held here against a
dense product.  On the card the kernel is held against the plain version on
the same CUDA tensors, per element, with |err| <= 1e-5 * sum|terms| (the
scale of float32 summation error): both sum in float32 in another order, and
the kernel adds a window's rows with atomics, in shared memory and across
the blocks that share the window, in an order that varies from launch to
launch.
"""
import numpy as np
import pytest
import torch

from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked_spmm,
                                 blocked_spmm_plain, scatter_values)

KERNEL_RTOL = 1e-5


def _inputs(seed, n=600, e=5000, f=16, heavy=0, window=64, tile=64,
            block_edges=128, device="cpu"):
    """A random layout with duplicates and empty windows (no edge lands on
    rows [n/2, 3n/4)); ``heavy`` extra edges all land in window 0, so it
    spans many runs of live edges."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e)
    row[row >= n // 4] += n // 2
    col = rng.randint(0, n, size=e)
    if heavy:
        row = np.concatenate([row, rng.randint(0, window, size=heavy)])
        col = np.concatenate([col, rng.randint(0, n, size=heavy)])
    lay = block_coo(row, col, n, window=window, tile=tile,
                    block_edges=block_edges)
    prep = BlockedSpMM(lay, device)
    vals = torch.from_numpy(rng.randn(len(row)).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, f).astype(np.float32))
    return (row, col, vals.numpy(), x.numpy()), prep, \
        scatter_values(prep, vals.to(device)), x.to(device)


def _dense(row, col, vals, x, n):
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (row, col), vals)
    return a @ x.astype(np.float64)


@pytest.mark.parametrize("f", [1, 6, 40])
def test_plain_matches_dense(f):
    (row, col, vals, x), prep, sv, xt = _inputs(0, f=f, heavy=3000)
    out = blocked_spmm_plain(prep, sv, xt)
    np.testing.assert_allclose(out.numpy(), _dense(row, col, vals, x, 600),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(blocked_spmm(prep, sv, xt), out)


def test_wrapper_rejects_bad_inputs():
    _, prep, sv, x = _inputs(1)
    with pytest.raises(TypeError):
        blocked_spmm(prep, sv, x.double())
    with pytest.raises(TypeError):
        blocked_spmm(prep, sv[:-1], x)
    with pytest.raises(TypeError):
        blocked_spmm(prep, sv, x[:-1])
    with pytest.raises(ValueError):
        blocked_spmm(prep, sv, torch.from_numpy(np.asfortranarray(x.numpy())))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(prep, sv, x):
    before = blocked_spmm.launches
    out = blocked_spmm(prep, sv, x)
    torch.cuda.synchronize()
    assert blocked_spmm.launches == before + (1 if prep.n_runs else 0)
    ref = blocked_spmm_plain(prep, sv, x)
    scale = blocked_spmm_plain(prep, sv.abs(), x.abs())
    diff = (out - ref).abs()
    assert bool((diff <= KERNEL_RTOL * scale).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
def test_kernel_matches_plain_on_card(cuda, f):
    # window 0 holds 30,000 edges, far more than one run of 2,048
    _, prep, sv, x = _inputs(2, n=5000, e=60_000, f=f, heavy=30_000,
                             window=256, tile=256, block_edges=1024,
                             device=cuda)
    _check_kernel(prep, sv, x)


@pytest.mark.cuda
def test_kernel_small_blocks_on_card(cuda):
    # windows shorter than a bitmask word and many one-edge chunks
    _, prep, sv, x = _inputs(3, n=700, e=3000, f=12, window=8, tile=16,
                             block_edges=32, device=cuda)
    _check_kernel(prep, sv, x)


@pytest.mark.cuda
def test_kernel_takes_unaligned_rows_on_card(cuda):
    # x starts one float into its buffer: F = 16 would take float4 loads,
    # but the rows are not 16-byte aligned, so the wrapper takes scalar ones
    _, prep, sv, x = _inputs(4, n=2000, e=30_000, f=16, device=cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    _check_kernel(prep, sv, xs)


@pytest.mark.cuda
def test_kernel_empty_graph_on_card(cuda):
    empty = np.zeros(0, np.int64)
    prep = BlockedSpMM(block_coo(empty, empty, 50, window=32, tile=32,
                                 block_edges=128), cuda)
    sv = scatter_values(prep, torch.zeros(0, device=cuda))
    out = blocked_spmm(prep, sv, torch.ones(50, 8, device=cuda))
    assert out.shape == (50, 8) and not out.any()


@pytest.mark.cuda
def test_kernel_raises_on_mixed_devices(cuda):
    _, prep, sv, x = _inputs(5, device=cuda)
    with pytest.raises(ValueError):
        blocked_spmm(prep, sv, x.cpu())


@pytest.mark.cuda
def test_pallas_training_on_card_matches_cpu(cuda):
    """Two epochs of APPNP under ``spmm_impl="pallas"`` with edge dropout
    (CPU-drawn salts, so the masks agree): 20 K2 launches an epoch on the
    card, losses close to the CPU run of the plain versions."""
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
            model.add(tt.PPRIteration(h0, 0.1, graph_dropout=0.5))
        before = blocked_spmm.launches
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0, spmm_impl="pallas")
        launched = blocked_spmm.launches - before
        assert launched == (40 if model.device.type == "cuda" else 0)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)
