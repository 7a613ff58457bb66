"""The ELL gather-reduce wrapper (K1) of the torch port, without JAX, so the
card tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_ell_gather.py

On the CPU the wrapper takes the plain version, which is held here against a
dense product.  On the card the kernel is held against the plain version on
the same CUDA tensors, per element, with |err| <= 1e-5 * sum|terms| (the
scale of float32 summation error): both sum in float32 in another order,
and rows that span runs of virtual rows are combined with atomics in an order
that varies from launch to launch.
"""
import numpy as np
import pytest
import torch

from gnntf_tpu_torch.ops import ell_gather, ell_gather_plain
from gnntf_tpu_torch.ops.spmm import build_ell

KERNEL_RTOL = 1e-5


def _ell_inputs(seed, n=500, e=4000, f=16, heavy=0):
    """An ELL layout with duplicates and empty (odd) rows; ``heavy`` extra
    edges all land on row 0, so that row spans many runs of virtual rows."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e) * 2
    col = rng.randint(0, n, size=e)
    if heavy:
        row = np.concatenate([row, np.zeros(heavy, row.dtype)])
        col = np.concatenate([col, rng.randint(0, n, size=heavy)])
    layout = build_ell(row, col, n, 8)
    vals = rng.randn(layout.n_vrows, layout.k).astype(np.float32)
    vals[layout.idx == n] = 0.0
    x = rng.randn(n, f).astype(np.float32)
    return layout, vals, x


def _tensors(layout, vals, x, device="cpu"):
    return [torch.from_numpy(a).to(device)
            for a in (layout.idx, vals, x, layout.vrow_row)]


def _dense_reference(layout, vals, x):
    n = layout.n_nodes
    a = np.zeros((n, n + 1), np.float64)
    rows = np.repeat(layout.vrow_row, layout.k)
    np.add.at(a, (rows, layout.idx.reshape(-1)), vals.reshape(-1))
    return a[:, :n] @ x.astype(np.float64)


@pytest.mark.parametrize("f", [1, 6, 16, 40])
def test_plain_matches_dense(f):
    layout, vals, x = _ell_inputs(0, f=f, heavy=300)
    out = ell_gather_plain(*_tensors(layout, vals, x), layout.n_nodes)
    np.testing.assert_allclose(out.numpy(), _dense_reference(layout, vals, x),
                               rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_bad_inputs():
    layout, vals, x = _ell_inputs(1)
    args = _tensors(layout, vals, x)
    bad = list(args)
    bad[0] = bad[0].long()
    with pytest.raises(TypeError):
        ell_gather(*bad, layout.n_nodes)
    bad = list(args)
    bad[2] = bad[2].double()
    with pytest.raises(TypeError):
        ell_gather(*bad, layout.n_nodes)
    bad = list(args)
    bad[2] = torch.from_numpy(np.asfortranarray(x))
    with pytest.raises(ValueError):
        ell_gather(*bad, layout.n_nodes)
    with pytest.raises(TypeError):
        ell_gather(*args, layout.n_nodes + 1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(args, n_nodes):
    before = ell_gather.launches
    out = ell_gather(*args, n_nodes)
    torch.cuda.synchronize()
    assert ell_gather.launches == before + 1
    idx, vals, x, vrow_row = args
    ref = ell_gather_plain(*args, n_nodes)
    scale = ell_gather_plain(idx, vals.abs(), x.abs(), vrow_row, n_nodes)
    diff = (out - ref).abs()
    assert bool((diff <= KERNEL_RTOL * scale).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
def test_kernel_matches_plain_on_card(cuda, f):
    layout, vals, x = _ell_inputs(2, n=3000, e=60_000, f=f, heavy=20_000)
    _check_kernel(_tensors(layout, vals, x, cuda), layout.n_nodes)


@pytest.mark.cuda
def test_kernel_takes_unaligned_rows_on_card(cuda):
    # x starts one float into its buffer: F = 16 would take float4 loads,
    # but the rows are not 16-byte aligned, so the wrapper takes scalar ones
    layout, vals, x = _ell_inputs(3, n=2000, e=30_000, f=16)
    idx, v, _, vr = _tensors(layout, vals, x, cuda)
    buf = torch.empty(x.size + 1, dtype=torch.float32, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(torch.from_numpy(x))
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    _check_kernel([idx, v, xs, vr], layout.n_nodes)


@pytest.mark.cuda
def test_kernel_raises_on_mixed_devices(cuda):
    layout, vals, x = _ell_inputs(4)
    args = _tensors(layout, vals, x, cuda)
    args[2] = args[2].cpu()
    with pytest.raises(ValueError):
        ell_gather(*args, layout.n_nodes)


@pytest.mark.cuda
def test_appnp_forward_on_card_matches_cpu(cuda):
    """The serving forward through PreparedSpMM: 10 K1 launches on the card,
    logits close to the CPU run of the plain versions (float32, sums in
    another order over ten propagation steps)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    n = 5000
    src, dst = random_power_law_edges(n, 40_000, seed=0)
    features = np.random.RandomState(1).randn(n, 32).astype(np.float32)
    out = {}
    for device in ("cpu", cuda):
        graph = tt.from_edges(src, dst, n_nodes=n, directed=False,
                              device=device)
        model = tt.APPNP(graph, features, num_classes=6, device=device)
        model.reset(seed=0)
        before = ell_gather.launches
        out[str(device)] = model._activations().cpu()
        launched = ell_gather.launches - before
        assert launched == (10 if model.device.type == "cuda" else 0)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_prepared_gradient_on_card_matches_cpu(cuda):
    """Training without edge dropout under the default impl runs K1 in the
    step too, with its plain transposed backward: 20 launches an epoch, and
    the losses close to the CPU run (float32, sums in another order)."""
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
            model.add(tt.PPRIteration(h0, 0.1, graph_dropout=0.0))
        before = ell_gather.launches
        hist[str(device)] = model.train(
            tt.NodeClassification(np.arange(1000), labels[:1000]),
            tt.NodeClassification(np.arange(1000, 2000), labels[1000:2000]),
            epochs=2, patience=100, seed=0)
        launched = ell_gather.launches - before
        assert launched == (40 if model.device.type == "cuda" else 0)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)
