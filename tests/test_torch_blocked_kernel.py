"""K2, the blocked-COO SpMM wrapper of the torch port, without JAX, so the
card tests run where JAX is not installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_blocked_kernel.py

On the CPU the wrapper takes the plain version, which is held here against a
dense product, over the forward list (``A @ x``) and the transposed one
(``A^T @ x``).  On the card the kernel is held against the plain version on
the same CUDA tensors, per element, with |err| <= 1e-5 * sum|terms| (the
scale of float32 summation error): both sum in float32 in another order, and
the kernel sums a split row's pieces apart before adding them.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu_torch.ops.blocked as blocked_ops
from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked_spmm,
                                 blocked_spmm_plain)

KERNEL_RTOL = 1e-5


def _inputs(seed, n=600, e=5000, f=16, heavy=0, hub=0, window=64, tile=64,
            block_edges=128, device="cpu"):
    """A random layout with duplicates and empty rows (no edge lands on rows
    [n/2, 3n/4)); ``heavy`` extra edges all land in window 0; ``hub`` extra
    edges land on row 17 and as many on column 33, so both directions hold
    a row split over many units of work."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e)
    row[row >= n // 4] += n // 2
    col = rng.randint(0, n, size=e)
    if heavy:
        row = np.concatenate([row, rng.randint(0, window, size=heavy)])
        col = np.concatenate([col, rng.randint(0, n, size=heavy)])
    if hub:
        row = np.concatenate([row, np.full(hub, 17), rng.randint(0, n, hub)])
        col = np.concatenate([col, rng.randint(0, n, hub), np.full(hub, 33)])
    lay = block_coo(row, col, n, window=window, tile=tile,
                    block_edges=block_edges)
    prep = BlockedSpMM(lay, device)
    vals = rng.randn(len(row)).astype(np.float32)
    x = rng.randn(n, f).astype(np.float32)
    return (row, col, vals, x), prep, torch.from_numpy(vals).to(device), \
        torch.from_numpy(x).to(device)


def _dense(row, col, vals, x, n):
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (row, col), vals)
    return a @ x.astype(np.float64)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("f", [1, 6, 40])
def test_plain_matches_dense(f, transposed):
    # row 17 and column 33 hold 1,500 edges each: split over 12 pieces
    (row, col, vals, x), prep, val, xt = _inputs(0, f=f, heavy=3000,
                                                  hub=1500)
    lst = prep.transposed if transposed else prep.forward
    assert lst.split.shape[0]
    if transposed:
        row, col = col, row
    out = blocked_spmm_plain(lst, val, xt)
    np.testing.assert_allclose(out.numpy(), _dense(row, col, vals, x, 600),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(blocked_spmm(lst, val, xt), out)


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("parts", [1, 5, 64])
def test_plain_sums_split_rows_in_fixed_parts(monkeypatch, parts,
                                              transposed):
    """The order that the plain version fixes and the kernel repeats: a
    row, or a piece of a split row, in edge order; a split row's pieces in
    ``_FIXUP_PARTS`` parts (part g sums pieces g, g + P, ... in turn), then
    the parts in order.  Emulated here one float32 sum at a time; on the
    CPU the plain version equals it bit for bit."""
    monkeypatch.setattr(blocked_ops, "_FIXUP_PARTS", parts)
    _, prep, val, x = _inputs(0, f=6, hub=1500)
    lst = prep.transposed if transposed else prep.forward
    assert lst.split.shape[0]
    ptr, idx, xs = lst.ptr.numpy(), lst.idx.numpy(), x.numpy()
    w = val.numpy() if lst.eid is None else val.numpy()[lst.eid.numpy()]
    unit_edge = lst.unit_edge.numpy()

    def run(e0, e1):
        acc = np.zeros(6, np.float32)
        for e in range(e0, e1):
            acc = acc + xs[idx[e]] * w[e]
        return acc

    want = np.stack([run(ptr[r], ptr[r + 1]) for r in range(lst.n_rows)])
    for r, first, count in lst.split.numpy():
        part = np.zeros((parts, 6), np.float32)
        for k in range(count):
            part[k % parts] += run(unit_edge[first + k],
                                   unit_edge[first + k + 1])
        want[r] = np.zeros(6, np.float32)
        for g in range(parts):
            want[r] = want[r] + part[g]
    np.testing.assert_array_equal(blocked_spmm_plain(lst, val, x).numpy(),
                                  want)


@pytest.mark.parametrize("parts", [1, 5, 64])
def test_part_items_hold_each_part_with_a_piece_once(parts):
    """The fix-up's items: every (split row s, part g) with g below the
    row's piece count once, as s * parts + g, part-major."""
    split = np.array([[3, 0, 2], [9, 2, 70], [11, 72, 5]], np.int32)
    items = blocked_ops.part_items(split, parts)
    s, g = items // parts, items % parts
    want = {(r, p) for r, (_, _, count) in enumerate(split)
            for p in range(min(parts, count))}
    assert items.dtype == np.int32 and len(items) == len(want)
    assert set(zip(s.tolist(), g.tolist())) == want
    assert np.all(np.diff(g) >= 0)
    assert np.all(np.diff(s)[np.diff(g) == 0] > 0)
    assert blocked_ops.part_items(np.zeros((0, 3), np.int32), parts).shape \
        == (0,)


def test_wrapper_rejects_bad_inputs():
    _, prep, val, x = _inputs(1)
    lst = prep.forward
    with pytest.raises(TypeError):
        blocked_spmm(lst, val, x.double())
    with pytest.raises(TypeError):
        blocked_spmm(lst, val[:-1], x)
    with pytest.raises(TypeError):
        blocked_spmm(lst, val.double(), x)
    with pytest.raises(TypeError):
        blocked_spmm(lst, val, x[:-1])
    with pytest.raises(ValueError):
        blocked_spmm(lst, val, torch.from_numpy(np.asfortranarray(x.numpy())))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _check_kernel(prep, val, x):
    for lst in (prep.forward, prep.transposed):
        before = blocked_spmm.launches
        out = blocked_spmm(lst, val, x)
        torch.cuda.synchronize()
        assert blocked_spmm.launches == before + 1
        ref = blocked_spmm_plain(lst, val, x)
        scale = blocked_spmm_plain(lst, val.abs(), x.abs())
        diff = (out - ref).abs()
        assert bool((diff <= KERNEL_RTOL * scale).all()), diff.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 6, 40, 64, 128, 260])
def test_kernel_matches_plain_on_card(cuda, f):
    # window 0 holds 30,000 edges; row 17 and column 33 hold 20,000 each,
    # so each is split over more than a hundred units of work
    _, prep, val, x = _inputs(2, n=5000, e=60_000, f=f, heavy=30_000,
                              hub=20_000, window=256, tile=256,
                              block_edges=1024, device=cuda)
    assert prep.forward.split.shape[0] and prep.transposed.split.shape[0]
    _check_kernel(prep, val, x)


@pytest.mark.cuda
def test_kernel_splits_hub_rows_on_card(cuda):
    # a hub row and a hub column of 1,500 edges each: more than ten units of
    # 128 items, beside rows of one or two units
    _, prep, val, x = _inputs(6, n=3000, e=20_000, f=40, hub=1_500,
                              device=cuda)
    for lst in (prep.forward, prep.transposed):
        split = lst.split.cpu().numpy()
        assert split[:, 2].max() > 10
    _check_kernel(prep, val, x)


@pytest.mark.cuda
def test_kernel_bit_equal_to_cpu_plain_on_card(cuda):
    # the kernel rounds each product and each sum apart, in the order the
    # plain version adds them on the CPU, split rows included
    _, prep, val, x = _inputs(7, n=3000, e=40_000, f=40, hub=5_000,
                              device=cuda)
    _, cpu, _, _ = _inputs(7, n=3000, e=40_000, f=40, hub=5_000)
    for lst, ref in ((prep.forward, cpu.forward),
                     (prep.transposed, cpu.transposed)):
        out = blocked_spmm(lst, val, x).cpu()
        assert torch.equal(out, blocked_spmm_plain(ref, val.cpu(), x.cpu()))


@pytest.mark.cuda
def test_kernel_small_blocks_on_card(cuda):
    # tiny windows and tiles: many one-edge chunks
    _, prep, val, x = _inputs(3, n=700, e=3000, f=12, window=8, tile=16,
                              block_edges=32, device=cuda)
    _check_kernel(prep, val, x)


@pytest.mark.cuda
def test_kernel_takes_unaligned_rows_on_card(cuda):
    # x starts one float into its buffer: F = 16 would take float4 loads,
    # but the rows are not 16-byte aligned, so the wrapper takes scalar ones
    _, prep, val, x = _inputs(4, n=2000, e=30_000, f=16, device=cuda)
    buf = torch.empty(x.numel() + 1, dtype=torch.float32, device=cuda)
    xs = buf[1:].view(x.shape)
    xs.copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16 != 0
    _check_kernel(prep, val, xs)


@pytest.mark.cuda
def test_kernel_empty_graph_on_card(cuda):
    # no edges: the kernel still writes every row, as zeros (out comes
    # from torch.empty)
    empty = np.zeros(0, np.int64)
    prep = BlockedSpMM(block_coo(empty, empty, 50, window=32, tile=32,
                                 block_edges=128), cuda)
    for lst in (prep.forward, prep.transposed):
        out = blocked_spmm(lst, torch.zeros(0, device=cuda),
                           torch.ones(50, 8, device=cuda))
        assert out.shape == (50, 8) and not out.any()


@pytest.mark.cuda
def test_kernel_raises_on_mixed_devices(cuda):
    _, prep, val, x = _inputs(5, device=cuda)
    with pytest.raises(ValueError):
        blocked_spmm(prep.forward, val, x.cpu())
    with pytest.raises(ValueError):
        blocked_spmm(prep.transposed, val.cpu(), x)


@pytest.mark.cuda
def test_pallas_training_on_card_matches_cpu(cuda):
    """Two epochs of APPNP under ``spmm_impl="pallas"`` with edge dropout
    (CPU-drawn salts, so the masks agree): 30 K2 launches an epoch on the
    card (10 in the step's forward, 10 in its backward, 10 in the
    validation forward), losses close to the CPU run of the plain
    versions."""
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
        assert launched == (60 if model.device.type == "cuda" else 0)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist["cuda"][key], hist["cpu"][key],
                                   rtol=1e-4)
