"""The multi-process slice's kernel paths on the card, without JAX:

    python -m pytest --noconftest -q -m cuda tests/test_torch_multihost_cuda.py

* K1's masked and degree walks over a slice of an edge list, the mask
  hashed at ``id_base`` plus the slice's ids: equal to their plain versions
  and to the whole list's walk restricted to the slice;
* A3 with a given ``rowdot`` against its plain version;
* GAT's attention chain over 4 slices merged in one process
  (``ops.attention.sharded_forward``/``sharded_backward``) against the
  whole list's chain, within ``1e-5`` of the sum of the terms' magnitudes
  (``ds_src`` with ``rowdot``'s scale, the merged ``rowdot`` differing
  from the whole one by its own rounding).

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

from gnntf_tpu_torch.ops import attention as pa
from gnntf_tpu_torch.ops.ell_gather import (ell_degree_masked,
                                            ell_degree_masked_plain,
                                            ell_gather_masked,
                                            ell_gather_masked_plain,
                                            pair_lists)
from gnntf_tpu_torch.ops.stochastic import device_salt

KEEP = 0.7
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _edges(n=3000, e=40_000, seed=0):
    rng = np.random.RandomState(seed)
    row = np.sort(rng.randint(0, n, e))
    return row, rng.randint(0, n, e), rng.rand(e).astype(np.float32)


@pytest.mark.cuda
def test_dropout_walks_over_a_slice_hash_global_ids(cuda):
    n = 3000
    row, col, val = _edges(n)
    lo, hi = 10_000, 25_000
    salt = device_salt(torch.tensor([0x2545F491, 12345]), cuda)
    fwd, bwd = pair_lists(row[lo:hi], col[lo:hi], None, n, n, cuda)
    v = torch.from_numpy(val[lo:hi]).to(cuda)
    x = torch.randn(n, 40, device=cuda)
    draw = (salt, KEEP, len(row))
    for lst in (fwd, bwd):
        got = ell_gather_masked(lst, v, *draw, x, lo)
        ref = ell_gather_masked_plain(lst, v, *draw, x, lo)
        torch.testing.assert_close(got, ref, rtol=RTOL, atol=1e-5)
        deg = ell_degree_masked(lst, v, *draw, lo)
        torch.testing.assert_close(deg, ell_degree_masked_plain(
            lst, v, *draw, lo), rtol=RTOL, atol=1e-6)
    # the slice's walk is the whole list's walk over the slice's edges
    whole_fwd, _ = pair_lists(row[lo:hi], col[lo:hi],
                              np.arange(lo, hi), n, n, cuda, n_ids=len(row))
    full = torch.from_numpy(val).to(cuda)
    torch.testing.assert_close(ell_gather_masked(fwd, v, *draw, x, lo),
                               ell_gather_masked(whole_fwd, full, *draw, x),
                               rtol=RTOL, atol=1e-5)


def _attn_inputs(n, heads, feats, dev, seed=1):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)
    return t(n, heads, feats), t(n, heads), t(n, heads), t(n, heads * feats)


@pytest.mark.cuda
def test_a3_with_a_given_rowdot(cuda):
    n = 3000
    row, col, _ = _edges(n, seed=2)
    lists = pa.attn_lists(row, col, n, cuda)
    h, ss, sd, g = _attn_inputs(n, 4, 8, cuda)
    tab = pa.pack_table(h.reshape(n, -1), ss)
    salt = torch.tensor([7, 9], device=cuda)
    rmax0, dinv = pa.attn_stats(lists.rows, None, tab, sd, 4, 8, 0.2)
    given = torch.randn(n, 4, device=cuda)
    args = (lists.rows, None, tab, sd, rmax0, dinv, g, 4, 8, 0.2, salt, KEEP)
    got = pa.attn_bwd_rows(*args, rowdot=given)
    ref = pa.attn_bwd_rows_plain(*args, rowdot=given)
    own = pa.attn_bwd_rows(*args)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)
    assert torch.equal(got[0], own[0])


@pytest.mark.cuda
@pytest.mark.parametrize("drop", [False, True])
def test_sliced_attention_merges_to_the_whole(cuda, drop):
    n, heads, feats = 3000, 8, 8
    row, col, _ = _edges(n, seed=3)
    salt = torch.tensor([0x9E3779B9, 77], device=cuda) if drop else None
    keep = KEEP if drop else 1.0
    whole = pa.attn_lists(row, col, n, cuda, dedup=not drop)
    per = -(-len(row) // 4)
    parts = [pa.attn_lists(row[r * per:(r + 1) * per],
                           col[r * per:(r + 1) * per], n, cuda,
                           dedup=not drop, id_base=r * per)
             for r in range(4)]
    h, ss, sd, g = _attn_inputs(n, heads, feats, cuda)
    tab = pa.pack_table(h.reshape(n, -1), ss)
    want = pa.attn_chain(whole, h, ss, sd, g, 0.2, salt, keep)
    fwd = pa.sharded_forward(parts, tab, sd, heads, feats, 0.2, salt, keep,
                             reduce=pa.folded)
    bwd = pa.sharded_backward(parts, tab, sd, fwd["rmax0"], fwd["dinv"], g,
                              heads, feats, 0.2, salt, keep,
                              reduce=pa.folded)
    args = (whole, tab, sd, want["rmax0"], want["dinv"], g)
    rest = (heads, feats, 0.2, salt, keep)
    scales = pa.attn_error_scales(*args, want["rowdot"], *rest)
    # the merged rowdot differs from the whole one by its own rounding:
    # ds_src's alpha * rowdot terms are held with rowdot's scale
    scales["ds_src"] = pa.attn_error_scales(*args, scales["rowdot"],
                                            *rest)["ds_src"]
    for name, got in {**fwd, **bwd}.items():
        diff = (got - want[name]).abs()
        assert bool((diff <= RTOL * scales[name] + 1e-30).all()), name
