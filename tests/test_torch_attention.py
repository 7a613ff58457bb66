"""The port's graph attention (``gnntf_tpu_torch/ops/attention.py``,
``ops/segment.py``) against the JAX package's, on the CPU, where the four
attention kernels run their plain versions: the same numpy inputs to both.

Bit-equal: the attention grids in both flavours (every integer array and
multiplicity) and the per-(edge, head) dropout scale for several salts,
head counts and keep rates.

Tolerances (float32, sums in another order than XLA's):

* forwards (grid path, segment path, ``segment_softmax``): rtol=1e-5,
  atol=1e-5;
* gradients in ``h``, ``s_src`` and ``s_dst``: rtol=1e-4, atol=1e-5, and
  atol=1e-4 with dropout 0.4 and the same salt pair (the JAX package's own
  test holds its two paths to these).

The grid path runs under ``min_edges_scope(0)`` or on graphs of a few
hundred edges called through ``_gat_attention_ell`` directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import attention as ja
from gnntf_tpu.ops import segment as jseg
from gnntf_tpu_torch.ops import attention as pa
from gnntf_tpu_torch.ops import stochastic as pst

FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
DROP_GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
SALT = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
GRID_FIELDS = ("r_idx", "r_vrow", "r_eid", "c_idx", "c_vrow", "c_eid",
               "r_mult", "c_mult")


def _graphs(n=80, e=600, seed=0, hub=False):
    """A random symmetrized graph with duplicate edges (and with ``hub`` a
    row and a column of 300 edges, split over many units) in both
    packages."""
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
    if hub:
        src = np.concatenate([src, np.zeros(300, np.int64)])
        dst = np.concatenate([dst, rng.randint(0, n, 300)])
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False,
                          device="cpu"))


def _inputs(n, heads=4, feats=8, seed=1):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, heads, feats).astype(np.float32),
            rng.randn(n, heads).astype(np.float32),
            rng.randn(n, heads).astype(np.float32))


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("k", [None, "4"])
def test_attn_grids_bit_equal_to_jax(dedup, k, monkeypatch):
    """The JAX package reads its width from GNNTF_ATTN_K; the port takes
    it as an argument (default 16, the JAX default)."""
    if k is not None:
        monkeypatch.setenv("GNNTF_ATTN_K", k)
    jg, pg = _graphs(hub=True)
    a = ja.build_attn_grids(np.asarray(jg.row), np.asarray(jg.col),
                            jg.n_nodes, dedup=dedup)
    b = pa.build_attn_grids(pg.row.numpy(), pg.col.numpy(), pg.n_nodes,
                            dedup=dedup, **({} if k is None else
                                            dict(k=int(k))))
    assert a.n_nodes == b.n_nodes
    for name in GRID_FIELDS:
        x, y = getattr(a, name), getattr(b, name)
        if x is None:
            assert y is None, name
            continue
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name


@pytest.mark.parametrize("dedup", [False, True])
@pytest.mark.parametrize("k", [4, 8, 16, 32])
def test_lists_are_the_grids_flattened(dedup, k):
    """The kernels' lists, built by a stable sort, hold the JAX package's
    grids' live slots in grid order at every width: the same rows, sources,
    ids and multiplicities."""
    _, pg = _graphs(hub=True)
    row, col = pg.row.numpy(), pg.col.numpy()
    grids = pa.build_attn_grids(row, col, pg.n_nodes, dedup=dedup, k=k)
    lists = pa.attn_lists(row, col, pg.n_nodes, "cpu", dedup=dedup)
    for lst, idx, vrow, eid in ((lists.rows, grids.r_idx, grids.r_vrow,
                                 grids.r_eid),
                                (lists.cols, grids.c_idx, grids.c_vrow,
                                 grids.c_eid)):
        flat = pst._grid_list(idx, vrow, eid, pg.n_nodes, "cpu")
        assert torch.equal(lst.ptr, flat.ptr)
        assert torch.equal(lst.idx, flat.idx)
        assert torch.equal(pa._slot_ids(lst), pa._slot_ids(flat))
    if dedup:
        live = grids.r_idx.reshape(-1) < pg.n_nodes
        by_id = np.zeros(lists.mult.shape[0], np.float32)
        by_id[grids.r_eid.reshape(-1)[live]] = grids.r_mult.reshape(-1)[live]
        assert np.array_equal(lists.mult.numpy(), by_id)
    else:
        assert lists.mult is None


@pytest.mark.parametrize("salt", [[1, 2], [0xFFFFFFFF, 0x9E3779B9],
                                  [0x12345678, 0]])
@pytest.mark.parametrize("heads", [1, 3, 8])
@pytest.mark.parametrize("keep", [0.4, 0.5, 1.0])
def test_keep_scale_bit_equal_to_jax(salt, heads, keep):
    eids = np.random.RandomState(0).randint(0, 2**32, 2000,
                                            dtype=np.uint64)
    eids = eids.astype(np.uint32)
    ref = np.asarray(ja._attn_keep_scale(
        jnp.asarray(eids), jnp.asarray(np.array(salt, np.uint32)), heads,
        keep, jnp.float32))
    got = pa._attn_keep_scale(torch.from_numpy(eids.astype(np.int64)),
                              torch.tensor(salt), heads, keep)
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert np.array_equal(got.numpy(), ref)
    if keep < 1.0:
        assert 0.0 < float((got == 0).double().mean()) < 1.0


@pytest.mark.parametrize("shape", [(600,), (600, 4)])
def test_segment_softmax_matches_jax(shape):
    rng = np.random.RandomState(2)
    scores = (rng.randn(*shape) * 3).astype(np.float32)
    ids = np.sort(rng.randint(0, 50, shape[0]))  # some segments empty
    ref = jseg.segment_softmax(jnp.asarray(scores), jnp.asarray(ids), 60)
    got = tt.segment_softmax(torch.from_numpy(scores), torch.from_numpy(ids),
                             60)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **FWD_TOL)


def _run_jax(fn, jg, h, ss, sd, drop):
    salt = jnp.asarray(SALT) if drop else None
    kw = dict(negative_slope=0.2, attn_dropout=drop, salt=salt)
    if fn is ja._gat_attention_segment:
        kw["sorted_by_row"] = jg.sorted_by_row
    args = [jnp.asarray(v) for v in (h, ss, sd)]
    out = fn(jg, *args, **kw)
    grads = jax.grad(lambda *a: jnp.sum(fn(jg, *a, **kw) ** 2),
                     argnums=(0, 1, 2))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _run_torch(fn, pg, h, ss, sd, drop):
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    kw = dict(negative_slope=0.2, attn_dropout=drop, salt=salt)
    if fn is pa._gat_attention_segment:
        kw["sorted_by_row"] = pg.sorted_by_row
    args = [torch.tensor(v, requires_grad=True) for v in (h, ss, sd)]
    out = fn(pg, *args, **kw)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [a.grad.numpy() for a in args]


@pytest.mark.parametrize("path", ["grid", "segment"])
@pytest.mark.parametrize("drop", [0.0, 0.4])
@pytest.mark.parametrize("hub", [False, True])
def test_attention_and_gradients_match_jax(path, drop, hub):
    jg, pg = _graphs(hub=hub)
    h, ss, sd = _inputs(pg.n_nodes)
    jfn, pfn = ((ja._gat_attention_ell, pa._gat_attention_ell)
                if path == "grid" else
                (ja._gat_attention_segment, pa._gat_attention_segment))
    ref, ref_grads = _run_jax(jfn, jg, h, ss, sd, drop)
    out, grads = _run_torch(pfn, pg, h, ss, sd, drop)
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want,
                                   **(DROP_GRAD_TOL if drop else GRAD_TOL))


@pytest.mark.parametrize("heads,feats", [(1, 40), (8, 8), (3, 6)])
def test_grid_path_matches_jax_at_layer_shapes(heads, feats):
    """The shapes of GAT's layers (8 heads of 8; one head of 40 classes)
    and a width that is not a multiple of 4."""
    jg, pg = _graphs(seed=4, hub=True)
    h, ss, sd = _inputs(pg.n_nodes, heads, feats, seed=5)
    ref, ref_grads = _run_jax(ja._gat_attention_ell, jg, h, ss, sd, 0.4)
    out, grads = _run_torch(pa._gat_attention_ell, pg, h, ss, sd, 0.4)
    np.testing.assert_allclose(out, ref, **FWD_TOL)
    for got, want in zip(grads, ref_grads):
        np.testing.assert_allclose(got, want, **DROP_GRAD_TOL)


def test_isolated_destinations_give_finite_zeros():
    """Node 9 has no incoming edge: its output is 0, with no NaN, on the
    grid path (rmax0 0, dinv 1e30, no slot) as on the segment path."""
    pg = tt.from_edges([0, 1, 2], [1, 2, 0], n_nodes=10, directed=False,
                       device="cpu")
    rng = np.random.RandomState(1)
    h = torch.tensor(rng.randn(10, 2, 4).astype(np.float32),
                     requires_grad=True)
    s = torch.tensor(rng.randn(10, 2).astype(np.float32),
                     requires_grad=True)
    for scope in (0, 10**9):
        with pst.min_edges_scope(scope):
            out = tt.ops.gat_attention(pg, h, s, s)
        assert torch.isfinite(out).all()
        assert torch.equal(out[3:], torch.zeros_like(out[3:]))
        (out ** 2).sum().backward()
        assert torch.isfinite(h.grad).all() and torch.isfinite(s.grad).all()
        h.grad = s.grad = None


def test_dispatch_follows_min_edges_scope(monkeypatch):
    """``gat_attention`` takes the grids at or above ``min_edges()`` edges
    and the segment form below; ``min_edges_scope`` moves the gate (the
    JAX package's gate ignores it)."""
    _, pg = _graphs()
    h, ss, sd = (torch.from_numpy(v) for v in _inputs(pg.n_nodes))
    calls = []
    for name in ("_gat_attention_ell", "_gat_attention_segment"):
        real = getattr(pa, name)
        monkeypatch.setattr(pa, name, lambda *a, _real=real, _name=name,
                            **kw: calls.append(_name) or _real(*a, **kw))
    ref = pa.gat_attention(pg, h, ss, sd)
    with pst.min_edges_scope(pg.n_edges):
        out = pa.gat_attention(pg, h, ss, sd)
    with pst.min_edges_scope(pg.n_edges + 1):
        pa.gat_attention(pg, h, ss, sd)
    assert calls == ["_gat_attention_segment", "_gat_attention_ell",
                     "_gat_attention_segment"]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **FWD_TOL)


def test_grids_and_lists_built_once_per_structure():
    """A structure's lists are built once a flavour: forwards, steps and
    both layers of a GAT share them."""
    _, pg = _graphs(seed=7)
    h, ss, sd = _inputs(pg.n_nodes)
    args = [torch.tensor(v, requires_grad=True) for v in (h, ss, sd)]
    salt = torch.tensor(SALT.astype(np.int64))
    before = pa._attn_lists.builds
    with pst.min_edges_scope(0):
        for _ in range(3):
            pa.gat_attention(pg, *args).sum().backward()
            pa.gat_attention(pg, *args, attn_dropout=0.5,
                             salt=salt).sum().backward()
    assert pa._attn_lists.builds == before + 2
    assert pa._attn_lists(pg, dedup=True) is pa._attn_lists(pg, dedup=True)
    assert pa._attn_lists.builds == before + 2


def test_coalesced_lists_carry_the_multiplicities():
    """The coalesced lists read each pair's multiplicity through its id;
    the multiplicities sum to the edge count, and the rows of both lists
    hold every pair once."""
    _, pg = _graphs(seed=3)
    lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), pg.n_nodes, "cpu",
                          dedup=True)
    assert float(lists.mult.sum()) == pg.n_edges
    assert lists.rows.n_edges == lists.cols.n_edges == lists.mult.shape[0]
    assert lists.mult.min() >= 1
    per_edge = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), pg.n_nodes,
                             "cpu")
    assert per_edge.mult is None and per_edge.rows.n_edges == pg.n_edges


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("drop", [0.0, 0.5])
def test_kernel_plain_versions_sum_split_rows_in_parts(drop, fused):
    """The plain versions on lists cut into small units (so the hub row
    spans many pieces) equal A1-A4's on one unit a row, up to the order of
    the sums: the split rows' fix-up (A1 and A2, ``fused`` False) and the
    fused walk's fold of the pieces (``fused``) are reorderings only."""
    _, pg = _graphs(seed=2, hub=True)
    h, ss, sd = (torch.from_numpy(v) for v in _inputs(pg.n_nodes))
    salt = torch.tensor(SALT.astype(np.int64)) if drop else None
    g = torch.from_numpy(np.random.RandomState(9).randn(
        pg.n_nodes, 32).astype(np.float32))
    outs = []
    for items in (4, 10**6):
        lists = pa.attn_lists(pg.row.numpy(), pg.col.numpy(), pg.n_nodes,
                              "cpu", items=items)
        if items == 4:
            assert lists.rows.split.shape[0] > 0
            assert lists.cols.split.shape[0] > 0
        outs.append(pa.attn_chain(lists, h, ss, sd, g, 0.2, salt, 1 - drop,
                                  fused=fused if items == 4 else None))
    assert pa.softmax_route(lists, 4, 8) is False  # one unit a row: A1, A2
    for name in outs[0]:
        np.testing.assert_allclose(outs[0][name].numpy(),
                                   outs[1][name].numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_wrappers_count_only_card_launches():
    """On the CPU the wrappers run the plain versions and count nothing."""
    _, pg = _graphs()
    names = ("attn_stats", "attn_aggregate", "attn_bwd_rows",
             "attn_bwd_cols")
    before = [getattr(pa, n).launches for n in names]
    h, ss, sd = (torch.tensor(v, requires_grad=True)
                 for v in _inputs(pg.n_nodes))
    with pst.min_edges_scope(0):
        pa.gat_attention(pg, h, ss, sd).sum().backward()
    assert [getattr(pa, n).launches for n in names] == before
