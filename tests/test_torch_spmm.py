"""The port's SpMM against the JAX package.

Tolerance rtol=1e-5, atol=1e-5: float32 both sides, summed in another
order (the port sums a row's live slots in one run, JAX each virtual row's
k slots and then the virtual rows; under ``hybrid`` the hub matmul is added
to that sum on both sides; under ``auto`` the port has no hub slice and
sums every live slot of a row in the walk, where JAX adds its hub matmul).
The hub route is reached by naming it (``PreparedSpMM(hubs=True)``, what
``impl="hybrid"`` builds); ``route`` runs a case under both.  The kernel wrapper on its own, and
the kernel against its plain version on the card, are in
test_torch_ell_gather.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import random_power_law_edges
from gnntf_tpu.ops import normalize_adjacency as jax_normalize
from gnntf_tpu.ops.spmm import PreparedSpMM as JaxPreparedSpMM
from gnntf_tpu.ops.spmm import _ell_compute
from gnntf_tpu.ops.spmm import spmm as jax_spmm
from gnntf_tpu_torch.ops import ell_gather_plain
from gnntf_tpu_torch.ops import normalize_adjacency
from gnntf_tpu_torch.ops.spmm import PreparedSpMM, build_ell, spmm
from _jax_budget import release_jax_layout_caches  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _graphs(n, e, seed, symmetric=True, uniform=False):
    rng = np.random.RandomState(seed)
    if uniform:
        src, dst = rng.randint(0, n, size=(2, e))
    else:
        src, dst = random_power_law_edges(n, e, seed=seed)
    vals = rng.rand(src.shape[0]) + 0.5
    kw = dict(n_nodes=n, directed=not symmetric)
    return gt.from_edges(src, dst, vals, **kw), \
        tt.from_edges(src, dst, vals, device="cpu", **kw)


def _ell_inputs(seed, n=500, e=4000, f=16):
    """An ELL layout with duplicates and empty rows, random values and x."""
    rng = np.random.RandomState(seed)
    row = rng.randint(0, n // 2, size=e) * 2   # odd rows stay empty
    col = rng.randint(0, n, size=e)
    layout = build_ell(row, col, n, 8)
    vals = rng.randn(layout.n_vrows, layout.k).astype(np.float32)
    vals[layout.idx == n] = 0.0
    x = rng.randn(n, f).astype(np.float32)
    return layout, vals, x


@pytest.mark.parametrize("f", [16, 40])
def test_plain_matches_ell_compute(f):
    layout, vals, x = _ell_inputs(0, f=f)
    ref = _ell_compute(layout, jnp.asarray(vals), jnp.asarray(x),
                       layout.n_nodes)
    out = ell_gather_plain(torch.from_numpy(layout.idx),
                           torch.from_numpy(vals), torch.from_numpy(x),
                           torch.from_numpy(layout.vrow_row), layout.n_nodes)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("normalized", [False, True])
def test_plain_matches_pallas_kernel(normalized):
    """The TPU kernel itself, run in interpret mode (as test_pallas.py
    runs it), against the port's layout + routing + plain K1."""
    from gnntf_tpu.ops.pallas.dma_gather import spmm_dma_gather
    jg, pg = _graphs(300, 1000, seed=5)
    if normalized:
        jg = jax_normalize(jg, graph_dropout=0.0)
        pg = normalize_adjacency(pg, graph_dropout=0.0)
    x = np.random.RandomState(2).randn(300, 16).astype(np.float32)
    ref = spmm_dma_gather(jg, jnp.asarray(x), interpret=True)
    base = pg.materialized()
    layout = build_ell(base.row.numpy(), base.col.numpy(), 300, 8)
    vals = torch.zeros(layout.n_vrows * layout.k)
    vals.index_add_(0, torch.from_numpy(layout.edge_slot.astype(np.int64)),
                    base.val)
    out = ell_gather_plain(torch.from_numpy(layout.idx),
                           vals.view(layout.n_vrows, layout.k),
                           torch.from_numpy(x),
                           torch.from_numpy(layout.vrow_row), 300)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("route", ["hybrid", "auto"])
@pytest.mark.parametrize("case", ["hybrid", "plain_ell"])
@pytest.mark.parametrize("add_eye", ["none", "after"])
def test_prepared_matches_jax(case, add_eye, route):
    if case == "hybrid":
        jg, pg = _graphs(3000, 20_000, seed=1)
    else:  # uniform sources: hub coverage too low, falls back to ELL
        jg, pg = _graphs(6000, 20_000, seed=1, uniform=True)
    jn = jax_normalize(jg, graph_dropout=0.0, add_eye=add_eye)
    pn = normalize_adjacency(pg, graph_dropout=0.0, add_eye=add_eye)
    x = np.random.RandomState(3).randn(jg.n_nodes, 24).astype(np.float32)
    jp, pp = JaxPreparedSpMM(jn), PreparedSpMM(pn, hubs=route == "hybrid")
    assert (jp.dense is None) == (case == "plain_ell")
    assert (pp.dense is None) == (case == "plain_ell" or route == "auto")
    np.testing.assert_allclose(pp(torch.from_numpy(x)).numpy(),
                               np.asarray(jp(jnp.asarray(x))), **TOL)


def _hub_and_split_graphs():
    """A power-law graph (hub slice) plus row 7 joined to 2,000 random
    nodes, most of them no hub: row 7's rest-ELL slots are split over many
    of K1's units."""
    rng = np.random.RandomState(11)
    n = 4000
    src, dst = random_power_law_edges(n, 24_000, seed=11)
    src = np.concatenate([src, np.full(2000, 7)])
    dst = np.concatenate([dst, rng.randint(0, n, 2000)])
    vals = rng.rand(src.shape[0]) + 0.5
    kw = dict(n_nodes=n, directed=False)
    jg = jax_normalize(gt.from_edges(src, dst, vals, **kw),
                       graph_dropout=0.0, add_eye="after")
    pg = normalize_adjacency(tt.from_edges(src, dst, vals, device="cpu",
                                           **kw),
                             graph_dropout=0.0, add_eye="after")
    return jg, pg


@pytest.mark.parametrize("route", ["hybrid", "auto"])
def test_prepared_with_hub_slice_and_split_rows_matches_jax(route):
    jg, pg = _hub_and_split_graphs()
    jp, pp = JaxPreparedSpMM(jg), PreparedSpMM(pg, hubs=route == "hybrid")
    assert jp.dense is not None
    assert (pp.dense is not None) == (route == "hybrid")
    split = pp.k1_list.split.numpy()
    assert len(split) and split[:, 2].max() > 10
    x = np.random.RandomState(12).randn(jg.n_nodes, 40).astype(np.float32)
    np.testing.assert_allclose(pp(torch.from_numpy(x)).numpy(),
                               np.asarray(jp(jnp.asarray(x))), **TOL)


@pytest.mark.parametrize("route", ["hybrid", "auto"])
def test_prepared_gradient_matches_jax(route):
    """The prepared operator's ``dx`` (K1's share from the walk over its
    transposed list, the hub matmul's and the scales' gradients; under
    ``auto`` the walk over every slot's transposed list) against
    ``jax.vjp``."""
    import jax
    jg, pg = _hub_and_split_graphs()
    jp, pp = JaxPreparedSpMM(jg), PreparedSpMM(pg, hubs=route == "hybrid")
    rng = np.random.RandomState(13)
    x = rng.randn(jg.n_nodes, 12).astype(np.float32)
    dy = rng.randn(jg.n_nodes, 12).astype(np.float32)
    _, vjp = jax.vjp(jp, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    pp(xt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("f", [1, 40])
@pytest.mark.parametrize("hubs", [True, False])
def test_backward_walk_matches_jax_gradient(f, hubs):
    """``dx`` of the prepared operator, K1's share from one walk over its
    transposed list, against ``jax.vjp`` of the JAX ``PreparedSpMM``, with
    and without a hub slice."""
    import jax
    if hubs:
        jg, pg = _hub_and_split_graphs()
    else:  # uniform sources: no hub slice
        jg, pg = _graphs(6000, 40_000, 3, uniform=True)
        jg = jax_normalize(jg, graph_dropout=0.0)
        pg = normalize_adjacency(pg, graph_dropout=0.0)
    jp, pp = JaxPreparedSpMM(jg), PreparedSpMM(pg, hubs=True)
    assert (pp.dense is not None) == hubs
    rng = np.random.RandomState(14)
    x = rng.randn(jg.n_nodes, f).astype(np.float32)
    dy = rng.randn(jg.n_nodes, f).astype(np.float32)
    _, vjp = jax.vjp(jp, jnp.asarray(x))
    (ref,) = vjp(jnp.asarray(dy))
    xt = torch.from_numpy(x).requires_grad_()
    pp(xt).backward(torch.from_numpy(dy))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref), **TOL)
    assert pp._routed._transposed is not None


@pytest.mark.parametrize("n,e", [(500, 3000), (6000, 40_000)])
def test_dispatcher_matches_jax(n, e):
    """Below 65,536 edges the segment path, at or above it PreparedSpMM."""
    jg, pg = _graphs(n, e, seed=2)
    jn = jax_normalize(jg, graph_dropout=0.0)
    pn = normalize_adjacency(pg, graph_dropout=0.0)
    x = np.random.RandomState(4).randn(n, 8).astype(np.float32)
    np.testing.assert_allclose(spmm(pn, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_spmm(jn, jnp.asarray(x))),
                               **TOL)


def test_segment_matches_dense():
    _, pg = _graphs(200, 800, seed=6)
    pn = normalize_adjacency(pg, graph_dropout=0.0, add_eye="after")
    x = torch.from_numpy(
        np.random.RandomState(1).randn(200, 8).astype(np.float32))
    from gnntf_tpu_torch.ops import spmm_segment
    np.testing.assert_allclose(spmm_segment(pn, x).numpy(),
                               (pn.to_dense() @ x).numpy(), **TOL)
