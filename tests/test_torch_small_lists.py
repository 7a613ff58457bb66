"""K2's store-mode walk over small lists: the lists cut by ``unit_items``
and derived from the graph's edges (``graph_lists``), against the JAX
package on the same numpy inputs.

Below 65,536 counted edges a card's ``spmm_segment`` and ``edge_degree``
walk K2's lists (``ops/blocked.py::blocked_layout``), cut into units whose
size ``unit_items`` takes from the list's item count (edges and row ends):
Cora's scale gets small units, the benchmark graph's lists 128 items.  The
kernel sums in the plain version's order, so the plain version under the
new units, which the CPU runs, is what the card computes.  Two graphs at
Cora's scale (2,708 nodes, 5,278 undirected edges): uniform random edges,
and power-law edges whose hub rows are longer than any unit, so rows split.

Tolerances: the products and degrees ``rtol=1e-5, atol=1e-6`` (float32,
sums in another order than XLA's ``segment_sum``).  A product is held to
that against the exact (float64) sum, and against JAX's to that plus JAX's
own distance from the exact sum: on the power-law graph at F=64 a hub row
whose terms cancel puts JAX's float32 sum 4.7e-6 from the exact one, the
walk's (its pieces summed apart) 6.5e-7, so the two are 1.3e-6 apart at one
element of 173,312.  The 3-epoch trajectory's
losses ``rtol=1e-4, atol=1e-5``, as the gradients of
``test_torch_determinism.py``, and its parameters the same but for at most
``PARAM_OUTLIERS`` of their elements, none off by more than
``MAX_PARAM_DIFF`` (the rule of ``chip_smoke.py`` phase 4b and
``test_torch_link_prediction.py``): Adam's first step moves each element by
about the learning rate whatever its gradient's size, so a gradient that is
rounding noise takes a step of its own in each package (on the power-law
graph one of 2,048 first-layer weights, 3e-5 apart, as with units of 128
items).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops.normalize import _degree as jax_degree
from gnntf_tpu.ops.spmm import spmm_segment as jax_segment
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import blocked
from gnntf_tpu_torch.ops.spmm import edge_degree

N, EDGES, CLASSES = 2708, 5278, 7
TOL = dict(rtol=1e-5, atol=1e-6)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_OUTLIERS = 0.01
MAX_PARAM_DIFF = 1e-3
# the items of the RCM benchmark graph's forward list: 2,332,478 counted
# edges and 169,343 row ends
BENCH_ITEMS = 2_501_821
GRAPHS = ("uniform", "power_law")


def _edges(kind):
    if kind == "uniform":
        rng = np.random.RandomState(0)
        return rng.randint(0, N, EDGES), rng.randint(0, N, EDGES)
    return random_power_law_edges(N, EDGES, seed=0)


@pytest.fixture(scope="module", params=GRAPHS)
def graphs(request):
    """The port's normalized adjacency with its values realized per edge,
    and the JAX package's graph of the same edges and values."""
    src, dst = _edges(request.param)
    pg = tt.from_edges(src, dst, n_nodes=N, directed=False, device="cpu")
    adj = tt.normalize_adjacency(pg).materialized()
    jg = gt.Graph(row=jnp.asarray(adj.row.numpy()),
                  col=jnp.asarray(adj.col.numpy()),
                  val=jnp.asarray(adj.val.numpy()), n_nodes=N)
    return request.param, adj, jg


def _transposed(jg):
    return dataclasses.replace(jg, row=jg.col, col=jg.row)


def test_unit_rule_is_a_pure_function_of_the_item_count():
    sizes = [blocked.unit_items(n) for n in range(0, 300_000, 1_013)]
    assert set(sizes) <= set(blocked._UNIT_SIZES)
    assert sizes == sorted(sizes)
    assert blocked.unit_items(BENCH_ITEMS) == 128
    # Cora's lists (10,556 counted edges and 2,708 rows), a list of ~100 K
    # items, one of the benchmark graph's gspmd slices (583,120 edges over
    # its 169,343 rows)
    assert [blocked.unit_items(n) for n in (10_556 + N, 100_000,
                                            583_120 + 169_343)] \
        == [16, 32, 128]
    assert blocked.unit_items(0) == min(blocked._UNIT_SIZES)


@pytest.mark.parametrize("transposed", [False, True])
def test_small_lists_get_small_units_and_repeat(graphs, transposed):
    """At Cora's scale the program's lists are cut into units of 16 items,
    eight times as many as units of 128 would give, and two builds of one
    structure are equal; the power-law graph's hub rows split."""
    name, adj, _ = graphs
    blocked._BLOCK_CACHE.clear()
    first = blocked.blocked_layout(adj)
    blocked._BLOCK_CACHE.clear()
    second = blocked.blocked_layout(adj)
    lst, again = ((first.transposed, second.transposed) if transposed
                  else (first.forward, second.forward))
    items = lst.n_edges + lst.n_rows
    size = blocked.unit_items(items)
    assert size == 16 and lst.n_units >= items // size
    for field in dataclasses.fields(lst):
        a, b = getattr(lst, field.name), getattr(again, field.name)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), field.name
        elif isinstance(a, blocked.Counters):  # a store of zeroed sets
            assert (a.size, a.sets, b.sets) == (b.size, {}, {}), field.name
        else:
            assert a == b, field.name
    if name == "power_law":
        assert lst.split.shape[0] > 0
        assert int(lst.ptr.diff().max()) > size


@pytest.mark.parametrize("f", [1, 7, 64])
@pytest.mark.parametrize("transposed", [False, True])
def test_plain_walk_matches_jax_spmm_segment(graphs, f, transposed):
    _, adj, jg = graphs
    prep = blocked.blocked_layout(adj)
    lst = prep.transposed if transposed else prep.forward
    x = np.random.RandomState(f).randn(N, f).astype(np.float32)
    ours = blocked.blocked_spmm_plain(lst, adj.val.to(torch.float32),
                                      torch.from_numpy(x)).numpy()
    want = np.asarray(jax_segment(_transposed(jg) if transposed else jg,
                                  jnp.asarray(x)))
    # the exact sum (float64); JAX's float32 sum may be off it by more than
    # TOL where a hub row's terms cancel, and never less than 0
    dst, src = (adj.col, adj.row) if transposed else (adj.row, adj.col)
    exact = np.zeros((N, f))
    np.add.at(exact, dst.numpy(), x[src.numpy()].astype(np.float64)
              * adj.val.numpy()[:, None])
    np.testing.assert_allclose(ours, exact, **TOL)
    np.testing.assert_array_less(
        np.abs(ours - want), TOL["atol"] + TOL["rtol"] * np.abs(want)
        + np.abs(want - exact) + 1e-12)


@pytest.mark.parametrize("by", ["col", "row"])
def test_degree_walk_matches_jax_degree(graphs, by):
    """``edge_degree``'s walk (K2 over a column of ones: the transposed
    list for column sums, the forward one for row sums), as a card takes
    it, in its plain version."""
    _, adj, jg = graphs
    ours = edge_degree(adj, by=by, walk=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(jax_degree(jg, by)),
                               **TOL)


def _appnp_stack(pkg, graph, feats, device=None):
    """APPNP's layers without dropout: the JAX and torch generators cannot
    draw the same masks."""
    kw = {} if device is None else {"device": device}
    relu = jax.nn.relu if pkg is gt else torch.relu
    m = pkg.GNN(graph, feats, **kw)
    m.add(pkg.Dense(64, activation=relu))
    h0 = m.add(pkg.Dense(CLASSES, regularize=False))
    for _ in range(10):
        m.add(pkg.PPRIteration(h0, 0.1, graph_dropout=0.0))
    return m


@pytest.mark.parametrize("name", GRAPHS)
def test_appnp_trajectory_matches_jax(name):
    """3 epochs of APPNP at Cora's scale: the port's products and their
    backward walk K2's lists under the new units (``spmm_impl="pallas"``,
    the card's route; the plain versions here), the JAX package sums with
    ``segment_sum``."""
    src, dst = _edges(name)
    rng = np.random.RandomState(5)
    feats = rng.rand(N, 32).astype(np.float32)
    labels = rng.randint(0, CLASSES, N)
    jm = _appnp_stack(gt, gt.from_edges(src, dst, n_nodes=N,
                                        directed=False), feats)
    pm = _appnp_stack(tt, tt.from_edges(src, dst, n_nodes=N, directed=False,
                                        device="cpu"), feats, device="cpu")
    init = {k: np.asarray(v) for k, v in jm.init(3).items()}

    def tasks(pkg):
        return dict(train=pkg.NodeClassification(np.arange(140),
                                                 labels[:140]),
                    valid=pkg.NodeClassification(np.arange(200, 700),
                                                 labels[200:700]))

    jh = jm.train(**tasks(gt), epochs=3, patience=100, seed=7,
                  init_params=dict(init))
    ph = pm.train(**tasks(tt), epochs=3, patience=100, seed=7,
                  spmm_impl="pallas", init_params=dict(init))
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **TRAJ_TOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    outside = total = 0
    for k, v in jm.params.items():
        got, want = pm.params[k].detach().numpy(), np.asarray(v)
        np.testing.assert_allclose(got, want, rtol=0, atol=MAX_PARAM_DIFF)
        outside += int((~np.isclose(got, want, **TRAJ_TOL)).sum())
        total += want.size
    assert outside <= PARAM_OUTLIERS * total, (outside, total)


def _case(kind):
    """Edges (numpy) of a graph of 900 nodes: ``duplicates`` (a quarter of
    the edges twice, in no order), ``self_loops`` (a (row, col)-sorted graph
    with its self-loops appended), ``rcm`` (a band graph relabelled by
    ``rcm_order``), ``unsorted`` (random edges in random order)."""
    rng = np.random.RandomState(len(kind))
    n = 900
    src, dst = rng.randint(0, n, 6000), rng.randint(0, n, 6000)
    if kind == "duplicates":
        src = np.concatenate([src, src[:1500]])
        dst = np.concatenate([dst, dst[:1500]])
        order = rng.permutation(len(src))
        return src[order], dst[order], n
    if kind == "self_loops":
        g = tt.add_self_loops(tt.from_edges(src, dst, n_nodes=n,
                                            device="cpu"))
        return g.row.numpy(), g.col.numpy(), n
    if kind == "rcm":
        dst = (src + rng.randint(-30, 30, len(src))) % n
        g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
        g, _ = tt.permute_graph(g, tt.rcm_order(g))
        return g.row.numpy(), g.col.numpy(), n
    return src, dst, n


@pytest.mark.parametrize("tile", [256, 64])
@pytest.mark.parametrize("kind", ["duplicates", "self_loops", "rcm",
                                  "unsorted"])
def test_graph_lists_bit_equal_to_the_layouts_lists(kind, tile):
    """``graph_lists`` (two stable sorts of the edges) equals
    ``edge_lists(block_coo(...))`` bit for bit, whatever the window and the
    chunk size, and ``blocked_layout`` holds the same lists."""
    row, col, n = _case(kind)
    want = blocked.edge_lists(blocked.block_coo(
        row, col, n, window=128, tile=tile, block_edges=256))
    got = blocked.graph_lists(row, col, n, tile=tile)
    for w_list, g_list in zip(want, got):
        for a, b in zip(w_list, g_list):
            assert a.dtype == b.dtype == np.int32
            np.testing.assert_array_equal(a, b)
    graph = tt.Graph(torch.from_numpy(row), torch.from_numpy(col),
                     torch.ones(len(row)), n)
    prep = blocked.blocked_layout(graph, tile=tile)
    ref = blocked.BlockedSpMM(want, "cpu")
    for lst, r in ((prep.forward, ref.forward),
                   (prep.transposed, ref.transposed)):
        for field in ("ptr", "idx", "unit_row", "unit_edge", "split"):
            assert torch.equal(getattr(lst, field), getattr(r, field))
        assert (lst.eid is None) == (r.eid is None)
        assert lst.eid is None or torch.equal(lst.eid, r.eid)
