"""The port's multi-process scale-out (``gnntf_tpu_torch/parallel/
multihost.py``, ``hier_halo.py``, and the gspmd executor's edge-sharded
degrees and attention) against the JAX package and against one device.

The gloo ranks' bodies live in ``tests/test_torch_multihost_ranks.py`` (no
JAX there, so spawned children stay light).  Two spawns: 4 ranks running
the hierarchical halo executor on a 2 hosts x 2 chips mesh and the gspmd
executor on a (4, 1) mesh, and 2 processes started by
``launch_distributed`` with explicit arguments, each holding only its
``shard_graph_local`` slice of the edge list, as
``tests/test_multihost.py`` runs the JAX package's.  The JAX side runs in
this process on ``tests/conftest.py``'s 8 virtual CPU devices.

Held bit-equal: the hierarchical plan on every field, two identical runs.
Held ``rtol=1e-5`` (``atol=1e-6``): products and gradients against JAX and
one device, the fits' losses against one device; the degrees at
``rtol=1e-6`` (their partials add in another order); the 2-process losses
``rel=1e-6`` across processes, ``rtol=1e-5`` against one process and
``rel=1e-4`` against JAX's single-process steps.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu import parallel as jp
from gnntf_tpu_torch import parallel as tp

import test_torch_multihost_ranks as M
import test_torch_parallel_ranks as R
from test_torch_parallel import _jax_product

TOL = dict(rtol=1e-5, atol=1e-6)


def _hier_graph(n=96, e=700, seed=0, hub=False):
    """``tests/test_multihost.py::TestHierHalo._graph``'s edges."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, n, e)
    dst = rng.randint(0, n, e)
    if hub:  # one node referenced by everyone (forces hub replication)
        dst = np.where(rng.rand(e) < 0.4, 7, dst)
    val = rng.rand(e).astype(np.float32)
    return (gt.from_edges(src, dst, val, n_nodes=n, directed=False),
            tt.from_edges(src, dst, val, n_nodes=n, directed=False,
                          device="cpu"))


def _host_local_graph(n=96, e=300, seed=5):
    """Every edge inside one host's rows at 2 hosts: no cross-host edge."""
    rng = np.random.RandomState(seed)
    half = n // 2
    src = rng.randint(0, half, e) + half * (np.arange(e) % 2)
    dst = rng.randint(0, half, e) + half * (np.arange(e) % 2)
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu"))


_GRAPHS = {"plain": lambda: _hier_graph(),
           "hub": lambda: _hier_graph(hub=True, seed=3),
           "host_local": _host_local_graph}
_FIELDS = ("rows", "cols", "edge_slot", "base_val", "send_intra",
           "send_dcn", "redis", "hub_idx")
_SCALARS = ("s1", "s2", "s3", "hub_rows", "n_nodes", "n_edges", "n_hosts",
            "n_chips", "rows_per_part", "dcn_rows_per_device")


@pytest.mark.parametrize("shape", [(2, 4), (2, 2)], ids=["2x4", "2x2"])
@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_hier_partition_bit_equal(graph, shape):
    jg, pg = _GRAPHS[graph]()
    a = jp.build_hier_halo_partition(jg, *shape)
    b = tp.build_hier_halo_partition(pg, *shape)
    for f in _FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in _SCALARS:
        assert getattr(a, f) == getattr(b, f), f
    if graph == "hub":
        assert b.hub_rows > 0
    if graph == "host_local":
        assert b.s2 == 1 and not b.send_dcn.any()


@pytest.mark.parametrize("graph", sorted(_GRAPHS))
def test_hier_dcn_rows_within_the_flat_plan(graph):
    _, pg = _GRAPHS[graph]()
    hier = tp.build_hier_halo_partition(pg, 2, 4)
    flat = tp.build_halo_partition(pg, 8)
    assert hier.dcn_rows_per_device <= flat.n_parts * flat.halo_size


def test_hier_rank_tables_are_what_the_exchange_fills():
    """``hier_rank_table``'s remote tables walked by each partition's lists
    give one device's product (the tables chip_smoke builds in one
    process)."""
    from gnntf_tpu_torch.parallel.dist import walk_or_zeros
    from gnntf_tpu_torch.parallel.hier_halo import hier_lists, hier_rank_table
    _, pg = _hier_graph(hub=True, seed=3)
    part = tp.build_hier_halo_partition(pg, 2, 2)
    x = torch.from_numpy(np.random.RandomState(1).randn(pg.n_nodes, 5)
                         .astype(np.float32))
    val = pg.val.to(torch.float32)
    nr = part.rows_per_part
    blocks = []
    for h in range(2):
        for c in range(2):
            lists = hier_lists(part, h, c, "cpu")
            own, table = hier_rank_table(part, x, h, c)
            assert table.shape[0] == part.table_rows
            blocks.append(walk_or_zeros(lists[0], 0, val, None, own, nr)
                          + walk_or_zeros(lists[1], 0, val, None, table, nr))
    want = tt.ops.spmm_segment(pg, x)
    np.testing.assert_allclose(torch.cat(blocks)[:pg.n_nodes].numpy(),
                               want.numpy(), **TOL)


# --- the 4-rank spawn ----------------------------------------------------

def _hier_cases():
    return [R.case(seed=41, n=160, e=600, f=8),
            R.case(seed=42, hub=80, n=256, e=700, f=5)]


def _hier_runs():
    return [R.appnp_run(M.HIER_MESH, "halo", min_edges=m) for m in (None, 0)]


def _attention_case(n=120, e=400, heads=2, feats=4, seed=43):
    row, col, val = R.random_graph(n, e, seed)
    rng = np.random.RandomState(seed + 1)
    gen = lambda *shape: rng.randn(*shape).astype(np.float32)
    return dict(row=row, col=col, val=val, n=n, h=gen(n, heads, feats),
                s_src=gen(n, heads), s_dst=gen(n, heads),
                w=gen(n, heads, feats), drop=0.4,
                salt=[int(rng.randint(1 << 31)), int(rng.randint(1 << 31))])


def _gat_runs():
    runs = []
    for m in (None, 0):
        run = R.appnp_run((4, 1), None, min_edges=m)
        run.update(model="GAT", model_kw=dict(num_classes=3, latent_dims=[8],
                                              heads=2))
        runs.append(run)
    return runs


def _sections4():
    return [("hier", "hier_body", (_hier_cases(), _hier_runs())),
            ("gspmd", "gspmd_body", (R.case(seed=44, n=160, e=600),
                                     _attention_case(), _gat_runs()))]


@pytest.fixture(scope="module")
def four():
    return R.spawn(4, M.sections_body, _sections4())


def _jax_hier_mesh():
    return jp.make_pod_mesh(1, n_edge_dcn=2, hierarchical=True,
                            devices=jax.devices()[:4])


def test_pod_mesh_shapes_and_errors(four):
    """``make_pod_mesh`` over 4 ranks as JAX's over 4 devices: its shapes
    (host-major, one host without ``torchrun``), its ``ValueError``s, and
    the hierarchical mesh's groups in the order ``p = h * C + c``."""
    devices = jax.devices()[:4]
    want = [jp.make_pod_mesh(devices=devices).shape,
            jp.make_pod_mesh(2, devices=devices).shape,
            _jax_hier_mesh().shape]
    for p, r in enumerate(four):
        hier = r["hier"]
        assert [dict(s) for s in hier["shapes"]] == [dict(s) for s in want]
        assert hier["errors"] == [True, True, True]
        assert hier["groups"] == (p % 2, p // 2, p)
        assert hier["hierarchical"]
    for bad in (dict(n_feat=3), dict(n_edge_dcn=3),
                dict(n_edge_dcn=2, n_edge_ici=3)):
        with pytest.raises(ValueError):
            jp.make_pod_mesh(devices=devices, **bad)


def _term_scales(c):
    """Per element of a case's product and of its ``x`` gradient, the sum
    of the magnitudes of the terms it adds (a dropped value is at most the
    base value over keep): float32 sums of them differ by order, so results
    are held to ``1e-5`` of it."""
    a = np.zeros((c["n"], c["n"]))
    np.add.at(a, (c["row"], c["col"]), np.abs(c["val"]) / c["draw"][1])
    return a @ np.abs(c["x"]), a.T @ np.abs(c["dy"])


@pytest.mark.parametrize("i", [0, 1], ids=["plain", "hub"])
@pytest.mark.parametrize("mode", ["realized", "lazy"])
def test_hier_halo_matches_jax_and_one_device(four, i, mode):
    """The hierarchical halo executor's product and ``x`` gradient against
    JAX's ``HaloExecutor`` on its hierarchical mesh and against one device
    (``rtol=1e-5``); every rank holds the same result."""
    c = _hier_cases()[i]
    out, dx = four[0]["hier"]["products"][i][mode][0]
    scales = _term_scales(c)
    for want in (_jax_product("halo", c, mode, _jax_hier_mesh()),
                 R.single(c, mode)):
        for got, ref, scale in zip((out, dx), want, scales):
            assert np.all(np.abs(got - ref) <= 1e-5 * scale), \
                np.abs(got - ref).max()
    for r in four[1:]:
        got = r["hier"]["products"][i][mode][0]
        assert np.array_equal(got[0], out) and np.array_equal(got[1], dx)


@pytest.mark.parametrize("i", [0, 1], ids=["plain", "hub"])
def test_hier_halo_lazy_equals_materialized(four, i):
    """A lazy draw through the hierarchical exchange equals its
    materialized realization through it and one device's product of that
    realization (``tests/test_dropgrids.py``'s check)."""
    c = _hier_cases()[i]
    lazy = four[0]["hier"]["products"][i]["lazy"][0]
    mat = four[0]["hier"]["products"][i]["materialized"]
    g = R.torch_graph(c["row"], c["col"], c["val"], c["n"], c["draw"])
    want = tt.ops.spmm_segment(g.materialized_dropout(),
                               torch.from_numpy(c["x"]))
    np.testing.assert_allclose(lazy[0], mat[0], **TOL)
    np.testing.assert_allclose(lazy[1], mat[1], **TOL)
    np.testing.assert_allclose(lazy[0], want.numpy(), **TOL)


def test_hier_halo_runs_are_bit_equal(four):
    """Two identical runs of each product and gradient are bit-equal on
    every rank (the phase-3 gradient adds in a fixed order)."""
    for r in four:
        for got in r["hier"]["products"]:
            for mode in ("realized", "lazy"):
                (a, da), (b, db) = got[mode]
                assert np.array_equal(a, b) and np.array_equal(da, db)


@pytest.mark.parametrize("i", [0, 1], ids=["eager", "lazy"])
def test_fit_on_hier_mesh_matches_one_device(four, i):
    """``fit(mesh=make_pod_mesh(hierarchical=True), spmm="halo")``, APPNP
    with dropout on (eager edge masks, or lazy draws under
    ``min_edges_scope(0)``): the losses within ``rtol=1e-5`` of one
    device's, the same best epoch, the parameters bit-equal on every
    rank."""
    _check_fit(four, "hier", _hier_runs(), i)


def _check_fit(four, section, runs, i):
    run = runs[i]
    local = R.fit_body(0, [dict(run, mesh=None,
                                fit=dict(run["fit"], spmm=None))])[0]
    hist, params = four[0][section]["fit"][i]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist[key], local[0][key], rtol=1e-5)
    assert hist["best_epoch"] == local[0]["best_epoch"]
    for r in four[1:]:
        for name, p in r[section]["fit"][i][1].items():
            assert np.array_equal(p.numpy(), params[name].numpy()), name


def test_shards_refused_by_halo_and_ring(four):
    """The halo and ring plans need the whole structure: an edge shard
    raises ``ValueError`` there, as does ``shard_graph_local`` given a
    count that does not divide the edge axis or does not fit the slice."""
    for p, r in enumerate(four):
        assert r["hier"]["shard_errors"] == [True, True, True, True]
        offset, total, held = r["hier"]["shard"]
        assert (offset, held) == (p * total // 4, total // 4)


@pytest.mark.parametrize("name", ["fixed", "eager", "lazy"])
def test_gspmd_degrees_from_each_slice(four, name):
    """The degrees under gspmd, each rank's partial over its slice summed
    over the ranks, equal one device's within ``rtol=1e-6``."""
    want = M.all_degrees(R.case(seed=44, n=160, e=600))
    for r in four:
        for by in ("col", "row"):
            np.testing.assert_allclose(r["gspmd"]["degrees"][name, by],
                                       want[name, by], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["clean", "dropout"])
def test_gspmd_attention_from_each_slice(four, mode):
    """GAT's attention and its gradients under gspmd, each rank's A1-A4
    over its slice merged over the ranks, against one device's and JAX's
    segment path (``rtol=1e-5``)."""
    a = _attention_case()
    want = M.attention_of(a)[mode]
    jax_want = _jax_attention(a, mode)
    for r in four:
        got = r["gspmd"]["attention"][mode]
        for g, w, j in zip(got, want, jax_want):
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)


def _jax_attention(a, mode):
    from gnntf_tpu.ops import attention as ja
    jg = gt.add_self_loops(gt.Graph(jnp.asarray(a["row"]),
                                    jnp.asarray(a["col"]),
                                    jnp.asarray(a["val"]), a["n"],
                                    sorted_by_row=True))
    drop = a["drop"] if mode == "dropout" else 0.0
    kw = dict(negative_slope=0.2, attn_dropout=drop,
              salt=jnp.asarray(np.array(a["salt"], np.uint32))
              if drop else None, sorted_by_row=jg.sorted_by_row)
    w = jnp.asarray(a["w"])
    args = [jnp.asarray(a[k]) for k in ("h", "s_src", "s_dst")]
    fn = lambda *v: ja._gat_attention_segment(jg, *v, **kw)
    grads = jax.grad(lambda *v: jnp.sum(fn(*v) * w), argnums=(0, 1, 2))(
        *args)
    return [np.asarray(fn(*args))] + [np.asarray(g) for g in grads]


@pytest.mark.parametrize("i", [0, 1], ids=["segment", "lists"])
def test_fit_gat_on_gspmd_mesh_matches_one_device(four, i):
    """``fit(mesh=make_mesh(4, 1))`` trains GAT (every dropout on) with
    its attention from each rank's slice: the losses within ``rtol=1e-5``
    of one device's (the segment form, or the lists under
    ``min_edges_scope(0)``), the same best epoch."""
    _check_fit(four, "gspmd", _gat_runs(), i)


# --- 2 processes, each holding its slice alone ---------------------------

def _setup():
    """``tests/test_multihost.py``'s graph and split, and JAX's initial
    parameters of APPNP and of its layers without dropout."""
    from gnntf_tpu.data import synthetic_planetoid
    G, labels, features, train, _, _ = synthetic_planetoid(
        n_nodes=96, n_classes=3, n_features=16, avg_degree=5.0, seed=4)
    adj = gt.graph2adj(G)
    init = {
        "appnp": gt.APPNP(adj, features, num_classes=3,
                          iterations=3).init(0),
        "stack": R.stack(gt, adj, features, 3).init(0)}
    return dict(row=np.asarray(adj.row), col=np.asarray(adj.col),
                val=np.asarray(adj.val), n=adj.n_nodes, features=features,
                labels=np.asarray(labels), train=np.asarray(train),
                init={k: {n: np.asarray(v) for n, v in p.items()}
                      for k, p in init.items()})


@pytest.fixture(scope="module")
def two():
    setup = _setup()
    return setup, R.spawn(2, M.launch_body, setup, launch=False)


def _padded_graph(setup):
    """The whole edge list padded as the 2 processes' shards are, as one
    graph."""
    return M.shard_of(setup, 0, 1)[0]


def test_launch_distributed_two_processes(two):
    """``launch_distributed`` with explicit arguments brings up 2
    processes (again: nothing), ``make_pod_mesh`` lays them on one edge
    axis, and each holds only its half of the padded edge list."""
    setup, outs = two
    e_global = -(-len(setup["row"]) // 2) * 2
    for pid, o in enumerate(outs):
        assert o["multi"] and o["again"]
        assert dict(o["shape"]) == {"edge": 2, "feat": 1}
        assert o["shard"] == (pid * e_global // 2, e_global, e_global // 2)


@pytest.mark.parametrize("name", ["appnp", "stack", "gat"])
def test_shard_steps_match_single_process(two, name):
    """3 train steps on each process's ``shard_graph_local`` shard (APPNP
    with its dropouts, and without; GAT with its dropouts, its self-loops on
    the last shard and its attention from each shard): the losses agree
    across processes (``rel=1e-6``) and with one process over the whole
    padded list (``rtol=1e-5``)."""
    setup, outs = two
    model = M.models(setup, _padded_graph(setup))[name]
    want = M.local_steps(name, model, setup)
    for o in outs:
        assert o[name] == pytest.approx(outs[0][name], rel=1e-6)
        np.testing.assert_allclose(o[name], want, rtol=1e-5)


def test_shard_steps_match_jax_single_process(two):
    """Without dropout the shards' losses match JAX's single-process steps
    of ``tests/test_multihost.py``'s setup (``rel=1e-4``), and the
    distributed eval's forward equals one process's."""
    import optax
    from gnntf_tpu.train.trainer import _total_loss, keras_adam
    setup, outs = two
    adj = gt.Graph(jnp.asarray(setup["row"]), jnp.asarray(setup["col"]),
                   jnp.asarray(setup["val"]), setup["n"], sorted_by_row=True)
    model = R.stack(gt, adj, setup["features"], 3)
    task = gt.NodeClassification(setup["train"],
                                 setup["labels"][setup["train"]])
    tx = keras_adam(0.01)
    params = {k: jnp.asarray(v) for k, v in setup["init"]["stack"].items()}
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, rng):
        loss, grads = jax.value_and_grad(
            lambda p: _total_loss(model, task, p, model.features, rng,
                                  task.batch(), 5e-4))(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for i in range(3):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.PRNGKey(i))
        losses.append(float(loss))
    for o in outs:
        assert o["stack"] == pytest.approx(losses, rel=1e-4)
    local = M.models(setup, _padded_graph(setup))["stack"]
    M.local_steps("stack", local, setup)
    want = tp.make_eval_raw(local)(local.features).numpy()
    for o in outs:
        np.testing.assert_allclose(o["eval"], want, **TOL)
