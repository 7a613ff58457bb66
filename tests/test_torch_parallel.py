"""The port's scale-out (``gnntf_tpu_torch/parallel``) against the JAX
package's ``parallel/``: the same numpy inputs go to JAX's 8 virtual CPU
devices (``tests/conftest.py``) and to the port's gloo ranks, whose bodies
live in ``tests/test_torch_parallel_ranks.py`` (no JAX there, so spawned
children stay light).  The ranks are spawned twice, at 4 and at 8, each
running every case of its size; the tests read their results.

Held bit-equal: ``pad_graph``, ``param_shardings``' decisions, the halo
and ring partitions and the plans' id grids.  Held ``rtol=1e-5,
atol=1e-6``: the executors' products and ``x`` gradients, realized and
under a lazy draw (the masks bit-equal by global edge id), and the gspmd
forward.  Training without dropout under each executor against JAX's mesh
runs: ``rtol=1e-4``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu import parallel as jp
from gnntf_tpu_torch import parallel as tp
from gnntf_tpu_torch.parallel import dropgrids as tdg
from gnntf_tpu.parallel import dropgrids as jdg
from gnntf_tpu.parallel.ring import RingExecutor

import test_torch_parallel_ranks as R

TOL = dict(rtol=1e-5, atol=1e-6)


def jax_graph(row, col, val, n, draw=None):
    g = gt.Graph(jnp.asarray(row, jnp.int32), jnp.asarray(col, jnp.int32),
                 jnp.asarray(val, jnp.float32), n, sorted_by_row=True)
    if draw is not None:
        salt, keep = draw
        g = dataclasses.replace(g, drop_salt=jnp.asarray(salt, jnp.uint32),
                                drop_keep=keep, drop_n=g.n_edges)
    return g


def hub_graph(n=1024, hub_deg=1000, e_rand=2000, seed=7):
    """``tests/test_parallel.py::TestHaloSkew._hub_graph``'s edges."""
    rng = np.random.RandomState(seed)
    hub_dst = rng.choice(n - 1, hub_deg, replace=False) + 1
    src = np.concatenate([np.zeros(hub_deg, np.int64),
                          rng.randint(0, n, e_rand)])
    dst = np.concatenate([hub_dst, rng.randint(0, n, e_rand)])
    return src, dst, n


def both(src, dst, n):
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu"))


# --- host-side layouts, bit-equal --------------------------------------

@pytest.mark.parametrize("multiple", [1, 3, 8])
def test_pad_graph_bit_equal(multiple):
    rng = np.random.RandomState(multiple)
    src, dst = rng.randint(0, 50, 101), rng.randint(0, 50, 101)
    jg, pg = both(src, dst, 50)
    jg, pg = gt.add_self_loops(jg), tt.add_self_loops(pg)
    a, b = jp.pad_graph(jg, multiple), tp.pad_graph(pg, multiple)
    if multiple == 1:
        assert b is pg
    for f in ("row", "col", "val"):
        assert np.array_equal(np.asarray(getattr(a, f)),
                              getattr(b, f).numpy()), f
    assert (a.n_edges, a.num_self_loop, a.sorted_by_row) == \
        (b.n_edges, b.num_self_loop, b.sorted_by_row)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2), (2, 4), (1, 8)])
def test_param_shardings_decisions_match_jax(shape):
    class _Mesh:  # param_shardings reads the axis sizes only
        def __init__(self, shape):
            self.shape = dict(zip(("edge", "feat"), shape))

    rng = np.random.RandomState(0)
    jg, pg = both(rng.randint(0, 40, 90), rng.randint(0, 40, 90), 40)
    feats = rng.rand(40, 16).astype(np.float32)
    for cls, kw in (("APPNP", dict(latent_dims=(64,))), ("GCN", {}),
                    ("GAT", dict(latent_dims=(8,), heads=2))):
        jm = getattr(gt, cls)(jg, feats, num_classes=4, **kw)
        pm = getattr(tt, cls)(pg, feats, num_classes=4, device="cpu", **kw)
        want = {k: tuple(a for a in s.spec if a is not None)
                for k, s in jp.param_shardings(
                    jm, jp.make_mesh(*shape)).items()}
        assert tp.param_shardings(pm, _Mesh(shape)) == want


def _partitions():
    rng = np.random.RandomState(11)
    small = rng.randint(0, 300, 900), rng.randint(0, 300, 900), 300
    return [(small, p, {}) for p in (2, 4, 8)] + [
        (hub_graph(), 8, {}), (hub_graph(), 8, dict(halo_cap=8)),
        (hub_graph(), 4, dict(hub_fanout=0, halo_cap=None)),
        (hub_graph(), 8, dict(max_hubs=1))]


@pytest.mark.parametrize("graph,parts,kw", _partitions())
def test_halo_partition_bit_equal(graph, parts, kw):
    jg, pg = both(*graph)
    a = jp.build_halo_partition(jg, parts, **kw)
    b = tp.build_halo_partition(pg, parts, **kw)
    for f in ("rows", "cols", "edge_slot", "base_val", "send_idx",
              "hub_idx"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("halo_size", "hub_rows", "halo_bytes_per_device", "n_nodes",
              "n_edges", "rows_per_part"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("parts", [2, 4, 8])
def test_ring_partition_and_grids_bit_equal(parts):
    jg, pg = both(*hub_graph())
    a = jp.build_ring_partition(jg, parts)
    b = tp.build_ring_partition(pg, parts)
    for f in ("rows", "cols", "edge_slot", "base_val"):
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert np.array_equal(np.asarray(a.vals), b.vals)
    for jplan, pplan in ((a, b), (jp.build_halo_partition(jg, parts),
                                  tp.build_halo_partition(pg, parts))):
        jv, je = jdg.plan_value_grids(jplan, jg, jplan.rows.shape)
        pv, pe = tdg.plan_value_grids(pplan, pg, pplan.rows.shape)
        assert np.array_equal(je, pe) and je.dtype == pe.dtype
        assert np.array_equal(np.asarray(jv), pv.numpy())


# --- products and training on the ranks --------------------------------

def _cases4():
    return [R.case(seed=21, n=160, e=600, f=8),
            R.case(seed=22, hub=80, n=256, e=700, f=5)]


def _cases8():
    return [R.case(seed=23, n=200, e=700, f=8, mesh=(8, 1),
                   kinds=("halo", "ring")),
            R.case(seed=24, hub=120, n=300, e=800, f=8, mesh=(8, 1),
                   kinds=("halo", "ring"))]


def _setup():
    from gnntf_tpu.data import synthetic_planetoid
    G, labels, features, train, valid, _ = synthetic_planetoid(
        n_nodes=160, n_classes=4, n_features=32, avg_degree=6.0, seed=21)
    adj = gt.graph2adj(G)
    return dict(row=np.asarray(adj.row), col=np.asarray(adj.col),
                val=np.asarray(adj.val), n=adj.n_nodes, features=features,
                labels=labels, train=np.asarray(train),
                valid=np.asarray(valid))


def _run(setup, mesh, model="stack", fit=(), **model_kw):
    return dict(setup, mesh=mesh, model=model, min_edges=None,
                model_kw=dict(dict(num_classes=4), **model_kw),
                fit=dict(dict(patience=10, epochs=6), **dict(fit)))


def _jax_init(setup):
    m = R.stack(gt, gt.Graph(jnp.asarray(setup["row"]),
                             jnp.asarray(setup["col"]),
                             jnp.asarray(setup["val"]), setup["n"],
                             sorted_by_row=True), setup["features"], 4)
    return m, {k: np.asarray(v) for k, v in m.init(0).items()}


_TRAIN_MESH = {None: (4, 2), "halo": (8, 1), "ring": (8, 1)}


def _sections8(setup, init, appnp_params):
    trains = [_run(setup, _TRAIN_MESH[s], fit=dict(spmm=s,
                                                   init_params=init))
              for s in (None, "halo", "ring")]
    learn = [_run(setup, (4, 2), "GAT", fit=dict(epochs=8),
                  latent_dims=[8], heads=2),
             _run(setup, (8, 1), "GAT", fit=dict(epochs=6, spmm="halo"),
                  latent_dims=[8], heads=2),
             _run(setup, (8, 1), "eye_after", fit=dict(epochs=10,
                                                       spmm="halo")),
             _run(setup, (8, 1), "eye_before", fit=dict(epochs=10,
                                                        spmm="halo"))]
    fused = [_run(setup, mesh, "APPNP", fit=dict(spmm=s, block_epochs=b),
                  iterations=3)
             for mesh, s in (((8, 1), "halo"), ((4, 2), None))
             for b in (1, 3)]
    evals = _run(setup, (4, 2), "APPNP", iterations=3)
    return [("shapes", "mesh_shapes_body", (_padded_case(),)),
            ("products", "products_body", (_cases8(),)),
            ("eval", "eval_body", (evals, appnp_params)),
            ("step", "train_step_body", (evals,)),
            ("train", "train_body", (trains,)),
            ("learn", "train_body", (learn,)),
            ("fused", "train_body", (fused,))]


@pytest.fixture(scope="module")
def ranks():
    """The results of one spawn at 4 ranks and one at 8, with the inputs
    they were given."""
    setup = _setup()
    _, init = _jax_init(setup)
    jm = gt.APPNP(gt.Graph(jnp.asarray(setup["row"]),
                           jnp.asarray(setup["col"]),
                           jnp.asarray(setup["val"]), setup["n"],
                           sorted_by_row=True), setup["features"],
                  num_classes=4, iterations=3)
    appnp_params = {k: np.asarray(v) for k, v in jm.init(0).items()}
    sections8 = _sections8(setup, init, appnp_params)
    four = R.spawn(4, R.products_body, _cases4())
    eight = R.spawn(8, R.sections_body, sections8)
    return dict(setup=setup, init=init, appnp=(jm, appnp_params),
                four=four, eight=eight, sections8=dict(
                    (name, args) for name, _, args in sections8))


def _jax_product(kind, c, mode, mesh):
    draw = c["draw"] if mode == "lazy" else None
    g = jax_graph(c["row"], c["col"], c["val"], c["n"], draw)
    ex = (jp.HaloExecutor if kind == "halo" else RingExecutor)(mesh)

    @jax.jit
    def run(x, dy):
        out, vjp = jax.vjp(lambda x: ex(g, x), x)
        return out, vjp(dy)[0]

    return tuple(map(np.asarray, run(jnp.asarray(c["x"]),
                                     jnp.asarray(c["dy"]))))


def _check_products(per_rank, cases, mesh):
    for i, c in enumerate(cases):
        for (kind, mode), (out, dx) in per_rank[0][i].items():
            if kind == "gspmd":
                want = R.single(c, mode)
            else:
                want = _jax_product(kind, c, mode, mesh)
            np.testing.assert_allclose(out, want[0], err_msg=kind + mode,
                                       **TOL)
            np.testing.assert_allclose(dx, want[1], err_msg=kind + mode,
                                       **TOL)
            for other in per_rank[1:]:
                assert np.array_equal(other[i][kind, mode][1], dx)


def test_products_match_jax_at_4_ranks(ranks):
    _check_products(ranks["four"], _cases4(), jp.make_mesh(
        4, 1, devices=jax.devices()[:4]))


def test_products_match_jax_at_8_ranks(ranks):
    _check_products([r["products"] for r in ranks["eight"]], _cases8(),
                    jp.make_mesh(8, 1))


def test_lazy_masks_bit_equal_by_global_id():
    """The mask the masked walk hashes for a rank's global ids equals the
    JAX package's on the plan's id grid."""
    from gnntf_tpu.ops.stochastic import keep_mask as jax_mask
    from gnntf_tpu_torch.ops.stochastic import keep_mask
    jg, pg = both(*hub_graph())
    plan = tp.build_halo_partition(pg, 8)
    eid, live = tdg.slot_ids(plan, plan.rows.shape)
    salt = (123456789, 987654321)
    want = np.asarray(jax_mask(jnp.asarray(eid), jnp.asarray(
        salt, jnp.uint32), 0.7, plan.n_edges))
    got = keep_mask(torch.from_numpy(eid.astype(np.int64)),
                    torch.tensor(salt), 0.7, plan.n_edges).numpy()
    assert np.array_equal(want[live], got[live])


def _padded_case():
    """A graph of 101 edges (not a multiple of 4) as (row, col, val, n)."""
    rng = np.random.RandomState(5)
    return (np.sort(rng.randint(0, 30, 101)), rng.randint(0, 30, 101),
            rng.rand(101).astype(np.float32), 30)


def test_mesh_shapes(ranks):
    """``make_mesh`` as JAX's: its shapes and its ``ValueError``; the
    ``edge`` ranks' shards of a graph, in order, are JAX's ``pad_graph``
    (a rank's ``feat`` neighbour holds the same shard)."""
    shards = []
    for shape, default, raised, shard in (r["shapes"]
                                          for r in ranks["eight"]):
        assert shape == {"edge": 4, "feat": 2}
        assert default == {"edge": 8, "feat": 1}
        assert raised
        shards.append(shard)
    assert jp.make_mesh(4, 2).shape == {"edge": 4, "feat": 2}
    row, col, val, n = _padded_case()
    want = jp.pad_graph(jax_graph(row, col, val, n), 4)
    for i, f in enumerate(("row", "col", "val")):
        assert np.array_equal(np.concatenate([s[i] for s in shards[::2]]),
                              np.asarray(getattr(want, f)))
        for a, b in zip(shards[::2], shards[1::2]):
            assert np.array_equal(a[i], b[i])


def test_gspmd_forward_matches_distributed_eval(ranks):
    jm, params = ranks["appnp"]
    mesh = jp.make_mesh(4, 2)
    sharded = jp.shard_graph(jm.graph, mesh)
    want = np.asarray(jp.make_distributed_eval(jm, mesh, sharded)(
        params, jm.features, sharded))
    for r in ranks["eight"]:
        np.testing.assert_allclose(r["eval"], want, **TOL)


def test_distributed_train_step_runs_and_learns(ranks):
    """``make_distributed_train_step`` on a 4x2 mesh, APPNP with dropout:
    the loss falls over 8 steps (``tests/test_parallel.py``'s test), the
    same on every rank."""
    losses = ranks["eight"][0]["step"]
    assert losses[-1] < losses[0], losses
    assert all(r["step"] == losses for r in ranks["eight"])


@pytest.mark.parametrize("spmm", [None, "halo", "ring"])
def test_training_matches_jax_mesh_runs(ranks, spmm):
    """The APPNP stack without dropout from JAX's initial parameters: the
    histories of ``fit(mesh=, spmm=)`` equal JAX's mesh runs' within
    ``rtol=1e-4``; the parameters are equal on every rank."""
    setup, init = ranks["setup"], ranks["init"]
    jm, _ = _jax_init(setup)
    tr = gt.NodeClassification(setup["train"],
                               setup["labels"][setup["train"]])
    va = gt.NodeClassification(setup["valid"],
                               setup["labels"][setup["valid"]])
    want = jm.train(tr, va, patience=10, epochs=6, seed=0,
                    init_params=dict(init), mesh=jp.make_mesh(
                        *_TRAIN_MESH[spmm]), spmm=spmm)
    i = (None, "halo", "ring").index(spmm)
    hist, params = ranks["eight"][0]["train"][i]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(hist[key], want[key], rtol=1e-4)
    for r in ranks["eight"][1:]:
        for k, p in r["train"][i][1].items():
            assert torch.equal(p, params[k]), k


@pytest.mark.parametrize("i,what", [(0, "GAT under gspmd"),
                                    (1, "GAT under halo"),
                                    (2, "add_eye after through halo"),
                                    (3, "add_eye before through halo")])
def test_models_learn_on_the_mesh(ranks, i, what):
    hist, _ = ranks["eight"][0]["learn"][i]
    assert np.isfinite(hist["train_loss"]).all(), what
    if i != 1:
        assert hist["valid_loss"][-1] < hist["valid_loss"][0], what


@pytest.mark.parametrize("i", [0, 1], ids=["halo", "gspmd"])
def test_fused_matches_per_epoch_on_the_mesh(ranks, i):
    """``fit(mesh=, block_epochs=3)`` against ``block_epochs=1``, APPNP
    with dropout on: equal histories (JAX's test holds 2e-3)."""
    per_epoch, fused = ranks["eight"][0]["fused"][2 * i:2 * i + 2]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(fused[0][key], per_epoch[0][key],
                                   rtol=1e-5)


def test_forward_graph_override_matches_jax():
    """``Network.forward(graph=)`` (the JAX package's ``apply(graph=)``):
    the forward of a model bound to one graph, run over another, equals
    JAX's and the forward of the model bound to the other graph."""
    rng = np.random.RandomState(9)
    feats = rng.rand(60, 12).astype(np.float32)
    (jg1, pg1), (jg2, pg2) = (both(rng.randint(0, 60, 150),
                                   rng.randint(0, 60, 150), 60)
                              for _ in range(2))
    jm = gt.APPNP(jg1, feats, num_classes=3, iterations=3)
    params = {k: np.asarray(v) for k, v in jm.init(0).items()}
    want = np.asarray(jm.apply(params, jm.features, graph=jg2))
    models = [tt.APPNP(g, feats, num_classes=3, iterations=3, device="cpu")
              for g in (pg1, pg2)]
    for m in models:
        tt.params_from_jax(params, m)
    with torch.no_grad():
        got = models[0].forward(models[0].features, graph=pg2)
        bound = models[1].forward(models[1].features)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert torch.equal(got, bound)
