"""The port's scale-out on gloo ranks (``gnntf_tpu_torch/parallel``).

This file imports no JAX: its rank bodies run in spawned children, which
import only this module and the port.  ``tests/test_torch_parallel.py``
spawns them with the JAX package's results beside; the cases here hold the
port against itself (the single-device products and training, the
collectives' gradients, parameters equal across ranks).  Each test spawns
its ranks once and runs all of its cases in them.
"""
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.graph.coo import Graph
from gnntf_tpu_torch.ops.spmm import spmm_segment
from gnntf_tpu_torch.parallel.multihost import (free_port, launch_distributed,
                                                shutdown_distributed)


def _entry(rank, world, port, body, args, out_dir, launch):
    torch.set_num_threads(1)
    if launch:
        launch_distributed(f"localhost:{port}", num_processes=world,
                           process_id=rank, device="cpu")
    else:
        args = (port,) + args
    try:
        result = body(rank, *args)
    except BaseException:
        # a failed rank frees its groups without waiting for the others
        # (whose next collective then fails), then reports the error
        shutdown_distributed(barrier=False)
        raise
    torch.save(result, os.path.join(out_dir, f"{rank}.pt"))
    # the rank ends normally: shutdown_distributed, which launch_distributed
    # registered at exit, frees every group while the interpreter is live


_BIND_TRIES = 3


def spawn(world: int, body, *args, launch=True) -> list:
    """``body(rank, *args)`` on ``world`` gloo ranks of the CPU, the process
    group initialized by ``multihost.launch_distributed``; returns each
    rank's result.  With ``launch=False`` the body is called as ``body(rank,
    port, *args)`` and initializes the group itself.

    Rank 0 binds the rendezvous store on the port ``free_port`` gave.
    Another process may take that port first; only then (the store's bind
    failed with ``EADDRINUSE``) the ranks are spawned again on a fresh
    port.  A rank's process ends normally once its result is saved
    (``_entry``), through the port's shutdown at exit."""
    with tempfile.TemporaryDirectory() as out_dir:
        for attempt in range(_BIND_TRIES):
            try:
                mp.spawn(_entry, args=(world, free_port(), body, args,
                                       out_dir, launch), nprocs=world)
                break
            except mp.ProcessRaisedException as e:
                if "EADDRINUSE" not in str(e) or attempt + 1 == _BIND_TRIES:
                    raise
        return [torch.load(os.path.join(out_dir, f"{r}.pt"),
                           weights_only=False) for r in range(world)]


def random_graph(n, e, seed, hub=0):
    """A symmetrized random graph's (row, col, val) as numpy, with a source
    of degree ``hub`` when given (node 0)."""
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
    if hub:
        src = np.concatenate([np.zeros(hub, np.int64), src])
        dst = np.concatenate([rng.choice(n - 1, hub, replace=False) + 1,
                              dst])
    g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    val = rng.uniform(0.5, 1.5, g.n_edges).astype(np.float32)
    return g.row.numpy(), g.col.numpy(), val


def torch_graph(row, col, val, n, draw=None) -> Graph:
    """The port's graph of numpy arrays; ``draw=(salt, keep)`` makes it
    lazily dropped (every edge droppable)."""
    g = Graph(torch.from_numpy(np.asarray(row, np.int64)),
              torch.from_numpy(np.asarray(col, np.int64)),
              torch.from_numpy(np.asarray(val, np.float32)), n,
              sorted_by_row=True)
    if draw is not None:
        salt, keep = draw
        g = Graph(g.row, g.col, g.val, n, sorted_by_row=True,
                  drop_salt=torch.as_tensor(np.asarray(salt, np.int64)),
                  drop_keep=keep, drop_n=g.n_edges)
    return g


def products_body(rank, cases):
    """Each case's product and its ``x`` gradient (of ``sum(out * dy)``)
    through each executor, on a fresh mesh of the case's shape: a list of
    ``{(kind, mode): (out, dx)}`` with ``mode`` "realized" or "lazy"."""
    from gnntf_tpu_torch.parallel import (GspmdExecutor, HaloExecutor,
                                          RingExecutor, make_mesh)
    made = {"gspmd": GspmdExecutor, "halo": HaloExecutor,
            "ring": RingExecutor}
    results = []
    for case in cases:
        mesh = make_mesh(*case["mesh"])
        out = {}
        for kind in case["kinds"]:
            executor = made[kind](mesh)
            for mode, draw in (("realized", None),
                               ("lazy", case.get("draw"))):
                if mode == "lazy" and draw is None:
                    continue
                g = torch_graph(case["row"], case["col"], case["val"],
                                case["n"], draw)
                x = torch.from_numpy(case["x"]).requires_grad_()
                y = executor(g, x)
                (y * torch.from_numpy(case["dy"])).sum().backward()
                out[kind, mode] = (y.detach().numpy(), x.grad.numpy())
        results.append(out)
    return results


def mesh_of(shape):
    """The mesh of a run's ``mesh``: None, ``make_mesh(*shape)`` for a
    tuple, ``make_pod_mesh(1, **shape)`` for a dict."""
    from gnntf_tpu_torch.parallel import make_mesh, make_pod_mesh
    if not shape:
        return None
    if isinstance(shape, dict):
        return make_pod_mesh(1, **shape)
    return make_mesh(*shape)


def train_body(rank, runs):
    """Each run's ``fit`` on a mesh: ``(history, {name: param})``.  A run
    gives the graph, the features, the labels and split, the mesh shape,
    the model's keyword arguments and ``fit``'s."""
    results = []
    for run in runs:
        mesh = mesh_of(run["mesh"])
        model = build_model(run)
        hist = model.train(*tasks(run), mesh=mesh, seed=0, **run["fit"])
        results.append((hist, {k: p.detach().clone()
                               for k, p in model.params.items()}))
    return results


class EyeGCNLayer(tt.GCNLayer):
    """A GCN layer whose adjacency adds the identity ``before`` or
    ``after`` normalization (the JAX package's
    ``tests/test_dropgrids.py`` layers)."""

    def build(self, net, outputs, add_eye="after", **kw):
        self.add_eye = add_eye
        return super().build(net, outputs, **kw)

    def apply(self, fw, x):
        adj = fw.adjacency(self.graph_dropout, add_eye=self.add_eye)
        y = fw.spmm(adj, torch.matmul(x, fw.param(self.W)))
        if self.b is not None and self.add_eye == "after":
            y = y + fw.param(self.b)
        return fw.dropout(self.activation(y), self.dropout_rate)


def build_model(run):
    """The run's model on the CPU: ``APPNP``, ``GAT``, ...; ``stack`` (APPNP
    without dropout, as the JAX parity tests build it); ``eye_before`` or
    ``eye_after`` (two :class:`EyeGCNLayer` with dropout)."""
    g = torch_graph(run["row"], run["col"], run["val"], run["n"])
    kind, kw = run.get("model", "APPNP"), run["model_kw"]
    if kind == "stack":
        return stack(tt, g, run["features"], kw["num_classes"],
                     device="cpu")
    if kind.startswith("eye_"):
        m = tt.GNN(g, run["features"], device="cpu")
        m.add(EyeGCNLayer(16, add_eye=kind[4:], graph_dropout=0.5,
                          dropout=0.5))
        m.add(EyeGCNLayer(kw["num_classes"], add_eye=kind[4:],
                          activation=lambda v: v, graph_dropout=0.5))
        return m
    return getattr(tt, kind)(g, run["features"], device="cpu", **kw)


def stack(pkg, graph, feats, classes, iterations=3, **kw):
    """APPNP's layers without its dropouts, in either package."""
    relu = torch.relu if pkg is tt else __import__("jax").nn.relu
    m = pkg.GNN(graph, feats, **kw)
    m.add(pkg.Dense(16, activation=relu))
    h0 = m.add(pkg.Dense(classes, regularize=False))
    for _ in range(iterations):
        m.add(pkg.PPRIteration(h0, 0.1, graph_dropout=0.0))
    return m


def tasks(run):
    labels, train, valid = run["labels"], run["train"], run["valid"]
    return (tt.NodeClassification(train, labels[train]),
            tt.NodeClassification(valid, labels[valid]))


def case(n=96, e=300, f=8, seed=0, mesh=(4, 1), hub=0,
         kinds=("gspmd", "halo", "ring"), keep=0.7):
    row, col, val = random_graph(n, e, seed, hub)
    rng = np.random.RandomState(seed + 1)
    return dict(n=n, row=row, col=col, val=val, mesh=mesh, kinds=kinds,
                x=rng.randn(n, f).astype(np.float32),
                dy=rng.randn(n, f).astype(np.float32),
                draw=((int(rng.randint(1 << 31)), int(rng.randint(1 << 31))),
                      keep))


def single(c, mode):
    """The single-device product and ``x`` gradient of a case."""
    g = torch_graph(c["row"], c["col"], c["val"], c["n"],
                    c["draw"] if mode == "lazy" else None)
    x = torch.from_numpy(c["x"]).requires_grad_()
    y = spmm_segment(g, x)
    (y * torch.from_numpy(c["dy"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def test_executors_match_single_device_products():
    """Every executor at 2 and 4 ranks (and on a 2x2 mesh), realized and
    under a lazy draw: the product and its ``x`` gradient equal the
    single-device ones within ``rtol=1e-5, atol=1e-6``, and every rank
    holds the same replicated result bit for bit."""
    cases4 = [case(seed=1), case(seed=2, hub=60, n=200, e=500),
              case(seed=3, mesh=(2, 2))]
    for world, cases in ((4, cases4), (2, [case(seed=4, mesh=(2, 1))])):
        per_rank = spawn(world, products_body, cases)
        for i, c in enumerate(cases):
            for (kind, mode), (out, dx) in per_rank[0][i].items():
                want_out, want_dx = single(c, mode)
                np.testing.assert_allclose(out, want_out, rtol=1e-5,
                                           atol=1e-6, err_msg=kind + mode)
                np.testing.assert_allclose(dx, want_dx, rtol=1e-5,
                                           atol=1e-6, err_msg=kind + mode)
                for other in per_rank[1:]:
                    assert np.array_equal(other[i][kind, mode][0], out)
                    assert np.array_equal(other[i][kind, mode][1], dx)


def appnp_run(mesh, spmm=None, n=120, e=400, seed=5, min_edges=None,
              **fit_kw):
    """An APPNP run of 3 epochs with dropout on (edge dropout eager, or
    lazy under ``min_edges``) on a small random graph."""
    row, col, val = random_graph(n, e, seed)
    rng = np.random.RandomState(seed + 2)
    return dict(row=row, col=col, val=np.ones_like(val), n=n, mesh=mesh,
                features=rng.rand(n, 12).astype(np.float32),
                labels=rng.randint(0, 3, n), train=np.arange(40),
                valid=np.arange(40, 90), min_edges=min_edges,
                model_kw=dict(num_classes=3, iterations=3),
                fit=dict(dict(epochs=3, spmm=spmm), **fit_kw))


def fit_body(rank, runs):
    """:func:`train_body` with each run's ``min_edges_scope``."""
    from gnntf_tpu_torch.ops.stochastic import min_edges_scope
    out = []
    for run in runs:
        scope = min_edges_scope(run["min_edges"]) \
            if run["min_edges"] is not None else None
        if scope is None:
            out += train_body(rank, [run])
        else:
            with scope:
                out += train_body(rank, [run])
    return out


def test_fit_on_mesh_matches_single_device_with_dropout():
    """``fit(mesh=, spmm=)`` with dropout on, under each executor, eager
    edge masks and lazy draws: the losses equal the single-device run's
    within ``rtol=1e-5``, the same best epoch, and the parameters are equal
    bit for bit on every rank."""
    runs = [appnp_run((2, 1), spmm, min_edges=m)
            for m in (None, 0) for spmm in (None, "halo", "ring")]
    per_rank = spawn(2, fit_body, runs)
    for i, run in enumerate(runs):
        local = fit_body(0, [dict(run, mesh=None,
                                  fit=dict(run["fit"], spmm=None))])[0]
        hist, params = per_rank[0][i]
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(hist[key], local[0][key], rtol=1e-5)
        assert hist["best_epoch"] == local[0]["best_epoch"]
        for name, p in params.items():
            assert torch.equal(p, per_rank[1][i][1][name]), name


def sections_body(rank, sections):
    """Several bodies in one spawn: ``{name: body(rank, *args)}`` for each
    ``(name, body name, args)``, in order on every rank."""
    return {name: globals()[body](rank, *args)
            for name, body, args in sections}


def mesh_shapes_body(rank, graph):
    """``make_mesh``'s shapes over 8 ranks and its ``ValueError``, and this
    rank's ``shard_graph`` of ``graph`` (row, col, val) on a 4x2 mesh."""
    from gnntf_tpu_torch.parallel import make_mesh, shard_graph
    try:
        make_mesh(3, 2)
        raised = False
    except ValueError:
        raised = True
    mesh = make_mesh(4, 2)
    shard = shard_graph(torch_graph(*graph), mesh)
    return (mesh.shape, make_mesh().shape, raised,
            tuple(getattr(shard, f).numpy() for f in ("row", "col", "val")))


def train_step_body(rank, run, steps=8):
    """The losses of ``steps`` calls of ``make_distributed_train_step`` on
    the run's mesh, dropout on."""
    from gnntf_tpu_torch.parallel import (make_distributed_train_step,
                                          make_mesh)
    from gnntf_tpu_torch.train.trainer import keras_adam
    model = build_model(run)
    model.reset(seed=0)
    task = tasks(run)[0]
    tx = keras_adam(0.01)
    step = make_distributed_train_step(model, task, make_mesh(*run["mesh"]),
                                       tx)
    state, losses = tx.init(dict(model.params)), []
    for i in range(steps):
        state, loss = step(state, torch.Generator().manual_seed(i),
                           torch.tensor(1.0), task.batch())
        losses.append(float(loss))
    return losses


def eval_body(rank, run, params):
    """The clean forward of the run's model with ``params`` through
    ``make_distributed_eval`` on the run's mesh."""
    from gnntf_tpu_torch.parallel import make_distributed_eval, make_mesh
    model = build_model(run)
    tt.params_from_jax(params, model)
    return make_distributed_eval(model, make_mesh(*run["mesh"]))(
        model.features).numpy()


def collectives_body(rank):
    """Each collective's forward and the gradient it gives its input for a
    loss ``sum(out * w)`` with ``w`` known to every rank."""
    from gnntf_tpu_torch.parallel import collectives as c, make_mesh
    group = make_mesh().group("edge")
    size = dist.get_world_size()
    w = torch.arange(2.0 * size * 3).reshape(2 * size, 3)
    x = torch.full((2 * size, 3), rank + 1.0, requires_grad=True)
    out = {}
    for name, fn in (("all_reduce", lambda t: c.all_reduce(t, group)),
                     ("slice", lambda t: c.slice_of_replicated(t, group, 2)),
                     ("all_gather", lambda t: c.all_gather(t[:2], group)),
                     ("all_to_all", lambda t: c.all_to_all(t, group))):
        x.grad = None
        y = fn(x)
        (y * w[:y.shape[0]]).sum().backward()
        out[name] = (y.detach().numpy(), x.grad.numpy())
    return out


def test_collectives_forward_and_gradients():
    """The replicated model's gradients through each collective, at 2
    ranks: all-reduce passes its gradient through, a slice of a replicated
    tensor gathers every rank's block gradient, an all-gather keeps the
    own block's, an all-to-all sends each block's gradient back."""
    per_rank = spawn(2, collectives_body)
    w = np.arange(12.0).reshape(4, 3)
    for r, got in enumerate(per_rank):
        y, g = got["all_reduce"]
        assert np.array_equal(y, np.full((4, 3), 3.0))
        assert np.array_equal(g, w)
        y, g = got["slice"]
        assert np.array_equal(y, np.full((2, 3), r + 1.0))
        assert np.array_equal(g, np.concatenate([w[:2], w[:2]]))
        y, g = got["all_gather"]
        assert np.array_equal(y, np.repeat([[1.0], [2.0]], 2, 0)
                              * np.ones((4, 3)))
        want = np.zeros((4, 3))
        want[:2] = w[2 * r:2 * r + 2]
        assert np.array_equal(g, want)
        y, g = got["all_to_all"]
        assert np.array_equal(y, np.repeat([[1.0], [2.0]], 2, 0)
                              * np.ones((4, 3)))
        want = np.concatenate([w[2 * r:2 * r + 2]] * 2)
        assert np.array_equal(g, want)


def resume_body(rank, data, directory):
    """On a (2, 1) mesh under the halo executor, APPNP with dropout on:
    ``(straight, resumed)`` for the host loop and the fused path, each a
    ``(history's losses and best epoch, params)``: 6 epochs straight, and 3
    epochs with a checkpoint then a resume to 6."""
    from gnntf_tpu_torch.parallel import make_mesh
    src, dst, n, feats, labels = data
    mesh = make_mesh(2, 1)
    g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    model = tt.APPNP(g, feats, num_classes=3, iterations=3, device="cpu")
    task = (tt.NodeClassification(np.arange(80), labels[:80]),
            tt.NodeClassification(np.arange(80, 160), labels[80:160]))
    out = []
    for block in (1, 3):
        kw = dict(mesh=mesh, spmm="halo", seed=0, block_epochs=block)
        where = os.path.join(directory, f"rank{rank}-block{block}")

        def run(**more):
            hist = model.train(*task, **kw, **more)
            return ((hist["train_loss"], hist["valid_loss"],
                     hist["best_epoch"]),
                    {k: p.detach().clone() for k, p in model.params.items()})

        straight = run(epochs=6)
        first = run(epochs=3, checkpoint_dir=where, checkpoint_every=3)
        later = run(epochs=6, checkpoint_dir=where, checkpoint_every=3,
                    resume=True)
        joined = (first[0][0] + later[0][0], first[0][1] + later[0][1],
                  later[0][2])
        out.append((straight, (joined, later[1])))
    return out
