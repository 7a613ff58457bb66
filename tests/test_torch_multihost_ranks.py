"""Rank bodies of the port's multi-process scale-out
(``gnntf_tpu_torch/parallel/multihost.py``, ``hier_halo.py`` and the gspmd
executor's edge-sharded degrees and attention), run on gloo ranks of the
CPU by ``tests/test_torch_multihost.py``, which holds their results
against the JAX package and against one device.

This file imports no JAX (spawned children import it and the port only);
its one test checks that the port's new modules import none either.
"""
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.graph.coo import Graph

import test_torch_parallel_ranks as R

HIER_MESH = dict(n_edge_dcn=2, hierarchical=True)


def raises(fn, kind=ValueError) -> bool:
    try:
        fn()
    except kind:
        return True
    return False


def product(executor, c, mode, materialize=False):
    """``executor``'s product of a case's graph (``mode`` "realized" or
    "lazy"; ``materialize`` folds the lazy draw into values first) and its
    ``x`` gradient of ``sum(out * dy)``."""
    g = R.torch_graph(c["row"], c["col"], c["val"], c["n"],
                      c["draw"] if mode == "lazy" else None)
    if materialize:
        g = g.materialized_dropout()
    x = torch.from_numpy(c["x"]).requires_grad_()
    y = executor(g, x)
    (y * torch.from_numpy(c["dy"])).sum().backward()
    return y.detach().numpy(), x.grad.numpy()


def hier_body(rank, cases, runs):
    """On 4 ranks as 2 hosts x 2 chips: the mesh's shapes and errors; each
    case's product and gradient through the hierarchical halo executor,
    realized and lazy, each twice with a fresh executor, and the lazy
    draw's materialized values through it; ``runs``' fits on the
    hierarchical mesh."""
    from gnntf_tpu_torch.parallel import (HaloExecutor, RingExecutor,
                                          make_mesh, make_pod_mesh,
                                          shard_graph_local)
    from gnntf_tpu_torch.parallel.hier_halo import hier_groups
    out = dict(
        shapes=[make_pod_mesh().shape, make_pod_mesh(2).shape,
                make_pod_mesh(1, **HIER_MESH).shape],
        errors=[raises(lambda: make_pod_mesh(3)),
                raises(lambda: make_pod_mesh(1, n_edge_dcn=3)),
                raises(lambda: make_pod_mesh(1, n_edge_dcn=2,
                                             n_edge_ici=3))])
    mesh = make_pod_mesh(1, **HIER_MESH)
    edge, host, both = hier_groups(mesh)
    out["groups"] = (dist.get_rank(edge), dist.get_rank(host),
                     dist.get_rank(both))
    out["hierarchical"] = HaloExecutor(mesh).hierarchical
    out["products"] = []
    for c in cases:
        got = {mode: [product(HaloExecutor(mesh), c, mode) for _ in range(2)]
               for mode in ("realized", "lazy")}
        got["materialized"] = product(HaloExecutor(mesh), c, "lazy", True)
        out["products"].append(got)
    # an edge shard: the halo and ring plans need the whole structure
    flat = make_mesh(4, 1)
    c = cases[0]
    e = len(c["row"]) - len(c["row"]) % 4
    per = e // 4
    local = Graph(*(torch.from_numpy(np.asarray(a[rank * per:(rank + 1) *
                                                  per]))
                    for a in (c["row"], c["col"], c["val"])), c["n"])
    shard = shard_graph_local(local, flat, e, c["n"])
    x = torch.from_numpy(c["x"])
    out["shard_errors"] = [
        raises(lambda: HaloExecutor(flat)(shard, x)),
        raises(lambda: RingExecutor(flat)(shard, x)),
        raises(lambda: shard_graph_local(local, flat, e + 2, c["n"])),
        raises(lambda: shard_graph_local(local, flat, e + 4, c["n"]))]
    out["shard"] = (shard.edge_offset, shard.global_edges, shard.n_edges)
    out["fit"] = R.fit_body(rank, runs)
    return out


def degrees_of(graph, executor=None, by="col"):
    from gnntf_tpu_torch.ops.normalize import _degree
    from gnntf_tpu_torch.ops.spmm import spmm_executor
    if executor is None:
        return _degree(graph, by=by).numpy()
    with spmm_executor(executor):
        return _degree(graph, by=by).numpy()


def degree_graphs(c):
    """A case's graph fixed, eagerly dropped and lazily dropped (the
    drop under ``min_edges_scope(0)``), each by name."""
    from gnntf_tpu_torch.ops.normalize import edge_dropout
    from gnntf_tpu_torch.ops.stochastic import min_edges_scope
    g = R.torch_graph(c["row"], c["col"], c["val"], c["n"])
    eager = edge_dropout(g, 0.3, torch.Generator().manual_seed(5))
    with min_edges_scope(0):
        lazy = edge_dropout(g, 0.3, torch.Generator().manual_seed(6))
    return dict(fixed=g, eager=eager, lazy=lazy)


def all_degrees(c, executor=None):
    """Each graph of :func:`degree_graphs`' column and row sums."""
    from gnntf_tpu_torch.ops.stochastic import min_edges_scope
    out = {}
    with min_edges_scope(0):  # the lazy graph takes its walk
        for name, g in degree_graphs(c).items():
            for by in ("col", "row"):
                out[name, by] = degrees_of(g, executor, by)
    return out


def attention_of(a, executor=None):
    """GAT's attention over a case's self-looped graph, with and without
    attention dropout: ``{mode: (out, dh, ds_src, ds_dst)}`` for a loss
    ``sum(out * w)``."""
    from gnntf_tpu_torch.ops.attention import gat_attention
    from gnntf_tpu_torch.ops.spmm import spmm_executor
    g = tt.add_self_loops(R.torch_graph(a["row"], a["col"], a["val"],
                                        a["n"]))
    out = {}
    for mode, drop in (("clean", 0.0), ("dropout", a["drop"])):
        h, ss, sd = (torch.from_numpy(a[k]).requires_grad_()
                     for k in ("h", "s_src", "s_dst"))
        salt = torch.tensor(a["salt"]) if drop else None
        run = lambda: gat_attention(g, h, ss, sd, attn_dropout=drop,
                                    salt=salt)
        if executor is None:
            y = run()
        else:
            with spmm_executor(executor):
                y = run()
        (y * torch.from_numpy(a["w"])).sum().backward()
        out[mode] = (y.detach().numpy(), h.grad.numpy(), ss.grad.numpy(),
                     sd.grad.numpy())
    return out


def gspmd_body(rank, c, a, runs):
    """On a (4, 1) mesh under the gspmd executor: :func:`all_degrees` and
    :func:`attention_of` from each rank's slice, and ``runs``' fits."""
    from gnntf_tpu_torch.parallel import GspmdExecutor, make_mesh
    executor = GspmdExecutor(make_mesh(4, 1))
    return dict(degrees=all_degrees(c, executor),
                attention=attention_of(a, executor),
                fit=R.fit_body(rank, runs))


def sections_body(rank, sections):
    """``{name: body(rank, *args)}`` for each ``(name, body name, args)``
    of this file, in order on every rank."""
    return {name: globals()[body](rank, *args)
            for name, body, args in sections}


def shard_of(setup, pid, nproc):
    """Process ``pid``'s slice of the setup's edge list padded to a multiple
    of ``nproc`` (what the process is given to hold alone), as a graph, and
    the padded list's length."""
    e = len(setup["row"])
    e_global = -(-e // nproc) * nproc
    pad = lambda a, v: np.concatenate([a, np.full(e_global - e, v, a.dtype)])
    lo, hi = pid * e_global // nproc, (pid + 1) * e_global // nproc
    arrays = (pad(np.asarray(setup["row"], np.int64), 0),
              pad(np.asarray(setup["col"], np.int64), 0),
              pad(np.asarray(setup["val"], np.float32), 0))
    local = Graph(*(torch.from_numpy(a[lo:hi]) for a in arrays),
                  setup["n"], sorted_by_row=False)
    return local, e_global


def local_steps(name, model, setup, graph=None, mesh=None, steps=3):
    """``steps`` train steps (keras Adam at 0.01) of ``model`` from the
    setup's initial parameters (JAX's where it has them, else seed 0's),
    the draws of step i from a generator seeded i: their losses.  With a
    ``mesh`` through ``make_distributed_train_step`` over ``graph``, else
    ``make_train_step_raw``."""
    from gnntf_tpu_torch.parallel import (make_distributed_train_step,
                                          make_train_step_raw)
    from gnntf_tpu_torch.train.trainer import keras_adam
    if name in setup["init"]:
        tt.params_from_jax(setup["init"][name], model)
    else:
        model.reset(seed=0)
    task = tt.NodeClassification(setup["train"],
                                 setup["labels"][setup["train"]])
    tx = keras_adam(0.01)
    step = make_train_step_raw(model, task, tx) if mesh is None else \
        make_distributed_train_step(model, task, mesh, tx, graph=graph)
    state, losses = tx.init(dict(model.params)), []
    for i in range(steps):
        state, loss = step(state, torch.Generator().manual_seed(i),
                           torch.tensor(1.0), task.batch())
        losses.append(float(loss.detach()))
    return losses


def models(setup, graph):
    """APPNP with its dropouts, its layers with every dropout at 0
    (``R.stack``), and GAT with its dropouts, bound to ``graph``, by
    name."""
    return dict(appnp=tt.APPNP(graph, setup["features"], num_classes=3,
                               iterations=3, device="cpu"),
                stack=R.stack(tt, graph, setup["features"], 3,
                              device="cpu"),
                gat=tt.GAT(graph, setup["features"], num_classes=3,
                           latent_dims=[8], heads=2, device="cpu"))


def launch_body(pid, port, setup, nproc=2):
    """One of ``nproc`` processes started by ``launch_distributed`` with
    explicit arguments: it holds only its slice of the padded edge list,
    as ``shard_graph_local``'s shard, builds each model of :func:`models`
    on it and runs 3 train steps under gspmd; then the clean forward of
    ``make_distributed_eval`` over the shard."""
    from gnntf_tpu_torch.parallel import (launch_distributed,
                                          make_distributed_eval,
                                          make_pod_mesh, shard_graph_local)
    multi = launch_distributed(f"localhost:{port}", num_processes=nproc,
                               process_id=pid, device="cpu")
    again = launch_distributed(f"localhost:{port}", num_processes=nproc,
                               process_id=pid, device="cpu")
    mesh = make_pod_mesh(1)
    local, e_global = shard_of(setup, pid, nproc)
    shard = shard_graph_local(local, mesh, e_global, setup["n"])
    out = dict(multi=multi, again=again, shape=mesh.shape,
               shard=(shard.edge_offset, shard.global_edges, shard.n_edges))
    for name, model in models(setup, shard).items():
        out[name] = local_steps(name, model, setup, shard, mesh)
        if name == "stack":
            out["eval"] = make_distributed_eval(model, mesh, graph=shard)(
                model.features).numpy()
    return out


def test_new_modules_import_no_jax():
    """The multi-process modules, imported alone, pull in no JAX and
    nothing of the JAX package."""
    code = ("import sys; import gnntf_tpu_torch.parallel.multihost, "
            "gnntf_tpu_torch.parallel.hier_halo, "
            "gnntf_tpu_torch.parallel.dist; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'gnntf_tpu')]; print(bad); "
            "sys.exit(1 if bad else 0)")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
