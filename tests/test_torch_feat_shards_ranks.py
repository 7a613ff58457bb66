"""Rank bodies of ``tests/test_torch_feat_shards.py``: ``fit(mesh=)`` with
the hidden weights column-sharded over the ``feat`` axis
(``parallel.dist.place_state``), on gloo ranks of the CPU.  This file
imports no JAX, so the spawned children stay light; the tests themselves
hold these ranks' results against one device and the JAX package.
"""
import os

import numpy as np
import torch

from gnntf_tpu_torch.parallel import dist as pdist
from gnntf_tpu_torch.train.trainer import KerasAdam

import test_torch_parallel_ranks as R


class RecordingAdam(KerasAdam):
    """``KerasAdam`` that keeps the shapes of the parameters it is made on
    and of its moments, as a rank holds them during ``fit``."""

    def init(self, params):
        state = super().init(params)
        self.shapes = {k: tuple(p.shape) for k, p in params.items()}
        self.moments = {k: tuple(t.shape) for part in ("m", "v")
                        for k, t in state[part].items()}
        self.held = {k: tuple(t.shape) for k, t in state["m"].items()}
        return state


def _replicated(model, mesh):
    return {spec.name: () for spec in model.param_specs}


def fit_run(rank, run):
    """One run of ``run`` on its mesh: the history, the whole parameters
    after ``fit``, the shapes a rank held during it (parameters and
    moments), whether ``fit`` left the model unsharded, and the model's
    parameter shapes.  ``run["replicated"]`` keeps every parameter whole
    (``param_shardings`` replaced), ``run["checkpoint"]`` a directory that
    rank 0 writes its checkpoints to (the others to their own)."""
    mesh = R.mesh_of(run["mesh"])
    model = R.build_model(run)
    tx = RecordingAdam(0.01)
    fit_kw = dict(run["fit"])
    if run.get("checkpoint"):
        fit_kw["checkpoint_dir"] = os.path.join(run["checkpoint"],
                                                f"rank{rank}")
    original = pdist.param_shardings
    if run.get("replicated"):
        pdist.param_shardings = _replicated
    try:
        hist = model.train(*R.tasks(run), mesh=mesh, seed=0, optimizer=tx,
                           **fit_kw)
    finally:
        pdist.param_shardings = original
    return dict(hist=hist,
                params={k: p.detach().clone()
                        for k, p in model.params.items()},
                held=tx.shapes, moments=tx.held,
                unsharded=model.shards is None,
                whole={s.name: s.shape for s in model.param_specs})


def shards_body(rank, runs):
    return [fit_run(rank, run) for run in runs]


def appnp(mesh, **kw):
    """APPNP (dropout on, eager edge masks) on a small random graph."""
    row, col, val = R.random_graph(120, 400, 5)
    rng = np.random.RandomState(7)
    return dict(row=row, col=col, val=np.ones_like(val), n=120, mesh=mesh,
                features=rng.rand(120, 12).astype(np.float32),
                labels=rng.randint(0, 3, 120), train=np.arange(40),
                valid=np.arange(40, 90),
                model_kw=dict(num_classes=3, iterations=3, latent_dims=[8]),
                fit=dict(dict(epochs=4, patience=100), **kw))


def gcnii(mesh, **kw):
    """A small GCNII with its dropout (latent 8, 4 convolutions)."""
    run = appnp(mesh, **kw)
    return dict(run, model="GCNII", model_kw=dict(
        num_classes=3, iterations=4, latent_dims=(8,), dropout=0.5))
