"""The port's GCN family (GCN, GCNII and their spectral-preserving layers,
NGCF), MLP, the experimental models and ``Structural`` against the JAX
package: the same graph and features, every parameter drawn from a seeded
uniform in numpy and given to both packages (GCNII's convolution weights
are zero-initialized, which would hide them).

Tolerances:

* clean forward, on a small graph and on one of 80,000 edges (>= 65,536,
  where the port's ``PreparedSpMM`` walks every edge and JAX's takes the
  hub slice): rtol=1e-4, atol=1e-5
  (float32, sums in another order over up to 8 propagation steps);
* layer losses (``FastReg``'s, NGCF's output regularization): rtol=1e-5;
* 3-epoch training trajectories with dropout off (losses, then the best
  parameters): rtol=1e-4, atol=1e-5, as in ``test_torch_train.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import random_power_law_edges, synthetic_planetoid
from _jax_budget import release_jax_layout_caches  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)
RELU = {gt: jax.nn.relu, tt: torch.relu}


@functools.lru_cache(maxsize=None)
def _data(kind):
    if kind == "small":
        G, labels, features, *_ = synthetic_planetoid(
            n_nodes=300, n_classes=4, n_features=24, avg_degree=6.0, seed=3)
        src, dst = (np.asarray(a) for a in zip(*gt.graph2indices(G)))
        n, c = 300, 4
    else:
        n, c = 5000, 6
        src, dst = random_power_law_edges(n, 40_000, seed=0)
        rng = np.random.RandomState(1)
        features = rng.randn(n, 24).astype(np.float32)
        labels = rng.randint(0, c, size=n)
    return src, dst, n, np.asarray(features, np.float32), labels, c


def _graphs(kind):
    src, dst, n, *_ = _data(kind)
    return (gt.from_edges(src, dst, n_nodes=n, directed=False),
            tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu"))


def _random_params(jm, seed, scale=0.3):
    """Every parameter of ``jm`` drawn from U(-scale, scale), as numpy."""
    rng = np.random.RandomState(seed)
    return {s.name: rng.uniform(-scale, scale, s.shape).astype(np.float32)
            for s in jm.param_specs}


def _set_params(jm, pm, params):
    jm.params = {k: jnp.asarray(v) for k, v in params.items()}
    jm._act_cache = None
    tt.params_from_jax(params, pm)


def _ppr_sweep(pkg, graph, features, num_classes, **kw):
    model = pkg.GNN(graph, features, **kw)
    model.add(pkg.PPRSweep())
    model.add(pkg.Dense(num_classes))
    return model


def _fast_reg(pkg, graph, features, num_classes, **kw):
    model = pkg.GNN(graph, features, **kw)
    model.add(pkg.Dense(8, activation=RELU[pkg]))
    model.add(pkg.FastReg())
    model.add(pkg.Dense(num_classes))
    return model


def _structural(bipartite, l2, width):
    """A GNN whose preprocessor is ``Structural`` (``width`` 0: the
    features are dropped, pure-structural mode)."""
    def build(pkg, graph, features, num_classes, **kw):
        feats = features[:, :width]
        model = pkg.GNN(graph, feats, preprocessor=pkg.Structural(
            dims=6, l2_contraint=l2, bipartite=bipartite), **kw)
        model.add(pkg.GCNLayer(num_classes))
        return model
    return build


MODELS = {
    "GCN": lambda pkg, *a, **kw: pkg.GCN(*a, latent_dims=(16,), **kw),
    "GCN-spectral": lambda pkg, *a, **kw: pkg.GCN(
        *a, latent_dims=(16,), layer_type=pkg.GCNSpectralPreservingLayer,
        **kw),
    "GCN-widening": lambda pkg, *a, **kw: pkg.GCN(*a, latent_dims=(40,),
                                                  **kw),
    "GCNII": lambda pkg, *a, **kw: pkg.GCNII(*a, iterations=8,
                                             latent_dims=(16,), **kw),
    "GCNII-spectral": lambda pkg, *a, **kw: pkg.GCNII(
        *a, iterations=8, latent_dims=(16,),
        layer_type=pkg.GCNIISpectralPreservingLayer, **kw),
    "NGCF": lambda pkg, *a, **kw: pkg.NGCF(*a, **kw),
    "APPNPReg": lambda pkg, *a, **kw: pkg.APPNPReg(*a, latent_dims=(16,),
                                                   **kw),
    "GCNIIReg": lambda pkg, *a, **kw: pkg.GCNIIReg(*a, iterations=4,
                                                   latent_dims=(16,), **kw),
    "APPNP2": lambda pkg, *a, **kw: pkg.APPNP2(*a, latent_dims=(16,), **kw),
    "APPNPThrough": lambda pkg, *a, **kw: pkg.APPNPThrough(
        *a, latent_dims=(16,), **kw),
    "PPRSweep": _ppr_sweep,
    "FastReg": _fast_reg,
    "Structural": _structural(0, False, 24),
    "Structural-bipartite-l2": _structural(100, True, 24),
    "Structural-width-0": _structural(0, True, 0),
    "Structural-bipartite-width-0": _structural(120, False, 0),
    "GAT": lambda pkg, *a, **kw: pkg.GAT(*a, latent_dims=(8,), heads=4,
                                         **kw),
    "GraphSAGE": lambda pkg, *a, **kw: pkg.GraphSAGE(*a, latent_dims=(16,),
                                                     **kw),
    "GraphSAGE-normalize": lambda pkg, *a, **kw: pkg.GraphSAGE(
        *a, latent_dims=(16,), normalize=True, **kw),
    "GIN": lambda pkg, *a, **kw: pkg.GIN(*a, latent_dims=(16,), **kw),
}


def _pair(name, kind):
    jg, pg = _graphs(kind)
    _, _, _, features, labels, c = _data(kind)
    build = MODELS[name]
    jm = build(gt, jg, features, c)
    pm = build(tt, pg, features, c, device="cpu")
    assert [s.name for s in pm.param_specs] == [s.name for s in
                                                jm.param_specs]
    _set_params(jm, pm, _random_params(jm, 5))
    return jm, pm, labels


@pytest.mark.parametrize("kind", ["small", "large"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_clean_forward_matches_jax(name, kind):
    jm, pm, _ = _pair(name, kind)
    ref, jfw = jm.apply(jm.params, jm.features, training=False,
                        return_ctx=True)
    out, pfw = pm.forward(pm.features, return_ctx=True)
    assert out.shape == ref.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **TOL)
    # the layer losses: FastReg's add_loss, NGCF's output regularization
    np.testing.assert_allclose(
        float(torch.as_tensor(pm.layer_losses(pfw)).detach()),
        float(jm.layer_losses(jfw)),
        rtol=LOSS_RTOL)
    assert len(pfw.extra_losses) == len(jfw.extra_losses)


@pytest.mark.parametrize("name", ["MLP", "MLP-deep"])
def test_mlp_forward_matches_jax(name):
    _, _, _, features, labels, c = _data("small")
    latent = (16,) if name == "MLP" else (32, 16)
    jm = gt.MLP(features, num_classes=c, latent_dims=latent)
    pm = tt.MLP(features, num_classes=c, latent_dims=latent, device="cpu")
    _set_params(jm, pm, _random_params(jm, 2))
    np.testing.assert_allclose(pm._activations().numpy(),
                               np.asarray(jm._activations()), **TOL)
    task = (gt.NodeClassification(np.arange(50), labels[:50]),
            tt.NodeClassification(np.arange(50), labels[:50]))
    np.testing.assert_array_equal(pm.predict(task[1]).numpy(),
                                  np.asarray(jm.predict(task[0])))


def test_fast_reg_adds_its_loss_in_training():
    """In a training forward FastReg's loss joins the total through
    ``add_loss``: the trainer's loss is the task loss plus it."""
    _, pm, labels = _pair("FastReg", "small")
    task = tt.NodeClassification(np.arange(40), labels[:40])
    gen = torch.Generator().manual_seed(0)
    out, fw = pm.forward(pm.features, training=True, generator=gen,
                         return_ctx=True)
    (lam,) = fw.extra_losses
    assert float(lam) < 0
    total = pm.layer_losses(fw)
    assert float(total) == float(lam)


def _no_dropout(pkg, layer):
    """A ``layer_type`` for ``GCN`` with both dropouts off."""
    return lambda outputs, graph_dropout=0.0, dropout=0.0: getattr(
        pkg, layer)(outputs)


TRAINED = {
    "GCNII": lambda pkg, *a, **kw: pkg.GCNII(
        *a, iterations=8, latent_dims=(16,), dropout=0.0, **kw),
    "GCN": lambda pkg, *a, **kw: pkg.GCN(
        *a, latent_dims=(16,), layer_type=_no_dropout(pkg, "GCNLayer"),
        **kw),
    "GAT": lambda pkg, *a, **kw: pkg.GAT(
        *a, latent_dims=(8,), heads=4, dropout=0.0, attn_dropout=0.0, **kw),
    "GraphSAGE": lambda pkg, *a, **kw: pkg.GraphSAGE(
        *a, latent_dims=(16,), dropout=0.0, **kw),
    "GIN": lambda pkg, *a, **kw: pkg.GIN(*a, latent_dims=(16,), dropout=0.0,
                                         **kw),
}


@pytest.mark.parametrize("name", sorted(TRAINED))
def test_training_trajectory_matches_jax(name):
    """3 epochs of ``train`` with dropout off on the large graph (the
    prepared operator's backward walk in every step) against JAX."""
    jg, pg = _graphs("large")
    _, _, _, features, labels, c = _data("large")
    jm = TRAINED[name](gt, jg, features, c)
    pm = TRAINED[name](tt, pg, features, c, device="cpu")
    init = _random_params(jm, 7, scale=0.2)
    tasks = lambda pkg: dict(
        train=pkg.NodeClassification(np.arange(300), labels[:300]),
        valid=pkg.NodeClassification(np.arange(300, 600), labels[300:600]))
    jh = jm.train(**tasks(gt), epochs=3, patience=100, seed=7,
                  init_params=dict(init))
    ph = pm.train(**tasks(tt), epochs=3, patience=100, seed=7,
                  init_params=dict(init))
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **TRAJ_TOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    for k, v in jm.params.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   np.asarray(v), **TRAJ_TOL)


def test_appnp_through_writes_the_labels_in_place():
    """``APPNPThrough.train`` writes the one-hot train labels into the
    label columns of the model's own feature tensor and drops the cached
    activations; the features then equal the JAX package's padded features
    with those labels written in (its own ``train`` cannot write them: it
    assigns into ``np.asarray`` of a JAX array, which is read-only)."""
    jg, pg = _graphs("small")
    _, _, _, features, labels, c = _data("small")
    jm = gt.APPNPThrough(jg, features, num_classes=c, latent_dims=(8,))
    pm = tt.APPNPThrough(pg, features, num_classes=c, latent_dims=(8,),
                         device="cpu")
    feats = pm.features
    pm._activations()
    nodes = np.arange(0, 60, 2)
    pm.train(tt.NodeClassification(nodes, labels[nodes]), epochs=1, seed=0)
    assert pm.features is feats and pm._act_cache is None
    want = np.array(jm.features)
    want[nodes, want.shape[1] - c + labels[nodes]] = 1.0
    np.testing.assert_array_equal(feats.numpy(), want)
    assert feats[:, -c:].sum() == len(nodes)


@pytest.mark.parametrize("name", ["GCN", "GCNII", "NGCF", "MLP", "GAT",
                                  "GraphSAGE", "GIN"])
def test_models_default_to_cuda(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, pg = _graphs("small")
    _, _, _, features, _, c = _data("small")
    with pytest.raises(RuntimeError):
        if name == "MLP":
            tt.MLP(features, num_classes=c)
        else:
            getattr(tt, name)(pg, features, num_classes=c)


def _gat_run(block_epochs):
    """GAT with feature and attention dropout on a small graph under
    ``min_edges_scope(0)`` (the grid path, per-edge lists in the step,
    coalesced in the validation forward), 10 epochs from ``reset(seed=3)``:
    the history, the parameters and the predictions."""
    from gnntf_tpu_torch.ops import stochastic
    src, dst, n, features, labels, c = _data("small")
    graph = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    model = tt.GAT(graph, features, num_classes=c, latent_dims=(8,), heads=4,
                   device="cpu")
    with stochastic.min_edges_scope(0):
        hist = model.train(tt.NodeClassification(np.arange(100),
                                                 labels[:100]),
                           tt.NodeClassification(np.arange(100, 200),
                                                 labels[100:200]),
                           epochs=10, patience=100, seed=3,
                           block_epochs=block_epochs)
        pred = model.predict(tt.NodeClassification(np.arange(200, n)))
    return hist, {k: p.detach().clone() for k, p in model.params.items()}, \
        pred


def test_gat_fused_equals_host_loop():
    """``fit(block_epochs=5)`` replays the host loop's draws, attention
    salts included (``Forward.attention_salt`` through the ``DrawTape``):
    the history, the parameters and the predictions are equal."""
    (hf, pf, yf), (hh, ph, yh) = _gat_run(5), _gat_run(1)
    for key in ("train_loss", "valid_loss", "best_epoch"):
        assert hf[key] == hh[key], key
    for k in pf:
        assert torch.equal(pf[k], ph[k]), k
    assert torch.equal(yf, yh)
    assert len(set(hh["train_loss"])) == len(hh["train_loss"])


@pytest.mark.parametrize("name", ["GAT", "GraphSAGE", "GIN"])
def test_params_from_jax_carries_the_new_models(name):
    """The JAX parameter names line up: ``params_from_jax`` copies a JAX
    model's parameters into the port's model of the same build, which then
    holds them exactly."""
    jm, pm, _ = _pair(name, "small")
    for k, v in jm.params.items():
        assert torch.equal(pm.params[k].detach(),
                           torch.from_numpy(np.array(v))), k
