"""The fused trainer (``fit(block_epochs=N)``) on every case the JAX
package's fused path runs, on the CPU, where the fused epoch runs eagerly
over the same state and tables that a card captures in a CUDA graph:

* the eager Bernoulli edge mask of a graph below ``min_edges()`` edges, its
  uniforms served from the tape's per-block table (``DrawTape.uniform``);
* any optimizer whose state is tensors (test-local ones with optax's
  semantics: momentum SGD and Adam with a device count), also held against
  the JAX package's fused run with the optax optimizers at ``TRAJ_TOL``;
* a layer drawing from ``Forward.next_generator()``;
* ``remat=True``, its recompute drawing from the tape's twin generators.

Each fused run equals its host loop (``block_epochs=1``) bit for bit.
"""
import types

import jax
import numpy as np
import optax
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.nn.core import DrawTape, Forward
from gnntf_tpu_torch.ops import stochastic as pst
from gnntf_tpu_torch.train.trainer import _check_capturable

TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


class MomentumSGD:
    """``optax.sgd(learning_rate, momentum)``: a trace ``t = g + m t``,
    the update ``-learning_rate * t``."""

    def __init__(self, learning_rate=0.1, momentum=0.9):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params):
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads, state):
        trace = {k: g + self.momentum * state["trace"][k]
                 for k, g in grads.items()}
        return ({k: -self.learning_rate * t for k, t in trace.items()},
                {"trace": trace})


class OptaxAdam:
    """``optax.adam(learning_rate)``: the moments bias-corrected by a count
    kept as a device tensor, ``eps`` added outside the square root."""

    def __init__(self, learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def update(self, grads, state):
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * torch.square(g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        count = state["count"] + 1
        t = count.to(torch.float32)
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        updates = {k: -self.learning_rate * (mu[k] / c1)
                   / (torch.sqrt(nu[k] / c2) + self.eps) for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}


OPTIMIZERS = {"sgd-momentum": (MomentumSGD, lambda: optax.sgd(
    0.1, momentum=0.9)), "optax-adam": (OptaxAdam, lambda: optax.adam(0.01))}


def _data(seed=0, n=240, e=900):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n, e), rng.randint(0, n, e),
            rng.rand(n, 10).astype(np.float32), rng.randint(0, 3, n), n)


def _tasks(pkg, labels):
    return dict(train=pkg.NodeClassification(np.arange(80), labels[:80]),
                valid=pkg.NodeClassification(np.arange(80, 160),
                                             labels[80:160]))


def _graph(src, dst, n):
    return tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")


def _result(model, h):
    n = model.features.shape[0]
    return (h, {k: p.detach().clone() for k, p in model.params.items()},
            model.predict(tt.NodeClassification(np.arange(160, n))))


def _assert_same_run(a, b):
    """Equal runs: ``b`` (fused) may run on to the end of the block in
    which ``a`` (the host loop) stopped."""
    (ha, pa, ya), (hb, pb, yb) = a, b
    n = len(ha["train_loss"])
    for key in ("train_loss", "valid_loss"):
        assert ha[key] == hb[key][:n], key
    assert ha["best_epoch"] == hb["best_epoch"]
    assert pa.keys() == pb.keys()
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(ya, yb)


def _appnp_run(block_epochs, seed=0, **kw):
    """APPNP with its feature and edge dropout on a graph below
    ``min_edges()`` (eager masks), from ``reset(seed=5)``."""
    src, dst, feats, labels, n = _data(seed)
    model = tt.APPNP(_graph(src, dst, n), feats, num_classes=3, iterations=3,
                     device="cpu")
    assert model.graph.n_edges < pst.min_edges()
    h = model.train(**_tasks(tt, labels), seed=5, block_epochs=block_epochs,
                    **kw)
    return _result(model, h)


def test_eager_masks_come_from_the_tables():
    """A forward fed row ``r`` of the tape's uniform tables (one row an
    epoch, written once a block) equals the host loop's forward on that
    epoch's generator, bit for bit."""
    src, dst, feats, _, n = _data(1)
    m = tt.APPNP(_graph(src, dst, n), feats, num_classes=3, iterations=3,
                 device="cpu")
    m.reset(seed=0)
    tape = DrawTape()
    tape.record(torch.Generator().manual_seed(3))
    m.forward(m.features, training=True, generator=tape)
    row = torch.zeros(1, dtype=torch.int64)
    tape.stop("cpu", rows=3, row=row)
    n_drop = m.graph.n_edges
    assert [tuple(t.shape) for t in tape.uniforms] == [(3, n_drop)] * 3
    gens = [lambda e=e: torch.Generator().manual_seed(100 + e)
            for e in range(3)]
    draws = [tape.draw(g()) for g in gens]
    tape.fill(0, [d[2] for d in draws])
    for r, g in enumerate(gens):
        host = m.forward(m.features, training=True, generator=g())
        row.fill_(r)
        tape.feed(draws[r][1])
        assert torch.equal(m.forward(m.features, training=True,
                                     generator=tape), host)


@pytest.mark.parametrize("block_epochs", [3, 4])
def test_fused_eager_masks_equal_host_loop(block_epochs):
    kw = dict(epochs=9, patience=100, regularization=1e-3)
    _assert_same_run(_appnp_run(1, **kw), _appnp_run(block_epochs, **kw))


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_fused_with_tensor_state_optimizer(name):
    """An optimizer whose state is tensors: its update runs in the fused
    epoch, the state gated by ``stopped`` in place; equal to the host loop
    also after early stopping inside a block."""
    make = OPTIMIZERS[name][0]
    for kw in (dict(epochs=8, patience=100), dict(epochs=20, patience=2)):
        host = _appnp_run(1, optimizer=make(), **kw)
        _assert_same_run(host, _appnp_run(4, optimizer=make(), **kw))
    assert len(host[0]["train_loss"]) < 20  # stopped inside a block


def _stack(pkg, graph, feats, classes, device=None):
    kw = {} if device is None else {"device": device}
    relu = jax.nn.relu if pkg is gt else torch.relu
    m = pkg.GNN(graph, feats, **kw)
    m.add(pkg.Dense(16, activation=relu))
    h0 = m.add(pkg.Dense(classes, regularize=False))
    for _ in range(3):
        m.add(pkg.PPRIteration(h0, 0.1, graph_dropout=0.0))
    return m


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_tensor_state_optimizers_match_jax_fused(name):
    """The test-local optimizers against optax's in the JAX package's fused
    run, dropout off, from JAX's initial parameters: ``TRAJ_TOL``."""
    ours, theirs = OPTIMIZERS[name]
    src, dst, feats, labels, n = _data(4, n=200, e=600)
    jm = _stack(gt, gt.from_edges(src, dst, n_nodes=n, directed=False),
                feats, 3)
    pm = _stack(tt, _graph(src, dst, n), feats, 3, device="cpu")
    init = {k: np.asarray(v) for k, v in jm.init(11).items()}
    kw = dict(epochs=10, patience=100, block_epochs=4, seed=7)
    jh = jm.train(**_tasks(gt, labels), init_params=dict(init),
                  optimizer=theirs(), **kw)
    ph = pm.train(**_tasks(tt, labels), init_params=dict(init),
                  optimizer=ours(), **kw)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **TRAJ_TOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    assert ph["epochs_run"] == jh["epochs_run"]
    for k, v in jm.params.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   np.asarray(v), **TRAJ_TOL)


def test_a_state_a_card_cannot_capture_names_its_leaf():
    """On a card every leaf of the optimizer's state must be a tensor
    there: the check names the first that is not."""
    p = {"w": torch.zeros(2, 2)}
    _check_capturable(OptaxAdam().init(p), torch.device("cpu"))
    with pytest.raises(ValueError, match="'count'.*int"):
        _check_capturable({"count": 0, "m": p}, torch.device("cpu"))
    with pytest.raises(ValueError, match="'m/w' is a tensor on cpu"):
        _check_capturable({"m": p}, torch.device("cuda"))


class _ScalesByDraws(tt.Layer):
    """A layer that scales its input by draws from generators of its own,
    two draws from one and one from another."""

    def build(self, net):
        return net.top_shape()

    def apply(self, fw, x):
        if not fw.training:
            return x
        g = fw.next_generator(x.device)
        noise = torch.rand(x.shape, generator=g, device=x.device)
        scale = torch.rand(1, generator=g, device=x.device)
        other = torch.rand(1, generator=fw.next_generator(), device="cpu")
        return x * noise * scale * other.to(x.device)


def _drawing_run(block_epochs, remat=False):
    src, dst, feats, labels, n = _data(3)
    m = tt.GNN(_graph(src, dst, n), feats, device="cpu")
    m.add(tt.Dense(8, dropout=0.3))
    m.add(_ScalesByDraws())
    m.add(tt.Dense(3))
    h = m.train(**_tasks(tt, labels), epochs=7, seed=0, remat=remat,
                block_epochs=block_epochs)
    return _result(m, h)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_fused_next_generator_draws_equal_host_loop(remat):
    _assert_same_run(_drawing_run(1, remat), _drawing_run(3, remat))
    if remat:
        _assert_same_run(_drawing_run(3, False), _drawing_run(3, True))


def test_next_generator_is_fresh_for_each_call():
    """Each call hands out a new generator, seeded by the layer's stream,
    on the device asked for; a tape on a card refuses a CPU one."""
    tape = DrawTape()
    fw = Forward(types.SimpleNamespace(device=torch.device("cpu")), True,
                 torch.Generator().manual_seed(1))
    fw.begin_layer()
    a, b = fw.next_generator(), fw.next_generator("cpu")
    assert a is not b and a.initial_seed() != b.initial_seed()
    assert a.device.type == "cpu"
    fw = Forward(types.SimpleNamespace(device=torch.device("cuda")), True,
                 tape)
    tape.record(torch.Generator().manual_seed(2))
    fw.begin_layer()
    with pytest.raises(ValueError, match="device="):
        fw.next_generator()


def _gcnii_run(block_epochs, remat):
    src, dst, feats, labels, n = _data(6)
    m = tt.GCNII(_graph(src, dst, n), feats, num_classes=3, iterations=4,
                 latent_dims=(8,), dropout=0.5, device="cpu")
    h = m.train(**_tasks(tt, labels), epochs=6, seed=1, remat=remat,
                block_epochs=block_epochs)
    return _result(m, h)


@pytest.mark.parametrize("model", ["gcnii", "appnp"])
def test_fused_remat_equals_host_loop(model):
    """``remat=True`` on the fused path: equal to the host loop with remat
    and to the fused run without it (GCNII with its dropout; APPNP with
    its eager edge masks too)."""
    if model == "gcnii":
        run = _gcnii_run
    else:
        run = lambda block, remat: _appnp_run(block, epochs=6, remat=remat)
    fused = run(3, True)
    _assert_same_run(run(1, True), fused)
    _assert_same_run(run(3, False), fused)


def test_internal_draw_streams_are_unchanged(monkeypatch):
    """The internal draws read the layer's stream as before
    ``next_generator`` handed out generators of their own: layer ``i``'s
    CPU generator is seeded by the ``i``-th draw of the step's, and each
    feature dropout's seed, each edge dropout's salts and each eager mask's
    uniforms are drawn from it in op order."""
    import importlib
    from gnntf_tpu_torch.nn.core import _draw_seed
    dropout_module = importlib.import_module("gnntf_tpu_torch.ops.dropout")
    normalize = importlib.import_module("gnntf_tpu_torch.ops.normalize")
    src, dst, feats, _, n = _data(2)
    m = tt.APPNP(_graph(src, dst, n), feats, num_classes=3, iterations=2,
                 device="cpu")
    m.reset(seed=0)
    seeds, uniforms = [], []
    dropout, draw_uniform = dropout_module.dropout, normalize.draw_uniform
    monkeypatch.setattr(dropout_module, "dropout", lambda x, rate, g: (
        seeds.append(g.initial_seed()), dropout(x, rate, g))[1])
    monkeypatch.setattr(normalize, "draw_uniform", lambda s, k, d: (
        uniforms.append(draw_uniform(s, k, d)), uniforms[-1])[1])
    m.forward(m.features, training=True,
              generator=torch.Generator().manual_seed(42))
    step = torch.Generator().manual_seed(42)
    layers = [torch.Generator().manual_seed(_draw_seed(step))
              for _ in m.layers()]
    # APPNP: Dropout, Dense (its dropout), Dense, then the propagation
    assert seeds == [_draw_seed(layers[0]), _draw_seed(layers[1])]
    for u, layer in zip(uniforms, layers[3:]):
        assert torch.equal(u, torch.rand(m.graph.n_edges, generator=layer))
    assert len(uniforms) == 2
