"""The fused trainer's card side, without JAX, so it runs where JAX is not
installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_fused_cuda.py

* K1's masked and degree walks read the draw's salt pair from device
  memory: rewriting the buffer between two launches with the same
  arguments, or between two replays of a captured launch, gives the second
  draw, bit-equal to the plain versions run on the CPU.
* A feature-dropout generator registered with a CUDA graph and seeded
  before a replay draws the mask of a fresh generator with that seed.
* ``fit(block_epochs=N)`` captures one epoch and replays it: its losses are
  within ``rtol=1e-5`` of the host loop's on the card (the same kernels in
  the same order; the capture may pick other library algorithms) and its
  best epoch and predictions equal; the launch counts show one recorded
  and one captured epoch; so for a small graph's eager edge masks, a
  layer's own draws from ``next_generator(device)`` and optimizers whose
  state is tensors (momentum SGD, optax-style Adam); a CPU generator, or
  an optimizer state holding a Python number, raises ``ValueError``.

Every test skips without a card.
"""
import dataclasses

import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import (build_train_grids, ell_degree_masked,
                                 ell_degree_masked_plain, ell_gather_masked,
                                 ell_gather_masked_plain, stochastic)

LOSS_RTOL = 1e-5
KEEP = 0.5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _lists(n=3000, e=60_000, seed=0):
    """The training-grid lists of a random graph with a hub row and a hub
    column (split over many units), on the CPU, with its values."""
    rng = np.random.RandomState(seed)
    row = np.concatenate([rng.randint(0, n, e), np.zeros(20_000, np.int64)])
    col = np.concatenate([rng.randint(0, n, e), rng.randint(0, n, 20_000)])
    row, col = np.concatenate([row, col]), np.concatenate([col, row])
    val = rng.rand(len(row)).astype(np.float32) + 0.5
    return (build_train_grids(row, col, val, n).lists("cpu"),
            torch.from_numpy(val), n)


def _to(lst, device):
    return dataclasses.replace(lst, **{
        f.name: getattr(lst, f.name).to(device)
        for f in dataclasses.fields(lst)
        if isinstance(getattr(lst, f.name), torch.Tensor)})


SALTS = [(0x9E3779B9, 77), (5, 0xDEADBEEF), (123456789, 987654321)]


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 40, 128])
def test_walks_read_the_salt_from_device_memory(cuda, f):
    (rows, cols), val, n = _lists()
    x = torch.from_numpy(np.random.RandomState(f).randn(n, f).astype(
        np.float32))
    buf = torch.tensor(SALTS[0], device=cuda)
    on = [_to(lst, cuda) for lst in (rows, cols)]
    for salt in SALTS:
        buf.copy_(torch.tensor(salt))
        for lst, lst_c in zip((rows, cols), on):
            out = ell_gather_masked(lst_c, val.to(cuda), buf, KEEP, len(val),
                                    x.to(cuda))
            deg = ell_degree_masked(lst_c, val.to(cuda), buf, KEEP, len(val))
            assert torch.equal(out.cpu(), ell_gather_masked_plain(
                lst, val, torch.tensor(salt), KEEP, len(val), x))
            assert torch.equal(deg.cpu(), ell_degree_masked_plain(
                lst, val, torch.tensor(salt), KEEP, len(val)))


@pytest.mark.cuda
def test_captured_walks_take_each_replays_draw(cuda):
    """The step's masked walks as the fused trainer captures them: the
    forward over the row list and, from the autograd thread, the backward's
    dx over the column list, and the degree walk; each replay reads the
    salts the buffer holds then."""
    (rows, cols), val, n = _lists(seed=1)
    x = torch.from_numpy(np.random.RandomState(2).randn(n, 40).astype(
        np.float32))
    dy = torch.from_numpy(np.random.RandomState(3).randn(n, 40).astype(
        np.float32))
    lists = tuple(_to(lst, cuda) for lst in (rows, cols))
    val_c, x_c, dy_c = val.to(cuda), x.to(cuda).requires_grad_(), dy.to(cuda)
    buf = torch.tensor(SALTS[0], device=cuda)

    def step():
        y = stochastic._TrainGridsFn.apply(x_c, lists, val_c, buf, KEEP,
                                           len(val))
        dx, = torch.autograd.grad(y, x_c, dy_c)
        return y.detach(), dx, ell_degree_masked(lists[1], val_c, buf, KEEP,
                                                 len(val))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()  # loads the library, warms the autograd thread
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = step()
    for salt in SALTS[1:] + SALTS[:1]:
        buf.copy_(torch.tensor(salt))
        graph.replay()
        s = torch.tensor(salt)
        want = (ell_gather_masked_plain(rows, val, s, KEEP, len(val), x),
                ell_gather_masked_plain(cols, val, s, KEEP, len(val), dy),
                ell_degree_masked_plain(cols, val, s, KEEP, len(val)))
        for got, ref in zip(outs, want):
            assert torch.equal(got.cpu(), ref)


@pytest.mark.cuda
def test_registered_generator_draws_a_fresh_seeds_mask(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.ones(3000, 40, device=cuda)
    tt.dropout(x, 0.6, g)  # warm up
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(g)
    with torch.cuda.graph(graph):
        out = tt.dropout(x, 0.6, g)
    for seed in (5, 1 << 40, 12345678901):
        g.manual_seed(seed)
        graph.replay()
        fresh = tt.dropout(x, 0.6,
                           torch.Generator(device=cuda).manual_seed(seed))
        assert torch.equal(out, fresh)


def _model(device, n=5000, e=40_000, iterations=10):
    src, dst = random_power_law_edges(n, e, seed=0)
    feats = np.random.RandomState(1).randn(n, 16).astype(np.float32)
    graph = tt.from_edges(src, dst, n_nodes=n, directed=False, device=device)
    return tt.APPNP(graph, feats, num_classes=6, iterations=iterations,
                    device=device)


def _tasks(n=5000):
    """Train on the first fifth of the nodes, validate on the second."""
    labels = np.random.RandomState(2).randint(0, 6, n)
    k = n // 5
    return (tt.NodeClassification(np.arange(k), labels[:k]),
            tt.NodeClassification(np.arange(k, 2 * k), labels[k:2 * k]))


def _counts():
    """The masked, degree, prepared operator's (K1's scaled walk) and K2's
    launches."""
    from gnntf_tpu_torch.ops import (blocked_spmm, ell_degree_masked,
                                     ell_gather_masked, ell_gather_scaled)
    return np.array([ell_gather_masked.launches, ell_degree_masked.launches,
                     ell_gather_scaled.launches, blocked_spmm.launches])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", [None, "pallas"])
def test_fused_run_matches_host_loop_on_card(cuda, impl):
    """APPNP with its dropout under ``min_edges_scope(0)``: the fused run's
    kernels launch twice an epoch's worth from the host (the recording
    epoch and the capture), whatever the number of epochs."""
    runs, launched = {}, {}
    for block_epochs in (1, 4):
        model = _model(cuda)
        before = _counts()
        with stochastic.min_edges_scope(0):
            hist = model.train(*_tasks(), epochs=9, patience=100, seed=0,
                               spmm_impl=impl, block_epochs=block_epochs)
        launched[block_epochs] = (_counts() - before).tolist()
        runs[block_epochs] = (hist, model.predict(tt.NodeClassification(
            np.arange(2000, 5000))).cpu())
    epoch = [20, 10, 10, 0] if impl is None else [0, 10, 0, 30]
    assert launched[1] == [9 * c for c in epoch]
    assert launched[4] == [2 * c for c in epoch]
    (host, host_pred), (fused, fused_pred) = runs[1], runs[4]
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(fused[key], host[key], rtol=LOSS_RTOL)
    assert fused["best_epoch"] == host["best_epoch"]
    assert torch.equal(fused_pred, host_pred)


@pytest.mark.cuda
def test_fused_patience_on_card(cuda):
    """Early stopping inside a block: the fused run's predictions equal
    the host loop's."""
    preds, runs = [], []
    for block_epochs in (1, 5):
        model = _model(cuda, iterations=3)
        with stochastic.min_edges_scope(0):
            runs.append(model.train(*_tasks(), epochs=12, patience=2, seed=0,
                                    learning_rate=0.05,
                                    block_epochs=block_epochs))
        preds.append(model.predict(tt.NodeClassification(
            np.arange(2000, 5000))).cpu())
    assert len(runs[0]["valid_loss"]) < 12  # the host loop stopped early
    assert runs[0]["best_epoch"] == runs[1]["best_epoch"]
    assert torch.equal(preds[0], preds[1])


def _same_runs(host, fused):
    """The fused run's losses within ``LOSS_RTOL`` of the host loop's on
    the card, the same best epoch."""
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(fused[key], host[key], rtol=LOSS_RTOL)
    assert fused["best_epoch"] == host["best_epoch"]


class DrawsItself(tt.Layer):
    """A layer that scales its input by draws from a generator of its own
    on the card (``Forward.next_generator(device)``)."""

    def __init__(self, device=None):
        super().__init__()
        self.device = device

    def build(self, net):
        return net.top_shape()

    def apply(self, fw, x):
        if not fw.training:
            return x
        g = fw.next_generator(x.device if self.device is None
                              else self.device)
        return x * torch.rand(x.shape, generator=g, device=g.device).to(
            x.device)


@pytest.mark.cuda
def test_fused_raises_for_an_unfeedable_draw_on_card(cuda):
    """The draws a replay is fed on the card: below ``min_edges()`` edges
    the eager Bernoulli edge mask's uniforms, from the tape's per-block
    table (K2's store-mode walks take the products and degrees), and a
    layer's own draws from ``next_generator(device)``: each fused run
    within ``rtol=1e-5`` of the host loop.  A CPU generator asked for under
    the capture raises ``ValueError``."""
    runs = {}
    for block_epochs in (1, 4):
        model = _model(cuda, n=500, e=2000, iterations=2)
        assert model.graph.n_edges < stochastic.min_edges()
        before = _counts()
        runs[block_epochs] = model.train(*_tasks(500), epochs=8, seed=0,
                                         patience=100,
                                         block_epochs=block_epochs)
        launched = _counts() - before
    _same_runs(runs[1], runs[4])
    assert launched[3] > 0 and launched[:3].sum() == 0

    runs = {}
    for block_epochs in (1, 4):
        model = _model(cuda, iterations=1)
        model.add(DrawsItself())
        with stochastic.min_edges_scope(0):
            runs[block_epochs] = model.train(*_tasks(), epochs=8, seed=0,
                                             patience=100,
                                             block_epochs=block_epochs)
    _same_runs(runs[1], runs[4])
    model = _model(cuda, iterations=1)
    model.add(DrawsItself(device="cpu"))
    with stochastic.min_edges_scope(0), pytest.raises(ValueError,
                                                      match="device="):
        model.train(*_tasks(), epochs=4, seed=0, block_epochs=2)


class MomentumSGD:
    """``optax.sgd(learning_rate, momentum)``."""

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
    """``optax.adam(learning_rate)``, its count a device tensor."""

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


@pytest.mark.cuda
@pytest.mark.parametrize("make", [MomentumSGD, OptaxAdam],
                         ids=["sgd-momentum", "optax-adam"])
def test_fused_needs_keras_adam_on_card(cuda, make):
    """Any optimizer whose state is tensors on the card runs its update in
    the captured epoch: within ``rtol=1e-5`` of the host loop, also after
    early stopping inside a block; one with a Python number in its state
    raises ``ValueError`` naming the leaf."""
    for kw in (dict(epochs=8, patience=100),
               dict(epochs=16, patience=2, learning_rate=0.05)):
        runs = {}
        for block_epochs in (1, 4):
            with stochastic.min_edges_scope(0):
                runs[block_epochs] = _model(cuda, iterations=3).train(
                    *_tasks(), seed=0, block_epochs=block_epochs,
                    optimizer=make(), **kw)
        n = len(runs[1]["valid_loss"])
        np.testing.assert_allclose(runs[4]["valid_loss"][:n],
                                   runs[1]["valid_loss"], rtol=LOSS_RTOL)
        assert runs[4]["best_epoch"] == runs[1]["best_epoch"]

    class CountingSGD(MomentumSGD):
        def init(self, params):
            return dict(super().init(params), count=0)

        def update(self, grads, state):
            updates, new = super().update(grads, state)
            return updates, dict(new, count=state["count"] + 1)

    with pytest.raises(ValueError, match="'count'"):
        _model(cuda).train(*_tasks(), epochs=4, seed=0, block_epochs=2,
                           optimizer=CountingSGD())
