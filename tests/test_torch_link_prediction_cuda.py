"""Link prediction, remat and resume on the card, without JAX:

    python -m pytest --noconftest -q -m cuda \
        tests/test_torch_link_prediction_cuda.py

* The C++ sampler builds and runs (no quiet fall to the Python path).
* NGCF link prediction without dropout, 3 epochs on the card against the
  CPU from the same weights and one draw of the sampler, on a graph that
  takes the prepared operator (K1 and its backward walk): losses within
  ``LOSS_RTOL``, parameters within ``PARAM_TOL`` but for at most
  ``PARAM_OUTLIERS`` of them (float32 sums in another order, which Adam
  scales up where a gradient is near its eps).  NGCF's output
  regularization is off: it is 0.5 a node and layer whatever the weights,
  so its gradient is rounding noise that differs between devices.
* The fused stacked path against the host loop on the card, feature
  dropout on and the output regularization off: losses within
  ``FUSED_RTOL`` (``edge_dot``'s backward scatters with ``index_add_``'s
  atomics; with the regularization on, each run's last bits re-roll its
  gradient's rounding noise, which Adam scales up), the same best epoch.
* ``remat=True`` equal to ``remat=False`` with dropout on; a run resumed
  from its checkpoint equal to the uninterrupted one, on the host loop and
  on the fused path; the fused path with remat (the recompute's draws
  from twin generators registered with the CUDA graph) within
  ``rtol=1e-5`` of the host loop with remat and of the fused run without
  it.  These run
  on graphs of at least 65,536 counted edges, whose products are the walks
  (each sums in a fixed order): below it a product scatters with
  ``index_add_``'s atomics, and two runs may differ in the last bit.

Every test skips without a card.
"""
import numpy as np
import pytest
import torch

import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import stochastic
from gnntf_tpu_torch.utils import native

LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_OUTLIERS = 0.01
FUSED_RTOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _graph(n=20_000, e=40_000, seed=2):
    src, dst = random_power_law_edges(n, e, seed=seed)
    return tt.from_edges(src, dst, n_nodes=n, directed=False,
                         device="cpu"), np.stack([src, dst], 1), n


def _ngcf(graph, features, device, dropout=0.0):
    """NGCF(16) without its output regularization."""
    model = tt.NGCF(graph.to(device), features, num_classes=16,
                    dropout=dropout, device=device)
    for layer in model.layers():
        layer.output_regularize = 0.0
    return model


@pytest.mark.cuda
def test_native_sampler_runs(cuda):
    graph, pos, _ = _graph()
    sampler = tt.negative_sampling(pos[:5000], graph, samples=2)
    for _ in range(3):
        edges, _ = sampler()
    assert native.available(), native.error
    assert sampler.native
    assert (edges[1::3, 1] >= 0).all()


@pytest.mark.cuda
def test_link_prediction_on_card_matches_cpu(cuda):
    graph, pos, n = _graph()
    assert graph.n_edges >= 65_536
    features = np.random.RandomState(1).randn(n, 32).astype(np.float32)
    tt.set_seed(3)
    draw = tt.negative_sampling(pos, graph, samples=1, prefetch=False)()
    held = tt.negative_sampling(pos[:2000], graph, samples=2,
                                prefetch=False)()
    runs, params = {}, {}
    for device in (cuda, "cpu"):
        model = _ngcf(graph, features, device)
        runs[str(device)] = model.train(
            tt.LinkPrediction(*draw, gnn=model, loss="diff"),
            tt.LinkPrediction(*held, gnn=model, loss="bce"), epochs=3,
            patience=100, seed=0)
        params[str(device)] = {k: p.detach().cpu()
                               for k, p in model.params.items()}
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(runs["cuda"][key], runs["cpu"][key],
                                   rtol=LOSS_RTOL)
    outside = total = 0
    for k, p in params["cpu"].items():
        q = params["cuda"][k]
        assert (q - p).abs().max() <= 1e-3, k
        outside += int((~torch.isclose(q, p, **PARAM_TOL)).sum())
        total += p.numel()
    assert outside <= PARAM_OUTLIERS * total


@pytest.mark.cuda
def test_fused_stacked_on_card_matches_host_loop(cuda):
    graph, pos, n = _graph()
    features = np.random.RandomState(1).randn(n, 32).astype(np.float32)
    model = _ngcf(graph, features, cuda, dropout=0.1)
    tt.set_seed(4)
    held = tt.negative_sampling(pos[:2000], graph, samples=2,
                                prefetch=False)()
    runs = {}
    for block in (1, 4):
        tt.set_seed(5)
        sampler = tt.negative_sampling(pos, graph, samples=1)
        runs[block] = model.train(
            tt.LinkPrediction(lambda: sampler(), gnn=model, loss="diff"),
            tt.LinkPrediction(*held, gnn=model, loss="bce"), epochs=8,
            patience=100, seed=0, block_epochs=block)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(runs[4][key], runs[1][key],
                                   rtol=FUSED_RTOL)
    assert runs[4]["best_epoch"] == runs[1]["best_epoch"]


def _appnp(cuda):
    graph, _, n = _graph(seed=6)
    features = np.random.RandomState(2).randn(n, 16).astype(np.float32)
    labels = np.random.RandomState(3).randint(0, 4, n)
    tasks = (tt.NodeClassification(np.arange(1000), labels[:1000]),
             tt.NodeClassification(np.arange(1000, 2000),
                                   labels[1000:2000]))
    return tt.APPNP(graph.to(cuda), features, num_classes=4,
                    device=cuda), tasks


def _params(model):
    return {k: p.detach().cpu() for k, p in model.params.items()}


@pytest.mark.cuda
def test_remat_on_card_equals_plain(cuda):
    graph, _, n = _graph(seed=7)
    features = np.random.RandomState(2).randn(n, 16).astype(np.float32)
    labels = np.random.RandomState(3).randint(0, 4, n)
    tasks = (tt.NodeClassification(np.arange(1000), labels[:1000]),
             tt.NodeClassification(np.arange(1000, 2000),
                                   labels[1000:2000]))
    model = tt.GCNII(graph.to(cuda), features, num_classes=4, iterations=8,
                     latent_dims=(16,), dropout=0.5, device=cuda)
    runs = {}
    for remat in (False, True):
        runs[remat] = (model.train(*tasks, epochs=3, seed=1, remat=remat),
                       _params(model))
    assert runs[False][0] == runs[True][0]
    for k, p in runs[False][1].items():
        assert torch.equal(p, runs[True][1][k]), k
    # the fused path: the recompute draws from the tape's twin generators,
    # registered with the CUDA graph; equal to the host loop with remat and
    # to the fused run without it within the fused tolerance
    fused = {remat: model.train(*tasks, epochs=4, seed=1, remat=remat,
                                block_epochs=2) for remat in (False, True)}
    host = model.train(*tasks, epochs=4, seed=1, remat=True)
    for other in (host, fused[False]):
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(fused[True][key], other[key],
                                       rtol=1e-5)
        assert fused[True]["best_epoch"] == other["best_epoch"]


@pytest.mark.cuda
@pytest.mark.parametrize("block", [1, 3], ids=["host", "fused"])
def test_resume_on_card_equals_uninterrupted(cuda, tmp_path, block):
    model, tasks = _appnp(cuda)
    assert model.graph.n_edges >= stochastic.min_edges()
    h = model.train(*tasks, epochs=6, seed=0, patience=100,
                    block_epochs=block)
    want = _params(model)
    kw = dict(seed=0, patience=100, block_epochs=block,
              checkpoint_dir=str(tmp_path), checkpoint_every=3)
    h1 = model.train(*tasks, epochs=3, **kw)
    h2 = model.train(*tasks, epochs=6, resume=True, **kw)
    assert h1["train_loss"] + h2["train_loss"] == h["train_loss"]
    assert h1["valid_loss"] + h2["valid_loss"] == h["valid_loss"]
    got = _params(model)
    for k, p in want.items():
        assert torch.equal(p, got[k]), k
