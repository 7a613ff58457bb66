"""The port's checkpoint/resume (``utils/checkpoint.py``, ``fit(
checkpoint_dir=, checkpoint_every=, resume=)``), remat (``fit(remat=True)``,
``Network.forward(remat=True)``), ``TrainLogger`` and ``utils/profiling.py``
on the CPU.

* A run stopped and resumed from its checkpoint is *equal* to the same run
  straight through, with feature and edge dropout on, on the host loop and
  on the fused path; the files are the JAX package's (either package reads
  the other's parameters).
* ``remat=True`` is *equal* to ``remat=False``: the recompute rewinds each
  layer's draws (APPNP with both dropouts on the training grids and on the
  eager edge mask, a small GCNII, the fused path); a layer that adds a loss
  raises as in the JAX package.
"""
import json
import os

import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.utils import checkpoint as jckpt
from gnntf_tpu.utils.logging import TrainLogger as JaxLogger
from gnntf_tpu_torch.ops import stochastic as pst
from gnntf_tpu_torch.utils import checkpoint as pckpt
from gnntf_tpu_torch.utils import profiling
from gnntf_tpu_torch.utils.logging import TrainLogger


def _data(seed=0, n=240, e=900):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n, e), rng.randint(0, n, e),
            rng.rand(n, 10).astype(np.float32), rng.randint(0, 3, n), n)


def _tasks(labels):
    return dict(train=tt.NodeClassification(np.arange(80), labels[:80]),
                valid=tt.NodeClassification(np.arange(80, 160),
                                            labels[80:160]))


def _appnp(seed=0):
    src, dst, feats, labels, n = _data(seed)
    g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    return tt.APPNP(g, feats, num_classes=3, iterations=3, device="cpu"), \
        labels


def _params(model):
    return {k: p.detach().clone() for k, p in model.params.items()}


def _assert_equal_params(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("block_epochs", [1, 3], ids=["host", "fused"])
def test_resumed_run_equals_uninterrupted(tmp_path, block_epochs):
    kw = dict(seed=5, patience=100, block_epochs=block_epochs,
              regularization=1e-3)
    with pst.min_edges_scope(0):
        straight, labels = _appnp()
        h = straight.train(**_tasks(labels), epochs=6, **kw)
        first, _ = _appnp()
        h1 = first.train(**_tasks(labels), epochs=3,
                         checkpoint_dir=str(tmp_path), checkpoint_every=3,
                         **kw)
        resumed, _ = _appnp()
        h2 = resumed.train(**_tasks(labels), epochs=6,
                           checkpoint_dir=str(tmp_path), checkpoint_every=3,
                           resume=True, **kw)
    assert h1["train_loss"] + h2["train_loss"] == h["train_loss"]
    assert h1["valid_loss"] + h2["valid_loss"] == h["valid_loss"]
    assert h2["best_epoch"] == h["best_epoch"]
    assert h2["epochs_run"] == h["epochs_run"]
    _assert_equal_params(_params(resumed), _params(straight))
    assert pckpt.all_steps(str(tmp_path)) == [2, 5]


def test_resume_keeps_the_early_stopping_state(tmp_path):
    """Patience and the least loss carry over: the resumed run stops where
    the uninterrupted one does."""
    kw = dict(seed=1, patience=2, learning_rate=0.3)
    straight, labels = _appnp(1)
    h = straight.train(**_tasks(labels), epochs=40, **kw)
    assert h["epochs_run"] < 40
    cut = h["epochs_run"] - 2
    first, _ = _appnp(1)
    first.train(**_tasks(labels), epochs=cut, checkpoint_dir=str(tmp_path),
                **kw)
    resumed, _ = _appnp(1)
    h2 = resumed.train(**_tasks(labels), epochs=40,
                       checkpoint_dir=str(tmp_path), resume=True, **kw)
    assert h2["epochs_run"] == h["epochs_run"]
    assert h2["best_epoch"] == h["best_epoch"]
    _assert_equal_params(_params(resumed), _params(straight))


def test_checkpoint_files_and_pruning(tmp_path):
    model, labels = _appnp()
    model.train(**_tasks(labels), epochs=5, seed=0, patience=100,
                checkpoint_dir=str(tmp_path), checkpoint_every=1)
    assert pckpt.all_steps(str(tmp_path)) == [2, 3, 4]
    assert sorted(os.listdir(tmp_path)) == [
        f"ckpt_{s:08d}.{ext}" for s in (2, 3, 4) for ext in ("json", "npz")]
    with open(tmp_path / "ckpt_00000004.json") as f:
        manifest = json.load(f)
    assert manifest["groups"] == ["best", "opt", "params"]
    assert set(manifest["meta"]) == {"epoch", "min_loss",
                                     "patience_remaining", "best_epoch",
                                     "rng_seed"}
    step, state = pckpt.restore_checkpoint(str(tmp_path))
    assert step == 4 and state["meta"]["epoch"] == 4
    assert int(state["opt_state"]["count"]) == 5
    assert set(state["opt_state"]) == {"count", "m", "v"}
    assert pckpt.restore_checkpoint(str(tmp_path / "none")) is None


def test_checkpoints_cross_between_packages(tmp_path):
    """The port reads the ``params`` and ``best`` groups of a checkpoint
    that the JAX package wrote, and the JAX package reads the port's."""
    src, dst, feats, labels, n = _data(2)
    jm = gt.APPNP(gt.from_edges(src, dst, n_nodes=n, directed=False), feats,
                  num_classes=3, iterations=3)
    jm.train(gt.NodeClassification(np.arange(80), labels[:80]), epochs=2,
             seed=0, checkpoint_dir=str(tmp_path / "jax"))
    _, state = pckpt.restore_checkpoint(str(tmp_path / "jax"))
    want = {k: np.asarray(v) for k, v in jm.params.items()}
    assert state["best_params"].keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_array_equal(state["best_params"][k], v)
    pm, _ = _appnp(2)
    tt.params_from_jax(state["params"], pm)
    pm.train(**_tasks(labels), epochs=2, seed=0,
             checkpoint_dir=str(tmp_path / "port"))
    _, jstate = jckpt.restore_checkpoint(str(tmp_path / "port"))
    for k, p in pm.params.items():
        np.testing.assert_array_equal(np.asarray(jstate["best_params"][k]),
                                      p.detach().numpy())


@pytest.mark.parametrize("grids", [True, False],
                         ids=["grids", "eager-edge-mask"])
def test_remat_equals_plain_appnp(grids):
    def run(remat):
        import contextlib
        scope = pst.min_edges_scope(0) if grids else contextlib.nullcontext()
        model, labels = _appnp(3)
        with scope:
            h = model.train(**_tasks(labels), epochs=4, seed=2, remat=remat)
        return h, _params(model)

    (h0, p0), (h1, p1) = run(False), run(True)
    assert h0["train_loss"] == h1["train_loss"]
    assert h0["valid_loss"] == h1["valid_loss"]
    _assert_equal_params(p0, p1)


def test_remat_equals_plain_gcnii():
    src, dst, feats, labels, n = _data(4)

    def run(remat, block_epochs=1):
        g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
        model = tt.GCNII(g, feats, num_classes=3, iterations=4,
                         latent_dims=(8,), dropout=0.5, device="cpu")
        h = model.train(**_tasks(labels), epochs=3, seed=1, remat=remat,
                        block_epochs=block_epochs)
        return h, _params(model)

    (h0, p0), (h1, p1) = run(False), run(True)
    assert h0["train_loss"] == h1["train_loss"]
    _assert_equal_params(p0, p1)
    (h2, p2), (h3, p3) = run(False, 3), run(True, 3)
    assert h2["train_loss"] == h3["train_loss"] == h0["train_loss"]
    _assert_equal_params(p2, p3)


def test_remat_recomputes_with_the_same_draws():
    """The gradients of one training forward under remat equal those
    without it, with a feature dropout whose mask comes from a generator the
    recompute must rewind."""
    model, _ = _appnp(5)
    model.reset(seed=0)
    grads = []
    for remat in (False, True):
        out = model.forward(model.features, training=True,
                            generator=torch.Generator().manual_seed(9),
                            remat=remat)
        grads.append(torch.autograd.grad(out.square().sum(),
                                         list(model.params.values())))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_remat_refuses_add_loss_like_jax():
    src, dst, feats, labels, n = _data(6)
    messages = []
    jm = gt.GCNIIReg(gt.from_edges(src, dst, n_nodes=n, directed=False),
                     feats, num_classes=3, iterations=2, latent_dims=(8,))
    pm = tt.GCNIIReg(tt.from_edges(src, dst, n_nodes=n, directed=False,
                                   device="cpu"), feats, num_classes=3,
                     iterations=2, latent_dims=(8,), device="cpu")
    for pkg, model in ((gt, jm), (tt, pm)):
        with pytest.raises(ValueError) as err:
            model.train(pkg.NodeClassification(np.arange(50), labels[:50]),
                        epochs=1, seed=0, remat=True)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_fit_options_left_unported(tmp_path):
    """``mesh`` and ``spmm``, ported since: on 2 gloo ranks under the halo
    executor, a run stopped after 3 epochs and resumed from its checkpoint
    (one directory a rank) equals 6 epochs straight through, on the host
    loop and on the fused path."""
    from test_torch_parallel_ranks import resume_body, spawn
    src, dst, feats, labels, n = _data()
    per_rank = spawn(2, resume_body, (src, dst, n, feats, labels),
                     str(tmp_path))
    for results in per_rank:
        for straight, resumed in results:
            assert resumed[0] == straight[0]
            _assert_equal_params(resumed[1], straight[1])


def test_train_logger_records_match_jax(tmp_path):
    records = []
    for logger_type, pkg in ((JaxLogger, gt), (TrainLogger, tt)):
        path = tmp_path / f"{pkg.__name__}.jsonl"
        with logger_type(jsonl_path=str(path)) as logger:
            for epoch in range(3):
                logger(epoch=epoch, params=None, valid_loss=1.0 / (epoch + 1),
                       best_loss=0.25, patience_remaining=7 - epoch, note="x")
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert [r.pop("ts") for r in lines] == [r.pop("ts")
                                                for r in logger.records]
        assert lines == logger.records
        records.append(lines)
    assert records[0] == records[1]


def test_train_logger_as_a_callback():
    logger = TrainLogger()
    model, labels = _appnp()
    model.train(**_tasks(labels), epochs=3, seed=0, callbacks=[logger])
    assert [r["epoch"] for r in logger.records] == [0, 1, 2]


def test_profiling_helpers(tmp_path):
    timer = profiling.StepTimer(warmup=1)
    for _ in range(3):
        timer.start()
        x = torch.ones(4) * 2
        timer.stop(x)
    summary = timer.summary()
    assert summary["steps"] == 2 and summary["min_s"] >= 0
    with profiling.trace(str(tmp_path)):
        with profiling.named_scope("span"):
            torch.ones(8).sum()
    assert (tmp_path / "trace.json").exists()
    r = profiling.roofline(1000, 16, 1e-6)
    assert r["bound_s"] == 1000 * 16 * 4 / 3350e9
    assert profiling.H100_SXM_HBM_GBPS == 3350.0
