"""The port's fused multi-epoch trainer (``fit(block_epochs=N)``) and the
repairs that came with it, on the CPU, where the fused epoch runs eagerly
over the same in-place state that a card captures in a CUDA graph.

* Against the port's own host loop (``block_epochs=1``), with feature and
  edge dropout on, under the default impl, ``pallas`` and ``segment``: the
  history, the best epoch, the parameters and the predictions are *equal*
  (the fused epoch replays the host loop's draws and rounds as it does).
* Against the JAX package's ``fit(block_epochs=4)`` on a stack without
  dropout, with the JAX initial parameters carried over: ``TRAJ_TOL``
  (float32, sums in another order over several propagation steps and
  optimizer updates), and the best epoch and ``epochs_run`` equal.
* A layer's own draws (``Forward.next_generator``) fed to each fused
  epoch: equal to the host loop.
* The draw tape, ``Predictor.static``, the hash with a salt tensor, and the
  repaired faults: re-adding a layer (F2), the memo of ``add_self_loops``
  (H3) and K2's lists keyed on ``row`` and ``col`` (H4).

Small graphs take the training grids under ``min_edges_scope(0)``.
"""
import contextlib
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import stochastic as jst
from gnntf_tpu_torch.nn.core import DrawTape
from gnntf_tpu_torch.ops import blocked as pblocked
from gnntf_tpu_torch.ops import normalize as pnorm
from gnntf_tpu_torch.ops import stochastic as pst

# the modules, not the functions that ``gnntf_tpu_torch.ops`` exports under
# their names
dropout_module = importlib.import_module("gnntf_tpu_torch.ops.dropout")
spmm_module = importlib.import_module("gnntf_tpu_torch.ops.spmm")
TRAJ_TOL = dict(rtol=1e-4, atol=1e-5)


def _data(seed=0, n=240, e=900):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, n, e), rng.randint(0, n, e),
            rng.rand(n, 10).astype(np.float32), rng.randint(0, 3, n), n)


def _tasks(pkg, labels):
    return dict(train=pkg.NodeClassification(np.arange(80), labels[:80]),
                valid=pkg.NodeClassification(np.arange(80, 160),
                                             labels[80:160]))


def _appnp(src, dst, feats, n):
    g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    return tt.APPNP(g, feats, num_classes=3, iterations=3, device="cpu")


def _run(block_epochs, impl=None, grids=True, seed=0, **kw):
    """APPNP with its feature dropout and edge dropout, trained from
    ``reset(seed=5)``; returns the history, the parameters and the
    predictions on the held-out nodes."""
    src, dst, feats, labels, n = _data(seed)
    m = _appnp(src, dst, feats, n)
    scope = pst.min_edges_scope(0) if grids else contextlib.nullcontext()
    with scope:
        h = m.train(**_tasks(tt, labels), seed=5, spmm_impl=impl,
                    block_epochs=block_epochs, **kw)
    return (h, {k: p.detach().clone() for k, p in m.params.items()},
            m.predict(tt.NodeClassification(np.arange(160, n))))


def _assert_same_run(a, b):
    (ha, pa, ya), (hb, pb, yb) = a, b
    for key in ("train_loss", "valid_loss", "best_epoch"):
        assert ha[key] == hb[key], key
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k
    assert torch.equal(ya, yb)


@pytest.mark.parametrize("impl,grids", [
    (None, True), ("pallas", True), ("segment", True), (None, False)],
    ids=["default", "pallas", "segment", "eager-edge-mask"])
def test_fused_equals_host_loop(impl, grids):
    kw = dict(epochs=9, patience=100, regularization=1e-3,
              degradation=lambda epoch: 0.9 ** epoch)
    host = _run(1, impl, grids, **kw)
    fused = _run(4, impl, grids, **kw)
    _assert_same_run(host, fused)
    assert host[0]["epochs_run"] == 10  # the host loop's rule: epoch + 1
    assert fused[0]["epochs_run"] == 9  # the fused rule: epochs run


def test_fused_with_another_optimizer_on_the_host():
    """An optimizer that is not ``KerasAdam`` runs the fused path on the
    host (a card needs KerasAdam's device step size)."""
    class SGD:
        def init(self, params):
            return {"count": 0}

        def update(self, grads, state):
            return ({k: -0.05 * g for k, g in grads.items()},
                    {"count": state["count"] + 1})

    kw = dict(epochs=6, patience=100)
    _assert_same_run(_run(1, optimizer=SGD(), **kw),
                     _run(3, optimizer=SGD(), **kw))


@pytest.mark.parametrize("block_epochs", [4, 40])
def test_patience_gating(block_epochs):
    """Epochs after the patience runs out inside a block leave the best
    parameters alone (``tests/test_trainer.py::
    test_block_epochs_patience_gating`` on the port's stack)."""
    kw = dict(epochs=40, patience=2, learning_rate=0.3)
    host, fused = _run(1, **kw), _run(block_epochs, **kw)
    assert len(host[0]["valid_loss"]) < 40
    assert torch.equal(host[2], fused[2])
    for k in host[1]:
        assert torch.equal(host[1][k], fused[1][k])
    assert host[0]["best_epoch"] == fused[0]["best_epoch"]
    n = len(host[0]["valid_loss"])
    assert fused[0]["valid_loss"][:n] == host[0]["valid_loss"]
    # the fused history runs to the end of the block that stopped
    assert fused[0]["epochs_run"] == len(fused[0]["valid_loss"])
    assert fused[0]["epochs_run"] == min(40, -(-n // block_epochs)
                                         * block_epochs)


def test_callbacks_see_the_host_loops_best_loss():
    """``tests/test_trainer.py::test_block_epochs_callback_best_loss`` on
    the port: the callbacks' running best loss is the host loop's, epoch by
    epoch; the fused path passes ``patience_remaining=-1``."""
    def run(block_epochs):
        seen = []
        _run(block_epochs, epochs=12, patience=50, callbacks=[
            lambda epoch, best_loss, patience_remaining, **_:
            seen.append((epoch, best_loss, patience_remaining))])
        return seen

    host, fused = run(1), run(4)
    assert [s[:2] for s in host] == [s[:2] for s in fused]
    assert len(fused) == 12 and {s[2] for s in fused} == {-1}


def test_tape_replays_the_host_loops_draws(monkeypatch):
    """The record of one training forward, rerun on a fresh generator,
    gives the salts and seeds that the host loop's forward draws from that
    generator; a forward fed them gives the host loop's output bit for
    bit."""
    src, dst, feats, _, n = _data(1)
    m = _appnp(src, dst, feats, n)
    m.reset(seed=0)
    salts, seeds = [], []
    draw_salt, dropout = pnorm.draw_salt, dropout_module.dropout

    def record_salt(source, device):
        salts.append(draw_salt(source, device))
        return salts[-1]

    def record_seed(x, rate, generator):
        seeds.append(generator.initial_seed())
        return dropout(x, rate, generator)

    gen = lambda: torch.Generator().manual_seed(77)
    with pst.min_edges_scope(0):
        tape = DrawTape()
        tape.record(torch.Generator().manual_seed(3))
        m.forward(m.features, training=True, generator=tape)
        tape.stop("cpu")
        monkeypatch.setattr(pnorm, "draw_salt", record_salt)
        monkeypatch.setattr(dropout_module, "dropout", record_seed)
        host = m.forward(m.features, training=True, generator=gen())
        monkeypatch.undo()
        tape_salts, tape_seeds, uniforms = tape.draw(gen())
        tape.salts.copy_(tape_salts)
        tape.feed(tape_seeds, uniforms)
        replayed = m.forward(m.features, training=True, generator=tape)
    assert len(salts) == 3 and len(seeds) == 2 and uniforms == []
    assert torch.equal(tape_salts, torch.stack(salts))
    assert tape_seeds == seeds
    assert [g.initial_seed() for g in tape.generators] == seeds
    assert torch.equal(replayed, host)
    assert tape.layers == [["seed"], ["seed"], []] + [["salt"]] * 3


def test_tape_rejects_a_forward_unlike_its_record():
    src, dst, feats, _, n = _data(2)
    m = _appnp(src, dst, feats, n)
    m.reset(seed=0)
    tape = DrawTape()
    with pst.min_edges_scope(0):
        tape.record(torch.Generator().manual_seed(0))
        m.forward(m.features, training=True, generator=tape)
    tape.stop("cpu")
    tape.layers[0] = ["salt"]
    with pytest.raises(RuntimeError):
        m.forward(m.features, training=True, generator=tape)


class _DrawsItself(tt.Layer):
    """A layer whose op draws from a generator of its own
    (``Forward.next_generator``)."""

    def build(self, net):
        return net.top_shape()

    def apply(self, fw, x):
        if not fw.training:
            return x
        return x * torch.rand(x.shape, generator=fw.next_generator())


def test_fused_raises_for_a_direct_generator_draw():
    """A layer's own draws (``next_generator()``, JAX's ``next_rng()``)
    are recorded and fed to each fused epoch: the fused run equals the
    host loop bit for bit."""
    src, dst, feats, labels, n = _data(3)
    runs = []
    for block_epochs in (1, 3):
        m = tt.GNN(tt.from_edges(src, dst, n_nodes=n, device="cpu"), feats,
                   device="cpu")
        m.add(tt.Dense(3))
        m.add(_DrawsItself())
        h = m.train(**_tasks(tt, labels), epochs=5, seed=0,
                    block_epochs=block_epochs)
        runs.append((h, {k: p.detach().clone() for k, p in m.params.items()},
                     m.predict(tt.NodeClassification(np.arange(160, n)))))
    _assert_same_run(*runs)


def test_verbose_block_epochs_takes_the_host_loop(capsys):
    kw = dict(epochs=5, patience=100, verbose=True)
    host, fused = _run(1, **kw), _run(2, **kw)
    _assert_same_run(host, fused)
    assert fused[0]["epochs_run"] == 6  # the host loop's rule
    assert "Epoch" in capsys.readouterr().out


def _stack(pkg, graph, feats, classes, device=None):
    kw = {} if device is None else {"device": device}
    relu = jax.nn.relu if pkg is gt else torch.relu
    m = pkg.GNN(graph, feats, **kw)
    m.add(pkg.Dense(16, activation=relu))
    h0 = m.add(pkg.Dense(classes, regularize=False))
    for _ in range(3):
        m.add(pkg.PPRIteration(h0, 0.1, graph_dropout=0.0))
    return m


@pytest.mark.parametrize("kw", [
    dict(epochs=10, patience=100, block_epochs=4),
    dict(epochs=30, patience=2, block_epochs=4, learning_rate=0.5)],
    ids=["to-the-end", "patience"])
def test_fused_matches_jax_fused(kw):
    src, dst, feats, labels, n = _data(4, n=200, e=600)
    jm = _stack(gt, gt.from_edges(src, dst, n_nodes=n, directed=False),
                feats, 3)
    pm = _stack(tt, tt.from_edges(src, dst, n_nodes=n, directed=False,
                                  device="cpu"), feats, 3, device="cpu")
    init = {k: np.asarray(v) for k, v in jm.init(11).items()}
    jh = jm.train(**_tasks(gt, labels), seed=7, init_params=dict(init), **kw)
    ph = pm.train(**_tasks(tt, labels), seed=7, init_params=dict(init), **kw)
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(ph[key], jh[key], **TRAJ_TOL)
    assert ph["best_epoch"] == jh["best_epoch"]
    assert ph["epochs_run"] == jh["epochs_run"]
    for k, v in jm.params.items():
        np.testing.assert_allclose(pm.params[k].detach().numpy(),
                                   np.asarray(v), **TRAJ_TOL)


def test_keras_adam_takes_a_step_size_tensor():
    """The fused path's table entry gives the update the host computes
    from the count, bit for bit."""
    rng = np.random.RandomState(0)
    tx = tt.keras_adam(0.01)
    p = {"w": torch.from_numpy(rng.randn(7, 3).astype(np.float32))}
    state = tx.init(p)
    for count in range(1, 6):
        g = {"w": torch.from_numpy(rng.randn(7, 3).astype(np.float32))}
        host, new = tx.update(g, state)
        table = torch.tensor([tx.step_size(count)], dtype=torch.float32)
        fused, _ = tx.update(g, state, step_size=table[0])
        assert torch.equal(host["w"], fused["w"])
        state = new


def test_predictor_static():
    assert tt.Predictor().static is True
    task = tt.NodeClassification([0, 1], [1, 0])
    assert task.static is True
    from gnntf_tpu_torch.train.trainer import _on
    nodes, labels = _on(task.batch(), "cpu")
    assert torch.equal(nodes, task.nodes) and torch.equal(labels, task.labels)


@pytest.mark.parametrize("salt", [(0, 0), (1, 2), (0x80000000, 0xFFFFFFFF),
                                  (0xDEADBEEF, 0x9E3779B9)])
def test_keep_mask_takes_a_salt_tensor(salt):
    """The hash with the salt as a tensor (the port's salts live on the
    graph's device) equals the hash on Python ints and the JAX package's."""
    e, keep, n_drop = 50_000, 0.5, 45_000
    eids = torch.arange(e)
    s0, s1 = salt
    h = pst._fmix32(pst._fmix32(eids ^ s0) ^ s1)
    ints = ((h >> 8) < pst._threshold(keep)) | (eids >= n_drop)
    ours = pst.keep_mask(eids, torch.tensor(salt), keep, n_drop)
    ref = jst.keep_mask(jnp.arange(e, dtype=jnp.uint32),
                        jnp.asarray(salt, jnp.uint32), keep, n_drop)
    assert torch.equal(ours, ints)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    assert torch.equal(pst.keep_mask(eids, salt, keep, n_drop), ours)


def test_draw_scalars_leave_the_salt_in_device_memory():
    assert pst.draw_scalars(0.5, 10) == (1 << 23, 10, 0, 2.0)
    assert pst.draw_scalars(0.5, 10, 7) == (1 << 23, 10, 7, 2.0)
    salt = torch.tensor([3, 4])
    assert pst.device_salt(salt, "cpu").data_ptr() == salt.data_ptr()
    assert pst.device_salt((3, 4), "cpu").tolist() == [3, 4]


def test_readded_layer_matches_jax():
    """F2: a layer added twice is applied twice with one set of
    parameters, in both packages."""
    src, dst, feats, _, n = _data(5, n=60, e=200)
    jm = gt.GNN(gt.from_edges(src, dst, n_nodes=n), feats)
    pm = tt.GNN(tt.from_edges(src, dst, n_nodes=n, device="cpu"), feats,
                device="cpu")
    for m, pkg in ((jm, gt), (pm, tt)):
        dense = m.add(pkg.Dense())
        again = m.add(dense)
        assert again is not dense and again.inner is dense
        assert again.output_shape == dense.output_shape
    jm.reset(seed=0)
    tt.params_from_jax({k: np.asarray(v) for k, v in jm.params.items()}, pm)
    assert list(pm.params) == list(jm.params) == ["p0", "p1"]
    np.testing.assert_allclose(pm._activations().detach().numpy(),
                               np.asarray(jm._activations()), rtol=1e-5,
                               atol=1e-6)


def test_create_var_defaults_to_a_scalar():
    src, dst, feats, _, n = _data(6, n=30, e=60)
    for m in (gt.GNN(gt.from_edges(src, dst, n_nodes=n), feats),
              tt.GNN(tt.from_edges(src, dst, n_nodes=n, device="cpu"), feats,
                     device="cpu")):
        names = [m.create_var(), m.create_var(None)]
        assert [s.shape for s in m.param_specs] == [(1, 1), (1, 1)]
        assert names == ["p0", "p1"]


def test_self_loops_are_memoized():
    """H3: the extension of one structure is built once (the same tensors
    at every call, so the identity-keyed grid and layout caches hit), the
    caller's lazy dropout is reattached, and it equals the JAX package's."""
    src, dst, _, _, n = _data(7, n=100, e=400)
    g = tt.from_edges(src, dst, n_nodes=n, device="cpu")
    a, b = tt.add_self_loops(g), tt.add_self_loops(g)
    assert a.row is b.row and a.col is b.col and a.val is b.val
    assert tt.add_self_loops(g, 2.0).val is not a.val
    salt = torch.tensor([5, 6])
    d = tt.add_self_loops(dataclasses.replace(
        g, drop_salt=salt, drop_keep=0.5, drop_n=g.n_edges))
    assert d.row is a.row and d.drop_salt is salt and d.drop_keep == 0.5
    assert d.drop_n == g.n_edges and d.num_self_loop == n
    ref = gt.add_self_loops(gt.from_edges(src, dst, n_nodes=n))
    for name in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      np.asarray(getattr(ref, name)))
    assert a.num_self_loop == ref.num_self_loop


def test_self_loops_build_the_grids_once():
    """H3 seen from the training path: ``add_eye='before'`` in every layer
    of three steps builds the extended structure's grids once."""
    src, dst, _, _, n = _data(8, n=100, e=400)
    g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
    x = torch.ones(n, 2)
    before = pst.train_grids.builds
    with pst.min_edges_scope(0):
        for step in range(3):
            adj = tt.normalize_adjacency(
                g, graph_dropout=0.5, add_eye="before",
                generator=torch.Generator().manual_seed(step))
            tt.spmm(adj, x)
    assert pst.train_grids.builds == before + 1


def test_blocked_lists_key_on_row_and_col():
    """H4: two graphs that share ``row`` but not ``col`` get their own K2
    lists, each product equal to the plain segment product."""
    rng = np.random.RandomState(9)
    n, e = 200, 1500
    row = torch.from_numpy(np.sort(rng.randint(0, n, e)).astype(np.int64))
    val = torch.from_numpy(rng.rand(e).astype(np.float32))
    x = torch.from_numpy(rng.randn(n, 4).astype(np.float32))
    for seed in (1, 2):
        col = torch.from_numpy(
            np.random.RandomState(seed).randint(0, n, e).astype(np.int64))
        g = tt.Graph(row, col, val, n)
        np.testing.assert_allclose(
            pblocked.spmm_pallas(g, x).numpy(),
            spmm_module.spmm_segment(g, x).numpy(), rtol=1e-5, atol=1e-5)


def test_drawn_values_follow_a_salt_rewritten_in_place():
    """A salt buffer refilled for the next draw (as a replayed epoch's
    slots are) gives the next draw's values, not the kept ones."""
    rng = np.random.RandomState(10)
    val = torch.from_numpy(rng.rand(5000).astype(np.float32))
    buf = torch.tensor([1, 2])
    first = pst.drawn_values(val, buf, 0.5, 5000)
    assert pst.drawn_values(val, buf, 0.5, 5000) is first  # kept
    buf.copy_(torch.tensor([3, 4]))
    second = pst.drawn_values(val, buf, 0.5, 5000)
    assert torch.equal(second, pst.dropped_values(
        val, torch.arange(5000), torch.tensor([3, 4]), 0.5, 5000))
    assert not torch.equal(first, second)
