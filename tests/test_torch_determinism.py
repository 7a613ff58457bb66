"""Small graphs train reproducibly (fault F7): below 65,536 counted edges,
at Cora scale (2,708 nodes, 10,556 counted edges) and with no
``min_edges_scope``, two identical runs of the port on the CPU are equal
bit for bit, as the JAX package's are, and the outputs stay allclose to the
JAX package's on the same numpy inputs.

The products there take ``spmm_segment`` and GAT's segment chain, whose
gathers sum their backward with ``index_add_`` in index order
(``ops/spmm.py::_SegmentFn``, ``ops/segment.py::gather_rows``); autograd's
backward of ``x[col]`` summed in no fixed order.  Tolerances as in
``test_torch_spmm.py`` and ``test_torch_attention.py``: forwards
``rtol=1e-5, atol=1e-5``, gradients ``rtol=1e-4, atol=1e-5``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import attention as ja
from gnntf_tpu.ops.spmm import spmm_segment as jax_segment
from gnntf_tpu_torch.ops import attention as pa
from gnntf_tpu_torch.ops.spmm import spmm_segment

N, EDGES, CLASSES = 2708, 5278, 7
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _cora_scale(seed=0):
    rng = np.random.RandomState(seed)
    src, dst = rng.randint(0, N, EDGES), rng.randint(0, N, EDGES)
    pg = tt.from_edges(src, dst, n_nodes=N, directed=False, device="cpu")
    jg = gt.from_edges(src, dst, n_nodes=N, directed=False)
    assert pg.n_edges == 10_556
    return jg, pg, rng.rand(N, 64).astype(np.float32), \
        rng.randint(0, CLASSES, N)


@pytest.fixture(scope="module")
def data():
    return _cora_scale()


def _tasks(pkg, labels):
    return (pkg.NodeClassification(np.arange(140), labels[:140]),
            pkg.NodeClassification(np.arange(200, 700), labels[200:700]))


@pytest.mark.parametrize("f", [7, 16, 64])
def test_spmm_segment_gradient_repeats_and_matches_jax(data, f):
    jg, pg, _, _ = data
    adj = tt.normalize_adjacency(pg)
    rng = np.random.RandomState(f)
    x0, dy = rng.randn(N, f).astype(np.float32), rng.randn(N, f).astype(
        np.float32)
    runs = []
    for _ in range(2):
        x = torch.tensor(x0, requires_grad=True)
        out = spmm_segment(adj, x)
        out.backward(torch.from_numpy(dy))
        runs.append((out.detach(), x.grad))
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])
    jadj = gt.normalize_adjacency(jg)
    out, vjp = jax.vjp(lambda x: jax_segment(jadj, x), jnp.asarray(x0))
    np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(out),
                               **FWD_TOL)
    np.testing.assert_allclose(runs[0][1].numpy(),
                               np.asarray(vjp(jnp.asarray(dy))[0]),
                               **GRAD_TOL)


@pytest.mark.parametrize("drop", [0.0, 0.6])
def test_gat_segment_gradients_repeat_and_match_jax(data, drop):
    jg, pg, _, _ = data
    pg, jg = tt.add_self_loops(pg), gt.add_self_loops(jg)
    rng = np.random.RandomState(3)
    h = rng.randn(pg.n_nodes, 2, 8).astype(np.float32)
    ss, sd = (rng.randn(pg.n_nodes, 2).astype(np.float32) for _ in "ab")
    salt = np.array([0x12345678, 0x9ABCDEF0], np.uint32)
    runs = []
    for _ in range(2):
        args = [torch.tensor(v, requires_grad=True) for v in (h, ss, sd)]
        out = pa._gat_attention_segment(
            pg, *args, negative_slope=0.2, attn_dropout=drop,
            salt=torch.tensor(salt.astype(np.int64)), sorted_by_row=False)
        (out ** 2).sum().backward()
        runs.append([out.detach()] + [a.grad for a in args])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    kw = dict(negative_slope=0.2, attn_dropout=drop,
              salt=jnp.asarray(salt), sorted_by_row=False)
    jargs = [jnp.asarray(v) for v in (h, ss, sd)]
    want = ja._gat_attention_segment(jg, *jargs, **kw)
    grads = jax.grad(lambda *a: jnp.sum(ja._gat_attention_segment(
        jg, *a, **kw) ** 2), argnums=(0, 1, 2))(*jargs)
    np.testing.assert_allclose(runs[0][0].numpy(), np.asarray(want),
                               **FWD_TOL)
    for got, ref in zip(runs[0][1:], grads):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4 if drop else 1e-5)


def _trained(model_fn, labels, **kw):
    model = model_fn()
    hist = model.train(*_tasks(tt, labels), epochs=5, seed=1, **kw)
    return hist, {k: p.detach().clone() for k, p in model.params.items()}


@pytest.mark.parametrize("name", ["APPNP", "GAT"])
def test_two_identical_runs_are_bit_equal(data, name):
    """``train(epochs=5, seed=1)`` twice, with every dropout on and the
    eager edge mask of a graph below ``min_edges()``."""
    _, pg, feats, labels = data
    make = lambda: getattr(tt, name)(pg, feats, num_classes=CLASSES,
                                     device="cpu")
    (h1, p1), (h2, p2) = (_trained(make, labels) for _ in range(2))
    assert h1 == h2
    for k in p1:
        assert torch.equal(p1[k], p2[k]), k


@pytest.mark.parametrize("name", ["APPNP", "GAT"])
def test_fused_equals_host_loop_at_cora_scale(data, name):
    _, pg, feats, labels = data
    make = lambda: getattr(tt, name)(pg, feats, num_classes=CLASSES,
                                     device="cpu")
    host = _trained(make, labels, block_epochs=1)
    fused = _trained(make, labels, block_epochs=5)
    for key in ("train_loss", "valid_loss", "best_epoch"):
        assert fused[0][key] == host[0][key], key
    for k in host[1]:
        assert torch.equal(fused[1][k], host[1][k]), k


@pytest.mark.parametrize("name", ["APPNP", "GAT"])
def test_forward_matches_jax_at_cora_scale(data, name):
    jg, pg, feats, _ = data
    jm = getattr(gt, name)(jg, feats, num_classes=CLASSES)
    pm = getattr(tt, name)(pg, feats, num_classes=CLASSES, device="cpu")
    params = {k: np.asarray(v) for k, v in jm.init(0).items()}
    tt.params_from_jax(params, pm)
    want = np.asarray(jm.apply(params, jm.features, training=False))
    with torch.no_grad():
        got = pm.forward(pm.features, training=False).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
