"""K2's bfloat16 mode, ``spmm_pallas(graph, x, bf16=True)``, against the JAX
package's (its Pallas kernel in interpret mode on the CPU), and the
kernel's wrapper and plain version.

Each term is ``fp32(bf16_rn(fp32(val * fp32(bf16_rn(x)))))`` in both
packages, bit for bit; only the order of the float32 sums differs (JAX's
one-hot product, the port's walk order).  So outputs are held within
``1e-6 * sum|terms|`` element by element (``sum|terms|`` in float64 from the
absolute values); a bfloat16 output, rounded from sums that may differ in
their last float32 bit, within that plus one bfloat16 rounding (``2**-8``
of the value).  The backward is float32 in both packages (``dx = A^T dy``,
``dval = <dy[row], x[col]>`` over the unrounded ``x``): within ``1e-6``
of the sum of its terms' magnitudes as well.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops.pallas import spmm_pallas as jax_spmm_pallas
from gnntf_tpu_torch.ops import (blocked, blocked_spmm_bf16,
                                 blocked_spmm_bf16_plain, spmm_pallas)

BLOCKING = dict(window=64, tile=64, block_edges=128)
TERM_RTOL = 1e-6
N = 300


def _graphs(seed, hub=True):
    """A weighted directed graph in both packages: duplicate pairs, row 3
    without edges, and (``hub``) row 5 with 400 edges, which the port's
    walk splits into pieces."""
    rng = np.random.RandomState(seed)
    src = rng.randint(0, N, 2000)
    dst = rng.randint(0, 60, 2000) * 5  # columns repeat: duplicate pairs
    if hub:
        src = np.concatenate([src, np.full(400, 5)])
        dst = np.concatenate([dst, rng.randint(0, N, 400)])
    keep = src != 3
    src, dst = src[keep], dst[keep]
    vals = rng.uniform(-1.5, 2.0, len(src))
    kw = dict(n_nodes=N, directed=True)
    return (gt.from_edges(src, dst, vals, **kw),
            tt.from_edges(src, dst, vals, device="cpu", **kw))


def _magnitudes(pg, x):
    """``sum|terms|`` of each output element: the float32 product of the
    graph with every value and every element of ``x`` made absolute, its
    scales and identity as they are (positive)."""
    absolute = dataclasses.replace(pg, val=pg.val.abs())
    return spmm_pallas(absolute, torch.from_numpy(np.abs(x)),
                       **BLOCKING).double().numpy()


def _jax(jg, x, **kw):
    return np.asarray(jax_spmm_pallas(jg, jnp.asarray(x), interpret=True,
                                      **BLOCKING, **kw))


def _within(out, ref, scale, extra=0.0):
    err = np.abs(out.astype(np.float64) - ref.astype(np.float64))
    limit = TERM_RTOL * scale + extra
    assert (err <= limit).all(), float((err - limit).max())


@pytest.mark.parametrize("f", [1, 7, 16, 40])
@pytest.mark.parametrize("seed", [0, 1])
def test_bf16_product_matches_jax(seed, f):
    jg, pg = _graphs(seed)
    x = np.random.RandomState(seed + 10).randn(N, f).astype(np.float32)
    ref = _jax(jg, x, bf16=True)
    out = spmm_pallas(pg, torch.from_numpy(x), bf16=True, **BLOCKING)
    assert out.dtype == torch.float32 and out.shape == (N, f)
    _within(out.numpy(), ref, _magnitudes(pg, x))
    assert not out[3].any()
    # the mode rounds: it is not the float32 product
    assert not np.array_equal(out.numpy(), _jax(jg, x))


@pytest.mark.parametrize("add_eye", ["none", "after"])
def test_bf16_product_of_a_normalized_graph_matches_jax(add_eye):
    """The lazy scales and identity apply around the kernel in float32, so
    the mode rounds ``cs * x``."""
    jg, pg = _graphs(2)
    jn = gt.normalize_adjacency(jg, graph_dropout=0.0, add_eye=add_eye)
    pn = tt.normalize_adjacency(pg, graph_dropout=0.0, add_eye=add_eye)
    assert pn.scaled
    x = np.random.RandomState(3).randn(N, 16).astype(np.float32)
    out = spmm_pallas(pn, torch.from_numpy(x), bf16=True, **BLOCKING)
    _within(out.numpy(), _jax(jn, x, bf16=True), _magnitudes(pn, x))


def test_bf16_product_of_a_dropped_graph_matches_jax():
    jg, pg = _graphs(4)
    salt = (12345, 678)
    jd = dataclasses.replace(jg, drop_salt=jnp.asarray(salt, jnp.uint32),
                             drop_keep=0.5, drop_n=pg.n_edges)
    pd = dataclasses.replace(pg, drop_salt=torch.tensor(salt),
                             drop_keep=0.5, drop_n=pg.n_edges)
    assert pd.dropped
    x = np.random.RandomState(5).randn(N, 24).astype(np.float32)
    out = spmm_pallas(pd, torch.from_numpy(x), bf16=True, **BLOCKING)
    _within(out.numpy(), _jax(jd, x, bf16=True),
            _magnitudes(pd.materialized(), x))


def test_bf16_input_gives_a_bf16_output():
    jg, pg = _graphs(6)
    xb = torch.from_numpy(np.random.RandomState(7).randn(N, 16).astype(
        np.float32)).to(torch.bfloat16)
    x32 = xb.to(torch.float32).numpy()
    ref = np.asarray(jax_spmm_pallas(
        jg, jnp.asarray(x32).astype(jnp.bfloat16), interpret=True, bf16=True,
        **BLOCKING)).astype(np.float32)
    out = spmm_pallas(pg, xb, bf16=True, **BLOCKING)
    assert out.dtype == torch.bfloat16
    _within(out.to(torch.float32).numpy(), ref, _magnitudes(pg, x32),
            extra=2.0 ** -8 * np.abs(ref))
    # the float32 input's product, rounded: the same terms
    out32 = spmm_pallas(pg, torch.from_numpy(x32), bf16=True, **BLOCKING)
    assert torch.equal(out, out32.to(torch.bfloat16))


@pytest.mark.parametrize("f", [7, 40])
def test_bf16_gradients_match_jax(f):
    """``jax.grad`` through the custom VJP (float32, the unrounded ``x``)
    against the port's backward."""
    jg, pg = _graphs(8)
    rng = np.random.RandomState(9)
    x = rng.randn(N, f).astype(np.float32)
    dy = rng.randn(N, f).astype(np.float32)

    def loss(v, xx):
        g = dataclasses.replace(jg, val=v)
        out = jax_spmm_pallas(g, xx, interpret=True, bf16=True, **BLOCKING)
        return jnp.sum(out * jnp.asarray(dy))

    ref_dval, ref_dx = jax.grad(loss, argnums=(0, 1))(jg.val, jnp.asarray(x))
    val = pg.val.clone().requires_grad_()
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm_pallas(dataclasses.replace(pg, val=val), xt, bf16=True,
                      **BLOCKING)
    out.backward(torch.from_numpy(dy))
    row, col = pg.row.numpy(), pg.col.numpy()
    dx_scale = np.zeros((N, f))
    np.add.at(dx_scale, col, np.abs(pg.val.numpy())[:, None]
              * np.abs(dy[row]))
    _within(xt.grad.numpy(), np.asarray(ref_dx), dx_scale)
    dval_scale = (np.abs(dy[row]) * np.abs(x[col])).sum(1)
    _within(val.grad.numpy(), np.asarray(ref_dval), dval_scale)


def test_plain_version_rounds_each_term():
    """The plain version's terms are float32 products rounded to bfloat16
    (to nearest even), summed in the walk's order: a row of one edge holds
    its term exactly."""
    _, pg = _graphs(10, hub=False)
    prep = blocked.blocked_layout(pg)
    xb = torch.from_numpy(np.random.RandomState(11).randn(N, 8).astype(
        np.float32)).to(torch.bfloat16)
    val = pg.val.to(torch.float32)
    out = blocked_spmm_bf16_plain(prep.forward, val, xb)
    row, col = pg.row.numpy(), pg.col.numpy()
    single = np.flatnonzero(np.bincount(row, minlength=N) == 1)
    e = np.flatnonzero(np.isin(row, single))
    term = (xb[col[e]].to(torch.float32) * val[e, None]).to(
        torch.bfloat16).to(torch.float32)
    assert len(e) and torch.equal(out[row[e]], term)
    before = blocked_spmm_bf16.launches
    assert torch.equal(blocked_spmm_bf16(prep.forward, val, xb), out)
    assert blocked_spmm_bf16.launches == before  # the CPU counts nothing


def test_wrapper_checks_its_inputs():
    _, pg = _graphs(12, hub=False)
    lst = blocked.blocked_layout(pg).forward
    val = pg.val.to(torch.float32)
    xb = torch.zeros(N, 8, dtype=torch.bfloat16)
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val, xb.to(torch.float32))
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val, xb[:-1])
    with pytest.raises(TypeError):
        blocked_spmm_bf16(lst, val.to(torch.float64), xb)
    with pytest.raises(ValueError):
        blocked_spmm_bf16(lst, val, torch.zeros(8, N,
                                                dtype=torch.bfloat16).t())


@pytest.mark.parametrize("widest", [8, 4, 2, 1])
def test_forced_loads_follow_width_and_alignment(monkeypatch, widest):
    """``_BF16_VEC`` set: a lane loads the most bfloat16 that the width,
    both addresses and ``_BF16_VEC`` allow, whatever the lanes."""
    monkeypatch.setattr(blocked, "_BF16_VEC", widest)
    cases = {  # (f, x address, out address): widest load allowed
        (40, 0, 0): 8, (40, 8, 16): 4, (40, 4, 8): 2, (40, 2, 4): 1,
        (12, 0, 0): 4, (6, 0, 0): 2, (7, 0, 0): 1, (1, 0, 0): 1,
        (64, 16, 8): 2}
    for (f, x_at, out_at), most in cases.items():
        assert blocked.bf16_vec(f, x_at, out_at) == min(most, widest), (
            f, x_at, out_at)


def test_loads_keep_the_wide_walk():
    """By default a lane loads the most bfloat16 that leaves a row at least
    8 loads, as the sweep chose: 2 at F=16, 4 at F=40, 8 at F=64 and 128;
    1 where no load does (the narrow walk)."""
    assert blocked._BF16_VEC is None
    cases = {(16, 0, 0): 2, (40, 0, 0): 4, (64, 0, 0): 8, (128, 0, 0): 8,
             (24, 0, 0): 2, (128, 8, 0): 4, (128, 0, 8): 2, (8, 0, 0): 1,
             (7, 0, 0): 1, (1, 0, 0): 1}
    for (f, x_at, out_at), vec in cases.items():
        assert blocked.bf16_vec(f, x_at, out_at) == vec, (f, x_at, out_at)


def test_pallas_impl_keeps_float32():
    """``spmm_impl("pallas")`` calls K2 without ``bf16``, as JAX's
    dispatcher does."""
    jg, pg = _graphs(13)
    x = np.random.RandomState(14).randn(N, 8).astype(np.float32)
    with tt.spmm_impl("pallas"):
        out = tt.spmm(pg, torch.from_numpy(x))
    assert torch.equal(out, spmm_pallas(pg, torch.from_numpy(x)))
