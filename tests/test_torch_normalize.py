"""The port's deterministic adjacency normalization against the JAX
package: every mode x add_eye, scales and materialized values at
rtol=1e-6 (float32; rsqrt and division may differ by an ulp)."""
import numpy as np
import pytest
import torch

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.ops import normalize_adjacency as jax_normalize
from gnntf_tpu_torch.ops import normalize_adjacency

RTOL = 1e-6


def _graphs():
    rng = np.random.RandomState(7)
    # duplicates, a directed edge set (colsum != rowsum) and isolated nodes
    # 80..99 (zero degree -> zero scale)
    src, dst = rng.randint(0, 80, size=(2, 900))
    vals = rng.rand(900) + 0.5
    return (gt.from_edges(src, dst, vals, n_nodes=100),
            tt.from_edges(src, dst, vals, n_nodes=100, device="cpu"))


def _close(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=RTOL,
                                   atol=0)


@pytest.mark.parametrize("normalized", ["symmetric", "bipartite", "row",
                                        "none"])
@pytest.mark.parametrize("add_eye", ["none", "before", "after"])
def test_normalize_matches_jax(normalized, add_eye):
    jg, pg = _graphs()
    jn = jax_normalize(jg, graph_dropout=0.0, normalized=normalized,
                       add_eye=add_eye)
    pn = normalize_adjacency(pg, graph_dropout=0.0, normalized=normalized,
                             add_eye=add_eye)
    _close(jn.row_scale, pn.row_scale)
    _close(jn.col_scale, pn.col_scale)
    assert jn.eye_weight == pn.eye_weight
    assert jn.num_self_loop == pn.num_self_loop
    jm, pm = jn.materialized(), pn.materialized()
    np.testing.assert_array_equal(np.asarray(jm.row), pm.row.numpy())
    np.testing.assert_array_equal(np.asarray(jm.col), pm.col.numpy())
    _close(jm.val, pm.val)


def test_degree_matches_jax():
    from gnntf_tpu.ops.normalize import _degree as jax_degree
    from gnntf_tpu_torch.ops.normalize import _degree
    jg, pg = _graphs()
    for by in ("col", "row"):
        _close(jax_degree(jg, by=by), _degree(pg, by=by))


def test_edge_dropout_not_ported_raises():
    """Edge dropout is ported: a generator draws a fresh mask, a rate
    outside [0, 1) raises, and rate 0 or no generator is the deterministic
    path."""
    _, pg = _graphs()
    with pytest.raises(ValueError):
        normalize_adjacency(pg, graph_dropout=1.0,
                            generator=torch.Generator().manual_seed(0))
    dropped = normalize_adjacency(pg, graph_dropout=0.5,
                                  generator=torch.Generator().manual_seed(0))
    assert 0 < int((dropped.val == 0).sum()) < pg.n_edges
    for g in (normalize_adjacency(pg, graph_dropout=0.5),
              normalize_adjacency(pg, graph_dropout=0.0,
                                  generator=torch.Generator().manual_seed(0))):
        assert torch.equal(g.val, pg.val) and not g.dropped


def test_invalid_mode_raises():
    _, pg = _graphs()
    with pytest.raises(ValueError):
        normalize_adjacency(pg, graph_dropout=0.0, normalized="bogus")
