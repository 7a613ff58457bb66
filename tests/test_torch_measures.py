"""The port's measures against the JAX package's: ``auc`` (numpy in the
port, scikit-learn's ``roc_curve`` + ``auc`` in the JAX package) to
rtol=1e-12, the ranking measures and ``bootstrap_ci`` exactly (the same
numpy code on the same inputs).
"""
import numpy as np
import pytest

import gnntf_tpu as gt
import gnntf_tpu_torch as tt


def _scores(seed, n=300, decimals=None):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 2, n)
    scores = rng.rand(n) + 0.3 * labels
    if decimals is not None:  # many ties
        scores = np.round(scores, decimals)
    return labels, scores


@pytest.mark.parametrize("seed,decimals", [(0, None), (1, 1), (2, 2),
                                           (3, 0)])
def test_auc_matches_jax(seed, decimals):
    labels, scores = _scores(seed, decimals=decimals)
    np.testing.assert_allclose(tt.auc(labels, scores),
                               gt.auc(labels, scores), rtol=1e-12)


def test_auc_extremes():
    labels = np.array([0, 0, 1, 1])
    assert tt.auc(labels, np.array([0.1, 0.2, 0.3, 0.4])) == 1.0
    assert tt.auc(labels, np.array([0.4, 0.3, 0.2, 0.1])) == 0.0
    assert tt.auc(labels, np.ones(4)) == 0.5
    assert np.isnan(tt.auc(np.ones(4), np.arange(4.0)))


@pytest.mark.parametrize("measure", ["avprec", "rec", "prec", "f1"])
@pytest.mark.parametrize("k", [1, 5, 40])
def test_ranking_measures_match_jax(measure, k):
    for seed in range(3):
        labels, scores = _scores(seed, n=100)
        assert getattr(tt, measure)(labels, scores, k) == \
            getattr(gt, measure)(labels, scores, k)
    zeros = np.zeros(20, np.int64)
    if measure == "avprec":
        assert getattr(tt, measure)(zeros, np.arange(20.0), k) == 0


def test_bootstrap_ci_matches_jax():
    values = np.random.RandomState(4).rand(17)
    ours = tt.measures.bootstrap_ci(values, confidence=0.9, n_boot=500,
                                    seed=3)
    assert ours == gt.measures.bootstrap_ci(values, confidence=0.9,
                                            n_boot=500, seed=3)
    assert ours[1] <= ours[0] <= ours[2]
