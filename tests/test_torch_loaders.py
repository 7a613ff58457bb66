"""The port's data loaders (``gnntf_tpu_torch/data/loaders.py``) against the
JAX package's, on the fixtures that ``tests/test_data.py`` writes and on
seeded draws: equal graphs, features, labels, splits and edge samples."""
import os

import networkx as nx
import numpy as np
import pytest

import gnntf_tpu as gt
import gnntf_tpu_torch as tt
from gnntf_tpu.data import loaders as jl
from gnntf_tpu_torch.data import loaders as pl
from test_data import (DENSE_CITES, DENSE_CONTENT, NAMED_CITES,
                       NAMED_CONTENT, _write)


def _same_graph(a, b):
    assert list(a) == list(b)
    assert list(a.edges()) == list(b.edges())


@pytest.mark.parametrize("name,cites,content", [
    ("dense", DENSE_CITES, DENSE_CONTENT),
    ("named", NAMED_CITES, NAMED_CONTENT)])
def test_dataload_and_load_match_jax(tmp_path, name, cites, content):
    data_dir = os.path.join(_write(tmp_path, name, cites, content), "data")
    for fn in ("_dataload", "load"):
        G, feats, labels = getattr(pl, fn)(name, data_dir)
        G_j, feats_j, labels_j = getattr(jl, fn)(name, data_dir)
        _same_graph(G, G_j)
        assert feats == feats_j and labels == labels_j
    pl._loaded.clear()
    jl._loaded.clear()


def test_dgl_setup_from_files_matches_jax(tmp_path, monkeypatch):
    data_dir = os.path.join(
        _write(tmp_path, "tiny", DENSE_CITES, DENSE_CONTENT), "data")
    monkeypatch.delenv("GNNTF_TPU_ALLOW_SYNTHETIC", raising=False)
    ours = pl.dgl_setup("tiny", data_dir)
    theirs = jl.dgl_setup("tiny", data_dir)
    _same_graph(ours[0], theirs[0])
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(FileNotFoundError):
        pl.dgl_setup("absent", data_dir)


def test_dgl_setup_synthetic_and_pickle_match_jax(tmp_path, monkeypatch):
    monkeypatch.setenv("GNNTF_TPU_ALLOW_SYNTHETIC", "1")
    ours = pl.dgl_setup("cora", str(tmp_path))
    theirs = jl.dgl_setup("cora", str(tmp_path))
    _same_graph(ours[0], theirs[0])
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    import pickle
    with open(tmp_path / "cached.dat", "wb") as f:
        pickle.dump(theirs, f)
    cached = pl.dgl_setup("cached", str(tmp_path))
    _same_graph(cached[0], theirs[0])


def test_ogb_setup_from_npz_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    n = 50
    np.savez(tmp_path / "ogbn_tiny.npz", src=rng.randint(0, n, 200),
             dst=rng.randint(0, n, 200), n_nodes=np.int64(n),
             labels=rng.randint(0, 3, n), features=rng.rand(n, 4),
             train=np.arange(20), valid=np.arange(20, 35),
             test=np.arange(35, 50))
    ours = pl.ogb_setup("ogbn-tiny", str(tmp_path), device="cpu")
    theirs = jl.ogb_setup("ogbn-tiny", str(tmp_path))
    for field in ("row", "col", "val"):
        np.testing.assert_array_equal(getattr(ours[0], field).numpy(),
                                      np.asarray(getattr(theirs[0], field)))
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("seed", [0, 5])
def test_splits_match_jax(seed):
    labels = np.random.RandomState(seed).randint(-1, 4, size=300)
    for num_validation in (50, None):
        ours = pl.custom_splits(labels, examples_per_class=7,
                                num_validation=num_validation, seed=seed)
        theirs = jl.custom_splits(labels, examples_per_class=7,
                                  num_validation=num_validation, seed=seed)
        assert [list(a) for a in ours] == [list(b) for b in theirs]
    assert pl.random_splits(labels, 0.5, 0.3, seed=seed) == \
        jl.random_splits(labels, 0.5, 0.3, seed=seed)


def test_sample_edges_matches_jax():
    G = nx.gnm_random_graph(80, 300, seed=3, directed=True)
    G.add_edge(5, 5)  # a self-loop is skipped
    gt.set_seed(4)
    je, jlab = jl.sample_edges(G)
    tt.set_seed(4)
    pe, plab = pl.sample_edges(G)
    np.testing.assert_array_equal(pe, je)
    np.testing.assert_array_equal(plab, jlab)
    assert len(pe) == 3 * 300


def test_tpl_setup_matches_jax(tmp_path):
    ours = pl.tpl_setup(seed=2)
    theirs = jl.tpl_setup(seed=2)
    _same_graph(ours[0], theirs[0])
    assert ours[1:3] == theirs[1:3]
    np.testing.assert_array_equal(ours[3], theirs[3])
    csv = tmp_path / "apps.csv"
    rows = [f"app{i},{';'.join(f'lib{(i + j) % 15}' for j in range(12))},"
            f"w{i % 4} w{i % 3} common" for i in range(8)]
    csv.write_text("\n".join(rows) + "\n")
    ours = pl.tpl_setup(app_csv=str(csv), min_df=2)
    theirs = jl.tpl_setup(app_csv=str(csv), min_df=2)
    _same_graph(ours[0], theirs[0])
    assert ours[1:3] == theirs[1:3]
    np.testing.assert_array_equal(ours[3], theirs[3])


def test_enrich_features_matches_jax():
    rng = np.random.RandomState(1)
    feats = rng.rand(30, 5)
    labels = rng.randint(0, 3, 30)
    for kw in (dict(), dict(labels=labels, train=[0, 4, 9]),
               dict(positional=False, labels=labels, train=[1])):
        np.testing.assert_array_equal(pl.enrich_features(feats, **kw),
                                      jl.enrich_features(feats, **kw))


def test_loaders_exported():
    from gnntf_tpu_torch import data
    for name in ("dgl_setup", "ogb_setup", "load", "custom_splits",
                 "random_splits", "sample_edges", "enrich_features",
                 "tpl_setup"):
        assert getattr(data, name) is getattr(pl, name)
