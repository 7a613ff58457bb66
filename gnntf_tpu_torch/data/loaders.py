"""Dataset loading and split utilities (reference
experiments/experiment_setup.py, the de-facto data layer), a copy of the JAX
package's ``data/loaders.py`` reading only files under ``data_dir``.

The data contract is the tuple ``(G, labels, features, train, valid,
test)`` (README.md:14-17): a directed networkx graph, numpy label and
feature arrays in graph-iteration order, and three index lists.  networkx
and scipy are imported inside the functions that need them.
"""
from __future__ import annotations

import os
import pickle
import random
from typing import Optional

import numpy as np


def dgl_setup(dataset_name: str, data_dir: str = "data"):
    """Canonical loader (reference experiment_setup.py:153-181), offline:
    the pickle cache that DGL's loader writes, then citeseer-style files on
    disk, then a deterministic synthetic stand-in (with
    ``GNNTF_TPU_ALLOW_SYNTHETIC=1``), else an error.  DGL itself is never
    imported: it downloads."""
    cache = os.path.join(data_dir, dataset_name + ".dat")
    if os.path.exists(cache):
        with open(cache, "rb") as f:
            return pickle.load(f)
    cites = os.path.join(data_dir, dataset_name + ".cites")
    if os.path.exists(cites):
        G, features, labels = load(dataset_name, data_dir=data_dir)
        feats = np.array([features[u] for u in G], np.float32)
        label_ids = {l: i for i, l in enumerate(sorted(set(labels.values())))}
        labs = np.array([label_ids[labels[u]] for u in G])
        train, valid, test = custom_splits(labs, num_validation=500)
        return G, labs, feats, train, valid, test
    if os.environ.get("GNNTF_TPU_ALLOW_SYNTHETIC") == "1":
        from .synthetic import synthetic_planetoid
        sizes = {"cora": (2708, 7, 1433), "citeseer": (3327, 6, 3703),
                 "pubmed": (19717, 3, 500)}
        n, c, f = sizes.get(dataset_name, (2708, 7, 256))
        return synthetic_planetoid(n_nodes=n, n_classes=c,
                                   n_features=min(f, 512))
    raise FileNotFoundError(
        f"No cached/offline data for {dataset_name!r}; place a pickle at "
        f"{cache} or citeseer-style files in {data_dir}, or set "
        f"GNNTF_TPU_ALLOW_SYNTHETIC=1 for a synthetic stand-in")


def ogb_setup(dataset_name: str = "ogbn-arxiv", data_dir: str = "data",
              device="cuda"):
    """OGB node-property loader at array scale, offline: the npz cache that
    the ``ogb`` package's loader writes (``scripts/ingest.py`` makes one),
    then a deterministic synthetic stand-in of the same scale (with
    ``GNNTF_TPU_ALLOW_SYNTHETIC=1``), else an error.  The graph is a
    :class:`~gnntf_tpu_torch.graph.coo.Graph` on ``device``, not a networkx
    object; the tuple is otherwise the data contract ``(graph, labels,
    features, train, valid, test)``."""
    from ..graph import from_edges

    cache = os.path.join(data_dir, dataset_name.replace("-", "_") + ".npz")
    if os.path.exists(cache):
        z = np.load(cache)
        graph = from_edges(z["src"], z["dst"], n_nodes=int(z["n_nodes"]),
                           directed=False, device=device)
        return (graph, z["labels"], z["features"],
                z["train"].tolist(), z["valid"].tolist(), z["test"].tolist())
    if os.environ.get("GNNTF_TPU_ALLOW_SYNTHETIC") == "1":
        from .synthetic import random_power_law_edges
        sizes = {"ogbn-arxiv": (169_343, 1_166_243, 128, 40)}
        n, e, f, c = sizes.get(dataset_name, (100_000, 800_000, 128, 16))
        rng = np.random.RandomState(0)
        src, dst = random_power_law_edges(n, e, seed=0)
        graph = from_edges(src, dst, n_nodes=n, directed=False,
                           device=device)
        labels = rng.randint(0, c, size=n).astype(np.int64)
        features = rng.randn(n, f).astype(np.float32)
        order = rng.permutation(n)
        n_tr, n_va = int(0.54 * n), int(0.18 * n)
        return (graph, labels, features, order[:n_tr].tolist(),
                order[n_tr:n_tr + n_va].tolist(),
                order[n_tr + n_va:].tolist())
    raise FileNotFoundError(
        f"No cached/offline data for {dataset_name!r}; place an npz at "
        f"{cache} or set GNNTF_TPU_ALLOW_SYNTHETIC=1 for a synthetic "
        f"stand-in")


_loaded = {}


def load(dataset_name: str, data_dir: str = "data"):
    """citeseer-style ``.cites``/``.content`` or ``.npz`` CSR loader with
    in-memory memo (reference experiment_setup.py:260-323)."""
    if dataset_name in _loaded:
        G, features, labels = _loaded[dataset_name]
        return G.copy(), features, labels
    if ".npz" in dataset_name:
        G, features, labels = _np_load(dataset_name, data_dir)
    else:
        G, features, labels = _dataload(dataset_name, data_dir)
    _loaded[dataset_name] = (G, features, labels)
    return G, features, labels


def _csr_from_npz(blob, tag):
    from scipy.sparse import csr_matrix
    return csr_matrix(
        (blob[f"{tag}.data"], blob[f"{tag}.indices"], blob[f"{tag}.indptr"]),
        shape=blob[f"{tag}.shape"], dtype=float)


def _np_load(dataset_name, data_dir):
    """SNAP-style ``.npz`` bundles (CSR adjacency + CSR attributes +
    labels); output contract identical to reference
    experiment_setup.py:273-283."""
    import networkx as nx

    blob = np.load(os.path.join(data_dir, dataset_name), allow_pickle=True)
    G = nx.from_scipy_sparse_array(_csr_from_npz(blob, "adj_matrix"),
                                   create_using=nx.DiGraph)
    dense_attr = np.asarray(_csr_from_npz(blob, "attr_matrix").todense())
    features = {u: dense_attr[u].tolist() for u in range(len(G))}
    return G, features, dict(enumerate(blob["labels"]))


def _citation_arcs(path):
    """Arc list of a tab-separated ``.cites`` file.  Endpoint ids may be
    namespaced (``paper:123`` -> ``123``); self-citations are dropped.
    Arc order is preserved verbatim — first mention defines a node's
    position in graph-iteration order, which downstream code turns into
    its integer id (the node-order contract, graph/nx_interop.py)."""
    with open(path) as fh:
        rows = (ln.rstrip("\n").split("\t") for ln in fh)
        ends = ((cells[-2].rpartition(":")[2], cells[-1].rpartition(":")[2])
                for cells in rows if len(cells) >= 2)
        return [(u, v) for u, v in ends if u != v]


def _named_attr_row(cells, schema):
    """One ``.content`` row of the named-attribute format: ``key=value``
    cells materialized against the declared ``schema`` column order
    (absent keys are 0; the ``summary`` column is always zeroed — a quirk
    of the upstream citeseer exports, reference experiment_setup.py:312)."""
    attr = {}
    for cell in cells[2:]:
        key, sep, rest = cell.partition("=")
        if sep:
            attr[key] = rest.split("=")[0]
    attr["summary"] = 0
    return [float(attr.get(column, 0)) for column in schema], cells[1]


def _dataload(dataset_name, data_dir):
    """Citeseer-style ``.cites``/``.content`` pair.  Supports both content
    formats (dense numeric columns, or a ``:label`` header row declaring
    named ``key=value`` attributes); rows for unknown nodes are ignored
    and nodes without attributes pruned.  Output contract — including the
    final node-order re-key of the feature dict — matches reference
    experiment_setup.py:285-323 exactly (fixture-tested against the live
    reference, tests/test_data.py)."""
    import networkx as nx

    G = nx.DiGraph(_citation_arcs(
        os.path.join(data_dir, dataset_name + ".cites")))
    features, labels = {}, {}
    schema = None
    with open(os.path.join(data_dir, dataset_name + ".content")) as fh:
        for ln in fh:
            cells = ln.rstrip("\n").split("\t")
            head = cells[0]
            if head == "NODE":
                continue
            if ":label" in head:
                schema = [c.split(":")[1] for c in cells[2:]]
            elif head in G:
                if schema is None:
                    features[head] = [float(v) for v in cells[1:-1]]
                    labels[head] = cells[-1]
                else:
                    features[head], labels[head] = _named_attr_row(cells,
                                                                   schema)
    G.remove_nodes_from([u for u in G if u not in features])
    features = {u: features[u] for u in G}  # node-order re-key (ref :321-323)
    return G, features, labels


def custom_splits(labels, examples_per_class: int = 20,
                  num_validation: Optional[int] = 500, seed: int = 0):
    """Planetoid-style splits: the first ``examples_per_class`` nodes of
    each class along a seeded shuffle train; of the remaining labeled
    nodes (reshuffled on the same random stream), ``num_validation``
    validate and the rest test.  Unlabeled nodes (label ``-1``) are
    excluded everywhere.

    Byte-identical to reference experiment_setup.py:183-201 — the
    random-module stream, the visit-order interleaving of the train list,
    and the set-difference ordering are all pinned by that contract (the
    per-class quota selection itself is vectorized)."""
    y = np.asarray(labels)
    n = y.shape[0]
    random.seed(seed)
    visit = list(range(n))
    random.shuffle(visit)
    rank = np.empty(n, np.int64)
    rank[visit] = np.arange(n)
    has_label = (y != -1) if y.dtype.kind in "biuf" else np.ones(n, bool)
    nodes = np.flatnonzero(has_label)
    classes, cls_of = np.unique(y[nodes], return_inverse=True)
    # a node trains iff its shuffled rank is among the first
    # examples_per_class within its class
    by_cls = np.lexsort((rank[nodes], cls_of))
    counts = np.bincount(cls_of, minlength=classes.shape[0])
    group_start = np.repeat(np.cumsum(counts) - counts, counts)
    quota_pos = np.arange(nodes.shape[0]) - group_start
    chosen = nodes[by_cls[quota_pos < examples_per_class]]
    train_nodes = chosen[np.argsort(rank[chosen])].tolist()
    leftover = list(set(nodes.tolist()) - set(train_nodes))
    random.shuffle(leftover)
    if num_validation is None:
        num_validation = classes.shape[0] * examples_per_class
    return (train_nodes, leftover[:num_validation],
            leftover[num_validation:])


def random_splits(labels, training: float = 0.6, validation: float = 0.2,
                  seed: int = 0):
    """Fraction-based random splits; same random stream as reference
    experiment_setup.py:204-210."""
    random.seed(seed)
    visit = list(range(np.asarray(labels).shape[0]))
    random.shuffle(visit)
    cut_train = int(len(visit) * training)
    cut_valid = int(len(visit) * (training + validation))
    return visit[:cut_train], visit[cut_train:cut_valid], visit[cut_valid:]


def sample_edges(G):
    """Link-prediction dataset builder: per edge, 1 positive + 2 structured
    negatives (corrupt head / corrupt tail)
    (reference experiment_setup.py:25-41)."""
    node2id = {u: idx for idx, u in enumerate(G)}
    nodes = list(G)
    edges = [[node2id[u], node2id[v]] for u, v in G.edges() if u != v]
    labels = [1] * len(edges) + [0] * (2 * len(edges))
    for u, v in G.edges():
        if u == v:
            continue
        neg = v
        while neg == u or neg == v or G.has_edge(u, neg):
            neg = random.choice(nodes)
        edges.append([node2id[u], node2id[neg]])
        neg = v
        while neg == u or neg == v or G.has_edge(neg, v):
            neg = random.choice(nodes)
        edges.append([node2id[neg], node2id[v]])
    return np.array(edges), np.array(labels)


def enrich_features(features, positional: bool = True, labels=None,
                    train=None):
    """Optional label one-hots for train nodes + binary positional encodings
    (reference experiment_setup.py:7-22)."""
    features = np.asarray(features)
    if labels is not None:
        labels = np.asarray(labels)
        num_classes = len(set(labels.tolist()))
        label_features = np.zeros((features.shape[0], num_classes))
        for i in train:
            label_features[i][labels[i]] = 1
        features = np.concatenate((features, label_features), axis=1)
    if positional:
        num_positions = int(1.5 + np.log2(features.shape[0] + 1))
        positional_features = np.zeros((features.shape[0], num_positions))
        for i in range(features.shape[0]):
            bits = bin(i + 1)[2:]
            norm = sum(float(val) for val in bits)
            for pos, val in enumerate(bits):
                positional_features[i][num_positions - 1 - pos] = \
                    float(val) / norm
        features = np.concatenate((features, positional_features), axis=1)
    return features


def tpl_setup(app_csv=None, library_csv=None, min_df: int = 3,
              min_out_degree: int = 10, n_apps: int = 200,
              n_libraries: int = 120, seed: int = 0):
    """Android app<->library bipartite graph from CSVs with bag-of-words
    features (reference experiment_setup.py:70-122: min-df 3 token filter,
    app out-degree >= 10 filter).  Without CSV paths, synthesizes an
    equivalent bipartite graph with planted app communities so demos and
    tests run in egress-free environments.

    Returns ``(nx.DiGraph, app_ids, library_ids, features)`` with apps
    numbered first (the layout ``Structural(bipartite=len(apps))`` expects,
    reference demos/development/library_recommendation.py:46-48).
    """
    import networkx as nx

    if app_csv is not None:
        import csv

        usage = {}
        tokens = {}
        with open(app_csv) as f:
            for row in csv.reader(f):
                app, libs, words = row[0], row[1].split(";"), row[2].split()
                usage[app] = [l for l in libs if l]
                tokens[app] = words
        usage = {a: ls for a, ls in usage.items()
                 if len(ls) >= min_out_degree}
        df = {}
        for words in tokens.values():
            for w in set(words):
                df[w] = df.get(w, 0) + 1
        vocab = sorted(w for w, c in df.items() if c >= min_df)
        apps = sorted(usage)
        libraries = sorted({l for ls in usage.values() for l in ls})
        app_id = {a: i for i, a in enumerate(apps)}
        lib_id = {l: len(apps) + i for i, l in enumerate(libraries)}
        G = nx.DiGraph()
        G.add_nodes_from(range(len(apps) + len(libraries)))
        for a, ls in usage.items():
            for l in ls:
                G.add_edge(app_id[a], lib_id[l])
        widx = {w: i for i, w in enumerate(vocab)}
        features = np.zeros((len(apps) + len(libraries), len(vocab)),
                            np.float32)
        for a in apps:
            for w in tokens[a]:
                if w in widx:
                    features[app_id[a], widx[w]] = 1.0
        return G, list(range(len(apps))), \
            list(range(len(apps), len(apps) + len(libraries))), features

    # synthetic stand-in: apps pick libraries from their community's pool
    rng = np.random.RandomState(seed)
    n_comm = 6
    G = nx.DiGraph()
    G.add_nodes_from(range(n_apps + n_libraries))
    lib_comm = rng.randint(0, n_comm, n_libraries)
    for a in range(n_apps):
        comm = a % n_comm
        pool = n_apps + np.flatnonzero(lib_comm == comm)
        other = n_apps + np.arange(n_libraries)
        picks = set(rng.choice(pool, size=min(8, len(pool)), replace=False))
        picks |= set(rng.choice(other, size=3, replace=False))
        for l in picks:
            G.add_edge(a, int(l))
    features = np.zeros((n_apps + n_libraries, 0), np.float32)
    return G, list(range(n_apps)), \
        list(range(n_apps, n_apps + n_libraries)), features
