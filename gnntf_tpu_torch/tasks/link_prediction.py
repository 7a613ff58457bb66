"""Link prediction task heads and negative sampling (reference
gnntf/core/gnn/graph_predictor.py:34-204; the JAX package's
``tasks/link_prediction.py``).

The graph a sampler or :class:`MeanLinkPrediction` rejects against is a
networkx graph, as in the JAX package, or the port's own :class:`Graph`
(its arcs and ``range(n_nodes)`` as the nodes), which needs no networkx.
"""
from __future__ import annotations

import random
import threading
import time
from typing import Optional, Union

import numpy as np
import torch

from .. import measures
from ..graph.coo import Graph
from .base import Predictor


def _adjacent_to(graph, node):
    """All neighbors of ``node`` in either direction."""
    linked = set(graph.neighbors(node))
    if graph.is_directed():
        linked.update(graph.predecessors(node))
    return linked


def _arcs(graph) -> np.ndarray:
    """The graph's arcs ``(u, v)`` as an (E, 2) int64 array."""
    if isinstance(graph, Graph):
        return torch.stack([graph.col, graph.row], 1).cpu().numpy().astype(
            np.int64)
    return np.asarray([(int(u), int(v)) for u, v in graph.edges()],
                      np.int64).reshape(-1, 2)


def _nodes(graph):
    if isinstance(graph, Graph):
        return np.arange(graph.n_nodes, dtype=np.int64)
    return list(graph)


def recommend_all(node, graph=None, positive_edges=None, negative_nodes=None):
    """Candidate edge list for one node: its positives (kept in given
    order) followed by every non-adjacent negative (in ``negative_nodes``
    order); output contract = reference graph_predictor.py:34-49."""
    if positive_edges is None:
        positive_edges = [[node, nb] for nb in graph.neighbors(node)]
    if negative_nodes is None:
        negative_nodes = list(graph)
    pos = [[u, v] for u, v in positive_edges if node in (u, v)]
    linked = set() if graph is None else _adjacent_to(graph, node)
    neg = [[node, c] for c in negative_nodes
           if c != node and c not in linked]
    return np.array(pos + neg), [1] * len(pos) + [0] * len(neg)


class negative_sampling:
    """Stateful sampler: per positive edge 1 positive + ``samples``
    negatives, interleaved (reference graph_predictor.py:52-98), the
    negatives redrawn at every call, rejecting self-edges and existing
    edges in either direction.

    The negatives come from the C++ sampler (``utils/native.py``) unless its
    library is missing or a custom ``pool`` is set; then from the Python
    path, ``random.Random(seed)``.  The two draw different streams: the JAX
    package picks its path by the same rule, so the two packages give the
    same edges.  :attr:`native` says which path made the last edges.

    With ``prefetch=True`` (the default) every call also starts a thread
    that draws the next call's negatives, its seed drawn here on the
    calling thread, so the edges stay the same under ``set_seed`` whatever
    the scheduling; the next call joins it (:attr:`wait_seconds`).  Unlike
    the JAX package, whose thread refills the array it returned two calls
    before, the thread fills a buffer of its own: an array that a call
    returned never changes afterwards."""

    def __init__(self, positive_edges, graph, samples: int = 1,
                 negative_nodes=None, pool: Optional[int] = None,
                 prefetch: bool = True):
        self.positive_edges = np.asarray(
            positive_edges, np.int64).reshape(-1, 2)
        self.samples = samples
        self.graph = graph
        self.negative_nodes = np.asarray(
            _nodes(graph) if negative_nodes is None else negative_nodes,
            dtype=np.int64)
        self.labels = np.tile(np.array([1.0] + [0.0] * samples),
                              len(self.positive_edges))
        self.arcs = _arcs(graph)
        self._edge_set_cache = None
        self.pool = pool
        if pool is None:
            self._negative_pool = None
        else:
            self._negative_pool = {}
            for u in {int(u) for u, _ in self.positive_edges.tolist()}:
                self._negative_pool[u] = [
                    self._draw_negative(u, -1) for _ in range(pool)]
        # positives in place, negatives -1 (the JAX package's first sample)
        self._layout = np.full(
            ((1 + samples) * len(self.positive_edges), 2), -1, np.int64)
        self._layout[:, 0] = np.repeat(self.positive_edges[:, 0], 1 + samples)
        self._layout[::1 + samples, 1] = self.positive_edges[:, 1]
        self.edges = self._layout.copy()
        self.native: Optional[bool] = None
        self.prefetch = prefetch
        self.wait_seconds = 0.0
        self._pending = None  # (thread, result box) of a prefetch

    @property
    def _edge_set(self):
        """The symmetric edge set the Python path rejects against."""
        if self._edge_set_cache is None:
            pairs = set(map(tuple, self.arcs.tolist()))
            self._edge_set_cache = pairs | {(v, u) for u, v in pairs}
        return self._edge_set_cache

    def _draw_negative(self, u: int, v: int, rng=random) -> int:
        cand = self.negative_nodes
        while True:
            vneg = int(cand[rng.randrange(len(cand))])
            if vneg != u and vneg != v and (u, vneg) not in self._edge_set:
                return vneg

    def _fill(self, buf: np.ndarray, seed: int) -> None:
        """The Python path: redraw the negative slots of ``buf`` (the
        positive rows in place) from ``seed`` alone."""
        rng = random.Random(seed)
        i = 0
        for u, v in self.positive_edges.tolist():
            i += 1
            if self._negative_pool is not None:
                cands = self._negative_pool[u]
                for _ in range(self.samples):
                    vneg = cands[rng.randrange(len(cands))]
                    while vneg == u or vneg == v:
                        vneg = cands[rng.randrange(len(cands))]
                    buf[i, 1] = vneg
                    i += 1
            else:
                for _ in range(self.samples):
                    buf[i, 1] = self._draw_negative(u, v, rng)
                    i += 1

    def _draw(self, seed: int):
        """A new edge array drawn from ``seed``, and whether the C++
        sampler drew it."""
        from ..utils.native import negative_sample_native
        buf = np.empty_like(self._layout)
        if negative_sample_native(self, buf, seed):
            return buf, True
        buf[:] = self._layout
        self._fill(buf, seed)
        return buf, False

    def _prefetch(self, box: dict, seed: int) -> None:
        try:
            box["edges"], box["native"] = self._draw(seed)
        except BaseException as exc:  # re-raised by the next call
            box["error"] = exc

    def __call__(self):
        if self._pending is not None:
            thread, box = self._pending
            self._pending = None
            t0 = time.perf_counter()
            thread.join()
            self.wait_seconds = time.perf_counter() - t0
            if "error" in box:
                raise box["error"]
            self.edges, self.native = box["edges"], box["native"]
        else:
            self.wait_seconds = 0.0
            self.edges, self.native = self._draw(random.randrange(2 ** 62))
        if self.prefetch:
            box = {}
            seed = random.randrange(2 ** 62)  # drawn HERE: deterministic
            thread = threading.Thread(target=self._prefetch,
                                      args=(box, seed), daemon=True)
            thread.start()
            self._pending = (thread, box)
        return self.edges, self.labels


class LinkPrediction(Predictor):
    """Edge scoring by (relational) dot product or cosine similarity, with
    BPR ("diff") or binary-cross-entropy loss (reference
    graph_predictor.py:101-151).

    * ``edges`` may be a callable sampler, drawn at construction and again
      at every ``refresh`` (predict/loss/evaluate and each training batch).
    * ``gnn`` registers a DistMult-style diagonal relation vector ``r``
      (ones, shared name "distmult") on the model, read from ``params``.
    * "diff" pairs even and odd rows: 1 positive + 1 negative, as
      ``negative_sampling(samples=1)`` interleaves them.
    * ``batch_size`` below the edge count draws that many edges at each
      ``refresh`` with ``random.sample``.

    Edges and labels are held on the CPU and moved to the activations'
    device on use; a batch already there (the fused trainer's) is not
    copied."""

    def __init__(self, edges, labels=None, gnn=None, similarity: str = "dot",
                 loss: str = "diff", regularize: float = 0,
                 batch_size: Union[int, float] = float("inf")):
        if callable(edges):
            self.edge_sampler = edges
            edges, labels = edges()
        else:
            self.edge_sampler = None
        self.batch_size = batch_size
        self.edges = np.asarray(edges)
        self.loss_func = loss
        self.labels = None if labels is None else np.asarray(
            labels, np.float32).reshape(-1)
        self.r = None if gnn is None else gnn.create_var(
            shape=(gnn.top_shape()[1], 1), regularize=0,
            shared_name="distmult", normalization="ones", trainable=True)
        self.similarity = similarity
        self.regularize = regularize
        self._batch_idx = None

    @property
    def static(self) -> bool:
        return self.edge_sampler is None and \
            self.batch_size >= self.edges.shape[0]

    @property
    def supports_stacking(self) -> bool:
        """A sampled task draws batches of one shape, so the fused trainer
        can draw a block's batches before the block and feed each epoch its
        own (``train/trainer.py::_fit_fused``)."""
        return self.edge_sampler is not None

    def stack_batches(self, n: int, device="cpu"):
        """Draw ``n`` epochs' batches and stack them on ``device``: edges
        ``(n, B, 2)`` int64 and labels ``(n, B)`` float32, or None."""
        edges, labels = [], []
        for _ in range(n):
            self.refresh()
            e, l = self._selected()
            edges.append(np.asarray(e, np.int64))
            labels.append(l)
        stack = torch.from_numpy(np.stack(edges)).to(device)
        return (stack, None if labels[0] is None
                else torch.from_numpy(np.stack(labels)).to(device))

    # -- host-side state ----------------------------------------------------
    def refresh(self):
        if self.edge_sampler is not None:
            edges, labels = self.edge_sampler()
            self.edges = np.asarray(edges)
            self.labels = None if labels is None else np.asarray(
                labels, np.float32).reshape(-1)
        n_edges = self.edges.shape[0]
        if self.batch_size < n_edges:
            # a subsample per refresh, for one batch shape (the reference
            # draws inside loss(), graph_predictor.py:132-133)
            self._batch_idx = np.asarray(
                random.sample(range(n_edges), int(self.batch_size)))
        else:
            self._batch_idx = None

    def _selected(self):
        edges, labels = self.edges, self.labels
        if self._batch_idx is not None:
            edges = edges[self._batch_idx]
            labels = None if labels is None else labels[self._batch_idx]
        return edges, labels

    def batch(self):
        edges, labels = self._selected()
        return (torch.as_tensor(np.asarray(edges, np.int64)),
                None if labels is None else torch.as_tensor(labels))

    # -- the math -----------------------------------------------------------
    def _logits(self, acts, edges, params):
        from ..ops.spmm import edge_dot
        edges = edges.to(acts.device)
        if self.similarity == "cos":
            sumsq = torch.sum(torch.square(acts), dim=1, keepdim=True)
            acts = acts * torch.rsqrt(torch.clamp_min(sumsq, 1e-12))
        if self.r is None:
            return edge_dot(edges[:, 0], edges[:, 1], acts)
        # DistMult: <acts[u] * r, acts[v]>, r folded into the left operand
        r = params[self.r]
        return edge_dot(edges[:, 0], edges[:, 1], acts * r[:, 0][None, :],
                        acts)

    def loss(self, acts, batch, params=None):
        edges, labels = batch
        logits = self._logits(acts, edges, params)
        if self.loss_func == "diff":
            # BPR: -mean(log sigma(pos - neg)) over interleaved pairs
            return -torch.mean(torch.nn.functional.logsigmoid(
                logits[0::2] - logits[1::2]))
        labels = labels.to(acts.device)
        per = torch.clamp_min(logits, 0) - logits * labels + torch.log1p(
            torch.exp(-torch.abs(logits)))
        return torch.mean(per)

    def predict(self, acts, batch=None, params=None, to_logits: bool = False):
        edges = self.batch()[0] if batch is None else batch[0]
        logits = self._logits(acts, edges, params)
        return logits if to_logits else torch.sigmoid(logits)

    def evaluate(self, acts, batch=None, params=None):
        b = self.batch() if batch is None else batch
        _, labels = b
        preds = self.predict(acts, b, params)
        return measures.auc(labels.cpu().numpy(),
                            preds.detach().cpu().numpy())


class MeanLinkPrediction(LinkPrediction):
    """Per-node recommendation evaluation: for every positive node, score
    its positives against all non-adjacent negatives; report mean
    node-level AUC / MAP / precision@k / recall@k / F1@k and catalog
    coverage, return mean F1 (reference graph_predictor.py:154-204).  In
    numpy, on the activations copied to the host."""

    def __init__(self, *args, graph, positive_nodes=None, negative_nodes=None,
                 k: int = 5, **kwargs):
        super().__init__(*args, **kwargs)
        self.positive_nodes = positive_nodes
        self.negative_nodes = negative_nodes
        self.k = k
        self.graph = graph
        self.parsed_edges = {}
        for u, v in self.edges.tolist():
            self.parsed_edges.setdefault(int(u), []).append(int(v))
            self.parsed_edges.setdefault(int(v), []).append(int(u))

    def evaluate(self, acts, batch=None, params=None, verbose: bool = True):
        """Per positive node, the candidate negatives come from one binary
        search of the pool's keys in a sorted, hashed symmetric edge table
        (the JAX package's ``isin``, without sorting the table again for
        every node) and the scores from one matrix-vector product (the
        reference's semantics, graph_predictor.py:182-203)."""
        k = self.k
        feats = acts.detach().cpu().numpy()
        if self.similarity == "cos":
            feats = feats / np.sqrt(
                np.maximum((feats ** 2).sum(1, keepdims=True), 1e-12))
        r = None if self.r is None or params is None \
            else params[self.r].detach().cpu().numpy()
        # logits (u, t) = <feats[u] * r, feats[t]>
        query = feats if r is None else feats * r[:, 0][None, :]

        positive_nodes = list(self.parsed_edges) \
            if self.positive_nodes is None else self.positive_nodes
        pool = set(v for nbrs in self.parsed_edges.values() for v in nbrs) \
            if self.negative_nodes is None else set(self.negative_nodes)
        neg_pool = np.fromiter(pool, np.int64, len(pool))

        # symmetric edge table of the rejection graph, hashed as u*n + v
        n_ids = feats.shape[0]
        arcs = _arcs(self.graph)
        linked = np.unique(np.concatenate([
            arcs[:, 0] * n_ids + arcs[:, 1],
            arcs[:, 1] * n_ids + arcs[:, 0]])) if arcs.size else \
            np.empty(0, np.int64)

        aucs, precs, recs, f1s, maps = [], [], [], [], []
        cov: set = set()
        for node in positive_nodes:
            if node not in self.parsed_edges:
                raise ValueError("Node not found")
            pos_t = np.asarray(self.parsed_edges[node], np.int64)
            keys = node * n_ids + neg_pool
            at = np.minimum(np.searchsorted(linked, keys),
                            max(len(linked) - 1, 0))
            known = linked[at] == keys if len(linked) else \
                np.zeros(len(keys), bool)
            keep = (neg_pool != node) & ~known
            targets = np.concatenate([pos_t, neg_pool[keep]])
            labels = np.zeros(targets.shape[0])
            labels[: pos_t.shape[0]] = 1.0
            logits = feats[targets] @ query[node]
            prediction = 1.0 / (1.0 + np.exp(-logits))
            aucs.append(measures.auc(labels, prediction))
            maps.append(measures.avprec(labels, prediction, k))
            precs.append(measures.prec(labels, prediction, k))
            recs.append(measures.rec(labels, prediction, k))
            f1s.append(measures.f1(labels, prediction, k))
            cov.update(targets[np.argsort(prediction)[-k:]].tolist())
        if verbose:
            print(f"Average node AUC {float(np.mean(aucs)):.3f}\t "
                  f"MAP {float(np.mean(maps)):.3f}\t"
                  f"Precision {float(np.mean(precs)):.3f}\t"
                  f"Recall {float(np.mean(recs)):.3f}\t "
                  f"F1 {float(np.mean(f1s)):.3f}\t "
                  f"Coverage {float(len(cov) / len(pool)):.3f}")
        return float(np.mean(f1s))
