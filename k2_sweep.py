#!/usr/bin/env python3
"""Sweep the tuning knobs of the edge-balanced walk (K1 and K2) on one
NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 k2_sweep.py [--out FILE] [--kernels k1,k2,train,k2small]
                        [--ab DIR] [--ab-small DIR] [--ab-attn DIR]

K2: on the RCM-reordered benchmark graph of ``chip_smoke.py``, over the
forward and the transposed list at F=40 and F=128, it times K2 (CUDA events,
as ``chip_smoke.py`` does) at:

- every pair of unit size (64, 128, 256 items; ``ops/blocked.py::
  unit_items`` gives this list 128) and gathers of x rows in flight
  (``WALK_UNROLL`` in ``csrc/edge_walk.cuh``: 2, 4, 8; one library built
  for each);
- fix-up parts (``_FIXUP_PARTS``: 16, 64, 256) at 128 items and the
  default unroll.

K2 on small lists (``--kernels k2small``, not run by default): unit sizes
of 8, 16, 32, 64 and 128 items (``ops/blocked.py::unit_items`` picks from
the last four), over the forward and the transposed list of graphs of
~13 K items (Cora's scale: 2,708 nodes, 5,278 undirected edges, uniform
and power-law), ~100 K items (20,000 nodes, 40,000 power-law edges),
~752 K items (the benchmark graph's first quarter of edges over all its
rows, the list a gspmd slice's degree walk takes) and 2,501,821 items (the
RCM benchmark graph), at F=1 (the degree walk), 7 (Cora's classes) and
64, with each kernel's device time from one call's profile (the walk, the
narrow walk, the parts, the fix-up) beside the CUDA-event mean, and, on
the Cora-scale lists, the ``index_add_`` route that the walk replaced.

K1: on the list of the benchmark graph's hub-free ELL (``PreparedSpMM``),
adding into a random base at F=40 and F=128, it times K1 at every pair of
unit size (``ops/ell_gather.py::_UNIT_ITEMS``: 32, 64, 128 items) and
gathers in flight (2, 4, 8), and at the least resident blocks that the
walk's ``__launch_bounds__`` asks for (``WALK_MIN_BLOCKS``: 1, 2, 3 beside
the default 4) at the default unit size and unroll; one ``ell_gather.cu`` library is built for
each build setting, and each setting's three kernels are timed apart with
``torch.profiler``.

Train (K1's dropout walks, ``csrc/drop_walk.cuh``): over the training
grids' lists of the natural-order benchmark graph (a draw keeping half the
edges), it times the masked walk over the row and the column list at F=40
and F=64 and the degree walk over both lists, for each pair of piece size
(``ops/ell_gather.py::_DROP_ITEMS``: 64, 128 items) and tile size
(``_TILE_ITEMS``: 128, 256, 384, 512 items), and for x rows in flight a
sub-group, the least resident blocks the walks ask for and the batches of
32 edges a warp loads at once when it stages (``DROP_RING``,
``DROP_MIN_BLOCKS``, ``DROP_BATCHES`` in ``csrc/drop_walk.cuh``;
``DROP_BUILDS`` below, one library built for each) at the default
sizes.  The
degree walk has no knob of lanes: a warp stages a tile and lane i sums its
segment i.  Each line gives each kernel's device time (the masked walk's
two passes, its flag's memset) from ``torch.profiler``.

With ``--ab DIR`` it times instead, in four processes started in turn
(the tree in DIR, this tree, this tree, DIR), the dropout walks of each
tree at their defaults: the masked walk over both lists at F=40 and F=64
and the degree walk over both lists, with the device time of each
kernel; DIR is another checkout (for example the parent commit, unpacked
with ``git archive`` into a directory of its own).

With ``--ab-small DIR`` it times, in the same four processes, one training
step (forward, losses, gradients, every dropout on) of APPNP and of GAT at
their defaults on the Cora-scale graph of ``chip_smoke.py``'s phase 14d
(2,708 nodes, 10,556 counted edges): the step's CUDA-event time over
back-to-back calls, and its device busy and wall time and its
``index_add_`` launches from a profile; then K2's walk over that graph's
normalized lists (``blocked_layout``, forward and transposed) at F=1, 7
and 64, with one call's device time by kernel from a profile.

With ``--ab-attn DIR`` it times, in the same four processes, GAT's
attention kernels A1-A4 (``csrc/attention.cu``) on ``chip_smoke.py``'s
phase 2e lists (the benchmark graph with its self-loops, per-edge with a
dropout draw at keep 0.4 and coalesced, 2,501,821 and 1,389,223 slots) at
GAT's layer shapes (8 heads of 8; one head of 40): each kernel's
CUDA-event mean of 20 calls and one call's device time by kernel (walk,
parts, fix-up) from a profile; then one training step of GAT at
``GATConfig`` on the benchmark graph: its device busy and wall time and
A1-A4's share of the busy time, from a profile.

Each setting is first held against the plain version on the card (per
element, within 1e-5 * sum|terms|); the A/B runs hold nothing.  One JSON
object a line goes to standard output and, with ``--out``, to FILE.
"""
import argparse
import ctypes
import importlib
import json
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (N_EDGES, N_FEATURES, N_NODES, check_close,
                        device_profile, kernel_name, log, nvidia_smi,
                        time_ms)

ITEMS = (64, 128, 256)
SMALL_ITEMS = (8, 16, 32, 64, 128)
SMALL_WIDTHS = (1, 7, 64)
UNROLLS = (2, 4, 8)
PARTS = (16, 64, 256)
K1_ITEMS = (32, 64, 128)
DROP_ITEMS = (64, 128)
TILE_ITEMS = (128, 256, 384, 512)
# (DROP_RING, DROP_MIN_BLOCKS, DROP_BATCHES) builds of the dropout walks;
# the first is the header's default
DROP_BUILDS = ((8, 3, 4), (4, 3, 4), (8, 2, 8), (4, 4, 4), (8, 4, 4),
               (16, 2, 4))
# WALK_MIN_BLOCKS: the header's default, and the others K1's sweep builds
MIN_BLOCKS_DEFAULT = 4
MIN_BLOCKS = (1, 2, 3)


def build_variants(name, entry, ref, builds, macros=("WALK_UNROLL",
                                                     "WALK_MIN_BLOCKS")):
    """One ``lib<name>_<values>.so`` for each tuple of ``builds``, the
    values of ``macros`` in turn, nvcc runs started together; returns
    ``{values: ctypes.CDLL}`` with the C signature of ``entry`` (a name or a
    tuple of names) in the default library ``ref``, and logs each
    library's registers and spills."""
    from gnntf_tpu_torch.utils import kernels
    src = kernels.CSRC / f"{name}.cu"
    entries = (entry,) if isinstance(entry, str) else tuple(entry)
    procs = {}
    for values in builds:
        tag = "_".join(str(v) for v in values)
        flags = [f"-D{m}={v}" for m, v in zip(macros, values)]
        out = kernels.BUILD / f"lib{name}_{tag}.so"
        procs[values] = (out, flags, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, *flags, "-o", str(out),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for values, (out, flags, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc {' '.join(flags)} failed:\n{text}")
        for line in text.splitlines():
            if "_walk" in line or "registers" in line or "spill" in line:
                log(f"  {name} {' '.join(flags)}: {line.strip()}")
        lib = ctypes.CDLL(str(out))
        for fn in (*entries, "gnntf_cuda_error_string"):
            getattr(lib, fn).restype = getattr(ref, fn).restype
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        libs[values] = lib
    return libs


def sweep_k1(graph, dev, card):
    """K1's unit size over the bench graph's rest ELL list, adding into a
    random base; returns the JSON lines."""
    from gnntf_tpu_torch.ops import (PreparedSpMM, blocked_spmm_plain,
                                     ell_gather_list, normalize_adjacency)
    k1 = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
    settings = [(i, u, MIN_BLOCKS_DEFAULT) for i in K1_ITEMS for u in UNROLLS]
    settings += [(K1_ITEMS[0], 4, b) for b in MIN_BLOCKS]
    libs = build_variants("ell_gather", "gnntf_ell_gather", k1._library(),
                          sorted({(u, b) for _, u, b in settings}))
    norm = normalize_adjacency(graph, graph_dropout=0.0)
    default, library, lines = k1._UNIT_ITEMS, k1._library, []
    rng = np.random.RandomState(4)
    bases = {f: torch.from_numpy(rng.randn(N_NODES, f).astype(
        np.float32)).to(dev) for f in (40, N_FEATURES)}
    xs = {f: torch.from_numpy(np.random.RandomState(seed).randn(
        N_NODES, f).astype(np.float32)).to(dev)
        for f, seed in ((40, 3), (N_FEATURES, 2))}
    preps = {}
    for items, unroll, blocks in settings:
        k1._UNIT_ITEMS = items
        if items not in preps:
            prep = PreparedSpMM(norm)
            preps[items] = prep.k1_list, prep.k1_val
        lst, val = preps[items]
        k1._library = lambda lib=libs[unroll, blocks]: lib
        for f, x in xs.items():
            base = bases[f]
            label = (f"K1 items={items} unroll={unroll} min_blocks="
                     f"{blocks} F={f}")
            check_close(label,
                        ell_gather_list(lst, val, x, base.clone()),
                        blocked_spmm_plain(lst, val, x, base.clone()),
                        blocked_spmm_plain(lst, val.abs(), x.abs(),
                                           base.abs()))
            scratch = base.clone()

            def run():
                ell_gather_list(lst, val, x, scratch)

            rows, _, _, _ = device_profile(run)
            line = dict(kernel="K1", items=items, unroll=unroll,
                        min_blocks=blocks, f=f,
                        units=lst.n_units,
                        split_rows=int(lst.split.shape[0]),
                        pieces=int(lst.split[:, 2].sum()),
                        ms=time_ms(run), card=card, us_by_kernel={
                            kernel_name(key): us
                            for key, us, _ in rows})
            print(json.dumps(line), flush=True)
            lines.append(line)
    k1._UNIT_ITEMS, k1._library = default, library
    return lines


def sweep_train(graph, dev, card):
    """K1's dropout walks (piece size, tile size, x rows in flight) over
    the bench graph's training-grid lists; returns the JSON lines."""
    from gnntf_tpu_torch.ops import (blocked_spmm_plain, build_train_grids,
                                     ell_degree_masked, ell_gather_masked,
                                     stochastic)
    k1 = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
    grids = build_train_grids(graph.row.cpu().numpy(),
                              graph.col.cpu().numpy(),
                              graph.val.cpu().numpy(), N_NODES)
    val = graph.val.to(torch.float32).contiguous()
    # the salts in device memory, where the kernels read them
    salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(9)).to(dev)
    draw = (salt, 0.5, graph.n_edges)
    w = stochastic.drawn_values(val, *draw)
    xs = {f: torch.from_numpy(np.random.RandomState(seed).randn(
        N_NODES, f).astype(np.float32)).to(dev)
        for f, seed in ((40, 3), (64, 10))}
    ones = torch.ones(N_NODES, 1, device=dev)
    entries = ("gnntf_ell_gather_masked", "gnntf_ell_degree")
    libs = build_variants("ell_gather", entries, k1._library(), DROP_BUILDS,
                          macros=("DROP_RING", "DROP_MIN_BLOCKS",
                                  "DROP_BATCHES"))
    defaults = k1._DROP_ITEMS, k1._TILE_ITEMS, k1._library
    settings = [(i, t, DROP_BUILDS[0]) for i in DROP_ITEMS
                for t in TILE_ITEMS]
    settings += [(defaults[0], defaults[1], b) for b in DROP_BUILDS[1:]]
    lines = []

    def emit(line, run):
        rows, _, _, _ = device_profile(run)
        line.update(ms=time_ms(run), card=card, us_by_kernel={
            kernel_name(key): us for key, us, _ in rows})
        print(json.dumps(line), flush=True)
        lines.append(line)

    for items, tile, (ring, blocks, batches) in settings:
        k1._DROP_ITEMS, k1._TILE_ITEMS = items, tile
        k1._library = lambda lib=libs[ring, blocks, batches]: lib
        grids._lists = {}  # built anew with these sizes
        lists = dict(zip(("row", "column"), grids.lists(dev)))
        for name, lst in lists.items():
            common = dict(items=items, tile=tile, ring=ring,
                          min_blocks=blocks, batches=batches, list=name,
                          units=lst.n_units, tiles=lst.n_tiles,
                          caps=list(lst.tile_caps),
                          pieces=int(lst.split[:, 2].sum()))
            for f, x in xs.items():
                check_close(f"masked items={items} tile={tile} ring={ring} "
                            f"min_blocks={blocks} batches={batches} {name} "
                            f"F={f}",
                            ell_gather_masked(lst, val, *draw, x),
                            blocked_spmm_plain(lst, w, x),
                            blocked_spmm_plain(lst, w.abs(), x.abs()))
                emit(dict(kernel="masked", f=f, **common),
                     lambda: ell_gather_masked(lst, val, *draw, x))
            ref = blocked_spmm_plain(lst, w, ones)[:, 0]
            check_close(f"degree items={items} tile={tile} ring={ring} "
                        f"min_blocks={blocks} batches={batches} {name}",
                        ell_degree_masked(lst, val, *draw), ref,
                        blocked_spmm_plain(lst, w.abs(), ones)[:, 0])
            emit(dict(kernel="degree", **common),
                 lambda: ell_degree_masked(lst, val, *draw))
    k1._DROP_ITEMS, k1._TILE_ITEMS, k1._library = defaults
    return lines


# One process of the A/B: the dropout walks of the tree it runs in, at that
# tree's defaults, on the bench graph's training-grid lists; one JSON line
# a (kernel, list, F).  It uses only what the parent tree has too.
AB_CODE = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import (build_train_grids, ell_degree_masked,
                                 ell_gather_masked)
from gnntf_tpu_torch.utils import kernels
kernels.build(["ell_gather"], force=True)
dev = torch.device("cuda")
src, dst = random_power_law_edges(cs.N_NODES, cs.N_EDGES, seed=0)
g = tt.from_edges(src, dst, n_nodes=cs.N_NODES, directed=False, device=dev)
lists = build_train_grids(g.row.cpu().numpy(), g.col.cpu().numpy(),
                          g.val.cpu().numpy(), cs.N_NODES).lists(dev)
val = g.val.to(torch.float32).contiguous()
salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                     generator=torch.Generator().manual_seed(9)).to(dev)
draw = (salt, cs.KEEP, g.n_edges)
xs = {40: np.random.RandomState(3), 64: np.random.RandomState(10)}
xs = {f: torch.from_numpy(r.randn(cs.N_NODES, f).astype(np.float32)).to(dev)
      for f, r in xs.items()}
runs = [("masked", name, f, lambda lst=lst, x=x: ell_gather_masked(
            lst, val, *draw, x))
        for name, lst in zip(("row", "column"), lists) for f, x in xs.items()]
runs += [("degree", name, None, lambda lst=lst: ell_degree_masked(
             lst, val, *draw)) for name, lst in zip(("row", "column"), lists)]
for kernel, name, f, run in runs:
    rows = cs.device_profile(run)[0]
    print(json.dumps(dict(tree=sys.argv[1], kernel=kernel, list=name, f=f,
                          ms=cs.time_ms(run), us_by_kernel={
                              cs.kernel_name(k): us for k, us, _ in rows})),
          flush=True)
"""


# One process of the small-graph A/B: a training step of APPNP and of GAT
# at Cora's scale in the tree it runs in (the data of chip_smoke.py's phase
# 14d); one JSON line a model.  It uses only what the parent tree has too.
AB_SMALL_CODE = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
dev = torch.device("cuda")
n, e, c = 2708, 5278, 7
rng = np.random.RandomState(0)
src, dst = rng.randint(0, n, e), rng.randint(0, n, e)
graph = tt.from_edges(src, dst, n_nodes=n, directed=False, device=dev)
features = rng.rand(n, 64).astype(np.float32)
labels = rng.randint(0, c, n)
train = tt.NodeClassification(np.arange(140), labels[:140])
for name in ("APPNP", "GAT"):
    model = getattr(tt, name)(graph, features, num_classes=c, device=dev)
    step = cs.step_fn(model, train)
    for _ in range(3):
        step()
    prof = cs.profile_step(step)
    print(json.dumps(dict(
        tree=sys.argv[1], model=name, edges=graph.n_edges,
        step_ms=cs.time_ms(step, reps=20), busy_us=prof["busy_us"],
        wall_us=prof["wall_us"], launches=prof["launches"],
        index_add_launches=prof["index_add_launches"],
        index_add_share=prof["index_add_share"])), flush=True)
from gnntf_tpu_torch.ops.blocked import blocked_layout, blocked_spmm
adj = tt.normalize_adjacency(graph)
prep = blocked_layout(adj)
val = adj.val.to(torch.float32).contiguous()
for f in (1, 7, 64):
    x = torch.from_numpy(np.random.RandomState(f).randn(n, f).astype(
        np.float32)).to(dev)
    for name, lst in (("A", prep.forward), ("AT", prep.transposed)):
        run = lambda lst=lst, x=x: blocked_spmm(lst, val, x)
        rows, busy, _, _ = cs.device_profile(run)
        print(json.dumps(dict(
            tree=sys.argv[1], kernel="K2", list=name, f=f,
            units=lst.n_units, split_rows=int(lst.split.shape[0]),
            ms=cs.time_ms(run), device_ms=busy / 1e3, us_by_kernel={
                cs.kernel_name(k): us for k, us, _ in rows})), flush=True)
"""


# One process of the attention A/B: A1-A4 on phase 2e's bench lists and a
# GAT training step at GATConfig (phase 9's model) in the tree it runs in;
# one JSON line a (kernel, lists, shape), then one for the step.  It uses
# only what the parent tree has too.
AB_ATTN_CODE = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
from gnntf_tpu_torch import config
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import attention as pa
from gnntf_tpu_torch.utils import kernels
kernels.build(["attention"], force=True)
dev = torch.device("cuda")
src, dst = random_power_law_edges(cs.N_NODES, cs.N_EDGES, seed=0)
graph = tt.from_edges(src, dst, n_nodes=cs.N_NODES, directed=False,
                      device=dev)
looped = tt.add_self_loops(graph)
salt = torch.tensor([0x9E3779B9, 77], device=dev)
for dedup in (False, True):
    lists = pa._attn_lists(looped, dedup=dedup)
    for heads, feats in cs.GAT_SHAPES:
        h, ss, sd, g = cs.attn_inputs(cs.N_NODES, heads, feats, dev,
                                      20 + heads)
        _, calls = cs.attn_calls(lists, h, ss, sd, g,
                                 None if dedup else salt,
                                 1.0 if dedup else cs.ATTN_KEEP)
        for name in cs.ATTN_KERNELS:
            rows, busy, _, _ = cs.device_profile(calls[name])
            print(json.dumps(dict(
                tree=sys.argv[1], kernel=name, heads=heads, feats=feats,
                lists="coalesced" if dedup else "per_edge",
                slots=lists.rows.n_edges, ms=cs.time_ms(calls[name]),
                device_ms=busy / 1e3,
                us_by_kernel={cs.kernel_name(k): us for k, us, _ in rows},
                launches=sum(n for _, _, n in rows))), flush=True)
features = np.random.RandomState(2).randn(
    cs.N_NODES, cs.N_FEATURES).astype(np.float32)
model = config.GATConfig().build(graph, features, cs.N_CLASSES, device=dev)
model.reset(seed=0)
step = cs.step_fn(model, cs.fused_tasks()[0])
for _ in range(3):
    step()
rows, busy, wall, _ = cs.device_profile(step)
attn = {}
for key, us, _ in rows:
    if "attn_" in key:
        name = cs.kernel_name(key)
        attn[name] = attn.get(name, 0.0) + us
print(json.dumps(dict(
    tree=sys.argv[1], model="GAT", step_ms=cs.time_ms(step, reps=20),
    busy_ms=busy / 1e3, wall_ms=wall / 1e3,
    attn_share=sum(attn.values()) / busy, attn_us_by_kernel=attn)),
    flush=True)
"""


def ab(parent, card, code=AB_CODE):
    """An A/B (``code``: the dropout walks, ``AB_SMALL_CODE`` or
    ``AB_ATTN_CODE``): this tree
    and the tree in ``parent`` in turn (parent, change, change, parent),
    each in its own process; returns the JSON lines."""
    import os
    here = os.path.dirname(os.path.abspath(__file__))
    lines = []
    for tree, where in (("parent", parent), ("change", here),
                        ("change", here), ("parent", parent)):
        out = subprocess.run([sys.executable, "-c", code, tree],
                             cwd=where, capture_output=True, text=True,
                             timeout=900)
        if out.returncode:
            raise RuntimeError(f"A/B run in {where} failed:\n{out.stdout}"
                               f"\n{out.stderr}")
        for text in out.stdout.splitlines():
            if text.startswith("{"):
                line = dict(json.loads(text), card=card)
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


def small_lists():
    """The graphs of ``--kernels k2small``: ``(name, n_nodes, row, col)``
    each, its edges (numpy) in the order its lists take them."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from chip_smoke import CORA_EDGES, CORA_NODES

    def undirected(src, dst, n):
        g = tt.from_edges(src, dst, n_nodes=n, directed=False, device="cpu")
        return g.row.numpy(), g.col.numpy()

    rng = np.random.RandomState(0)
    out = [("cora_uniform", CORA_NODES, *undirected(
        rng.randint(0, CORA_NODES, CORA_EDGES),
        rng.randint(0, CORA_NODES, CORA_EDGES), CORA_NODES))]
    out.append(("cora_power_law", CORA_NODES, *undirected(
        *random_power_law_edges(CORA_NODES, CORA_EDGES, seed=0),
        CORA_NODES)))
    out.append(("power_law_20k", 20_000, *undirected(
        *random_power_law_edges(20_000, 40_000, seed=1), 20_000)))
    g = tt.from_edges(*random_power_law_edges(N_NODES, N_EDGES, seed=0),
                      n_nodes=N_NODES, directed=False, device="cpu")
    quarter = g.n_edges // 4
    out.append(("bench_quarter", N_NODES, g.row.numpy()[:quarter],
                g.col.numpy()[:quarter]))
    g, _ = tt.permute_graph(g, tt.rcm_order(g))
    out.append(("bench_rcm", N_NODES, g.row.numpy(), g.col.numpy()))
    return out


def sweep_small(dev, card):
    """K2 over small and bench-size lists at each unit size of
    ``SMALL_ITEMS`` and width of ``SMALL_WIDTHS``, each line with the size
    ``unit_items`` would take (``rule``); returns the JSON lines."""
    from gnntf_tpu_torch.ops import blocked, blocked_spmm, blocked_spmm_plain
    lines = []
    for name, n, row, col in small_lists():
        lists = blocked.graph_lists(row, col, n)
        rng = np.random.RandomState(6)
        val = torch.from_numpy(rng.uniform(0.1, 1.0, len(row)).astype(
            np.float32)).to(dev)
        xs = {f: torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(
            dev) for f in SMALL_WIDTHS}
        items_n = len(row) + n
        for items in SMALL_ITEMS:
            prep = blocked.BlockedSpMM(lists, dev, items=items)
            for lname, lst in (("A", prep.forward), ("AT", prep.transposed)):
                for f, x in xs.items():
                    label = f"k2small {name} items={items} {lname} F={f}"
                    check_close(label, blocked_spmm(lst, val, x),
                                blocked_spmm_plain(lst, val, x),
                                blocked_spmm_plain(lst, val.abs(), x.abs()))
                    run = lambda lst=lst, x=x: blocked_spmm(lst, val, x)
                    rows, busy, _, _ = device_profile(run)
                    line = dict(kernel="K2small", graph=name, n_items=items_n,
                                rule=blocked.unit_items(items_n),
                                items=items, list=lname, f=f,
                                units=lst.n_units,
                                split_rows=int(lst.split.shape[0]),
                                pieces=int(lst.split[:, 2].sum()),
                                ms=time_ms(run), device_ms=busy / 1e3,
                                us_by_kernel={kernel_name(key): us
                                              for key, us, _ in rows},
                                card=card)
                    print(json.dumps(line), flush=True)
                    lines.append(line)
        if name.startswith("cora"):
            dst, src = (torch.from_numpy(a).to(dev) for a in (row, col))
            for f, x in xs.items():
                for lname, d, s in (("A", dst, src), ("AT", src, dst)):
                    run = lambda d=d, s=s, x=x: torch.zeros_like(x).index_add_(
                        0, d, x[s] * val[:, None])
                    _, busy, _, _ = device_profile(run)
                    line = dict(kernel="index_add_route", graph=name,
                                list=lname, f=f, ms=time_ms(run),
                                device_ms=busy / 1e3, card=card)
                    print(json.dumps(line), flush=True)
                    lines.append(line)
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--kernels", default="k1,k2,train",
                        help="which sweeps to run (k1, k2, train, k2small; "
                             "comma-separated)")
    parser.add_argument("--ab", metavar="DIR",
                        help="time the dropout walks of this tree and of "
                             "the checkout in DIR in turn, and nothing else")
    parser.add_argument("--ab-small", metavar="DIR",
                        help="time a Cora-scale APPNP and GAT training step "
                             "of this tree and of the checkout in DIR in "
                             "turn, and nothing else")
    parser.add_argument("--ab-attn", metavar="DIR",
                        help="time the attention kernels A1-A4 and a GAT "
                             "step of this tree and of the checkout in DIR "
                             "in turn, and nothing else")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_sweep: torch.cuda.is_available() is False")
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked,
                                     blocked_spmm, blocked_spmm_plain,
                                     normalize_adjacency)

    which = set(args.kernels.split(","))
    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(f"card: {card}")
    if args.ab or args.ab_small or args.ab_attn:
        write(args.out, ab(args.ab, card) if args.ab
              else ab(args.ab_small, card, AB_SMALL_CODE) if args.ab_small
              else ab(args.ab_attn, card, AB_ATTN_CODE))
        return
    lines = sweep_small(dev, card) if "k2small" in which else []
    if not which & {"k1", "k2", "train"}:
        write(args.out, lines)
        return
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    graph = tt.from_edges(src, dst, n_nodes=N_NODES, directed=False,
                          device=dev)
    if "k1" in which:
        lines += sweep_k1(graph, dev, card)
    if "train" in which:
        lines += sweep_train(graph, dev, card)
    if "k2" not in which:
        write(args.out, lines)
        return
    libs = build_variants("blocked_spmm", "gnntf_blocked_spmm",
                          blocked._library(),
                          [(u, MIN_BLOCKS_DEFAULT) for u in UNROLLS])
    perm = tt.rcm_order(graph)
    g, _ = tt.permute_graph(graph, perm)
    lay = block_coo(g.row.cpu().numpy(), g.col.cpu().numpy(), N_NODES)
    val = normalize_adjacency(g, graph_dropout=0.0).materialized().val
    val = val.to(torch.float32).contiguous()
    xs = {f: torch.from_numpy(np.random.RandomState(seed).randn(
        N_NODES, f).astype(np.float32)[perm]).to(dev)
        for f, seed in ((40, 3), (N_FEATURES, 2))}

    default_parts = blocked._FIXUP_PARTS
    settings = [(i, u, default_parts) for i in ITEMS for u in UNROLLS]
    settings += [(128, 4, p) for p in PARTS if p != default_parts]
    preps = {}
    for items, unroll, parts in settings:
        blocked._FIXUP_PARTS = parts
        blocked._library = lambda lib=libs[unroll, MIN_BLOCKS_DEFAULT]: lib
        if (items, parts) not in preps:  # a list keeps its parts
            preps[items, parts] = BlockedSpMM(lay, dev, items=items)
        prep = preps[items, parts]
        for f, x in xs.items():
            for name, lst in (("A", prep.forward), ("AT", prep.transposed)):
                label = f"items={items} unroll={unroll} parts={parts} " \
                        f"{name} F={f}"
                check_close(label, blocked_spmm(lst, val, x),
                            blocked_spmm_plain(lst, val, x),
                            blocked_spmm_plain(lst, val.abs(), x.abs()))
                line = dict(kernel="K2", items=items, unroll=unroll,
                            parts=parts,
                            list=name, f=f, units=lst.n_units,
                            split_rows=int(lst.split.shape[0]),
                            ms=time_ms(lambda: blocked_spmm(lst, val, x)),
                            card=card)
                print(json.dumps(line), flush=True)
                lines.append(line)
    blocked._FIXUP_PARTS = default_parts
    write(args.out, lines)


def write(path, lines):
    if path:
        with open(path, "w") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
