#!/usr/bin/env python3
"""Sweep the tuning knobs of the edge-balanced walk (K1 and K2) on one
NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 k2_sweep.py [--out FILE] [--kernels k1,k2,train]

K2: on the RCM-reordered benchmark graph of ``chip_smoke.py``, over the
forward and the transposed list at F=40 and F=128, it times K2 (CUDA events,
as ``chip_smoke.py`` does) at:

- every pair of unit size (``ops/blocked.py::_UNIT_ITEMS``: 64, 128, 256
  items) and gathers of x rows in flight (``WALK_UNROLL`` in
  ``csrc/edge_walk.cuh``: 2, 4, 8; one library built for each);
- fix-up parts (``_FIXUP_PARTS``: 16, 64, 256) at the default unit size and
  unroll.

K1: on the list of the benchmark graph's hub-free ELL (``PreparedSpMM``),
adding into a random base at F=40 and F=128, it times K1 at every pair of
unit size (``ops/ell_gather.py::_UNIT_ITEMS``: 32, 64, 128 items) and
gathers in flight (2, 4, 8), and at the least resident blocks that the
walk's ``__launch_bounds__`` asks for (``WALK_MIN_BLOCKS``: 1, 2, 3 beside
the default 4) at the default unit size and unroll; one ``ell_gather.cu`` library is built for
each build setting, and each setting's three kernels are timed apart with
``torch.profiler``.

Train (K1's masked and degree walks): over the training grids' lists of
the natural-order benchmark graph (a draw keeping half the edges), it
times the masked walk over the row and the column list at F=40 and F=128
for each unit size (``ops/blocked.py::_UNIT_ITEMS``: 32, 64, 128, 256
items), and the degree walk over the column list for each unit size and
number of lanes a unit (``ops/ell_gather.py::_DEGREE_GROUP``: 1 to 32);
no library is rebuilt.

Each setting is first held against the plain version on the card (per
element, within 1e-5 * sum|terms|).  One JSON object a line goes to
standard output and, with ``--out``, to FILE.
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
UNROLLS = (2, 4, 8)
PARTS = (16, 64, 256)
K1_ITEMS = (32, 64, 128)
TRAIN_ITEMS = (32, 64, 128, 256)
DEGREE_GROUPS = (1, 2, 4, 8, 16, 32)
# WALK_MIN_BLOCKS: the header's default, and the others K1's sweep builds
MIN_BLOCKS_DEFAULT = 4
MIN_BLOCKS = (1, 2, 3)


def build_variants(name, entry, ref, builds):
    """One ``lib<name>_u<unroll>_b<min blocks>.so`` for each (unroll, min
    blocks) pair, nvcc runs started together; returns ``{pair:
    ctypes.CDLL}`` with the C signature of ``entry`` in the default library
    ``ref``, and logs each library's registers and spills."""
    from gnntf_tpu_torch.utils import kernels
    src = kernels.CSRC / f"{name}.cu"
    procs = {}
    for u, b in builds:
        out = kernels.BUILD / f"lib{name}_u{u}_b{b}.so"
        procs[u, b] = (out, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, f"-DWALK_UNROLL={u}",
             f"-DWALK_MIN_BLOCKS={b}", "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (u, b), (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -DWALK_UNROLL={u} -DWALK_MIN_BLOCKS="
                               f"{b} failed:\n{text}")
        for line in text.splitlines():
            if "_walk" in line or "registers" in line or "spill" in line:
                log(f"  {name} u{u} b{b}: {line.strip()}")
        lib = ctypes.CDLL(str(out))
        for fn in (entry, "gnntf_cuda_error_string"):
            getattr(lib, fn).restype = getattr(ref, fn).restype
            getattr(lib, fn).argtypes = getattr(ref, fn).argtypes
        libs[u, b] = lib
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

            rows, _, _ = device_profile(run)
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
    """K1's masked walk (unit size) and degree walk (unit size, lanes a
    unit) over the bench graph's training-grid lists; returns the JSON
    lines."""
    from gnntf_tpu_torch.ops import (EdgeList, blocked_spmm_plain,
                                     build_train_grids, ell_degree_masked,
                                     ell_gather_masked, stochastic)
    k1 = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
    grids = build_train_grids(graph.row.cpu().numpy(),
                              graph.col.cpu().numpy(),
                              graph.val.cpu().numpy(), N_NODES)
    host = grids.lists("cpu")
    val = graph.val.to(torch.float32).contiguous()
    # the salts in device memory, where the kernels read them
    salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(9)).to(dev)
    draw = (salt, 0.5, graph.n_edges)
    w = stochastic.drawn_values(val, *draw)
    xs = {f: torch.from_numpy(np.random.RandomState(seed).randn(
        N_NODES, f).astype(np.float32)).to(dev)
        for f, seed in ((40, 3), (N_FEATURES, 2))}
    default, lines = k1._DEGREE_GROUP, []

    def emit(line, run):
        rows, _, _ = device_profile(run)
        line.update(ms=time_ms(run), card=card, us_by_kernel={
            kernel_name(key): us
            for key, us, _ in rows})
        print(json.dumps(line), flush=True)
        lines.append(line)

    for items in TRAIN_ITEMS:
        lists = {name: EdgeList.build(
            lst.ptr.numpy(), lst.idx.numpy(),
            None if lst.eid is None else lst.eid.numpy(), dev, items=items)
            for name, lst in zip(("row", "column"), host)}
        for name, lst in lists.items():
            for f, x in xs.items():
                check_close(f"masked items={items} {name} F={f}",
                            ell_gather_masked(lst, val, *draw, x),
                            blocked_spmm_plain(lst, w, x),
                            blocked_spmm_plain(lst, w.abs(), x.abs()))
                emit(dict(kernel="masked", items=items, list=name, f=f,
                          units=lst.n_units),
                     lambda: ell_gather_masked(lst, val, *draw, x))
        lst = lists["column"]
        ones = torch.ones(N_NODES, 1, device=dev)
        ref = blocked_spmm_plain(lst, w, ones)[:, 0]
        for group in DEGREE_GROUPS:
            k1._DEGREE_GROUP = group
            check_close(f"degree items={items} group={group}",
                        ell_degree_masked(lst, val, *draw), ref, ref.abs())
            emit(dict(kernel="degree", items=items, group=group,
                      units=lst.n_units),
                 lambda: ell_degree_masked(lst, val, *draw))
    k1._DEGREE_GROUP = default
    return lines


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--kernels", default="k1,k2,train",
                        help="which sweeps to run (k1, k2, train; "
                             "comma-separated)")
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
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    graph = tt.from_edges(src, dst, n_nodes=N_NODES, directed=False,
                          device=dev)
    lines = sweep_k1(graph, dev, card) if "k1" in which else []
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

    defaults = blocked._UNIT_ITEMS, blocked._FIXUP_PARTS
    settings = [(i, u, defaults[1]) for i in ITEMS for u in UNROLLS]
    settings += [(defaults[0], 4, p) for p in PARTS if p != defaults[1]]
    preps = {}
    for items, unroll, parts in settings:
        blocked._UNIT_ITEMS, blocked._FIXUP_PARTS = items, parts
        blocked._library = lambda lib=libs[unroll, MIN_BLOCKS_DEFAULT]: lib
        if (items, parts) not in preps:  # a list keeps its parts
            preps[items, parts] = BlockedSpMM(lay, dev)
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
    blocked._UNIT_ITEMS, blocked._FIXUP_PARTS = defaults
    write(args.out, lines)


def write(path, lines):
    if path:
        with open(path, "w") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
