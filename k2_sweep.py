#!/usr/bin/env python3
"""Sweep the tuning knobs of the edge-balanced walk (K1 and K2) on one
NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 k2_sweep.py [--out FILE]
                        [--kernels k1,k1s,k2,train,k2small,k2bf16,
                                   attn_sharded]
                        [--ab DIR] [--ab-small DIR] [--ab-attn DIR]
                        [--ab-route DIR] [--ab-bf16 DIR]

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

K2's bfloat16 mode (``--kernels k2bf16``, not run by default), over the
forward list of the Cora-scale uniform graph and of the RCM benchmark graph
at F=1, 7, 16, 40, 64 and 128: the generic walk at the widest load a lane
may take, forced (``ops/blocked.py::_BF16_VEC``: 8, 4, 2 or 1 bfloat16;
``bf16_vec`` narrows it to what F and the addresses allow, and rows of
fewer than 8 loads take the narrow walk); where it runs (F % 8 == 0, 16 <=
F <= 40), the staged walk (``csrc/bf16_walk.cuh``) at each ring of
``BF16_RINGS`` (batches in flight, edges a batch; ``_BF16_RING``); each
setting's CUDA-event mean and one call's device time by kernel, beside the
float32 walk and the cast of x to bfloat16.  Then the crossovers that
``_BF16_STAGED_EDGES`` and ``_BF16_SHARE_LISTS`` set: the staged and the
generic walk at F=16, 24, 32 and 40, and the share walk
(``csrc/share_walk.cuh``) and the generic walk at F=64, 96, 128 and 256,
over the lists of ``--kernels k2small`` and two power-law graphs between
them (10 K to 2.3 M edges), each's device time a call averaged over a
profile of 20 calls.

K1's scaled walk (``--kernels k1``, or ``k1s`` for it alone): over the
whole list of the benchmark graph's normalized adjacency (``PreparedSpMM``
under ``auto``: every live slot, ``ptr`` over all rows, the scales applied
in the walk) and over the transposed list its backward walks, at F=16, 40,
64 and 128, it times ``csrc/scaled_walk.cuh`` at each unit size
(``ops/ell_gather.py::_WHOLE_ITEMS``, and ``_UNIT_ITEMS`` for the
transposed list: 32, 64, 128, 256 items), each setting bit-equal to the
plain version on the CPU, with its CUDA-event mean and one call's device
time by kernel.

K1: on the rest list of the benchmark graph's hub-free ELL
(``PreparedSpMM(hubs=True)``, the ``hybrid`` route), adding into a random
base at F=40 and F=128, it times K1 at every pair of
unit size (``ops/ell_gather.py::_UNIT_ITEMS``: 32, 64, 128 items) and
gathers in flight (2, 4, 8), and at the least resident blocks that the
walk's ``__launch_bounds__`` asks for (``WALK_MIN_BLOCKS``: 1, 2, 3 beside
the default 4) at the default unit size and unroll; one ``ell_gather.cu`` library is built for
each build setting, and each setting's three kernels are timed apart with
``torch.profiler``.

Train (K1's masked walk, ``csrc/drop_walk.cuh``): over the training
grids' lists of the natural-order benchmark graph (a draw keeping half the
edges), it times the masked walk over the row and the column list at F=40
and F=64, for each pair of piece size
(``ops/ell_gather.py::_DROP_ITEMS``: 64, 128 items) and tile size
(``_TILE_ITEMS``: 128, 256, 384, 512 items), and for x rows in flight a
sub-group, the least resident blocks the walks ask for and the batches of
32 edges a warp loads at once when it stages (``DROP_RING``,
``DROP_MIN_BLOCKS``, ``DROP_BATCHES`` in ``csrc/drop_walk.cuh``;
``DROP_BUILDS`` below, one library built for each) at the default
sizes.  Each line gives each kernel's device time (the masked walk's two
passes, its flag's memset) from ``torch.profiler``.  The degree walk
(``csrc/degree_walk.cuh``) has no knob: its lanes and edges a lane are
constants.

With ``--ab DIR`` it times instead, in four processes started in turn
(the tree in DIR, this tree, this tree, DIR), the dropout walks of each
tree at their defaults: the masked walk over both lists at F=40 and F=64
and the degree walk over both lists, over float32 and over bfloat16
values, with one call's device time in all and by kernel; then one
training step of APPNP at its defaults (the masked and degree walks'
share of its device busy time).  DIR is another checkout (for example the
parent commit, unpacked with ``git archive`` into a directory of its
own).

With ``--ab-small DIR`` it times, in the same four processes, one training
step (forward, losses, gradients, every dropout on) of APPNP and of GAT at
their defaults on the Cora-scale graph of ``chip_smoke.py``'s phase 14d
(2,708 nodes, 10,556 counted edges): the step's CUDA-event time over
back-to-back calls, and its device busy and wall time and its
``index_add_`` launches from a profile; then K2's walk over that graph's
normalized lists (``blocked_layout``, forward and transposed) at F=1, 7
and 64, with one call's device time by kernel from a profile.

With ``--ab-attn DIR`` it times, in the same four processes, GAT's
attention kernels (``csrc/attention.cu``: A1-A4, and in a tree that has
it the fused forward ``attn_softmax_aggregate``, ``csrc/softmax_walk.cuh``)
on ``chip_smoke.py``'s phase 2e lists (the benchmark graph with its
self-loops, per-edge with a dropout draw at keep 0.4 and coalesced,
2,501,821 and 1,389,223 slots) at GAT's layer shapes (8 heads of 8; one
head of 40): each kernel's CUDA-event mean of 20 calls and one call's
device time by kernel (walk, parts, fix-up, merge) from a profile, and the
forward as the tree routes it (``attn_forward``: A1 then A2, or the fused
walk); then one training step and one serving forward of GAT at
``GATConfig`` on the benchmark graph: device busy and wall time, launches,
and the attention kernels' share of the busy time, from a profile.

GAT's forward over gspmd slices (``--kernels attn_sharded``, not run by
default): ``chip_smoke.py``'s phase 15b slices of the self-looped
benchmark graph at GAT's layer shapes, per-edge with a dropout draw and
coalesced; ``sharded_forward`` (A1 then A2 a slice, then the merge)
against each slice's fused walk merged by rescaling to the rows' maxima
(``rescale_merge``), both held to the whole graph's forward; each one's
CUDA-event mean and one call's device time by kernel.

With ``--ab-bf16 DIR`` it times, in the same four processes, K2's
bfloat16 mode on the RCM benchmark graph's normalized forward list (phase
2f's) at F=16, 40, 64 and 128 and on the Cora-scale uniform graph's at
F=7, 16, 40 and 64: ``spmm_pallas(graph, x, bf16=True)`` from float32 ``x``
(the product as users call it, the cast included), the mode's walk over
``x`` cast to bfloat16, the cast, and K2's float32 walk beside them, each's
CUDA-event mean and one call's device time by kernel.

With ``--ab-route DIR`` it times, in the same four processes, the
prepared operator's routes on the benchmark graph's normalized adjacency
(``normalize_adjacency(graph)``: row and column scales, no identity), one
SpMM at F=16, 40, 64 and 128 each: ``auto`` (what ``prepare`` builds in the
tree), ``hybrid`` (the hub slice's matmul and K1 over the rest ELL, the
scales in torch), ``ell`` (K1 over the whole ELL's list adding into zeros,
``_routed_layout(hubs=False)``, the scales in torch) and ``k2`` (K2's
store-mode walk over ``blocked_layout``'s forward list of every edge, the
scales in torch): each route's CUDA-event mean, one call's device time,
launches and time by kernel from a profile, its largest difference from
``hybrid``, and the device memory its operator holds; then a clean forward
of APPNP and of GCNII-64 (``GCNIIConfig``) under ``auto`` and under
``hybrid``: CUDA-event mean, device busy time and launches.  Beside each
SpMM it times the ``auto`` operator's backward (``dx`` of that SpMM:
CUDA-event mean, one call's device time, launches and time by kernel) and,
after GCNII-64's forwards, one of its training steps under ``auto``
(forward, losses, gradients: 64 scaled walks and 64 backward walks).

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
                        device_profile, kernel_name, list_to, log,
                        nvidia_smi, time_ms)

ITEMS = (64, 128, 256)
SMALL_ITEMS = (8, 16, 32, 64, 128)
SMALL_WIDTHS = (1, 7, 64)
UNROLLS = (2, 4, 8)
PARTS = (16, 64, 256)
K1_ITEMS = (32, 64, 128)
WHOLE_ITEMS = (32, 64, 128, 256)
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
        for fn in (*entries, "gnntf_cuda_error_string",
                   *(["gnntf_stream_capture"]
                     if hasattr(ref, "gnntf_stream_capture") else [])):
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
    libs = build_variants("ell_gather", ("gnntf_ell_gather",
                                         "gnntf_ell_gather_scaled"),
                          k1._library(),
                          sorted({(u, b) for _, u, b in settings}))
    norm = normalize_adjacency(graph, graph_dropout=0.0)
    lines = sweep_k1_whole(norm, dev, card)
    default, library = k1._UNIT_ITEMS, k1._library
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
            prep = PreparedSpMM(norm, hubs=True)
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


def sweep_k1_whole(norm, dev, card):
    """K1's scaled walk (``csrc/scaled_walk.cuh``) over the whole list of
    the normalized bench graph and, its backward, over the transposed list,
    at each unit size (``WHOLE_ITEMS``, set through ``whole_list(items=)``
    and ``_UNIT_ITEMS``, which the transposed list reads) and F=16, 40, 64
    and 128; each setting bit-equal to the plain version on the CPU, its
    CUDA-event mean and one call's device time by kernel.  Returns the JSON
    lines."""
    from gnntf_tpu_torch.ops import (PreparedSpMM, ell_gather_scaled,
                                     ell_gather_scaled_backward,
                                     ell_gather_scaled_plain, whole_list)
    k1 = importlib.import_module("gnntf_tpu_torch.ops.ell_gather")
    op = PreparedSpMM(norm)
    rs, cs = op._scales
    host = op._routed._host_list
    xs = {f: torch.from_numpy(np.random.RandomState(seed).randn(
        N_NODES, f).astype(np.float32)).to(dev)
        for f, seed in ((16, 5), (40, 3), (64, 10), (N_FEATURES, 2))}
    defaults = {"A": k1._WHOLE_ITEMS, "AT": k1._UNIT_ITEMS}
    lines = []
    for items in WHOLE_ITEMS:
        k1._UNIT_ITEMS = items
        try:
            lists = {"A": whole_list(*host, N_NODES, dev, items=items),
                     "AT": k1.ell_transposed_list(op._routed.list, N_NODES)}
        finally:
            k1._UNIT_ITEMS = defaults["AT"]
        for kind, lst in lists.items():
            call = (ell_gather_scaled if kind == "A"
                    else ell_gather_scaled_backward)
            for f, x in xs.items():
                out = call(lst, op.k1_val, x, rs, cs)
                ref = ell_gather_scaled_plain(
                    list_to(lst, "cpu"), op.k1_val.cpu(), x.cpu(),
                    *(None if v is None else v.cpu() for v in (
                        (rs, cs) if kind == "A" else (cs, rs))))
                if not torch.equal(out.cpu(), ref):
                    raise AssertionError(
                        f"K1 scaled {kind} items={items} F={f}: not "
                        "bit-equal to the plain version on the CPU")

                def run():
                    call(lst, op.k1_val, x, rs, cs)

                rows, busy, _, _ = device_profile(run)
                line = dict(kernel="K1 scaled", list=kind, items=items,
                            default=items == defaults[kind], f=f,
                            units=lst.n_units,
                            split_rows=int(lst.split.shape[0]),
                            ms=time_ms(run), device_ms=busy / 1e3,
                            card=card,
                            us_by_kernel={kernel_name(key): us
                                          for key, us, _ in rows})
                print(json.dumps(line), flush=True)
                lines.append(line)
    return lines


def sweep_train(graph, dev, card):
    """K1's masked walk (piece size, tile size, x rows in flight) over the
    bench graph's training-grid lists; returns the JSON lines."""
    from gnntf_tpu_torch.ops import (blocked_spmm_plain, build_train_grids,
                                     ell_gather_masked, stochastic)
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
    libs = build_variants("ell_gather", "gnntf_ell_gather_masked",
                          k1._library(), DROP_BUILDS,
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
    k1._DROP_ITEMS, k1._TILE_ITEMS, k1._library = defaults
    return lines


# One process of the A/B: the dropout walks of the tree it runs in, at that
# tree's defaults, on the bench graph's training-grid lists, over float32
# and bfloat16 values; one JSON line a (values, kernel, list, F), with the
# host's time to issue a call (HOST_CALLS calls enqueued in turn), then one
# for a training step of APPNP at its defaults.  It uses only what the
# parent tree has too.
AB_CODE = """
import json, sys, time
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import (build_train_grids, ell_degree_masked,
                                 ell_gather_masked)
from gnntf_tpu_torch.utils import kernels
kernels.build(["ell_gather"], force=True)
dev = torch.device("cuda")
HOST_CALLS = 50
src, dst = random_power_law_edges(cs.N_NODES, cs.N_EDGES, seed=0)
g = tt.from_edges(src, dst, n_nodes=cs.N_NODES, directed=False, device=dev)
lists = build_train_grids(g.row.cpu().numpy(), g.col.cpu().numpy(),
                          g.val.cpu().numpy(), cs.N_NODES).lists(dev)
val32 = g.val.to(torch.float32).contiguous()
salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                     generator=torch.Generator().manual_seed(9)).to(dev)
draw = (salt, cs.KEEP, g.n_edges)
xs = {40: np.random.RandomState(3), 64: np.random.RandomState(10)}
xs = {f: torch.from_numpy(r.randn(cs.N_NODES, f).astype(np.float32)).to(dev)
      for f, r in xs.items()}
for values, val in (("float32", val32), ("bfloat16",
                                         val32.to(torch.bfloat16))):
    runs = [("masked", name, f, lambda lst=lst, x=x: ell_gather_masked(
                lst, val, *draw, x))
            for name, lst in zip(("row", "column"), lists)
            for f, x in xs.items()]
    runs += [("degree", name, None, lambda lst=lst: ell_degree_masked(
                 lst, val, *draw))
             for name, lst in zip(("row", "column"), lists)]
    for kernel, name, f, run in runs:
        run()  # what a first call makes once (a list's copy of the values)
        torch.cuda.synchronize()
        t0 = time.perf_counter()  # the host's time to issue a call
        for _ in range(HOST_CALLS):
            run()
        host_us = (time.perf_counter() - t0) / HOST_CALLS * 1e6
        torch.cuda.synchronize()
        rows, busy, _, _ = cs.device_profile(run)
        print(json.dumps(dict(
            tree=sys.argv[1], values=values, kernel=kernel, list=name, f=f,
            ms=cs.time_ms(run), host_us=host_us, device_ms=busy / 1e3,
            launches=sum(n for _, _, n in rows),
            us_by_kernel={cs.kernel_name(k): us for k, us, _ in rows})),
            flush=True)
features = np.random.RandomState(2).randn(
    cs.N_NODES, cs.N_FEATURES).astype(np.float32)
model = tt.APPNP(g, features, num_classes=cs.N_CLASSES, device=dev)
model.reset(seed=0)
train, _ = cs.fused_tasks()
step = cs.step_fn(model, train)
step()
rows, busy, wall, _ = cs.device_profile(step)
family = lambda tag: sum(us for k, us, _ in rows if tag in k) / 1e3
print(json.dumps(dict(
    tree=sys.argv[1], run="appnp_step", ms=cs.time_ms(step, reps=5),
    busy_ms=busy / 1e3, wall_ms=wall / 1e3,
    launches=sum(n for _, _, n in rows),
    masked_ms=family("ell_gather_masked"), degree_ms=family("ell_degree"),
    scaled_ms=family("ell_gather_scaled"),
    top={cs.kernel_name(k): [us, n] for k, us, n in rows[:12]})),
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
        tab = pa.pack_table(h.reshape(cs.N_NODES, -1), ss)
        calls["forward"] = lambda: pa.attn_forward(
            lists, tab, sd, heads, feats, cs.ATTN_SLOPE,
            None if dedup else salt, 1.0 if dedup else cs.ATTN_KEEP)
        for name in (*cs.ATTN_KERNELS, "forward"):
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


def forward():
    with torch.no_grad():
        model.forward(model.features)


for label, fn in (("step", step), ("forward", forward)):
    for _ in range(3):
        fn()
    rows, busy, wall, _ = cs.device_profile(fn)
    attn = {}
    for key, us, _ in rows:
        if "attn_" in key:
            name = cs.kernel_name(key)
            attn[name] = attn.get(name, 0.0) + us
    print(json.dumps(dict(
        tree=sys.argv[1], model="GAT", run=label,
        ms=cs.time_ms(fn, reps=20), busy_ms=busy / 1e3, wall_ms=wall / 1e3,
        launches=sum(n for _, _, n in rows),
        attn_share=sum(attn.values()) / busy, attn_us_by_kernel=attn)),
        flush=True)
"""


# One process of the route A/B: the prepared operator's routes and the
# serving forwards of APPNP and GCNII-64 in the tree it runs in; one JSON
# line a (route, F) and a (model, impl).  It uses only what the parent tree
# has too.
AB_ROUTE_CODE = """
import dataclasses, importlib, json, sys
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
from gnntf_tpu_torch import config
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import normalize_adjacency, prepare, spmm_impl
from gnntf_tpu_torch.utils import kernels
sp = importlib.import_module("gnntf_tpu_torch.ops.spmm")
bl = importlib.import_module("gnntf_tpu_torch.ops.blocked")
kernels.build()
dev = torch.device("cuda")
tree = sys.argv[1]
src, dst = random_power_law_edges(cs.N_NODES, cs.N_EDGES, seed=0)
graph = tt.from_edges(src, dst, n_nodes=cs.N_NODES, directed=False,
                      device=dev)
adj = normalize_adjacency(graph, graph_dropout=0.0)
rs = adj.row_scale[:, None].to(torch.float32)
cs_ = adj.col_scale[:, None].to(torch.float32)
base = dataclasses.replace(adj, row_scale=None, col_scale=None,
                           eye_weight=0.0)
val32 = base.val.to(torch.float32).contiguous()


def held(build):
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    op = build()
    torch.cuda.synchronize()
    return op, torch.cuda.memory_allocated() - before


routes = {}
routes["auto"] = held(lambda: prepare(adj))
routes["hybrid"] = held(lambda: prepare(adj, "hybrid"))
def ell_route():
    routed = sp._routed_layout(base, 8, hubs=False)
    lv, _ = routed.values(base.val)
    return lambda x: routed.apply(lv, None, (x * cs_).contiguous()) * rs
routes["ell"] = held(ell_route)
def k2_route():
    lay = bl.blocked_layout(base)
    return lambda x: bl.blocked_spmm(lay.forward, val32,
                                     (x * cs_).contiguous()) * rs
routes["k2"] = held(k2_route)
for f in (16, 40, 64, 128):
    x = torch.from_numpy(np.random.RandomState(f).randn(
        cs.N_NODES, f).astype(np.float32)).to(dev)
    ref = routes["hybrid"][0](x)
    for name, (op, nbytes) in routes.items():
        run = lambda op=op: op(x)
        diff = (run() - ref).abs().max().item()
        rows, busy, _, _ = cs.device_profile(run)
        print(json.dumps(dict(
            tree=tree, route=name, f=f, ms=cs.time_ms(run),
            device_ms=busy / 1e3, launches=sum(n for _, _, n in rows),
            us_by_kernel={cs.kernel_name(k): us for k, us, _ in rows},
            max_diff_from_hybrid=diff, operator_bytes=nbytes)), flush=True)
    # the auto operator's backward, dx of one SpMM
    dy = torch.from_numpy(np.random.RandomState(f + 1).randn(
        cs.N_NODES, f).astype(np.float32)).to(dev)
    xg = x.clone().requires_grad_()
    y = routes["auto"][0](xg)
    run = lambda: torch.autograd.grad(y, xg, dy, retain_graph=True)
    run()  # builds the transposed list
    rows, busy, _, _ = cs.device_profile(run)
    print(json.dumps(dict(
        tree=tree, route="auto_backward", f=f, ms=cs.time_ms(run),
        device_ms=busy / 1e3, launches=sum(n for _, _, n in rows),
        us_by_kernel={cs.kernel_name(k): us for k, us, _ in rows})),
        flush=True)
    del xg, y
features = np.random.RandomState(2).randn(
    cs.N_NODES, cs.N_FEATURES).astype(np.float32)
for name in ("APPNP", "GCNII-64"):
    for impl in ("auto", "hybrid"):
        with spmm_impl(impl):
            if name == "APPNP":
                model = tt.APPNP(graph, features, num_classes=cs.N_CLASSES,
                                 device=dev)
                model.reset(seed=0)
            else:
                model = config.GCNIIConfig().build(graph, features,
                                                   cs.N_CLASSES, device=dev)
                tt.params_from_jax(cs.init_params(model, 11), model)
            fwd = cs.clean_forward(model)
            fwd()
            rows, busy, wall, _ = cs.device_profile(fwd)
            gemm = sum(us for k, us, _ in rows if "gemm" in k.lower())
            print(json.dumps(dict(
                tree=tree, model=name, impl=impl,
                ms=cs.time_ms(fwd, reps=10), busy_ms=busy / 1e3,
                wall_ms=wall / 1e3, launches=sum(n for _, _, n in rows),
                gemm_ms=gemm / 1e3, top={cs.kernel_name(k): us
                                         for k, us, _ in rows[:8]})),
                flush=True)
        if name == "GCNII-64" and impl == "auto":
            # one training step: 64 scaled walks and 64 backward walks
            train, _ = cs.fused_tasks()
            step = cs.step_fn(model, train)
            step()
            rows, busy, wall, _ = cs.device_profile(step)
            print(json.dumps(dict(
                tree=tree, model=name, impl=impl, run="step",
                ms=cs.time_ms(step, reps=5), busy_ms=busy / 1e3,
                wall_ms=wall / 1e3, launches=sum(n for _, _, n in rows),
                top={cs.kernel_name(k): us for k, us, _ in rows[:8]})),
                flush=True)
        del model, fwd
"""


# One process of the bfloat16 A/B: K2's bfloat16 mode in the tree it runs
# in; one JSON line a (graph, F, run).  It uses only what the parent tree
# has too.
AB_BF16_CODE = """
import json, sys
import numpy as np, torch
import chip_smoke as cs
import gnntf_tpu_torch as tt
from gnntf_tpu_torch.data import random_power_law_edges
from gnntf_tpu_torch.ops import (blocked, blocked_spmm, blocked_spmm_bf16,
                                 normalize_adjacency, spmm_pallas)
from gnntf_tpu_torch.utils import kernels
kernels.build(["blocked_spmm"], force=True)
dev = torch.device("cuda")
src, dst = random_power_law_edges(cs.N_NODES, cs.N_EDGES, seed=0)
graph = tt.from_edges(src, dst, n_nodes=cs.N_NODES, directed=False,
                      device=dev)
g_rcm, _ = tt.permute_graph(graph, tt.rcm_order(graph))
rng = np.random.RandomState(0)
n = cs.CORA_NODES
cora = tt.from_edges(rng.randint(0, n, cs.CORA_EDGES),
                     rng.randint(0, n, cs.CORA_EDGES), n_nodes=n,
                     directed=False, device=dev)
for name, g, widths in (("bench_rcm", g_rcm, (16, 40, 64, 128)),
                        ("cora_uniform", cora, (7, 16, 40, 64))):
    base = normalize_adjacency(g, graph_dropout=0.0).materialized()
    lst = blocked.blocked_layout(base).forward
    val = base.val.to(torch.float32).contiguous()
    for f in widths:
        x = torch.from_numpy(np.random.RandomState(f).randn(
            g.n_nodes, f).astype(np.float32)).to(dev)
        xb = x.to(torch.bfloat16)
        runs = {"call": lambda: spmm_pallas(base, x, bf16=True),
                "walk": lambda: blocked_spmm_bf16(lst, val, xb),
                "cast": lambda: x.to(torch.bfloat16),
                "k2": lambda: blocked_spmm(lst, val, x)}
        for run_name, run in runs.items():
            rows, busy, _, _ = cs.device_profile(run)
            print(json.dumps(dict(
                tree=sys.argv[1], graph=name, f=f, run=run_name,
                edges=lst.n_edges, ms=cs.time_ms(run), device_ms=busy / 1e3,
                us_by_kernel={cs.kernel_name(k): us for k, us, _ in rows})),
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


BF16_WIDTHS = (1, 7, 16, 40, 64, 128)
BF16_VECS = (8, 4, 2, 1)
# the staged walk's rings: (batches in flight, edges a batch); a width
# skips those past its 48 KB a block
BF16_RINGS = ((2, 8), (2, 12), (2, 16), (2, 20), (3, 8), (3, 12), (4, 8))
# the crossover between the staged and the generic walk in a list's edges:
# its widths, the power-law graphs (nodes, edges before symmetrizing) it
# adds to small_lists(), and the calls a profile averages
BF16_CROSS_WIDTHS = (16, 24, 32, 40)
BF16_CROSS_GRAPHS = ((40_000, 100_000), (60_000, 180_000))
BF16_CROSS_CALLS = 20
# _BF16_STAGED_EDGES that gives the staged walk every list at its widths
EVERY_LIST = dict.fromkeys((16, 24, 32, 40), 0)
# the crossover between the share walk and the generic walk: its widths,
# and the _BF16_SHARE_LISTS that gives the share walk every list
BF16_SHARE_CROSS_WIDTHS = (64, 96, 128, 256)
EVERY_SHARE = dict.fromkeys((8, 16, 32), (0, 0))


def sweep_bf16(dev, card):
    """K2's bfloat16 mode over the Cora-scale uniform and the RCM bench
    forward lists at each width of ``BF16_WIDTHS``: the generic walk at each
    widest load of ``BF16_VECS``, the staged walk at each ring of
    ``BF16_RINGS`` (where it runs), beside the float32 walk and the cast;
    then the staged and the generic walk over lists of 10 K to 2.3 M edges
    at each width of ``BF16_CROSS_WIDTHS`` (:func:`_sweep_crossover`);
    returns the JSON lines."""
    from gnntf_tpu_torch.ops import (blocked, blocked_spmm, blocked_spmm_bf16,
                                     blocked_spmm_bf16_plain,
                                     blocked_spmm_plain)
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    default = (blocked._BF16_VEC, blocked._BF16_RING,
               blocked._BF16_STAGED_EDGES)
    lines = []
    graphs = small_lists()
    for n, e in BF16_CROSS_GRAPHS:
        g = tt.from_edges(*random_power_law_edges(n, e, seed=2), n_nodes=n,
                          directed=False, device="cpu")
        graphs.append((f"power_law_{n // 1000}k", n, g.row.numpy(),
                       g.col.numpy()))
    for name, n, row, col in graphs:
        lists = blocked.graph_lists(row, col, n)
        lst = blocked.BlockedSpMM(lists, dev).forward
        val = torch.from_numpy(np.random.RandomState(6).uniform(
            0.1, 1.0, len(row)).astype(np.float32)).to(dev)
        lines += _sweep_crossover(blocked, lst, val, n, name, card)
        if name not in ("cora_uniform", "bench_rcm"):
            continue
        cpu_lst = blocked.BlockedSpMM(lists, "cpu").forward
        for f in BF16_WIDTHS:
            x = torch.from_numpy(np.random.RandomState(f).randn(
                n, f).astype(np.float32)).to(dev)
            xb = x.to(torch.bfloat16)
            seen = set()
            for widest in BF16_VECS:
                blocked._BF16_VEC = widest
                vec = blocked.bf16_vec(f, xb.data_ptr(), 0)
                if vec in seen:
                    continue
                seen.add(vec)
                check_close(f"k2bf16 {name} F={f} vec={vec}",
                            blocked_spmm_bf16(lst, val, xb),
                            blocked_spmm_bf16_plain(lst, val, xb),
                            blocked_spmm_plain(lst, val, x.abs()))
                lines += _time_runs(dict(
                    kernel="K2bf16", graph=name, f=f, vec=vec,
                    walk="narrow" if min(32, f // vec) < 8 else "wide",
                    edges=lst.n_edges, units=lst.n_units, card=card),
                    lambda: blocked_spmm_bf16(lst, val, xb))
            blocked._BF16_VEC = None
            lines += _sweep_rings(blocked, lst, cpu_lst, val, xb, name, card)
            lines += _time_runs(dict(kernel="K2", graph=name, f=f,
                                     edges=lst.n_edges, card=card),
                                lambda: blocked_spmm(lst, val, x))
            lines += _time_runs(dict(kernel="cast", graph=name, f=f,
                                     card=card),
                                lambda: x.to(torch.bfloat16))
    (blocked._BF16_VEC, blocked._BF16_RING,
     blocked._BF16_STAGED_EDGES) = default
    return lines


def _sweep_crossover(blocked, lst, val, n, name, card):
    """The staged walk and the generic walk (each forced through
    ``_BF16_STAGED_EDGES``) over ``lst`` at each width of
    ``BF16_CROSS_WIDTHS``, and the share walk and the generic walk (through
    ``_BF16_SHARE_LISTS``) at each of ``BF16_SHARE_CROSS_WIDTHS``: each's
    CUDA-event mean and device time a call, averaged over a profile of
    ``BF16_CROSS_CALLS`` calls, and whether the two outputs are equal bit
    for bit (the share walk's: each equal to its plain version)."""
    from gnntf_tpu_torch.ops import blocked_spmm_bf16, blocked_spmm_bf16_plain
    default = blocked._BF16_STAGED_EDGES, blocked._BF16_SHARE_LISTS
    pairs = ((BF16_CROSS_WIDTHS, (("staged", EVERY_LIST, {}),
                                  ("generic", {}, {}))),
             (BF16_SHARE_CROSS_WIDTHS, (("share", {}, EVERY_SHARE),
                                        ("generic", {}, {}))))
    lines = []
    for widths, walks in pairs:
        for f in widths:
            xb = torch.from_numpy(np.random.RandomState(f).randn(
                n, f).astype(np.float32)).to(lst.device).to(torch.bfloat16)
            run = lambda: blocked_spmm_bf16(lst, val, xb)
            outs = {}
            for walk, staged, share in walks:
                blocked._BF16_STAGED_EDGES = staged
                blocked._BF16_SHARE_LISTS = share
                plan = blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                                         lst.n_rows)
                outs[walk] = run()
                if walk == "share" and not torch.equal(
                        outs[walk], blocked_spmm_bf16_plain(lst, val, xb)):
                    raise AssertionError(f"k2bf16 share {name} F={f}: not "
                                         f"equal to the plain version")
                rows, busy, _, _ = device_profile(
                    lambda: [run() for _ in range(BF16_CROSS_CALLS)])
                line = dict(kernel="K2bf16cross", graph=name, f=f, walk=walk,
                            vec=plan.vec, ring=(plan.depth, plan.rows),
                            edges=lst.n_edges, n_rows=lst.n_rows,
                            units=lst.n_units, ms=time_ms(run),
                            device_ms=busy / 1e3 / BF16_CROSS_CALLS,
                            us_by_kernel={kernel_name(k):
                                          us / BF16_CROSS_CALLS
                                          for k, us, _ in rows}, card=card)
                lines.append(line)
            a, b = (outs[w[0]] for w in walks)
            for line in lines[-2:]:
                line["equal"] = bool(torch.equal(a, b))
                print(json.dumps(line), flush=True)
    blocked._BF16_STAGED_EDGES, blocked._BF16_SHARE_LISTS = default
    return lines


def _sweep_rings(blocked, lst, cpu_lst, val, xb, name, card):
    """The staged walk (forced on any list) at its own ring and at each
    ring of ``BF16_RINGS`` that fits, where it runs at F; each held
    bit-equal to the plain version on the CPU (``cpu_lst``: ``lst``
    there)."""
    from gnntf_tpu_torch.ops import blocked_spmm_bf16, blocked_spmm_bf16_plain
    f = xb.shape[1]
    default = blocked._BF16_RING, blocked._BF16_STAGED_EDGES
    blocked._BF16_STAGED_EDGES = EVERY_LIST
    ref = None
    lines = []
    for ring in (None,) + BF16_RINGS:
        blocked._BF16_RING = ring
        try:
            plan = blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                                     lst.n_rows)
        except ValueError:  # past 48 KB a block at F
            continue
        if not plan.staged:
            break
        if ref is None:
            ref = blocked_spmm_bf16_plain(cpu_lst, val.cpu(), xb.cpu())
        run = lambda: blocked_spmm_bf16(lst, val, xb)
        if not torch.equal(run().cpu(), ref):
            raise AssertionError(f"k2bf16 staged {name} F={f} {plan}: "
                                 f"not bit-equal to the plain version")
        lines += _time_runs(dict(
            kernel="K2bf16staged", graph=name, f=f, ring=ring,
            depth=plan.depth, rows=plan.rows, smem=plan.smem(f),
            edges=lst.n_edges, units=lst.n_units, card=card), run)
    blocked._BF16_RING, blocked._BF16_STAGED_EDGES = default
    return lines


def rescale_merge(ranks, tab, s_dst, heads, feats, slope, salt, keep):
    """The forward over the slices in ``ranks`` (:class:`AttnLists` each)
    as each slice's fused walk (``attn_softmax_aggregate``, its own rmax0
    m_r, dinv_r and out_r), merged by rescaling: ``M = max m_r`` over the
    slices that hold the row, ``f_r = exp(m_r - M) / dinv_r``, ``dinv = 1 /
    sum f_r``, ``out = (sum out_r f_r) dinv`` per head; the same three
    reductions (max, sum, sum) as ``sharded_forward``, folded in rank
    order."""
    from gnntf_tpu_torch.ops import attention as pa
    per = [pa.attn_softmax_aggregate(lst.rows, lst.plan, lst.mult, tab,
                                     s_dst, heads, feats, slope, salt, keep)
           for lst in ranks]
    held = [pa.row_held(lst.rows) for lst in ranks]
    ninf = tab.new_full((), float("-inf"))
    mx = pa.folded([torch.where(hd, m, ninf)
                    for (m, _, _), hd in zip(per, held)], "max")
    rmax0 = torch.where(torch.isfinite(mx), mx, torch.zeros_like(mx))
    f = [torch.where(hd, torch.exp(m - rmax0) / di, torch.zeros_like(di))
         for (m, di, _), hd in zip(per, held)]
    dinv = 1.0 / pa.folded(f, "sum").clamp(min=1e-30)
    n = tab.shape[0]
    out = pa.folded([(o.view(n, heads, feats) * fr[:, :, None]).view(n, -1)
                     for (_, _, o), fr in zip(per, f)], "sum")
    out = (out.view(n, heads, feats) * dinv[:, :, None]).view(n, -1)
    return dict(rmax0=rmax0, dinv=dinv, out=out)


def sweep_attn_sharded(dev, card):
    """``--kernels attn_sharded``: GAT's forward over ``chip_smoke.py``'s
    phase 15b gspmd slices (the self-looped bench graph cut into
    ``MESH_PARTS`` slices of its edge list, as ``RankSlice`` builds each
    rank's lists) at GAT's layer shapes, per-edge with a dropout draw and
    coalesced: ``sharded_forward`` (A1 then A2 a slice, merged) against
    :func:`rescale_merge` (the fused walk a slice, merged by rescaling),
    in the order A1+A2, rescale, rescale, A1+A2; each held to the whole
    graph's forward within ``KERNEL_RTOL`` of its terms' magnitudes."""
    import chip_smoke as cs
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import attention as pa
    from gnntf_tpu_torch.parallel.dist import RankSlice
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    graph = tt.add_self_loops(tt.from_edges(src, dst, n_nodes=N_NODES,
                                            directed=False, device=dev))
    per = -(-graph.n_edges // cs.MESH_PARTS)
    slices = [RankSlice(graph.row[r * per:(r + 1) * per],
                        graph.col[r * per:(r + 1) * per], r * per, r * per,
                        N_NODES, dev) for r in range(cs.MESH_PARTS)]
    salt = torch.tensor([0x9E3779B9, 77], device=dev)
    lines = []
    for dedup in (False, True):
        ranks = [sl.attention(dedup=dedup) for sl in slices]
        whole = pa._attn_lists(graph, dedup=dedup)
        draw = (None, 1.0) if dedup else (salt, cs.ATTN_KEEP)
        for heads, feats in cs.GAT_SHAPES:
            h, ss, sd, _ = cs.attn_inputs(N_NODES, heads, feats, dev,
                                          28 + heads)
            tab = pa.pack_table(h.reshape(N_NODES, -1), ss)
            args = (tab, sd, heads, feats, cs.ATTN_SLOPE, *draw)
            want = pa.attn_forward(whole, *args)
            scales = pa.attn_error_scales(
                whole, tab, sd, want["rmax0"], want["dinv"],
                torch.zeros(N_NODES, heads * feats, device=dev),
                want["rmax0"], heads, feats, cs.ATTN_SLOPE, *draw)
            runs = {
                "a1_a2": lambda: pa.sharded_forward(ranks, *args,
                                                    reduce=pa.folded),
                "rescale": lambda: rescale_merge(ranks, *args)}
            common = dict(heads=heads, feats=feats, parts=cs.MESH_PARTS,
                          lists="coalesced" if dedup else "per_edge",
                          slots=sum(r.rows.n_edges for r in ranks),
                          card=card)
            for name in ("a1_a2", "rescale"):
                got = runs[name]()
                err = {k: check_close(f"sharded forward {name} {k} "
                                      f"H={heads} F={feats} dedup={dedup}",
                                      got[k], want[k], scales[k])
                       for k in ("rmax0", "dinv", "out")}
                lines.append(dict(common, kernel=f"sharded_{name}",
                                  max_abs_err=err))
            for name in ("a1_a2", "rescale", "rescale", "a1_a2"):
                lines += _time_runs(dict(common, kernel=f"sharded_{name}"),
                                    runs[name])
    return lines


def _time_runs(fields, run):
    """A one-line list: ``fields`` with ``run``'s CUDA-event mean and one
    call's device time by kernel."""
    rows, busy, _, _ = device_profile(run)
    line = dict(fields, ms=time_ms(run), device_ms=busy / 1e3,
                us_by_kernel={kernel_name(k): us for k, us, _ in rows})
    print(json.dumps(line), flush=True)
    return [line]


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    parser.add_argument("--kernels", default="k1,k2,train",
                        help="which sweeps to run (k1, k1s: K1's scaled "
                             "walk alone, k2, train, k2small, k2bf16, "
                             "attn_sharded; comma-separated)")
    parser.add_argument("--ab", metavar="DIR",
                        help="time the dropout walks of this tree and of "
                             "the checkout in DIR in turn, and nothing else")
    parser.add_argument("--ab-small", metavar="DIR",
                        help="time a Cora-scale APPNP and GAT training step "
                             "of this tree and of the checkout in DIR in "
                             "turn, and nothing else")
    parser.add_argument("--ab-attn", metavar="DIR",
                        help="time the attention kernels, the forward and "
                             "a GAT step and forward of this tree and of the "
                             "checkout in DIR in turn, and nothing else")
    parser.add_argument("--ab-bf16", metavar="DIR",
                        help="time K2's bfloat16 mode (the product, its "
                             "walk, the cast, the float32 walk) of this tree "
                             "and of the checkout in DIR in turn, and "
                             "nothing else")
    parser.add_argument("--ab-route", metavar="DIR",
                        help="time the prepared operator's routes and the "
                             "APPNP and GCNII-64 serving forwards of this "
                             "tree and of the checkout in DIR in turn, and "
                             "nothing else")
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
    if (args.ab or args.ab_small or args.ab_attn or args.ab_route
            or args.ab_bf16):
        write(args.out, ab(args.ab, card) if args.ab
              else ab(args.ab_small, card, AB_SMALL_CODE) if args.ab_small
              else ab(args.ab_attn, card, AB_ATTN_CODE) if args.ab_attn
              else ab(args.ab_bf16, card, AB_BF16_CODE) if args.ab_bf16
              else ab(args.ab_route, card, AB_ROUTE_CODE))
        return
    lines = sweep_small(dev, card) if "k2small" in which else []
    if "k2bf16" in which:
        lines += sweep_bf16(dev, card)
    if "attn_sharded" in which:
        lines += sweep_attn_sharded(dev, card)
    if not which & {"k1", "k1s", "k2", "train"}:
        write(args.out, lines)
        return
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    graph = tt.from_edges(src, dst, n_nodes=N_NODES, directed=False,
                          device=dev)
    if "k1" in which:
        lines += sweep_k1(graph, dev, card)
    elif "k1s" in which:
        lines += sweep_k1_whole(normalize_adjacency(graph, graph_dropout=0.0),
                                dev, card)
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
