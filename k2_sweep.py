#!/usr/bin/env python3
"""Sweep K2's tuning knobs on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 k2_sweep.py [--out FILE]

On the RCM-reordered benchmark graph of ``chip_smoke.py``, over the forward
and the transposed list at F=40 and F=128, it times K2 (CUDA events, as
``chip_smoke.py`` does) at:

- every pair of unit size (``ops/blocked.py::_UNIT_ITEMS``: 64, 128, 256
  items) and gathers of x rows in flight (``K2_UNROLL`` in
  ``csrc/blocked_spmm.cu``: 2, 4, 8; one library built for each);
- fix-up parts (``_FIXUP_PARTS``: 16, 64, 256) at the default unit size and
  unroll.

Each setting is first held against the plain version on the card (per
element, within 1e-5 * sum|terms|).  One JSON object a line goes to
standard output and, with ``--out``, to FILE.
"""
import argparse
import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from chip_smoke import (N_EDGES, N_FEATURES, N_NODES, check_close, log,
                        nvidia_smi, time_ms)

ITEMS = (64, 128, 256)
UNROLLS = (2, 4, 8)
PARTS = (16, 64, 256)


def build_variants(unrolls):
    """One ``libblocked_spmm_u<n>.so`` for each unroll, nvcc runs started
    together; returns ``{unroll: ctypes.CDLL}`` with the C signature of the
    default library."""
    from gnntf_tpu_torch.ops import blocked
    from gnntf_tpu_torch.utils import kernels
    ref = blocked._library()
    src = kernels.CSRC / "blocked_spmm.cu"
    procs = {}
    for u in unrolls:
        out = kernels.BUILD / f"libblocked_spmm_u{u}.so"
        procs[u] = (out, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, f"-DK2_UNROLL={u}", "-o",
             str(out), str(src)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for u, (out, proc) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc -DK2_UNROLL={u} failed:\n{text}")
        lib = ctypes.CDLL(str(out))
        for name in ("gnntf_blocked_spmm", "gnntf_cuda_error_string"):
            getattr(lib, name).restype = getattr(ref, name).restype
            getattr(lib, name).argtypes = getattr(ref, name).argtypes
        libs[u] = lib
    return libs


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", help="also write the JSON lines here")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k2_sweep: torch.cuda.is_available() is False")
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked,
                                     blocked_spmm, blocked_spmm_plain,
                                     normalize_adjacency)

    dev = torch.device("cuda")
    card = nvidia_smi("name,power.limit")
    log(f"card: {card}")
    libs = build_variants(UNROLLS)
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    graph = tt.from_edges(src, dst, n_nodes=N_NODES, directed=False,
                          device=dev)
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
    lines, preps = [], {}
    for items, unroll, parts in settings:
        blocked._UNIT_ITEMS, blocked._FIXUP_PARTS = items, parts
        blocked._library = lambda lib=libs[unroll]: lib
        if items not in preps:
            preps[items] = BlockedSpMM(lay, dev)
        prep = preps[items]
        for f, x in xs.items():
            for name, lst in (("A", prep.forward), ("AT", prep.transposed)):
                label = f"items={items} unroll={unroll} parts={parts} " \
                        f"{name} F={f}"
                check_close(label, blocked_spmm(lst, val, x),
                            blocked_spmm_plain(lst, val, x),
                            blocked_spmm_plain(lst, val.abs(), x.abs()))
                line = dict(items=items, unroll=unroll, parts=parts,
                            list=name, f=f, units=lst.n_units,
                            split_rows=int(lst.split.shape[0]),
                            ms=time_ms(lambda: blocked_spmm(lst, val, x)),
                            card=card)
                print(json.dumps(line), flush=True)
                lines.append(line)
    blocked._UNIT_ITEMS, blocked._FIXUP_PARTS = defaults
    if args.out:
        with open(args.out, "w") as fh:
            fh.writelines(json.dumps(line) + "\n" for line in lines)


if __name__ == "__main__":
    main()
