#!/usr/bin/env python3
"""Smoke run of the torch port (gnntf_tpu_torch) on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero):

1. build every CUDA kernel from ``gnntf_tpu_torch/csrc`` with nvcc, one
   process per source, all started together, and beside them the C++
   sampler (``native/gnntf_native.cc``, g++) into ``gnntf_tpu_torch/build``;
1b. the C++ host builders (``utils/native.py``) on the benchmark graph:
   ``from_edges`` (its radix argsort) and ``build_ell`` without
   deduplication, each timed with the library and with its numpy path,
   equal results, the library's calls counted;
2. hold K1 (the ELL gather-reduce, an edge-balanced walk over the live
   slots of the ELL grid that adds each row into a base) against its plain
   PyTorch version on the card, adding into a random base — a small random
   ELL graph with duplicates, empty rows and a row split over many units,
   and the list of the benchmark graph's hub-free ("rest") ELL at F=128,
   64, 16 (NGCF) and at the serving width F=40 — timing kernel, plain
   version and one PyTorch
   library call (``torch.sparse.addmm``) with CUDA events, and logging the
   share of the bench output at F=40 bit-equal to the plain version run on
   the CPU; then K1's scaled walk, the prepared operator's route under
   ``auto`` (every live slot of the hub-free ELL as a list over all rows,
   the normalized adjacency's scales applied in the walk), over the bench
   graph's whole list at the same widths beside ``torch.sparse.mm`` of the
   normalized matrix (``csrc/scaled_walk.cuh``; each call's device time by
   kernel and its launches), each width bit-equal to the plain version on
   the CPU, and over a list with a row split into thousands of pieces,
   rows without slots and an identity (F=7, 40), with the whole list's
   statistics (rows, units, split rows) and the device memory each
   operator holds;
2b. the same for K2 (the blocked-COO SpMM, an edge-balanced walk over
   per-edge lists) over its forward list (A) and its transposed list (A^T):
   a small random layout with duplicates, empty rows and a hub row and
   column split over many units of work, and the layout of the
   RCM-reordered benchmark graph at F=40 and F=128 (each direction beside
   the cuSPARSE CSR product of A or A^T), with the layout's statistics;
2c. the same for K1's dropout walks: the masked walk
   (``csrc/drop_walk.cuh``: each edge weighted by its dropped value, the
   mask hashed in the kernel, only kept edges' x rows gathered) over the
   training grids' row list (the step's forward) and column list (its
   backward), and the degree walk (``csrc/degree_walk.cuh``: the dropped
   graph's column or row sums over equal shares of the list's edges,
   bit-equal to its plain version on the card, in at most two kernels a
   call, over float32 and bfloat16 values): a small graph with empty
   rows and columns, a hub row and column split over many units, trailing
   self-loops (``n_drop < E``) and ``keep = 1``, and the benchmark graph's
   lists at F=40, F=64 and F=128 beside ``torch.sparse.mm`` of the dropped
   A in CSR and ``index_add_`` of the dropped values (the degree walk also
   beside ``sparse.mm`` of a column of ones), each call's device time by
   kernel (the masked walk's two passes and its flag's memset, the degree
   walk and its fold) from the profiler, the share bit-equal to the plain
   versions on the CPU at F=40 (all of it); an inf and a NaN in x rows
   that only dropped edges read (the masked walk's second pass then
   gathers every edge's row: NaNs where the plain version's are); then
   both walks with the draw's salt pair in a device buffer: two launches
   with the same arguments, the buffer rewritten between them, and a CUDA
   graph of the launches replayed after another rewrite, each output
   bit-equal to the CPU plain version of its draw;
2d. the same for the prepared operator's backward: under ``auto`` one
   launch of the scaled walk over the transposed whole list, ``dx = cs *
   (A^T (rs * dy)) + w * dy`` (``ell_gather_scaled_backward``), over a
   list with a column in thousands of pieces, rows without slots and an
   identity, and over the bench graph's transposed whole list at F=64, 40,
   16 and 128 beside ``torch.sparse.mm`` of the normalized ``A^T`` (the
   scales folded in), each bit-equal to the plain version on the CPU;
   under ``hybrid`` K2's store-mode entry, ``dx = A_rest^T dy``
   (``ell_gather_transposed``): a small random ELL with duplicates, an
   empty column and a hub column split over many units, and the bench
   transposed list at F=40 beside ``torch.sparse.mm`` of ``A^T`` in CSR
   and the ``index_add_`` route it replaced;
2e. the same for the attention kernels A1-A4 (``csrc/attention.cu``: the
   row pass's statistics and aggregation, the backward's row and column
   passes), each on its kernel's inputs within ``1e-5 * sum|terms|`` and a
   second launch bit-equal: a small random graph with duplicates, an
   isolated destination and a hub row and column split over many units, and
   the benchmark graph with its self-loops at GAT's layer shapes (8 heads
   of 8; one head of 40), over the per-edge lists with a dropout draw (keep
   0.4) and the coalesced lists without, beside ``torch.sparse.mm`` of the
   realized coefficients (one head), logging the share bit-equal to the
   plain versions on the CPU and each bench call's device time by kernel
   (A3 and A4: at most 3 launches a call); then the chain with its salt
   pair in a device buffer, rewritten between launches and before a CUDA
   graph's replay, each output equal to a fresh launch with its draw;
2f. K2's bfloat16 mode (``spmm_pallas(bf16=True)``: x rounded to
   bfloat16, each term rounded to bfloat16, the sums in float32) over the
   RCM benchmark graph's forward list at F=7, 16, 40, 64 and 128 against
   its plain version: the walk ``bf16_plan`` picks (the staged walk,
   ``csrc/bf16_walk.cuh``, at F=16 and 40, bit-equal to the plain version
   on the CPU; the share walk, ``csrc/share_walk.cuh``, at 64 and 128,
   bit-equal to it on the card and on the CPU; the generic walk's narrow
   walk at 7), the call from float32 x (cast, then that walk) and, at
   F=16-128, the generic walk beside it, each timed beside its bound,
   beside the cast, the float32 walk and ``torch.sparse.mm``, the share at
   F=40 bit-equal to the plain version on the CPU; the slice's main path,
   a serving product and a training step at F=40 and serving products at
   F=7 and F=128 through ``spmm_pallas(bf16=True)`` with the counts zeroed
   just before and read just after (2 launches of the staged walk, 1 of
   the generic walk, 1 of the share walk, 1 of K2's float32 walk for
   ``dx``), the products and ``dx`` bit-equal to the CPU's and ``dval``
   close to it; the masked walk over the training
   grids' row and column lists and the degree walk (beside
   ``torch.sparse.mm`` of a column of ones), the values of a weighted
   copy in bfloat16 (the
   grids of ``GNNTF_GRID_VALUE_DTYPE=bfloat16``) beside float32, each
   against its plain version; after phase 16, APPNP at its defaults on the
   benchmark graph 3 epochs without and 3 under the knob (an epoch: 20
   masked and 10 degree walks over bfloat16 values), the losses
   bit-equal;
2g. launches over one list that run at the same time: over one
   ``PreparedSpMM`` (the scaled walk) and one training grid's lists (the
   masked and degree walks), calls on two streams in turn and replays of
   a captured call beside eager calls on another stream, each output
   bit-equal to the CPU plain version; the scaled walk's list holds a set
   of split-row counters for each stream and one for the capture, all zero
   after, and lets go of the capture's at the next eager call;
3. drive the serving path: APPNP(num_classes=40) at full width on the
   benchmark graph (random_power_law_edges(169,343, 1,166,243, seed=0),
   symmetrized; 128 random features), three clean forwards, three predict
   requests of 10,000 nodes and one evaluate, with the kernel launch counts
   zeroed just before and read just after (30 launches of K1's scaled
   walk, nothing else); a device profile of one forward and of one SpMM
   (the scaled walk alone: its split rows are finished inside its launch;
   no GEMM), logging the device launches per SpMM and per forward; the
   same forwards
   under ``hybrid`` (the hub slice's matmul and K1 adding into it: 30 K1
   launches) with their profiles beside, the logits allclose to auto's;
   then the same forward on the CPU (plain versions) as the reference;
4a. drive the training path through K2: APPNP(num_classes=40) with its
   defaults on the RCM-reordered benchmark graph, ``train(...,
   spmm_impl="pallas", epochs=5)`` on 10,000 train and 10,000 valid nodes,
   counts zeroed just before and read just after (30 K2 launches an epoch:
   10 in the step's forward, 10 in its backward's A^T dy, 10 in the
   validation forward; the step's degrees run K1's degree mode, 10 an
   epoch); then predict;
4b. the same path on both devices: a hand-built APPNP stack without feature
   dropout (edge masks come from CPU-drawn salts, so they agree), 3 epochs
   under ``pallas`` and 3 epochs under the default implementation, each on
   the card and on the CPU (plain versions), losses and parameters
   compared;
5. drive the default training path: APPNP(num_classes=40) with its defaults
   on the natural-order benchmark graph, ``train(..., epochs=5)`` with no
   ``spmm_impl``, 4a's labels and split, counts zeroed just before and read
   just after: an epoch launches the masked walk 20 times (10 in the step's
   forward over the row list, 10 in its backward over the column list), the
   degree walk 10 times, K1 10 times (the validation forward) and K2 never,
   and the training grids are built once; a profile of one step;
6. drive the fused trainer: phase 5's configuration trained with
   ``train(epochs=10, block_epochs=5, patience=100, seed=0)`` (two blocks:
   one epoch recorded, one captured in a CUDA graph, replayed for the rest)
   against the host loop with ``block_epochs=1``: losses within
   ``rtol=1e-5``, the same best epoch; launches counted twice an epoch's
   worth (the recorded epoch and the capture); the second block's wall time
   an epoch; a profile of a second run's second block (5 replays): per
   replay 20 masked walks, 10 degree walks, 10 K1 walks, no K2 and no
   ``index_add_``, and its device busy time an epoch; peak memory with the
   graph's pool;
6b. the same under ``spmm_impl="pallas"`` on the RCM graph (phase 4a's
   configuration): per replay 30 K2 walks and 10 degree walks;
6c. early stopping inside a block on the card: a small graph under
   ``min_edges_scope(0)``, ``patience=2``, ``epochs=12``, ``block_epochs=5``:
   the fused run's predictions equal the host loop's;
7. GCNII at its published configuration (latent 64, 64 convolutions,
   ``alpha=0.1``, ``l=0.5``, dropout 0.6) on the benchmark graph with 40
   classes: three forwards, three predict requests and one evaluate (64
   walks of K1's scaled walk a forward, no hub-route K1) and a profile of
   one forward; the full-depth forward
   against the CPU's with the same random weights (``rtol=1e-3,
   atol=1e-4``, argmax agreement >= 99.9%); ``train(epochs=3)`` with no
   ``spmm_impl`` (an epoch: 128 scaled walks, 64 backward walks over the
   transposed list) and a profile of one step (no ``index_add_``); 3 epochs
   at depth 8 without dropout on the card and on the CPU, compared as in
   4b;
8. GCN at its published configuration (latent 64, dropout and edge dropout
   0.5): ``train(epochs=5)`` with no ``spmm_impl`` (an epoch: 2 masked
   walks at F=64, 1 degree walk, 3 scaled walks, 1 backward walk at F=40), a
   profile of one step, predict, then ``fit(block_epochs=5)`` against the
   host loop at ``epochs=10`` (losses within ``rtol=1e-5``, the same best
   epoch) and a profile of a fused run's replays;
9. GAT at its configuration (``GATConfig``: latent 8, 8 heads, dropout
   0.6; attention dropout 0.6) on the benchmark graph with its self-loops
   and 40 classes: three forwards, three predict requests and one evaluate
   (A1 and A2 in each layer of a forward, over the coalesced lists), a
   profile of one forward, of one training step (A1-A4 twice each, no
   ``index_add_``; its busy time and A1-A4's share of it) and of the
   attention chain alone (no ``index_add_`` or
   scatter kernel); the serving forward against the CPU's with the same
   weights (``rtol=1e-4, atol=1e-5``, argmax agreement >= 99.9%);
   ``train(epochs=3)`` (per-edge lists with the dropout draw in the step);
   3 epochs without dropout on the card and on the CPU, compared as in 4b;
   ``fit(block_epochs=5)`` with attention dropout against the host loop at
   ``epochs=10`` (losses within ``rtol=1e-5``, the same best epoch) and a
   profile of a fused run's replays;
10. GraphSAGE and GIN at ``GraphSAGEConfig`` and ``GINConfig``: three
   forwards each (K1's scaled walk in each convolution), each against the
   CPU's with the same weights, and ``train(epochs=3)`` (the scaled walk
   and the backward walk); phases 7-10 log their launches an epoch;
11. NGCF link prediction at the configuration of demos/link_prediction.py
   (``NGCF(num_classes=16)``: latent [16, 16], dropout 0.1) on the bench
   graph: BPR over every edge with one negative a pair, redrawn each epoch
   by the C++ sampler (``utils/native.py``, asserted to run) on a prefetch
   thread, validated by BCE on 10,000 held edges with 2 negatives each;
   one sampler call timed, ``train(epochs=3)`` (an epoch: 6 K1 walks at
   F=128, 16, 16 and 2 backward walks at F=16; the wait on the prefetch
   thread each epoch), a profile of one step (``edge_dot``'s two
   ``index_add_`` scatters) and ``edge_dot``'s own time, evaluate's AUC;
   ``fit(epochs=10, block_epochs=5)`` with the block's draws stacked
   against the host loop, timed and with a replay profile, their losses'
   drift logged; the same pair with NGCF's output regularization off (a
   constant: its gradient is rounding noise that Adam scales up): losses
   within ``LP_FUSED_RTOL``, the same best epoch; ``MeanLinkPrediction(
   k=5)`` over 200 nodes,
   peak memory; then 3 epochs without dropout on the card and on the CPU
   on a graph of 80,000 counted edges from one static draw, compared as in
   4b;
12. remat and resume: GCNII-64 at ``GCNIIConfig`` trained 2 epochs with
   and without ``remat`` (dropout on, the same seed): equal histories and
   parameters, each run's peak memory; APPNP under the default impl
   stopped after 3 epochs and resumed from its checkpoint against 6
   epochs straight through, on the host loop and on the fused path:
   equal;
14. single-host scale-out (``gnntf_tpu_torch/parallel``; the card machine
   has one GPU, so no multi-GPU figure exists): (a) the bench graph cut
   into 4 parts by the halo and the ring plans, each rank's halo local and
   remote lists and its 4 ring groups walked at F=40 against their plain
   versions on the card (``1e-5 * sum|terms|``), with realized values (K2's
   store mode) and with a lazy draw at keep 0.9 hashed by global edge id
   (K1's masked walk), each timed beside its bound and ``torch.sparse.mm``
   of the rank's block, the plans' halo and hub sizes logged (the table a
   halo exchange fills is built in the process: no collective); (b)
   ``fit(mesh=make_mesh(1, 1), spmm=s)`` over NCCL at world size 1 for s
   in None, "halo", "ring", APPNP at its defaults with dropout, 5 epochs,
   each against ``fit()`` on one device from the same seed (losses within
   ``rtol=1e-5``, the same best epoch), with each run's launches (counts
   zeroed just before), its epochs' wall seconds and one epoch's device
   busy time; (c) ``fit(mesh=, block_epochs=5)`` against (b)'s gspmd run;
   (d) at Cora's scale (2,708 nodes, 10,556 counted edges) two identical
   APPNP and GAT runs bit-equal, K2's launches in APPNP's runs (counts
   zeroed just before), a profiled step of each with no ``index_add_``
   kernel (APPNP's K2 walks all ``blocked_spmm_walk_narrow``), and on the
   uniform graph and a power-law one (hub rows split) K2 over both lists at
   F=1 (a column of ones: the degree walk), 7 and 64, cut by
   ``unit_items`` and at 128 items side by side, each against its plain
   version, the program's cut bit-equal to the plain version on the CPU,
   with one call's device time by kernel (walk, parts, fix-up) beside the
   ``index_add_`` route it replaced; (e) the process group destroyed;
16. the fused trainer's cases that ran only on the host loop on a card
   before, each fused run against the host loop on the card from the same
   seed (losses within ``rtol=1e-5``, the same best epoch, the recorded
   epoch's and the capture's launches twice an epoch's, each walk's
   launches in a profiled replay equal to the host loop's an epoch, the
   second block's wall time an epoch, a replay's device busy time): (a)
   APPNP at its defaults at Cora's scale, its eager edge masks' uniforms
   read from the tape's per-block tables (K2's store-mode walks), the
   tables' bytes; (b) GCNII-64 at ``GCNIIConfig`` with ``remat=True``,
   ``block_epochs=2``, against the host loop with remat and the fused run
   without it, both fused peaks with the graph's pool (K1 and its backward
   walk); (c) APPNP at its defaults on the bench graph with momentum SGD
   and optax-style Adam (the masked and degree walks); (d) (a)'s APPNP
   with a layer that scales by a draw from ``next_generator(device)``;
13. print each phase's seconds, a ``{"kernels": [...]}`` line (K1's
   scaled walk and its backward, K1 and hybrid's backward walk, with
   NGCF's launches and an F=16 reading, phases 2 and 2d; K2 and the masked walk with phase 14's per-rank walks and
   launches; K2's bfloat16 mode and the walks over bfloat16 values, phase
   2f), the card's name and power limit from nvidia-smi, and as the
   last line ``{"ok": true, "device": {...}}``.
"""
import dataclasses
import importlib
import json
import subprocess
import sys
import threading
import time

import numpy as np
import torch

N_NODES = 169_343
N_EDGES = 1_166_243
N_FEATURES = 128
N_CLASSES = 40
N_REQUESTS, REQUEST_NODES = 3, 10_000
TRAIN_NODES = VALID_NODES = 10_000
TRAIN_EPOCHS, CROSS_EPOCHS = 5, 3
# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s off the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
# integer operations of the dropout hash an edge (two fmix32 rounds, the
# salts, the threshold and n_drop tests), counted at the fp32 rate: the
# data sheet gives no integer rate off the tensor cores, and a higher rate
# would only lower the bound
HASH_OPS = 21
# the draw of the masked kernels' checks: keep rate of APPNP's edge dropout
KEEP = 0.5
# K1's degree walk (csrc/degree_walk.cuh) in a profile: the walk, and the
# fold of the rows that cross a block's share (at most these two a call)
DEGREE_WALK = "ell_degree_share_walk"
DEGREE_FOLD = "ell_degree_share_fold"
# kernel vs plain version on the card, per element, relative to the sum of
# the magnitudes of the element's terms (the scale of float32 summation
# error; the result itself may cancel).  Neither kernel uses atomics: each
# sums a row, or a piece of a split row, in list order and a split row's
# pieces in a fixed order, so the plain version run on the CPU, where
# index_add_ adds in index order, equals it bit for bit (phases 2 and 2b log
# that share).  The plain version on the card adds a row's terms with
# index_add_'s atomics, in no fixed order, hence the tolerance.
KERNEL_RTOL = 1e-5
# fused vs host-loop training on the card: the same kernels in the same
# order (a CUDA graph of one epoch replays the host loop's work), but the
# capture may take other library algorithms for the dense products
FUSED_RTOL = 1e-5
FUSED_EPOCHS, FUSED_BLOCK = 10, 5
# GPU vs CPU forward: float32, sums in another order across 10 steps
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)
MIN_ARGMAX_AGREEMENT = 0.999
# GPU vs CPU training (3 epochs, same edge masks): float32 sums in another
# order through 10 propagation steps, their backward and 3 Adam updates.
# Parameters must agree within PARAM_TOL except for at most PARAM_OUTLIERS of
# their elements, and no element may differ by more than MAX_PARAM_DIFF.
# Adam's state at the elements outside PARAM_TOL is logged: an update is
# -alpha * m / (sqrt(v) + eps), most sensitive to rounding in g where sqrt(v)
# is of the order of eps.
LOSS_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_OUTLIERS = 1e-3
MAX_PARAM_DIFF = 1e-3
LEARNING_RATE = 0.01
# the models run at their published configurations, the port's config.py
# (GCNIIConfig: latent 64, 64 convolutions, alpha 0.1, l 0.5, dropout 0.6;
# GCNConfig: latent 64, GCN's own dropouts 0.5 feature and 0.5 edge;
# GATConfig, GraphSAGEConfig, GINConfig); GCNII's depth, read where it sets
# a launch count
GCNII_ITERATIONS = 64
GCNII_EPOCHS, GCN_EPOCHS = 3, 5
# GCNII's weights for the GPU vs CPU checks: U(-INIT_SCALE, INIT_SCALE), as
# its zero-initialized convolution weights would hide the convolutions
INIT_SCALE = 0.1
# GCNII-64's GPU vs CPU forward: float32, 64 layers of sums in another
# order (each SpMM, each 64-wide mix)
GCNII_TOL = dict(rtol=1e-3, atol=1e-4)
# the depth of the cross-device GCNII run
CROSS_ITERATIONS = 8


def log(msg):
    print(msg, flush=True)


def nvidia_smi(query):
    """The first card's ``nvidia-smi --query-gpu=<query>`` line."""
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps=20, warmup=3):
    """Mean device time of one ``fn()`` over ``reps`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# spin kernels a profiler session launches before its work: torch.profiler
# can drop the first device events of a session, from none to a whole
# session's worth (PERF.md §7), so the work's events are all kept when at
# least one primer kernel is; a session that kept none is taken again with
# four times as many, up to PROFILE_TRIES sessions.  It can drop the last
# ones too (the work's one walk, right before the session stopped), so a
# session waits PRIMER_WAIT_S a primer of PRIMER_KERNELS on the host
# between its work's end and its stop, and a session that kept fewer walks
# than the wrappers launched in it is taken again like one unprimed
PRIMER_KERNELS = 256
PRIMER_WAIT_S = 0.002
PROFILE_TRIES = 4


def device_profile(fn):
    """Device time by kernel over one ``fn()`` (torch.profiler): rows
    ``(name, us, launches)`` by time, busy and wall microseconds, and the
    wrappers' launch counts over the session.  After PROFILE_TRIES
    sessions that each lost walks, the last one is returned for the
    caller's checks to judge."""
    primer, short = PRIMER_KERNELS, None
    for _ in range(PROFILE_TRIES):
        before = launch_counts()
        span = ProfiledSpan(primer)
        span.start()
        fn()
        rows, busy_us, wall_us = span.stop()
        if not span.primed:
            primer = lost_primer(primer)
            continue
        counted = {k: v - before[k] for k, v in launch_counts().items()}
        short = rows, busy_us, wall_us, counted
        if walk_launches(rows) >= sum(counted.values()):
            return short
        primer = lost_walks(primer, walk_launches(rows),
                            sum(counted.values()))
    if short is None:
        raise RuntimeError(f"the profiler kept no primer kernel in "
                           f"{PROFILE_TRIES} sessions")
    return short


def walk_launches(rows):
    """Launches of the port's walks in a profile's rows: each wrapper's
    counted launch runs one kernel whose name ends in ``_walk`` (or
    ``_walk_narrow``) beside its parts and fix-up."""
    return sum(r[2] for r in rows
               if kernel_name(r[0]).endswith(("_walk", "_walk_narrow")))


def lost_primer(primer):
    """Log a session that kept none of its ``primer`` kernels; the next
    session's primer."""
    log(f"a profiler session kept none of its {primer} primer kernels: "
        f"taken again with {4 * primer}")
    return 4 * primer


def lost_walks(primer, kept, launched):
    """Log a session that kept ``kept`` of the ``launched`` walks run in
    it; the next session's primer (its wait grows with it)."""
    log(f"a profiler session kept {kept} of the {launched} walks launched "
        f"in it: taken again with {4 * primer} primer kernels")
    return 4 * primer


class ProfiledSpan:
    """torch.profiler from :meth:`start` to :meth:`stop` (which may be
    called from two callbacks of one run), ``primer`` spin kernels at its
    start, outside the rows and the times; ``primed`` (after ``stop``)
    counts those that the profile kept."""

    def __init__(self, primer=PRIMER_KERNELS):
        self.primer = primer

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        for _ in range(self.primer):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        self.t0 = time.perf_counter()

    def stop(self):
        """Rows ``(name, us, launches)`` by time, busy and wall
        microseconds."""
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - self.t0) * 1e6
        time.sleep(PRIMER_WAIT_S * self.primer / PRIMER_KERNELS)
        self.prof.stop()
        rows = [(e.key, e.self_device_time_total, e.count)
                for e in self.prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        self.primed = sum(r[2] for r in rows if "spin_kernel" in r[0])
        rows = [r for r in rows if "spin_kernel" not in r[0]]
        rows.sort(key=lambda r: -r[1])
        return rows, sum(r[1] for r in rows), wall_us


def kernel_name(key):
    """A profiled kernel's name without namespace, template arguments and
    parameters (``ell_degree_share_walk``, ``blocked_spmm_walk``,
    ...)."""
    return key.split("(anonymous namespace)::")[-1].split("<")[0].split(
        "(")[0]


def log_kernels(label, rows, tag):
    """One line per kernel whose name holds ``tag`` (K1's or K2's walk,
    parts and fix-up)."""
    for key, us, count in rows:
        if tag in key:
            log(f"  {label} kernel {kernel_name(key)}: {us} "
                f"us in {count} launches, {us / count} us a launch")


def clean_forward(model):
    """A call that runs ``model``'s forward anew each time (no cached
    activations)."""
    def forward():
        model._act_cache = None
        return model._activations()
    return forward


def profile_forward(label, fn, top=10):
    """Device time by kernel over one clean forward or one SpMM, the share
    of its wall time (under the profiler) that the device was busy, and
    K1's kernels apart."""
    rows, busy_us, wall_us, _ = device_profile(fn)
    launches = sum(r[2] for r in rows)
    log(f"profile of {label}: wall {wall_us} us, device busy {busy_us} us "
        f"in {launches} launches, idle share {1 - busy_us / wall_us}")
    for key, us, count in rows[:top]:
        log(f"  {us} us in {count} launches: {key[:90]}")
    log_kernels("K1", rows, "ell_gather")
    return dict(busy_us=busy_us, wall_us=wall_us, launches=launches,
                k1_us=sum(r[1] for r in rows if "ell_gather" in r[0]),
                k1_walks=sum(r[2] for r in rows
                             if "ell_gather_walk" in r[0]),
                k1s_walks=sum(r[2] for r in rows
                              if "ell_gather_scaled_walk" in r[0]),
                gemm_us=sum(r[1] for r in rows if "gemm" in r[0].lower()),
                us_by_kernel={kernel_name(k): us for k, us, _ in rows})


def ell_bound(lst, f):
    """Least time for the K1 function over this list: its row pointer and
    row ids (8 B a held row), each live slot's source and value (8 B), the
    referenced x rows read once, the held rows of out read and written once;
    2 flops per live slot and feature, and one add per held row and
    feature."""
    x_rows = int(torch.unique(lst.idx).numel())
    n_bytes = ((lst.n_rows + 1) * 4 + lst.n_rows * 4 + lst.n_edges * 8
               + x_rows * f * 4 + 2 * lst.n_rows * f * 4)
    flops = (2 * lst.n_edges + lst.n_rows) * f
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def check_close(label, out, ref, scale):
    """Raise unless ``|out - ref| <= KERNEL_RTOL * scale`` everywhere;
    returns max|out - ref|."""
    diff = (out - ref).abs()
    err = diff.max().item()
    ratio = (diff / scale.clamp(min=1e-30)).max().item()
    log(f"{label}: max_abs_err {err}, max |err| / sum|terms| {ratio} "
        f"(limit {KERNEL_RTOL})")
    if not bool((diff <= KERNEL_RTOL * scale).all()):
        raise AssertionError(f"{label} disagrees with the plain version")
    return err


def list_to(lst, device):
    """A walk's list (K1's or K2's) with every tensor on ``device``."""
    return dataclasses.replace(lst, **{
        f.name: getattr(lst, f.name).to(device)
        for f in dataclasses.fields(lst)
        if isinstance(getattr(lst, f.name), torch.Tensor)})


def check_ell_kernel(label, lst, val, x, base, library=False):
    """K1 over its list, adding into a copy of ``base``, against its plain
    version on the card; times kernel, plain version and (``library``)
    ``torch.sparse.addmm`` of the same CSR matrix."""
    from gnntf_tpu_torch.ops import blocked_spmm_plain, ell_gather_list

    out = ell_gather_list(lst, val, x, base.clone())
    torch.cuda.synchronize()
    ref = blocked_spmm_plain(lst, val, x, base.clone())
    scale = blocked_spmm_plain(lst, val.abs(), x.abs(), base.abs())
    err = check_close(f"K1 {label}", out, ref, scale)
    scratch = base.clone()  # timed calls add into it, again and again
    res = dict(max_abs_err=err,
               ms=time_ms(lambda: ell_gather_list(lst, val, x, scratch)),
               plain_ms=time_ms(lambda: blocked_spmm_plain(lst, val, x,
                                                           scratch)))
    res["bound_ms"], res["bound_by"], n_bytes = ell_bound(lst, x.shape[1])
    res["library_ms"] = None
    if library:
        # yardstick only: one cuSPARSE CSR product added into the base
        n = base.shape[0]
        rows = torch.repeat_interleave(lst.rows.long(), lst.ptr.diff().long())
        a = torch.sparse_coo_tensor(torch.stack([rows, lst.idx.long()]), val,
                                    (n, x.shape[0]))
        a = a.coalesce().to_sparse_csr()
        check_close(f"library sparse.addmm {label}",
                    torch.sparse.addmm(base, a, x), ref, scale)
        res["library_ms"] = time_ms(lambda: torch.sparse.addmm(base, a, x))
    log(f"K1 {label}: kernel {res['ms']} ms, plain {res['plain_ms']} ms, "
        f"library {res['library_ms']} ms, bound {res['bound_ms']} ms "
        f"({res['bound_by']}, {n_bytes} B), held rows {lst.n_rows}, live "
        f"slots {lst.n_edges}, units {lst.n_units}, split rows "
        f"{lst.split.shape[0]}, F={x.shape[1]}")
    return res


def scaled_bound(lst, f, scales, w):
    """Least time for K1's scaled walk over this whole list (or, over the
    transposed list, its backward, ``scales`` swapped): its row pointer (4
    B a row), each live slot's source and value (8 B) and, where the list
    reads one, its id (4 B more), x read once (the referenced rows, or
    every row where the identity reads it), the scales (4 B a row each)
    and out written once; per slot and feature a product and a sum (and
    the gathered scale's product), per row and feature the stored scale's
    product (and the identity's product and sum)."""
    x_rows = lst.n_rows if w != 0.0 else int(torch.unique(lst.idx).numel())
    n_scales = sum(v is not None for v in scales)
    n_bytes = ((lst.n_rows + 1) * 4 + lst.n_edges * 8 + x_rows * f * 4
               + (lst.eid is not None) * lst.n_edges * 4
               + n_scales * lst.n_rows * 4 + lst.n_rows * f * 4)
    flops = ((2 + (scales[1] is not None)) * lst.n_edges
             + ((scales[0] is not None) + 2 * (w != 0.0)) * lst.n_rows) * f
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def check_scaled_kernel(label, lst, val, x, rs, cs, w, library=False,
                        backward=False):
    """K1's scaled walk over the whole list ``lst`` (with ``backward``, the
    prepared operator's backward over the transposed list, ``x`` being
    ``dy``) against its plain version on the card and, bit for bit, on the
    CPU; times kernel, plain version and (``library``) ``torch.sparse.mm``
    of the normalized matrix (``A^T`` for the backward; the scales folded
    into its values) plus ``w * x``; one call's device time by kernel from
    a profile."""
    from gnntf_tpu_torch.ops import (ell_gather_scaled,
                                     ell_gather_scaled_backward,
                                     ell_gather_scaled_backward_plain,
                                     ell_gather_scaled_plain)

    call, plain = ((ell_gather_scaled_backward,
                    ell_gather_scaled_backward_plain) if backward
                   else (ell_gather_scaled, ell_gather_scaled_plain))
    what = "K1 scaled backward" if backward else "K1 scaled"
    out = call(lst, val, x, rs, cs, w)
    torch.cuda.synchronize()
    ref = plain(lst, val, x, rs, cs, w)
    absent = lambda t: None if t is None else t.abs()
    scale = plain(lst, val.abs(), x.abs(), absent(rs), absent(cs), abs(w))
    err = check_close(f"{what} {label}", out, ref, scale)
    cpu = lambda t: None if t is None else t.cpu()
    bits = (out.cpu() == plain(list_to(lst, "cpu"), val.cpu(), x.cpu(),
                               cpu(rs), cpu(cs), w)).double().mean().item()
    log(f"{what} {label} on the card against the plain version on the "
        f"CPU: bit-equal share {bits}")
    if bits != 1.0:
        raise AssertionError(f"{what} {label} is not bit-equal to its plain "
                             "version on the CPU")
    run = lambda: call(lst, val, x, rs, cs, w)
    res = dict(max_abs_err=err, bit_equal_to_cpu_plain=bits, ms=time_ms(run),
               plain_ms=time_ms(lambda: plain(lst, val, x, rs, cs, w)))
    rows, busy_us, _, _ = device_profile(run)
    res["device_ms"] = busy_us / 1e3
    res["us_by_kernel"] = {kernel_name(key): us for key, us, _ in rows}
    res["launches_a_call"] = sum(r[2] for r in rows)
    # the gathered scale is cs forward, rs backward
    res["bound_ms"], res["bound_by"], n_bytes = scaled_bound(
        lst, x.shape[1], (cs, rs) if backward else (rs, cs), w)
    res["library_ms"] = None
    if library:
        # yardstick only: one cuSPARSE CSR product of the normalized matrix
        # (the scales folded into its values; backward: A^T, the stored
        # scale cs and the gathered rs)
        r, c = live_edges(lst)
        v = val if lst.eid is None else val[lst.eid.long()]
        gathered, stored = (rs, cs) if backward else (cs, rs)
        v = v * (1.0 if stored is None else stored[r]) * (
            1.0 if gathered is None else gathered[c])
        a = torch.sparse_coo_tensor(torch.stack([r, c]), v,
                                    (lst.n_rows, x.shape[0]))
        a = a.coalesce().to_sparse_csr()
        lib = (lambda: torch.sparse.mm(a, x)) if w == 0.0 else \
            (lambda: torch.sparse.addmm(x, a, x, beta=w))
        check_close(f"library sparse.mm {label}", lib(), ref, scale)
        res["library_ms"] = time_ms(lib)
    log(f"{what} {label}: kernel {res['ms']} ms (one call's device time "
        f"{res['device_ms']} ms in {res['launches_a_call']} launches: "
        f"{res['us_by_kernel']} us), plain {res['plain_ms']} ms, library "
        f"{res['library_ms']} ms, bound {res['bound_ms']} ms "
        f"({res['bound_by']}, {n_bytes} B), rows {lst.n_rows}, live slots "
        f"{lst.n_edges}, units {lst.n_units}, split rows "
        f"{lst.split.shape[0]}, F={x.shape[1]}")
    return res


def split_whole_list(seed, n, pieces, dev, hub=0.05):
    """A whole list of ``n`` short rows (0-6 slots, every third row empty),
    row 3 split into ``pieces`` pieces of the scaled walk's unit size and
    row n/2 into two, a share ``hub`` of the slots on column 11, in units
    of that size with the walk's counters; its slot values, positive row
    and column scales."""
    from gnntf_tpu_torch.ops import EdgeList
    items = k1_module()._WHOLE_ITEMS
    rng = np.random.RandomState(seed)
    deg = rng.randint(0, 7, n)
    deg[::3] = 0
    deg[3] = pieces * items - items // 2
    deg[n // 2] = items + 1
    ptr = np.concatenate([[0], np.cumsum(deg)])
    src = rng.randint(0, n, ptr[-1])
    src[rng.rand(len(src)) < hub] = 11
    lst = EdgeList.build(ptr, src, None, dev, items=items)
    val, rs, cs = (torch.from_numpy(a.astype(np.float32)).to(dev) for a in (
        rng.randn(len(src)), rng.uniform(0.1, 2.0, n),
        rng.uniform(0.1, 2.0, n)))
    return lst, val, rs, cs


def phase_ell_kernel(graph, dev, x16, x40, x64, x128):
    """2: K1 against its plain version, small and on the bench graph's rest
    ELL list (``hybrid``'s, F=128, 64, 40 and 16), adding into random
    bases; K1's scaled walk over the whole list of the serving adjacency
    (``auto``'s, the same widths, each bit-equal to its plain version on
    the CPU) and over a list with a row split into thousands of pieces,
    rows without slots and an identity; returns the results."""
    from gnntf_tpu_torch.ops import (PreparedSpMM, blocked_spmm_plain,
                                     ell_edge_list, ell_gather_list,
                                     normalize_adjacency)
    from gnntf_tpu_torch.ops.spmm import build_ell

    rng = np.random.RandomState(0)
    n = 3000
    row = rng.randint(0, n // 2, size=60_000) * 2  # odd rows stay empty
    col = rng.randint(0, n, size=60_000)
    # row 0 holds ~2,900 unique slots: split over many units
    row = np.concatenate([row, np.zeros(20_000, np.int64)])
    col = np.concatenate([col, rng.randint(0, n, size=20_000)])
    layout = build_ell(row, col, n, 8)
    small, slot = ell_edge_list(layout.idx, layout.vrow_row, n, dev)
    small_val = torch.from_numpy(rng.randn(len(slot)).astype(
        np.float32)).to(dev)
    for f in (6, 40):  # the line reports F=40, the width of the path
        x = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev)
        base = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev)
        small_res = check_ell_kernel(f"small F={f}", small, small_val, x,
                                     base)

    adj = normalize_adjacency(graph, graph_dropout=0.0)
    held = {}
    for hubs in (True, False):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        held[hubs] = PreparedSpMM(adj, hubs=hubs)
        torch.cuda.synchronize()
        held[hubs] = (held[hubs], time.perf_counter() - t0,
                      torch.cuda.memory_allocated() - before)
    prep, setup_s, hybrid_bytes = held[True]
    lst, val = prep.k1_list, prep.k1_val
    split = lst.split.cpu().numpy()
    slots = lst.ptr.diff().cpu().numpy()
    stats = dict(held_rows=lst.n_rows, live_slots=lst.n_edges,
                 units=lst.n_units, split_rows=len(split),
                 pieces=int(split[:, 2].sum()),
                 heaviest_row_slots=int(slots.max(initial=0)),
                 rows_over_1000_slots=int((slots > 1000).sum()),
                 rest_vrows=prep.ell.n_vrows,
                 hub_slice=list(prep.dense.shape),
                 hub_pairs=int(torch.count_nonzero(prep.dense)),
                 prepared_s=setup_s, operator_bytes=hybrid_bytes)
    log(f"bench graph: {graph.n_edges} counted edges; K1's rest list "
        f"(hybrid) {stats}")
    rng = np.random.RandomState(4)
    res = {}
    for f, x in ((N_FEATURES, x128), (64, x64), (16, x16), (40, x40)):
        base = torch.from_numpy(rng.randn(N_NODES, f).astype(
            np.float32)).to(dev)
        res[f] = check_ell_kernel(f"bench F={f}", lst, val, x, base,
                                  library=True)
    # the kernel rounds as the plain version does on the CPU, in its order
    out = ell_gather_list(lst, val, x40, base.clone()).cpu()
    ref = blocked_spmm_plain(list_to(lst, "cpu"), val.cpu(), x40.cpu(),
                             base.cpu())
    stats["bit_equal_to_cpu_plain_f40"] = (out == ref).double().mean().item()
    log(f"K1 bench F=40 on the card against the plain version on the CPU: "
        f"bit-equal share {stats['bit_equal_to_cpu_plain_f40']}")

    # K1's scaled walk: the auto operator, every live slot of the ELL
    op, auto_s, auto_bytes = held[False]
    whole = op.k1_list
    split = whole.split.cpu().numpy()
    slots = whole.ptr.diff().cpu().numpy()
    whole_stats = dict(rows=whole.n_rows, held_rows=int((slots > 0).sum()),
                       live_slots=whole.n_edges, units=whole.n_units,
                       split_rows=len(split), pieces=int(split[:, 2].sum()),
                       heaviest_row_slots=int(slots.max(initial=0)),
                       hub_slice=None if op.dense is None else "built",
                       prepared_s=auto_s, operator_bytes=auto_bytes,
                       bytes_less_than_hybrid=hybrid_bytes - auto_bytes)
    log(f"K1's whole list (auto, no hub slice): {whole_stats}")
    if op.dense is not None or whole.rows is not None:
        raise AssertionError("auto built a hub slice or a list of held rows")
    # a list with a row split into thousands of pieces, rows without slots
    # and an identity, at an aligned and an unaligned width
    small_lst, small_val, rs, cs = split_whole_list(13, 3000, 2500, dev)
    rng = np.random.RandomState(5)
    scaled_small = {f: check_scaled_kernel(
        f"small F={f}", small_lst, small_val, torch.from_numpy(
            rng.randn(3000, f).astype(np.float32)).to(dev), rs, cs, 0.5)
        for f in (7, 40)}
    scaled = {}
    for f, x in ((N_FEATURES, x128), (64, x64), (16, x16), (40, x40)):
        scaled[f] = check_scaled_kernel(
            f"bench F={f}", whole, op.k1_val, x, *op._scales,
            float(op.eye_weight), library=True)
    whole_stats["bit_equal_to_cpu_plain_f40"] = \
        scaled[40]["bit_equal_to_cpu_plain"]
    return dict(small=small_res, bench=res[N_FEATURES], serving=res[40],
                gcn_width=res[64], ngcf_width=res[16], rest_list=stats,
                scaled=dict(serving=scaled[40], bench=scaled[N_FEATURES],
                            gcn_width=scaled[64], ngcf_width=scaled[16],
                            small=scaled_small, whole_list=whole_stats))


def live_edges(lst):
    """(row, source) of every edge of a K2 list, as the plain version walks
    them."""
    rows = torch.repeat_interleave(
        torch.arange(lst.n_rows, device=lst.ptr.device), lst.ptr.diff().long())
    return rows, lst.idx.long()


def blocked_bound(lst, f):
    """Least time for the K2 function over this list: its row pointer (4 B
    a row), each edge's source and value (8 B) and, where the list reads
    one, its edge id (4 B more) read once, the referenced x rows read once,
    out written once; 2 flops per edge and feature."""
    x_rows = int(torch.unique(lst.idx).numel())
    edge_bytes = 8 if lst.eid is None else 12
    n_bytes = ((lst.n_rows + 1) * 4 + lst.n_edges * edge_bytes
               + x_rows * f * 4 + lst.n_rows * f * 4)
    flops = 2 * lst.n_edges * f
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def check_blocked_kernel(label, lst, val, x, library=False):
    from gnntf_tpu_torch.ops import blocked_spmm, blocked_spmm_plain

    out = blocked_spmm(lst, val, x)
    torch.cuda.synchronize()
    ref = blocked_spmm_plain(lst, val, x)
    scale = blocked_spmm_plain(lst, val.abs(), x.abs())
    err = check_close(f"K2 {label}", out, ref, scale)
    res = dict(max_abs_err=err,
               ms=time_ms(lambda: blocked_spmm(lst, val, x)),
               plain_ms=time_ms(lambda: blocked_spmm_plain(lst, val, x)))
    # one call's device time (a profile): the walk, its parts and fix-up
    rows, busy_us, _, _ = device_profile(lambda: blocked_spmm(lst, val, x))
    res["device_ms"] = busy_us / 1e3
    res["us_by_kernel"] = {kernel_name(key): us for key, us, _ in rows}
    res["bound_ms"], res["bound_by"], n_bytes = blocked_bound(
        lst, x.shape[1])
    res["library_ms"] = None
    if library:
        # yardstick only: one cuSPARSE CSR product of the same matrix
        rows, src = live_edges(lst)
        n = lst.n_rows
        w = val if lst.eid is None else val[lst.eid.long()]
        a = torch.sparse_coo_tensor(torch.stack([rows, src]), w,
                                    (n, x.shape[0]))
        a = a.coalesce().to_sparse_csr()
        check_close(f"library CSR product {label}", torch.sparse.mm(a, x),
                    ref, scale)
        res["library_ms"] = time_ms(lambda: torch.sparse.mm(a, x))
    log(f"K2 {label}: kernel {res['ms']} ms (one call's device time "
        f"{res['device_ms']} ms: {res['us_by_kernel']} us), plain "
        f"{res['plain_ms']} ms, library {res['library_ms']} ms, bound "
        f"{res['bound_ms']} ms "
        f"({res['bound_by']}, {n_bytes} B), edges {lst.n_edges}, units "
        f"{lst.n_units}, split rows {lst.split.shape[0]}, eid "
        f"{'identity' if lst.eid is None else 'read'}, N={lst.n_rows} "
        f"F={x.shape[1]}")
    return res


def layout_stats(lay, seconds):
    """Chunks, fill and the skew of the work over windows and chunks."""
    clen = lay.chunk_len
    per_window = np.bincount(lay.chunk_window, minlength=lay.n_windows)
    edges = np.bincount(lay.chunk_window, weights=clen,
                        minlength=lay.n_windows).astype(np.int64)
    stats = dict(
        chunks=lay.n_chunks, slots=int(lay.rows.shape[0]),
        fill=lay.fill_factor, windows=lay.n_windows,
        chunks_per_window_median=float(np.median(per_window)),
        chunks_per_window_p99=float(np.percentile(per_window, 99)),
        chunks_per_window_max=int(per_window.max()),
        edges_per_window_median=float(np.median(edges)),
        heaviest_window_edges=int(edges.max()),
        heaviest_window_share=float(edges.max() / max(1, lay.n_edges)),
        edges_per_chunk_median=float(np.median(clen)),
        chunks_at_most_8_edges=int((clen <= 8).sum()),
        full_chunks=int((clen == lay.block_edges).sum()), **seconds)
    log(f"RCM bench layout: {stats}")
    return stats


def list_rows(lst):
    """The list row of each item of a walk's list."""
    return torch.repeat_interleave(
        torch.arange(lst.n_rows, device=lst.device), lst.ptr.diff().long(),
        output_size=lst.n_edges)


def list_eids(lst):
    return (torch.arange(lst.n_edges, device=lst.device) if lst.eid is None
            else lst.eid.long())


def masked_bound(lst, kept, f=None, val_bytes=4):
    """Least time for a masked walk over this list under a draw that keeps
    ``kept`` (one bool a list item): its row pointer (4 B a row), each
    item's edge id where the list reads one (4 B), the source (4 B) and
    value (``val_bytes``: 4, or 2 in bfloat16) of each kept edge (a dropped
    edge's are not needed), the x rows that kept edges reference read once
    and out written once; 2 flops per kept edge and feature and the hash's
    integer operations an edge.  With no ``f`` (the degree walk): no
    sources and no x, one value a row out, an addition per kept edge."""
    n_kept = int(kept.sum())
    eid_bytes = 0 if lst.eid is None else 4 * lst.n_edges
    n_bytes = (lst.n_rows + 1) * 4 + eid_bytes
    if f is None:
        n_bytes += n_kept * val_bytes + lst.n_rows * 4
        ops = n_kept + HASH_OPS * lst.n_edges
    else:
        x_rows = int(torch.unique(lst.idx[kept]).numel())
        n_bytes += (n_kept * (4 + val_bytes) + x_rows * f * 4
                    + lst.n_rows * f * 4)
        ops = 2 * n_kept * f + HASH_OPS * lst.n_edges
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def check_masked_kernel(label, lst, val, draw, x=None, library=False):
    """K1's masked walk (``x`` given) or its degree walk (no ``x``) over a
    training-grid list against its plain version on the card; times kernel,
    plain version (the hash included) and (``library``) one PyTorch call of
    the same function on the realized values: ``torch.sparse.mm`` of the
    dropped matrix in CSR, or ``index_add_`` for the degree (``library=
    "csr"``: ``sparse.mm`` with a column of ones, whose sums do not add a
    hub row's thousands of terms one atomic at a time); one call's device
    time, in all and by kernel (a profile).  ``draw`` is ``(salt, keep,
    n_drop)``, or with a fourth item the id base of a rank's slice (the
    mask hashed at it plus the list's ids)."""
    from gnntf_tpu_torch.ops import (blocked_spmm_plain, ell_degree_masked,
                                     ell_degree_masked_plain,
                                     ell_gather_masked,
                                     ell_gather_masked_plain, stochastic)

    w = stochastic.drawn_values(val, *draw)
    draw, base = draw[:3], draw[3:]
    if x is None:
        kernel = lambda: ell_degree_masked(lst, val, *draw, *base)
        plain_fn = lambda: ell_degree_masked_plain(lst, val, *draw, *base)
        ones = torch.ones(lst.n_rows, 1, device=val.device)
        scale = blocked_spmm_plain(lst, w.abs(), ones)[:, 0]
    else:
        kernel = lambda: ell_gather_masked(lst, val, *draw, x, *base)
        plain_fn = lambda: ell_gather_masked_plain(lst, val, *draw, x,
                                                   *base)
        scale = blocked_spmm_plain(lst, w.abs(), x.abs())
    out = kernel()
    torch.cuda.synchronize()
    ref = plain_fn()
    err = check_close(f"{label}", out, ref, scale)
    # the degree walk sums in its plain version's order (shares, lanes,
    # blocks), so it is bit-equal to it on the card
    if x is None and not torch.equal(out, ref):
        raise AssertionError(f"{label}: the degree walk is not bit-equal to "
                             "its plain version")

    def plain():
        stochastic._last_draw = None  # hash anew, as a new draw would
        return plain_fn()

    res = dict(max_abs_err=err, ms=time_ms(kernel))
    # one call's device time by kernel, right after the kernel's own calls
    # (as the library call's below): the masked walk's two passes (and its
    # flag's memset), or the degree walk and its fold
    rows, busy_us, _, _ = device_profile(kernel)
    res["plain_ms"] = time_ms(plain)
    res["device_ms"] = busy_us / 1e3
    res["us_by_kernel"] = {kernel_name(key): us for key, us, _ in rows}
    res["kernels_a_call"] = sum(n for _, _, n in rows)
    if x is None and (res["kernels_a_call"] > 2 or any(
            kernel_name(key) not in (DEGREE_WALK, DEGREE_FOLD)
            for key, _, _ in rows)):
        raise AssertionError(f"{label}: a degree call ran {rows}, expected "
                             f"{DEGREE_WALK} and at most {DEGREE_FOLD}")
    kept = stochastic.keep_mask(list_eids(lst) + sum(base), draw[0],
                                draw[1], draw[2])
    res["bound_ms"], res["bound_by"], n_bytes = masked_bound(
        lst, kept, None if x is None else x.shape[1], val.element_size())
    res["library_ms"] = None
    if library:
        rows, w_items = list_rows(lst), w[list_eids(lst)]
        if x is None:
            # sparse.mm of a column of ones, timed for every degree walk
            # (events and one call's device time)
            a = torch.sparse_coo_tensor(
                torch.stack([rows, lst.idx.long()]), w_items,
                (lst.n_rows, lst.n_rows)).coalesce().to_sparse_csr()
            ones = torch.ones(lst.n_rows, 1, device=val.device)
            ones_call = lambda: torch.sparse.mm(a, ones)[:, 0]
            check_close(f"sparse.mm of ones {label}", ones_call(), ref,
                        scale)
            res["ones_spmm_ms"] = time_ms(ones_call)
            res["ones_spmm_device_ms"] = device_profile(ones_call)[1] / 1e3
        if x is None and library != "csr":
            call = lambda: torch.zeros(lst.n_rows, device=val.device
                                       ).index_add_(0, rows, w_items)
        elif x is None:
            call = ones_call
        else:
            a = torch.sparse_coo_tensor(
                torch.stack([rows, lst.idx.long()]), w_items,
                (lst.n_rows, x.shape[0])).coalesce().to_sparse_csr()
            call = lambda: torch.sparse.mm(a, x)
        check_close(f"library {label}", call(), ref, scale)
        res["library_ms"] = time_ms(call)
    log(f"{label}: kernel {res['ms']} ms, plain {res['plain_ms']} ms, "
        f"library {res['library_ms']} ms (sparse.mm of ones "
        f"{res.get('ones_spmm_ms')} ms, device "
        f"{res.get('ones_spmm_device_ms')} ms), bound {res['bound_ms']} ms "
        f"({res['bound_by']}, {n_bytes} B), kept {int(kept.sum())} of "
        f"{lst.n_edges} edges, units {lst.n_units}, split rows "
        f"{lst.split.shape[0]}, tiles {lst.n_tiles} (caps {lst.tile_caps}), "
        f"eid {'identity' if lst.eid is None else 'read'}"
        f", N={lst.n_rows}" + ("" if x is None else f" F={x.shape[1]}")
        + f"; one call's device time {res['device_ms']} ms, by kernel "
        f"{res['us_by_kernel']} us")
    return res


def cpu_share(label, out, lst, val, draw, x=None):
    """The share of ``out`` (from the card) bit-equal to the plain version
    run on the CPU."""
    from gnntf_tpu_torch.ops import (ell_degree_masked_plain,
                                     ell_gather_masked_plain)
    lst = list_to(lst, "cpu")
    if x is None:
        ref = ell_degree_masked_plain(lst, val.cpu(), *draw)
    else:
        ref = ell_gather_masked_plain(lst, val.cpu(), *draw, x.cpu())
    share = (out.cpu() == ref).double().mean().item()
    log(f"{label} on the card against the plain version on the CPU: "
        f"bit-equal share {share}")
    return share


def phase_masked_kernels(graph, dev, x40, x64, x128):
    """2c: K1's masked and degree walks against their plain versions, small
    and on the bench graph's training-grid lists; returns the results."""
    from gnntf_tpu_torch.ops import (build_train_grids, ell_degree_masked,
                                     ell_gather_masked)

    rng = np.random.RandomState(6)
    n = 3000
    # even rows and columns that are multiples of 3 (the others stay
    # empty), a hub row and a hub column, then 300 self-loops past n_drop
    row = np.concatenate([rng.randint(0, n // 2, 60_000) * 2,
                          np.zeros(20_000, np.int64),
                          rng.randint(0, n // 2, 20_000) * 2])
    col = np.concatenate([rng.randint(0, n // 3, 80_000) * 3,
                          np.full(20_000, 33)])
    n_drop = len(row)
    row = np.concatenate([row, np.arange(300)])
    col = np.concatenate([col, np.arange(300)])
    val = torch.from_numpy(rng.rand(len(row)).astype(np.float32) + 0.5).to(
        dev)
    rows, cols = build_train_grids(row, col, val.cpu().numpy(), n).lists(dev)
    salt = torch.tensor([0x9E3779B9, 77], device=dev)
    small = {}
    for f in (6, 40):
        x = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev)
        for name, lst in (("row", rows), ("column", cols)):
            small[name] = check_masked_kernel(
                f"masked small {name} list F={f}", lst, val,
                (salt, 0.3, n_drop), x)
    for keep in (0.3, 1.0):
        small["degree"] = check_masked_kernel(
            f"degree small column list keep={keep}", cols, val,
            (salt, keep, n_drop))
    small["degree_bf16"] = check_masked_kernel(
        "degree small row list bf16 values", rows, val.to(torch.bfloat16),
        (salt, 0.3, n_drop))

    t0 = time.perf_counter()
    grids = build_train_grids(graph.row.cpu().numpy(),
                              graph.col.cpu().numpy(),
                              graph.val.cpu().numpy(), N_NODES)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    rows, cols = grids.lists(dev)
    torch.cuda.synchronize()
    stats = dict(grids_s=build_s, lists_s=time.perf_counter() - t0)
    for name, lst in (("row", rows), ("column", cols)):
        split = lst.split.cpu().numpy()
        stats[name] = dict(edges=lst.n_edges, units=lst.n_units,
                           split_rows=len(split),
                           pieces=int(split[:, 2].sum()),
                           most_pieces=int(split[:, 2].max(initial=0)),
                           eid="identity" if lst.eid is None else "read")
    log(f"bench training grids: {stats}")
    val = graph.val.to(torch.float32).contiguous()
    salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(9)).to(dev)
    draw = (salt, KEEP, graph.n_edges)
    res = {}
    for f, x in ((N_FEATURES, x128), (64, x64), (40, x40)):
        res["forward", f] = check_masked_kernel(
            f"masked bench row list F={f}", rows, val, draw, x, library=True)
        res["backward", f] = check_masked_kernel(
            f"masked bench column list F={f}", cols, val, draw, x,
            library=True)
    res["degree"] = check_masked_kernel("degree bench column list", cols, val,
                                        draw, library=True)
    res["degree_row"] = check_masked_kernel("degree bench row list", rows,
                                            val, draw, library=True)
    vb = val.to(torch.bfloat16)
    res["degree_bf16"] = check_masked_kernel(
        "degree bench column list bf16 values", cols, vb, draw, library=True)
    res["degree_row_bf16"] = check_masked_kernel(
        "degree bench row list bf16 values", rows, vb, draw, library=True)
    # the kernels round as the plain versions do on the CPU, in their order
    shares = dict(
        forward_f40=cpu_share("masked bench row list F=40",
                              ell_gather_masked(rows, val, *draw, x40),
                              rows, val, draw, x40),
        backward_f40=cpu_share("masked bench column list F=40",
                               ell_gather_masked(cols, val, *draw, x40),
                               cols, val, draw, x40),
        degree=cpu_share("degree bench column list",
                         ell_degree_masked(cols, val, *draw), cols, val,
                         draw))
    if any(share != 1.0 for share in shares.values()):
        raise AssertionError(f"bench outputs at F=40 not bit-equal to the "
                             f"plain versions on the CPU: {shares}")
    stats["bit_equal_to_cpu_plain"] = shares
    stats["nonfinite_nan_elements"] = check_nonfinite(rows, cols, val, draw,
                                                      x40)
    stats["device_salts"] = check_device_salts(rows, cols, val, x40, x128,
                                               dev)
    return dict(small=small, forward=res["forward", 40],
                forward_bench=res["forward", N_FEATURES],
                backward=res["backward", 40],
                backward_bench=res["backward", N_FEATURES],
                forward_gcn=res["forward", 64],
                backward_gcn=res["backward", 64],
                degree=res["degree"], degree_row=res["degree_row"],
                degree_bf16=res["degree_bf16"],
                degree_row_bf16=res["degree_row_bf16"], lists=stats)


def check_nonfinite(rows, cols, val, draw, x):
    """2c: an inf and a NaN in x rows that only dropped edges read (the
    masked walk then gathers every edge's row, as JAX's product does):
    NaNs where the plain version run on the CPU has them, every other
    element bit-equal to it; returns the NaN counts."""
    from gnntf_tpu_torch.ops import ell_gather_masked, ell_gather_masked_plain
    from gnntf_tpu_torch.ops import stochastic
    counts = {}
    for name, lst in (("row", rows), ("column", cols)):
        kept = stochastic.keep_mask(list_eids(lst), *draw)
        src = lst.idx.long()
        only = np.setdiff1d(src[~kept].cpu().numpy(),
                            src[kept].cpu().numpy())
        bad = x.clone()
        bad[int(only[0]), 0] = float("inf")
        bad[int(only[-1]), x.shape[1] - 1] = float("nan")
        got = ell_gather_masked(lst, val, *draw, bad).cpu()
        ref = ell_gather_masked_plain(list_to(lst, "cpu"), val.cpu(),
                                      draw[0].cpu(), *draw[1:], bad.cpu())
        nan = torch.isnan(ref)
        log(f"masked bench {name} list F={x.shape[1]} with an inf and a NaN "
            f"in {len(only)} sources only dropped edges read: "
            f"{int(nan.sum())} NaN elements in the plain version, "
            f"{int(torch.isnan(got).sum())} in the kernel's output")
        if not (nan.any() and torch.equal(torch.isnan(got), nan)
                and torch.equal(got[~nan], ref[~nan])):
            raise AssertionError(f"masked {name} list: the kernel's output "
                                 "with non-finite x differs from the plain "
                                 "version")
        counts[name] = int(nan.sum())
    return counts


def check_device_salts(rows, cols, val, x40, x128, dev):
    """2c: the masked walks (both lists, F=40 and F=128) and the degree walk
    with the salt pair in one device buffer: launched with draw A, the
    buffer rewritten to draw B, launched again with the same arguments;
    then the F=40 launches captured in a CUDA graph and replayed after the
    buffer is rewritten to draw C.  Every output must be bit-equal to the
    CPU plain version of its draw; returns the shares (all 1.0)."""
    from gnntf_tpu_torch.ops import ell_degree_masked, ell_gather_masked

    n_drop = val.shape[0]
    draws = [torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(s))
             for s in (21, 22, 23)]
    buf = draws[0].to(dev, copy=True)
    launches = [(f"masked {name} list F={x.shape[1]}",
                 lambda lst=lst, x=x: ell_gather_masked(lst, val, buf, KEEP,
                                                        n_drop, x), lst, x)
                for x in (x40, x128) for name, lst in (("row", rows),
                                                       ("column", cols))]
    launches.append(("degree column list",
                     lambda: ell_degree_masked(cols, val, buf, KEEP, n_drop),
                     cols, None))
    shares = {}

    def hold(label, out, lst, x, draw):
        share = cpu_share(f"{label}, salts in device memory (draw {draw})",
                          out, lst, val, (draws[draw], KEEP, n_drop), x)
        shares[f"{label} draw {draw}"] = share
        if share != 1.0:
            raise AssertionError(f"{label} with draw {draw} from the device "
                                 f"buffer: bit-equal share {share}")

    for label, launch, lst, x in launches:
        buf.copy_(draws[0])
        first = launch()
        buf.copy_(draws[1])
        second = launch()
        hold(label, first, lst, x, 0)
        hold(label, second, lst, x, 1)
    if dev.type != "cuda":  # a rehearsal on the CPU: no graphs there
        return shares
    graphed = [launch for launch in launches
               if launch[3] is None or launch[3] is x40]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        outs = [launch() for _, launch, _, _ in graphed]
    buf.copy_(draws[2])
    graph.replay()
    for (label, _, lst, x), out in zip(graphed, outs):
        hold(f"{label} (graph replay)", out, lst, x, 2)
    return shares


def counters_zero(label, *lists):
    """Raise unless every set of the lists' split-row counters reads zero
    (each launch of a walk leaves its set zero)."""
    for lst in lists:
        if lst.counters is not None and not lst.counters.zero():
            raise AssertionError(f"{label}: a set of split-row counters is "
                                 "not zero")


STREAM_REPS = 8


def phase_streams(graph, dev, x40):
    """2g: launches over one list that run at the same time.  Over one
    ``PreparedSpMM`` (the scaled walk) and over one training grid's lists
    (the masked walk over both, the degree walk over the column list):
    STREAM_REPS calls on each of two streams, enqueued in turn, then
    STREAM_REPS replays of a captured call on one stream, each beside an
    eager call on another.  Every output must be bit-equal to the plain
    version on the CPU.  The scaled walk's list must hold a set of
    split-row counters for each stream and, once captured, one for the
    capture, apart from them; the next eager call lets go of the capture's,
    and every set reads zero after; returns each case's results."""
    from gnntf_tpu_torch.ops import (PreparedSpMM, build_train_grids,
                                     ell_degree_masked,
                                     ell_degree_masked_plain,
                                     ell_gather_masked,
                                     ell_gather_masked_plain,
                                     normalize_adjacency)
    from gnntf_tpu_torch.ops.ell_gather import ell_gather_scaled_plain

    cpu = torch.device("cpu")
    host = lambda t: None if t is None else t.cpu()
    op = PreparedSpMM(normalize_adjacency(graph, graph_dropout=0.0))
    rs, cs = op._scales
    w = float(op.eye_weight)
    rows, cols = build_train_grids(graph.row.cpu().numpy(),
                                   graph.col.cpu().numpy(),
                                   graph.val.cpu().numpy(),
                                   N_NODES).lists(dev)
    val = graph.val.to(torch.float32).contiguous()
    salt = torch.tensor([0x2545F491, 31337], dtype=torch.int64, device=dev)
    draw = (salt, KEEP, graph.n_edges)
    host_draw = (salt.cpu(), KEEP, graph.n_edges)
    k1_cpu, rows_cpu, cols_cpu = (list_to(lst, cpu)
                                  for lst in (op.k1_list, rows, cols))
    cases = {
        "scaled walk, one PreparedSpMM": (
            op.k1_list, op, lambda x: ell_gather_scaled_plain(
                k1_cpu, op.k1_val.cpu(), x.cpu(), host(rs), host(cs), w)),
        "masked walk, row list": (
            rows, lambda x: ell_gather_masked(rows, val, *draw, x),
            lambda x: ell_gather_masked_plain(rows_cpu, val.cpu(),
                                              *host_draw, x.cpu())),
        "masked walk, column list": (
            cols, lambda x: ell_gather_masked(cols, val, *draw, x),
            lambda x: ell_gather_masked_plain(cols_cpu, val.cpu(),
                                              *host_draw, x.cpu())),
        "degree walk, column list": (
            cols, lambda x: ell_degree_masked(cols, val, *draw),
            lambda x: ell_degree_masked_plain(cols_cpu, val.cpu(),
                                              *host_draw))}
    xb = torch.from_numpy(np.random.RandomState(41).randn(
        N_NODES, N_CLASSES).astype(np.float32)).to(dev)
    out = {}
    for label, (lst, call, plain) in cases.items():
        refs = {"a": plain(x40), "b": plain(xb)}
        xs = {"a": x40, "b": xb}
        side = [torch.cuda.Stream(dev), torch.cuda.Stream(dev)]
        for s in side:
            s.wait_stream(torch.cuda.current_stream(dev))
        got = []
        for _ in range(STREAM_REPS):
            for s, key in zip(side, "ab"):
                with torch.cuda.stream(s):
                    got.append((key, call(xs[key])))
        torch.cuda.synchronize()
        two_streams = all(torch.equal(o.cpu(), refs[key]) for key, o in got)
        cap = torch.cuda.Stream(dev)
        cap.wait_stream(torch.cuda.current_stream(dev))
        graph_exec = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph_exec, stream=cap):
            static = call(x40)
        store = lst.counters if label.startswith("scaled") else None
        if store is not None:
            eager = {id(t) for t in store.sets.values()}
            own = (len(store.captured) == 1 and len(store.sets) >= 2
                   and not eager & {id(t) for t in store.captured.values()})
        got = []
        for _ in range(STREAM_REPS):
            with torch.cuda.stream(side[0]):
                graph_exec.replay()
            with torch.cuda.stream(side[1]):
                got.append(call(xb))
        torch.cuda.synchronize()
        beside_replay = (torch.equal(static.cpu(), refs["a"]) and all(
            torch.equal(o.cpu(), refs["b"]) for o in got))
        out[label] = dict(two_streams_bit_equal=two_streams,
                          beside_replay_bit_equal=beside_replay,
                          split_rows=lst.split.shape[0])
        if store is not None:
            counters_zero(label, lst)
            out[label].update(eager_counter_sets=len(store.sets),
                              capture_set_of_its_own=own,
                              capture_set_let_go=not store.captured)
        log(f"2g {label}: {STREAM_REPS} calls on each of two streams "
            f"bit-equal to the CPU plain version: {two_streams}; "
            f"{STREAM_REPS} replays each beside an eager call on another "
            f"stream: {beside_replay}; {out[label]}")
        if not (two_streams and beside_replay) or (
                store is not None and not (own and not store.captured)):
            raise AssertionError(f"2g {label}: {out[label]}")
        del graph_exec, static, got
    return out


def hand_stack(graph, features, device, iterations=10):
    """APPNP's stack without its feature-dropout layers: Dense(64, relu),
    H0 = Dense(40, no regularization), ``iterations`` x
    PPRIteration(H0, 0.1, graph_dropout=0.5)."""
    import gnntf_tpu_torch as tt
    model = tt.GNN(graph, features, device=device)
    model.add(tt.Dense(64, activation=torch.relu))
    h0 = model.add(tt.Dense(N_CLASSES, regularize=False))
    for _ in range(iterations):
        model.add(tt.PPRIteration(h0, 0.1, graph_dropout=0.5))
    return model


def profile_step(step, top=10):
    """Device time by kernel over one training step (torch.profiler): the
    share of it in ``index_add_`` kernels, in K2 (forward and backward
    launches), in K1's masked walk and in its degree walk, the walks of
    each, and the wrappers' launch counts over the step (``counted``)."""
    rows, busy_us, wall_us, counted = device_profile(step)

    def family(*tags):
        hit = [r for r in rows if any(t in r[0] for t in tags)]
        return sum(r[1] for r in hit), sum(r[2] for r in hit)

    index_add_us, index_add_launches = family("indexFunc", "index_add")
    walks = {name: family(name)[1] for name in (
        "blocked_spmm_walk", "blocked_spmm_walk_narrow",
        "ell_gather_masked_walk", DEGREE_WALK, "ell_gather_walk",
        "ell_gather_scaled_walk", "ell_gather_scaled_bwd_walk")}
    shares = {name: family(tag)[0] / busy_us for name, tag in (
        ("k2", "blocked_spmm"), ("masked", "ell_gather_masked"),
        ("degree", "ell_degree"))}
    log(f"profile of one training step: wall {wall_us} us, device busy "
        f"{busy_us} us, idle share {1 - busy_us / wall_us}; index_add_ "
        f"kernels {index_add_us} us in {index_add_launches} launches; "
        f"shares of busy {shares}; walks {walks}; the wrappers' counts "
        f"{counted}")
    for key, us, count in rows[:top]:
        log(f"  {us} us in {count} launches: {key[:90]}")
    log_kernels("K2", rows, "blocked_spmm")
    log_kernels("K1 masked", rows, "ell_gather_masked")
    log_kernels("K1 degree", rows, "ell_degree")
    return dict(busy_us=busy_us, wall_us=wall_us,
                launches=sum(r[2] for r in rows),
                degree_kernels=family("ell_degree")[1],
                degree_us=family("ell_degree")[0],
                index_add_share=index_add_us / busy_us,
                index_add_launches=index_add_launches, shares=shares,
                k2_walks=walks["blocked_spmm_walk"],
                narrow_walks=walks["blocked_spmm_walk_narrow"],
                masked_walks=walks["ell_gather_masked_walk"],
                degree_walks=walks[DEGREE_WALK],
                k1_walks=walks["ell_gather_walk"],
                k1s_walks=walks["ell_gather_scaled_walk"],
                k1s_backward_walks=walks["ell_gather_scaled_bwd_walk"],
                counted=counted)


def phase_blocked_kernel(graph, dev, x40, x128):
    """2b: K2 against its plain version over both lists, small and at bench
    size; returns the RCM-reordered graph, its permutation and the
    results."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import (BlockedSpMM, block_coo, blocked_spmm,
                                     blocked_spmm_plain, normalize_adjacency)

    rng = np.random.RandomState(5)
    n = 5000
    row = rng.randint(0, n // 2, size=60_000)
    row[row >= n // 4] += n // 2  # rows [n/2, 3n/4) stay empty
    # a hub row and a hub column, each split over ~150 units of work
    row = np.concatenate([row, np.full(20_000, 17), rng.randint(0, n, 20_000)])
    col = np.concatenate([rng.randint(0, n, size=80_000),
                          np.full(20_000, 33)])
    small = BlockedSpMM(block_coo(row, col, n), dev)
    small_vals = torch.from_numpy(
        rng.randn(row.shape[0]).astype(np.float32)).to(dev)
    for f in (6, 40):  # the line reports F=40, the width of the path
        x = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev)
        small_res = check_blocked_kernel(f"small F={f}", small.forward,
                                         small_vals, x)
        small_t = check_blocked_kernel(f"small transposed F={f}",
                                       small.transposed, small_vals, x)

    t0 = time.perf_counter()
    perm = tt.rcm_order(graph)
    rcm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g_rcm, inv = tt.permute_graph(graph, perm)
    permute_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    lay = block_coo(g_rcm.row.cpu().numpy(), g_rcm.col.cpu().numpy(), N_NODES)
    block_s = time.perf_counter() - t0
    log(f"RCM: bandwidth {tt.bandwidth(graph)} -> {tt.bandwidth(g_rcm)}")
    t0 = time.perf_counter()
    prep = BlockedSpMM(lay, dev)
    torch.cuda.synchronize()
    stats = layout_stats(lay, dict(rcm_s=rcm_s, permute_s=permute_s,
                                   block_coo_s=block_s,
                                   edge_lists_s=time.perf_counter() - t0))
    for name, lst in (("forward", prep.forward),
                      ("transposed", prep.transposed)):
        split = lst.split.cpu().numpy()
        stats[name] = dict(units=lst.n_units, split_rows=len(split),
                           pieces=int(split[:, 2].sum()),
                           most_pieces=int(split[:, 2].max(initial=0)),
                           eid="identity" if lst.eid is None else "read")
    log(f"RCM bench lists: forward {stats['forward']}, transposed "
        f"{stats['transposed']}")
    norm = normalize_adjacency(g_rcm, graph_dropout=0.0).materialized()
    val = norm.val.to(torch.float32).contiguous()
    perm_t = torch.from_numpy(perm).to(dev)
    # the kernel rounds as the plain version does on the CPU, in its order
    cpu = BlockedSpMM(lay, "cpu")
    x_cpu = x40[perm_t].cpu()
    for name, lst, ref in (("forward", prep.forward, cpu.forward),
                           ("transposed", prep.transposed, cpu.transposed)):
        out = blocked_spmm(lst, val, x40[perm_t].contiguous()).cpu()
        same = (out == blocked_spmm_plain(ref, val.cpu(), x_cpu))
        share = same.double().mean().item()
        stats[name]["bit_equal_to_cpu_plain_f40"] = share
        log(f"K2 RCM bench {name} F=40 on the card against the plain version "
            f"on the CPU: bit-equal share {share}")
    res = {}
    for f, x in ((128, x128), (40, x40)):
        x = x[perm_t].contiguous()
        for name, lst in (("A", prep.forward), ("AT", prep.transposed)):
            res[name, f] = check_blocked_kernel(
                f"RCM bench {'transposed ' if name == 'AT' else ''}F={f}",
                lst, val, x, library=True)
    return g_rcm, perm, inv, dict(
        small=small_res, small_transposed=small_t, bench=res["A", 128],
        train=res["A", 40], bench_t=res["AT", 128], train_t=res["AT", 40],
        layout=stats)


def phase_train(g_rcm, perm, inv, features, dev):
    """4a: APPNP.train(spmm_impl="pallas") at full width through K2."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import (blocked_spmm, ell_degree_masked,
                                     ell_gather)
    from gnntf_tpu_torch.train.trainer import _total_loss

    order = np.random.RandomState(7).permutation(N_NODES)
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    train_old = order[:TRAIN_NODES]
    valid_old = order[TRAIN_NODES:TRAIN_NODES + VALID_NODES]
    train = tt.NodeClassification(inv[train_old], labels[train_old])
    valid = tt.NodeClassification(inv[valid_old], labels[valid_old])
    model = tt.APPNP(g_rcm, features[perm], num_classes=N_CLASSES, device=dev)
    marks = []

    def mark(epoch, **_):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), blocked_spmm.launches))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    blocked_spmm.launches = 0
    ell_gather.launches = 0
    ell_degree_masked.launches = 0
    t0 = time.perf_counter()
    hist = model.train(train, valid, spmm_impl="pallas", epochs=TRAIN_EPOCHS,
                       patience=100, seed=0, callbacks=[mark])
    launches, k1_launches = blocked_spmm.launches, ell_gather.launches
    degree_launches = ell_degree_masked.launches
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    epoch_ms, per_epoch, prev = [], [], (t0, 0)
    for t, n in marks:
        epoch_ms.append((t - prev[0]) * 1e3)
        per_epoch.append(n - prev[1])
        prev = (t, n)
    log(f"training (pallas): epoch ms {epoch_ms}, K2 launches per epoch "
        f"{per_epoch}, K1 launches {k1_launches}, degree walks "
        f"{degree_launches}, peak memory {peak_mb} MiB, train loss "
        f"{hist['train_loss']}, valid loss {hist['valid_loss']}")
    if degree_launches != 10 * TRAIN_EPOCHS:
        raise AssertionError(f"{degree_launches} degree walks under pallas, "
                             f"expected 10 an epoch (the step's degrees)")
    if per_epoch != [30] * TRAIN_EPOCHS or launches != 30 * TRAIN_EPOCHS:
        raise AssertionError(f"K2 launches per epoch {per_epoch}, expected "
                             "30 (10 in the step's forward, 10 in its "
                             "backward, 10 in the validation)")
    if k1_launches:
        raise AssertionError(f"{k1_launches} K1 launches under pallas")
    losses = np.array(hist["train_loss"] + hist["valid_loss"])
    if len(losses) != 2 * TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses {hist}")

    params = [p for p in model.params.values() if p.requires_grad]

    def step():
        with tt.spmm_impl("pallas"):
            loss = _total_loss(model, train, train.batch(), 5e-4,
                               torch.Generator().manual_seed(1))
            torch.autograd.grad(loss, params)

    def eval_forward():
        with torch.no_grad(), tt.spmm_impl("pallas"):
            model.forward(model.features)

    timings = {}
    for name, fn in (("step", step), ("eval_forward", eval_forward)):
        fn()
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        timings[name + "_ms"] = times
    profile = profile_step(step)
    # the backward's A^T dy runs K2 and the 10 layers' degrees run K1's
    # degree walk: no index_add_ is left in the step
    if (profile["index_add_launches"], profile["k2_walks"],
            profile["degree_walks"]) != (0, 20, 10):
        raise AssertionError(f"step profile: {profile['index_add_launches']}"
                             f" index_add_ launches (expected 0), "
                             f"{profile['k2_walks']} K2 walks (expected 20), "
                             f"{profile['degree_walks']} degree walks "
                             "(expected 10)")
    log(f"training step (forward + backward) ms {timings['step_ms']}, "
        f"validation forward ms {timings['eval_forward_ms']}")

    with tt.spmm_impl("pallas"):
        preds = model.predict(valid).cpu()
        accuracy = float(model.evaluate(valid))
    if preds.shape != (VALID_NODES,) or int(preds.max()) >= N_CLASSES:
        raise AssertionError(f"bad predictions {tuple(preds.shape)}")
    log(f"predict on the valid set: {VALID_NODES} labels, accuracy "
        f"{accuracy} (random labels: ~{1 / N_CLASSES})")
    return dict(launches=launches, degree_launches=degree_launches,
                epoch_ms=epoch_ms, peak_mb=peak_mb, profile=profile,
                **timings)


def recording_adam(learning_rate):
    """keras_adam that keeps every step's gradients and second moments on
    the host (``.steps``: one ``{name: (g, v)}`` per update)."""
    from gnntf_tpu_torch.train.trainer import KerasAdam

    class RecordingAdam(KerasAdam):
        def __init__(self):
            super().__init__(learning_rate)
            self.steps = []

        def update(self, grads, state):
            updates, state = super().update(grads, state)
            self.steps.append({k: (g.detach().cpu(), state["v"][k].cpu())
                               for k, g in grads.items()})
            return updates, state

    return RecordingAdam()


def log_adam_state(name, far, steps_gpu, steps_cpu, eps, top=8):
    """Per step, the gradients on both devices and the card's sqrt(v) at the
    elements outside PARAM_TOL, against eps."""
    where = torch.nonzero(far).tolist()[:top]
    for t, (sg, sc) in enumerate(zip(steps_gpu, steps_cpu), start=1):
        g_gpu, v_gpu = sg[name]
        g_cpu = sc[name][0]
        dg = (g_gpu - g_cpu).abs()
        log(f"    step {t}: all of {name}: median |g| "
            f"{g_cpu.abs().median().item()}, max |g gpu - g cpu| "
            f"{dg.max().item()}")
        for i in where:
            i = tuple(i)
            log(f"    step {t} {name}{list(i)}: g gpu {g_gpu[i].item()}, "
                f"g cpu {g_cpu[i].item()}, sqrt(v) gpu "
                f"{v_gpu[i].sqrt().item()} (eps {eps})")


# the attention kernels A1-A4 and the fused forward (A1 and A2 as one walk;
# ops/attention.py), by their wrappers' names, and the profile names of
# their walks (csrc/attention.cu, csrc/softmax_walk.cuh); A1 and A2 run
# the forward of a slice of the edges (gspmd ranks), the fused walk the
# whole graph's
ATTN_FUSED = "attn_softmax_aggregate"
ATTN_KERNELS = ("attn_stats", "attn_aggregate", ATTN_FUSED, "attn_bwd_rows",
                "attn_bwd_cols")
ATTN_WALKS = tuple(name + "_walk" for name in ATTN_KERNELS)
def launch_counts():
    """The kernel wrappers' launch counts: K2, K1, K1's scaled walk, its
    masked walk, its degree walk, the scaled walk's backward over the
    transposed list ("backward") and hybrid's backward walk over it
    ("k1t"), the attention kernels A1-A4, K2's bfloat16 mode (the generic
    walk, "k2_bf16", the staged walk, "k2_bf16s", and the share walk,
    "k2_bf16sh") and the masked and degree walks over bfloat16 values."""
    from gnntf_tpu_torch.ops import (attention, blocked_spmm,
                                     blocked_spmm_bf16, ell_degree_masked,
                                     ell_gather, ell_gather_masked,
                                     ell_gather_scaled)
    from gnntf_tpu_torch.ops.ell_gather import (ell_gather_scaled_backward,
                                                ell_gather_transposed)
    return dict(k2=blocked_spmm.launches, k1=ell_gather.launches,
                k1s=ell_gather_scaled.launches,
                masked=ell_gather_masked.launches,
                degree=ell_degree_masked.launches,
                backward=ell_gather_scaled_backward.launches,
                k1t=ell_gather_transposed.launches,
                **{name: getattr(attention, name).launches
                   for name in ATTN_KERNELS},
                k2_bf16=(blocked_spmm_bf16.launches
                         - blocked_spmm_bf16.staged_launches
                         - blocked_spmm_bf16.share_launches),
                k2_bf16s=blocked_spmm_bf16.staged_launches,
                k2_bf16sh=blocked_spmm_bf16.share_launches,
                masked_bf16=ell_gather_masked.bf16_launches,
                degree_bf16=ell_degree_masked.bf16_launches)


def zero_counts():
    from gnntf_tpu_torch.ops import (attention, blocked_spmm,
                                     blocked_spmm_bf16, ell_degree_masked,
                                     ell_gather, ell_gather_masked,
                                     ell_gather_scaled)
    from gnntf_tpu_torch.ops.ell_gather import (ell_gather_scaled_backward,
                                                ell_gather_transposed)
    for fn in (blocked_spmm, blocked_spmm_bf16, ell_gather,
               ell_gather_scaled, ell_gather_masked, ell_degree_masked,
               ell_gather_scaled_backward, ell_gather_transposed,
               *(getattr(attention, name) for name in ATTN_KERNELS)):
        fn.launches = 0
    ell_gather.backward_launches = 0
    ell_gather_masked.bf16_launches = ell_degree_masked.bf16_launches = 0
    blocked_spmm_bf16.staged_launches = 0
    blocked_spmm_bf16.share_launches = 0


def per_epoch(marks):
    """Per-epoch differences of the launch counts read at each epoch's
    end (counts zeroed before the run)."""
    prev = dict.fromkeys(marks[0], 0) if marks else {}
    out = []
    for m in marks:
        out.append({k: m[k] - prev[k] for k in m})
        prev = m
    return out


# launches an epoch on the card: K2 in the step's forward and backward and
# in the validation forward under pallas, with K1's degree walk for the
# step's degrees; under the default impl K1's masked walk in the step's
# forward and backward, its degree walk, and the prepared operator (K1's
# scaled walk, "k1s") in the validation forward.  K1 adding into a base
# ("k1") runs only under hybrid and in the per-call ell route.
NO_LAUNCHES = dict(k2=0, k1=0, k1s=0, masked=0, degree=0, backward=0,
                   k1t=0, **dict.fromkeys(ATTN_KERNELS, 0), k2_bf16=0,
                   k2_bf16s=0, k2_bf16sh=0, masked_bf16=0, degree_bf16=0)
EPOCH_LAUNCHES = {"pallas": dict(NO_LAUNCHES, k2=30, degree=10),
                  None: dict(NO_LAUNCHES, k1s=10, masked=20, degree=10)}
# GCNII-64 an epoch: the prepared operator in each convolution of the step
# and of the validation forward, the backward walk in each of the step;
# GCN: the masked walk forward and backward and the degree walk in its
# hidden layer, the prepared operator and the backward walk in its output
# layer, the prepared operator in both layers of the validation forward
GCNII_LAUNCHES = dict(NO_LAUNCHES, k1s=128, backward=64)
GCN_LAUNCHES = dict(NO_LAUNCHES, k1s=3, masked=2, degree=1, backward=1)
# GAT an epoch: the fused forward (A1 and A2 as one walk) in both layers of
# the step and of the validation forward, A3 and A4 in both layers of the
# step's backward; GraphSAGE: the
# prepared operator in both layers of the step and of the validation
# forward, the backward walk in both layers of the step; GIN: the prepared
# operator in its one convolution of the step and of the validation forward
# (its input needs no gradient, so no backward walk)
GAT_LAUNCHES = dict(NO_LAUNCHES, attn_softmax_aggregate=4, attn_bwd_rows=2,
                    attn_bwd_cols=2)
SAGE_LAUNCHES = dict(NO_LAUNCHES, k1s=4, backward=2)
GIN_LAUNCHES = dict(NO_LAUNCHES, k1s=2)


def compare_params(label, params, adam, dev):
    """GPU against CPU parameters after training (``params`` and ``adam``
    keyed by device name): raises unless they agree within PARAM_TOL but
    for at most PARAM_OUTLIERS of the elements, none off by more than
    MAX_PARAM_DIFF; logs Adam's state where they do not.  Returns the
    largest difference, the elements outside and the elements."""
    worst, outside, total = 0.0, 0, 0
    for k, p in params["cpu"].items():
        q = params[str(dev)][k]
        diff = (q - p).abs()
        worst = max(worst, diff.max().item())
        far = ~torch.isclose(q, p, **PARAM_TOL)
        outside += int(far.sum())
        total += p.numel()
        log(f"  parameter {k} {tuple(p.shape)}: max |diff| "
            f"{diff.max().item()}, {int(far.sum())} elements outside "
            f"{PARAM_TOL}, largest |value| there "
            f"{p[far].abs().max().item() if far.any() else 0.0}")
        if far.any():
            log_adam_state(k, far, adam[str(dev)].steps,
                           adam["cpu"].steps, adam["cpu"].eps)
    log(f"GPU vs CPU parameters after {label}: max |diff| {worst} (limit "
        f"{MAX_PARAM_DIFF}), {outside} of {total} elements outside "
        f"{PARAM_TOL}")
    if outside > PARAM_OUTLIERS * total or worst > MAX_PARAM_DIFF:
        raise AssertionError(f"parameters differ between devices after "
                             f"{label}")
    return worst, outside, total


def phase_devices(g_rcm, perm, inv, features, dev):
    """4b: the pallas and the default training path, each on the card and
    on the CPU."""
    import gnntf_tpu_torch as tt

    order = np.random.RandomState(7).permutation(N_NODES)
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    train_old = order[:TRAIN_NODES]
    valid_old = order[TRAIN_NODES:TRAIN_NODES + VALID_NODES]
    tasks = (tt.NodeClassification(inv[train_old], labels[train_old]),
             tt.NodeClassification(inv[valid_old], labels[valid_old]))
    feats = features[perm]
    g_cpu = g_rcm.to("cpu")
    out = {}
    for impl in ("pallas", None):
        runs, seconds, params, adam, counts = {}, {}, {}, {}, {}
        for device, graph in ((dev, g_rcm), ("cpu", g_cpu)):
            model = hand_stack(graph, feats, device)
            adam[str(device)] = recording_adam(LEARNING_RATE)
            marks = []
            zero_counts()
            t0 = time.perf_counter()
            runs[str(device)] = model.train(
                *tasks, spmm_impl=impl, epochs=CROSS_EPOCHS, patience=100,
                optimizer=adam[str(device)], seed=0,
                callbacks=[lambda **_: marks.append(launch_counts())])
            seconds[str(device)] = time.perf_counter() - t0
            counts[str(device)] = per_epoch(marks)
            want = EPOCH_LAUNCHES[impl] if device == dev else NO_LAUNCHES
            if counts[str(device)] != [want] * CROSS_EPOCHS:
                raise AssertionError(f"launches an epoch under {impl} on "
                                     f"{device}: {counts[str(device)]}, "
                                     f"expected {want}")
            params[str(device)] = {k: p.detach().cpu()
                                   for k, p in model.params.items()}
        gpu, cpu = runs[str(dev)], runs["cpu"]
        log(f"GPU vs CPU training under {impl or 'the default impl'}, "
            f"{CROSS_EPOCHS} epochs: GPU {gpu} ({seconds[str(dev)]} s, "
            f"launches an epoch {counts[str(dev)][0]}), CPU {cpu} "
            f"({seconds['cpu']} s)")
        for key in ("train_loss", "valid_loss"):
            np.testing.assert_allclose(gpu[key], cpu[key], rtol=LOSS_RTOL)
        worst, outside, total = compare_params(
            f"training under {impl or 'the default impl'} (best epoch "
            f"{gpu['best_epoch']})", params, adam, dev)
        out[impl or "default"] = dict(
            cpu_seconds=seconds["cpu"], gpu_seconds=seconds[str(dev)],
            max_param_diff=worst, outside=outside,
            launches_per_epoch=counts[str(dev)][0])
    return out


def phase_default_train(graph, features, dev):
    """5: APPNP.train() with no spmm_impl at full width on the natural-order
    bench graph: the masked and degree walks in the step, K1 in the
    validation forward, the grids built once."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import (ell_degree_masked, ell_gather_masked,
                                     stochastic)
    from gnntf_tpu_torch.train.trainer import _total_loss

    order = np.random.RandomState(7).permutation(N_NODES)
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    train_old = order[:TRAIN_NODES]
    valid_old = order[TRAIN_NODES:TRAIN_NODES + VALID_NODES]
    train = tt.NodeClassification(train_old, labels[train_old])
    valid = tt.NodeClassification(valid_old, labels[valid_old])
    model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
    marks, times = [], []

    def mark(epoch, **_):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        marks.append(launch_counts())

    stochastic._last_draw = None  # set only where a draw is realized
    builds = stochastic.train_grids.builds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    hist = model.train(train, valid, epochs=TRAIN_EPOCHS, patience=100,
                       seed=0, callbacks=[mark])
    counts = per_epoch(marks)
    builds = stochastic.train_grids.builds - builds
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    epoch_ms = np.diff([t0] + times) * 1e3
    log(f"training (default impl): epoch ms {epoch_ms.tolist()}, launches "
        f"an epoch {counts}, grid builds {builds}, peak memory {peak_mb} "
        f"MiB, train loss {hist['train_loss']}, valid loss "
        f"{hist['valid_loss']}")
    if counts != [EPOCH_LAUNCHES[None]] * TRAIN_EPOCHS:
        raise AssertionError(f"launches an epoch {counts}, expected "
                             f"{EPOCH_LAUNCHES[None]}")
    if builds != 1:
        raise AssertionError(f"{builds} grid builds, expected 1")
    # on the card no draw is realized per edge (the plain versions that
    # stand in for the kernels on the CPU realize each one)
    if dev.type == "cuda" and stochastic._last_draw is not None:
        raise AssertionError("a draw was realized per edge on the default "
                             "training path")
    losses = np.array(hist["train_loss"] + hist["valid_loss"])
    if len(losses) != 2 * TRAIN_EPOCHS or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses {hist}")

    params = [p for p in model.params.values() if p.requires_grad]
    split = {}

    def step(record=False):
        before = (ell_gather_masked.launches, ell_degree_masked.launches)
        loss = _total_loss(model, train, train.batch(), 5e-4,
                           torch.Generator().manual_seed(1))
        mid = (ell_gather_masked.launches, ell_degree_masked.launches)
        torch.autograd.grad(loss, params)
        if record:
            split.update(forward_masked=mid[0] - before[0],
                         forward_degree=mid[1] - before[1],
                         backward_masked=ell_gather_masked.launches - mid[0],
                         backward_degree=ell_degree_masked.launches - mid[1])

    def eval_forward():
        with torch.no_grad():
            model.forward(model.features)

    step(record=True)
    log(f"one step's launches: {split}")
    if split != dict(forward_masked=10, forward_degree=10,
                     backward_masked=10, backward_degree=0):
        raise AssertionError(f"one step's launches {split}: expected the "
                             "masked walk 10 times forward and 10 backward, "
                             "the degree walk 10 times forward")
    timings = {}
    for name, fn in (("step", step), ("eval_forward", eval_forward)):
        fn()
        reps = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t) * 1e3)
        timings[name + "_ms"] = reps
    profile = profile_step(step)
    if (profile["index_add_launches"], profile["k2_walks"],
            profile["masked_walks"], profile["degree_walks"]) != (0, 0, 20,
                                                                  10):
        raise AssertionError(f"step profile {profile}: expected no "
                             "index_add_, no K2, 20 masked and 10 degree "
                             "walks")
    if profile["degree_kernels"] > 2 * profile["degree_walks"]:
        raise AssertionError(f"step profile: {profile['degree_kernels']} "
                             f"degree kernels for {profile['degree_walks']} "
                             "calls, expected at most 2 a call")
    log(f"training step (forward + backward, default impl) ms "
        f"{timings['step_ms']}, validation forward ms "
        f"{timings['eval_forward_ms']}")
    preds = model.predict(valid).cpu()
    accuracy = float(model.evaluate(valid))
    if preds.shape != (VALID_NODES,) or int(preds.max()) >= N_CLASSES:
        raise AssertionError(f"bad predictions {tuple(preds.shape)}")
    log(f"predict on the valid set: {VALID_NODES} labels, accuracy "
        f"{accuracy} (random labels: ~{1 / N_CLASSES})")
    total = {k: sum(c[k] for c in counts) for k in counts[0]}
    return dict(launches=total, epoch_ms=epoch_ms.tolist(), peak_mb=peak_mb,
                grid_builds=builds, step_split=split, profile=profile,
                **timings)


def fused_tasks(inv=None):
    """Phase 5's (and 4a's) labels and split, the node ids mapped through
    ``inv`` on a reordered graph."""
    import gnntf_tpu_torch as tt
    order = np.random.RandomState(7).permutation(N_NODES)
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    ids = order[:TRAIN_NODES], order[TRAIN_NODES:TRAIN_NODES + VALID_NODES]
    return tuple(tt.NodeClassification(
        nodes if inv is None else inv[nodes], labels[nodes]) for nodes in ids)


def fused_run(model, tasks, impl, block_epochs, profile=False,
              primer=PRIMER_KERNELS, epochs=FUSED_EPOCHS, block=FUSED_BLOCK,
              **kw):
    """``model.train(epochs=epochs, block_epochs=..., patience=100,
    seed=0, **kw)`` with the counts zeroed just before and read just
    after: the history, the counts, the host clock at the start and at each
    callback (after a synchronize), and with ``profile`` the profile of the
    second block of ``block`` epochs, from the first block's last callback
    to the second block's first (``primer`` spin kernels at its start,
    ``ProfiledSpan``)."""
    marks, span, profiled = [], ProfiledSpan(primer), {}

    def mark(epoch, **_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        if profile and epoch == block - 1:
            span.start()
        if profile and epoch == block:
            profiled["rows"], profiled["busy_us"], profiled["wall_us"] = \
                span.stop()
            profiled["primed"] = span.primed

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    hist = model.train(*tasks, epochs=epochs, patience=100, seed=0,
                       spmm_impl=impl, block_epochs=block_epochs,
                       callbacks=[mark], **kw)
    return hist, launch_counts(), t0, marks, profiled


def replay_profile(label, take, want, replays=FUSED_BLOCK):
    """The kernels of a profiled block (``replays`` replays; ``take(primer)``
    runs ``fused_run(..., profile=True, primer=primer)`` and gives its
    profile) an epoch; raises unless each of ``want`` (a name tag: walks
    an epoch) holds.  A block whose profile kept none of its primer
    kernels, or fewer walks than ``want`` asks, is taken again with four
    times as many (``device_profile``)."""
    primer, profiled = PRIMER_KERNELS, None
    for _ in range(PROFILE_TRIES):
        taken = take(primer)
        if not taken["primed"]:
            primer = lost_primer(primer)
            continue
        profiled = taken
        kept = walk_launches(taken["rows"])
        wanted = replays * sum(n for tag, n in want.items()
                               if tag != "index_add")
        if kept >= wanted:
            break
        primer = lost_walks(primer, kept, wanted)
    if profiled is None:
        raise RuntimeError(f"{label}: the profiler kept no primer kernel in "
                           f"{PROFILE_TRIES} blocks")
    rows = profiled["rows"]
    count = lambda tag: sum(r[2] for r in rows if tag in r[0])
    walks = {tag: count(tag) / replays for tag in (
        "ell_gather_masked_walk", DEGREE_WALK, "ell_gather_walk",
        "ell_gather_scaled_walk", "ell_gather_scaled_bwd_walk",
        "blocked_spmm_walk", *ATTN_WALKS)}
    index_add = (count("indexFunc") + count("index_add")) / replays
    out = dict(walks_per_epoch=walks, index_add_per_epoch=index_add,
               launches_per_epoch=sum(r[2] for r in rows) / replays,
               busy_ms_per_epoch=profiled["busy_us"] / replays / 1e3,
               profiled_wall_ms_per_epoch=(profiled["wall_us"] / replays
                                           / 1e3))
    log(f"{label} replay profile ({replays} replays): {out}")
    for key, us, n in rows[:12]:
        log(f"  {us} us in {n} launches: {key[:90]}")
    got = dict(walks, index_add=index_add)
    if any(got[tag] != n for tag, n in want.items()):
        raise AssertionError(f"{label}: per replay {got}, expected {want}")
    return out


# walks a replayed epoch: the profile's kernel names
REPLAY_WALKS = {
    None: {"ell_gather_masked_walk": 20, DEGREE_WALK: 10,
           "ell_gather_walk": 0, "ell_gather_scaled_walk": 10,
           "ell_gather_scaled_bwd_walk": 0, "blocked_spmm_walk": 0,
           "index_add": 0},
    "pallas": {"ell_gather_masked_walk": 0, DEGREE_WALK: 10,
               "ell_gather_walk": 0, "ell_gather_scaled_walk": 0,
               "ell_gather_scaled_bwd_walk": 0, "blocked_spmm_walk": 30,
               "index_add": 0}}


def phase_fused(label, graph, features, dev, impl=None, inv=None):
    """6 / 6b: the fused trainer against the host loop at full width, the
    second block timed, and a second fused run's second block profiled."""
    import gnntf_tpu_torch as tt

    tasks = fused_tasks(inv)
    model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused, counts, t0, marks, _ = fused_run(model, tasks, impl, FUSED_BLOCK)
    peak = dict(allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20)
    # the recorded epoch and the capture (a rehearsal on the CPU runs every
    # epoch)
    runs = 2 if dev.type == "cuda" else FUSED_EPOCHS
    want = {k: runs * v for k, v in EPOCH_LAUNCHES[impl].items()}
    if counts != want:
        raise AssertionError(f"{label}: launches counted {counts}, expected "
                             f"{want} (the recorded epoch and the capture)")
    block_ms = [(marks[FUSED_BLOCK - 1] - t0) * 1e3,
                (marks[2 * FUSED_BLOCK - 1] - marks[FUSED_BLOCK - 1]) * 1e3]
    host, host_counts, h0, host_marks, _ = fused_run(model, tasks, impl, 1)
    if host_counts != {k: FUSED_EPOCHS * v
                       for k, v in EPOCH_LAUNCHES[impl].items()}:
        raise AssertionError(f"{label}: host loop launches {host_counts}")
    host_ms = np.diff([h0] + host_marks) * 1e3
    rel = {}
    for key in ("train_loss", "valid_loss"):
        a, b = np.array(fused[key]), np.array(host[key])
        rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=FUSED_RTOL)
    if fused["best_epoch"] != host["best_epoch"]:
        raise AssertionError(f"{label}: best epoch {fused['best_epoch']}, "
                             f"host loop {host['best_epoch']}")
    replay = replay_profile(
        label, lambda primer: fused_run(model, tasks, impl, FUSED_BLOCK,
                                        profile=True, primer=primer)[4],
        REPLAY_WALKS[impl])
    epoch_ms = block_ms[1] / FUSED_BLOCK
    out = dict(fused_epoch_ms=epoch_ms, first_block_ms=block_ms[0],
               busy_ms_per_epoch=replay["busy_ms_per_epoch"],
               wall_over_busy=epoch_ms / replay["busy_ms_per_epoch"],
               host_epoch_ms=host_ms.tolist(),
               max_rel_loss_diff=rel, best_epoch=fused["best_epoch"],
               counted=counts, peak=peak, replay=replay,
               train_loss=fused["train_loss"], valid_loss=fused["valid_loss"])
    log(f"{label}: fused epoch {epoch_ms} ms (second block, wall), device "
        f"busy {replay['busy_ms_per_epoch']} ms an epoch, wall/busy "
        f"{out['wall_over_busy']}, first block (record + capture + "
        f"{FUSED_BLOCK - 1} replays) {block_ms[0]} ms; host loop epoch ms "
        f"{host_ms.tolist()}; max relative loss difference {rel} (limit "
        f"{FUSED_RTOL}), best epoch {fused['best_epoch']}; launches counted "
        f"{counts}; peak memory with the graph pool {peak}")
    return out


def phase_fused_patience(dev):
    """6c: early stopping inside a block on the card: the fused run's
    predictions equal the host loop's."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import stochastic

    n = 20_000
    src, dst = random_power_law_edges(n, 80_000, seed=1)
    graph = tt.from_edges(src, dst, n_nodes=n, directed=False, device=dev)
    features = np.random.RandomState(3).randn(n, 16).astype(np.float32)
    labels = np.random.RandomState(4).randint(0, 6, n)
    tasks = (tt.NodeClassification(np.arange(2000), labels[:2000]),
             tt.NodeClassification(np.arange(2000, 4000), labels[2000:4000]))
    runs = {}
    for block_epochs in (1, FUSED_BLOCK):
        model = tt.APPNP(graph, features, num_classes=6, device=dev)
        with stochastic.min_edges_scope(0):
            hist = model.train(*tasks, epochs=12, patience=2, seed=0,
                               learning_rate=0.2, block_epochs=block_epochs)
        runs[block_epochs] = (hist, model.predict(tt.NodeClassification(
            np.arange(4000, n))).cpu())
    (host, host_pred), (fused, fused_pred) = runs[1], runs[FUSED_BLOCK]
    log(f"patience on the card: host loop ran {len(host['valid_loss'])} "
        f"epochs (best {host['best_epoch']}), fused {fused['epochs_run']} "
        f"(best {fused['best_epoch']}); predictions equal "
        f"{torch.equal(host_pred, fused_pred)}")
    if len(host["valid_loss"]) == 12:
        raise AssertionError("the host loop did not stop early")
    if not torch.equal(host_pred, fused_pred) or (
            host["best_epoch"] != fused["best_epoch"]):
        raise AssertionError("the fused run's predictions or best epoch "
                             "differ from the host loop's after early "
                             "stopping")
    return dict(host_epochs=len(host["valid_loss"]),
                fused_epochs=fused["epochs_run"],
                best_epoch=fused["best_epoch"])


def fused_launches(result, walk, counter):
    """A kernel's launches on the fused path: its walks a replayed epoch
    (the profile) and the launches its wrapper counted over the run (the
    recorded epoch and the capture)."""
    return dict(per_replayed_epoch=result["replay"]["walks_per_epoch"][walk],
                counted=result["counted"][counter])


def k1_module():
    """K1's module (``gnntf_tpu_torch.ops`` exports its function
    ``ell_gather`` under the same name)."""
    return importlib.import_module("gnntf_tpu_torch.ops.ell_gather")


def check_backward_kernel(label, lst, lst_t, val, dy, library=False):
    """K1's backward walk over its transposed list ``lst_t`` (``dx =
    A_rest^T dy``) against its plain version on the card; times kernel,
    plain version and (``library``) ``torch.sparse.mm`` of ``A_rest^T`` in
    CSR and the route it replaced, ``dy[dst] * val`` then ``index_add_``
    over K1's list's slots.  The bound is blocked_bound's reckoning over the
    transposed list (store mode; its ``eid`` is read)."""
    from gnntf_tpu_torch.ops import blocked_spmm_plain

    k1 = k1_module()
    kernel = lambda: k1.ell_gather_transposed(lst_t, val, dy)
    out = kernel()
    torch.cuda.synchronize()
    ref = blocked_spmm_plain(lst_t, val, dy)
    scale = blocked_spmm_plain(lst_t, val.abs(), dy.abs())
    err = check_close(f"K1 backward {label}", out, ref, scale)
    res = dict(max_abs_err=err, ms=time_ms(kernel),
               plain_ms=time_ms(lambda: blocked_spmm_plain(lst_t, val, dy)))
    res["bound_ms"], res["bound_by"], n_bytes = blocked_bound(
        lst_t, dy.shape[1])
    res["library_ms"] = res["index_add_ms"] = None
    if library:
        n, f = lst_t.n_rows, dy.shape[1]
        rows, dst = live_edges(lst_t)
        a_t = torch.sparse_coo_tensor(
            torch.stack([rows, dst]), val[lst_t.eid.long()],
            (n, dy.shape[0])).coalesce().to_sparse_csr()
        call = lambda: torch.sparse.mm(a_t, dy)
        check_close(f"library sparse.mm of A_rest^T {label}", call(), ref,
                    scale)
        res["library_ms"] = time_ms(call)
        k1_dst = list_rows(lst)
        if lst.rows is not None:
            k1_dst = lst.rows.long()[k1_dst]
        k1_src = lst.idx.long()
        old = lambda: dy.new_zeros(n, f).index_add_(
            0, k1_src, dy[k1_dst] * val[:, None])
        check_close(f"index_add_ route {label}", old(), ref, scale)
        res["index_add_ms"] = time_ms(old)
    log(f"K1 backward {label}: kernel {res['ms']} ms, plain "
        f"{res['plain_ms']} ms, library {res['library_ms']} ms, index_add_ "
        f"route {res['index_add_ms']} ms, bound {res['bound_ms']} ms "
        f"({res['bound_by']}, {n_bytes} B), slots {lst_t.n_edges}, units "
        f"{lst_t.n_units}, split columns {lst_t.split.shape[0]}, "
        f"N={lst_t.n_rows} F={dy.shape[1]}")
    return res


def phase_backward_kernel(graph, dev, x16, x40, x64, x128):
    """2d: the prepared operator's backward walks against their plain
    versions.  Under ``auto`` (the default) one launch of K1's scaled walk
    over the transposed whole list, ``dx = cs * (A^T (rs * dy)) + w * dy``:
    over a list with a column split into thousands of pieces, rows without
    slots and an identity, and over the bench graph's transposed whole list
    at F=64, 40, 16 and 128, bound and ``sparse.mm`` of the normalized
    ``A^T`` beside it, bit for bit the plain version on the CPU.  Under
    ``hybrid`` K2's store-mode entry over the transposed list of K1's rest
    list (``dx = A_rest^T dy``): small (duplicates, an empty column, a hub
    column split over many units) and at F=40 over the bench graph's
    transposed whole list.  Returns the results."""
    from gnntf_tpu_torch.ops import (PreparedSpMM, blocked_spmm_plain,
                                     ell_edge_list, normalize_adjacency)
    from gnntf_tpu_torch.ops.spmm import build_ell

    k1 = k1_module()
    rng = np.random.RandomState(12)
    n = 3000
    # even rows; columns below n - 1 (column n - 1 stays empty); then
    # 20,000 slots on column 33 from random rows (duplicate pairs coalesce)
    row = np.concatenate([rng.randint(0, n // 2, 60_000) * 2,
                          rng.randint(0, n // 2, 20_000) * 2])
    col = np.concatenate([rng.randint(0, n - 1, 60_000),
                          np.full(20_000, 33)])
    layout = build_ell(row, col, n, 8)
    small, slot = ell_edge_list(layout.idx, layout.vrow_row, n, dev)
    small_t = k1.ell_transposed_list(small, n)
    small_val = torch.from_numpy(rng.randn(len(slot)).astype(
        np.float32)).to(dev)
    for f in (6, 40):
        dy = torch.from_numpy(rng.randn(n, f).astype(np.float32)).to(dev)
        small_res = check_backward_kernel(f"small F={f}", small, small_t,
                                          small_val, dy)

    # the scaled backward over a transposed list with a hub column in
    # thousands of pieces, rows without slots and an identity
    lst, val, rs, cs = split_whole_list(17, 3000, 1200, dev, hub=0.5)
    lst_t = k1.ell_transposed_list(lst, 3000)
    if int(lst_t.split[:, 2].max()) < 1000:
        raise AssertionError("the small transposed list splits no column "
                             "into thousands of pieces")
    scaled_small = {f: check_scaled_kernel(
        f"small F={f}", lst_t, val, torch.from_numpy(rng.randn(
            3000, f).astype(np.float32)).to(dev), rs, cs, 0.5,
        backward=True) for f in (7, 40)}

    op = PreparedSpMM(normalize_adjacency(graph, graph_dropout=0.0))
    t0 = time.perf_counter()
    lst_t = op._routed.transposed()
    torch.cuda.synchronize()
    split = lst_t.split.cpu().numpy()
    slots = lst_t.ptr.diff().cpu().numpy()
    stats = dict(columns=lst_t.n_rows, slots=lst_t.n_edges,
                 units=lst_t.n_units, split_columns=len(split),
                 pieces=int(split[:, 2].sum()),
                 heaviest_column_slots=int(slots.max(initial=0)),
                 empty_columns=int((slots == 0).sum()),
                 build_s=time.perf_counter() - t0)
    log(f"bench whole list transposed: {stats}")
    scaled = {f: check_scaled_kernel(
        f"bench F={f}", lst_t, op.k1_val, x, *op._scales,
        float(op.eye_weight), library=True, backward=True)
        for f, x in ((64, x64), (40, x40), (16, x16), (N_FEATURES, x128))}
    hybrid = check_backward_kernel("bench F=40", op.k1_list, lst_t,
                                   op.k1_val, x40, library=True)
    # the kernel rounds as the plain version does on the CPU, in its order
    out = k1.ell_gather_transposed(lst_t, op.k1_val, x40).cpu()
    ref = blocked_spmm_plain(list_to(lst_t, "cpu"), op.k1_val.cpu(),
                             x40.cpu())
    hybrid["bit_equal_to_cpu_plain"] = (out == ref).double().mean().item()
    log(f"K1 backward (hybrid's) bench F=40 on the card against the plain "
        f"version on the CPU: bit-equal share "
        f"{hybrid['bit_equal_to_cpu_plain']}")
    return dict(small=small_res, hybrid=hybrid,
                scaled=dict(gcn=scaled[40], gcnii=scaled[64],
                            ngcf=scaled[16], bench=scaled[N_FEATURES],
                            small=scaled_small),
                transposed_list=stats)


# attention dropout of phase 2e's per-edge lists, and the slope of GAT's
# leaky_relu
ATTN_KEEP = 0.4
ATTN_SLOPE = 0.2
# GAT's layers at GATConfig with 40 classes: (heads, features)
GAT_SHAPES = ((8, 8), (1, N_CLASSES))


def attn_calls(lists, h, ss, sd, g, salt, keep, plain=False, given=None):
    """A1-A4 in the autograd Function's order over ``lists``
    (``attn_chain`` with A1 then A2), then the fused forward over the same
    inputs (its outputs as ``fused_rmax0``, ``fused_dinv``, ``fused_out``):
    the outputs by name, and each kernel's call (a closure over its
    inputs).  With ``plain`` the plain versions run, A2, A3 and A4 each on
    the inputs that ``given`` (the kernels' outputs) gave its kernel."""
    from gnntf_tpu_torch.ops import attention as pa
    calls = {}
    outs = pa.attn_chain(lists, h, ss, sd, g, ATTN_SLOPE, salt, keep,
                         fused=False, plain=plain, given=given, calls=calls)
    n, heads, feats = h.shape
    tab = pa.pack_table(h.reshape(n, -1), ss)
    fused = pa.attn_forward(lists, tab, sd, heads, feats, ATTN_SLOPE, salt,
                            keep, fused=True, plain=plain, calls=calls)
    outs.update({"fused_" + k: v for k, v in fused.items()})
    return outs, calls


def attn_outputs(name):
    """Kernel ``name``'s outputs: ``(key in attn_calls' outputs, key of
    attn_error_scales)`` each."""
    from gnntf_tpu_torch.ops import attention as pa
    prefix = "fused_" if name == ATTN_FUSED else ""
    return [(prefix + o, o) for o in pa.ATTN_OUTPUTS[name]]


def attn_bound(name, lists, heads, feats, kept=None):
    """Least time for attention kernel ``name`` over these lists: the list
    (4 B a row pointer, 4 B a slot's index, 4 B its id where the list reads
    one, 4 B a multiplicity), the gathered table rows (the score part of
    every referenced row; the feature part of each (row, head) that a kept
    (slot, head) references, ``kept`` (E, H) bool, all without dropout),
    the per-row tables and the outputs once each.  Operations: ~10 fp32
    operations a (slot, head) for the score and its exponential, the
    dropout hash's where it is drawn, 2 a (slot, feature) for each product
    with a feature row, at the fp32 rate."""
    lst = lists.cols if name == "attn_bwd_cols" else lists.rows
    n, e, w = lst.n_rows, lst.n_edges, heads * feats
    idx = lst.idx.long()
    n_bytes = (n + 1) * 4 + e * 4 + (0 if lst.eid is None else e * 4)
    if lists.mult is not None:
        n_bytes += lists.mult.numel() * 4
    refs = int(torch.unique(idx).numel())
    if kept is None:
        feat_rows = refs * w * 4
    else:
        pairs = idx[:, None] * heads + torch.arange(heads, device=idx.device)
        feat_rows = int(torch.unique(pairs[kept]).numel()) * feats * 4
    hash_ops = 0 if kept is None else HASH_OPS
    nh = n * heads * 4
    if name == "attn_stats":
        n_bytes += refs * heads * 4 + nh + 2 * nh
        ops = e * heads * 10
    elif name in ("attn_aggregate", ATTN_FUSED):
        # A2 reads s_dst, rmax0 and dinv; the fused walk reads s_dst and
        # writes rmax0 and dinv: the same bytes
        n_bytes += refs * heads * 4 + feat_rows + 3 * nh + n * w * 4
        ops = e * heads * (10 + hash_ops) + 2 * e * w
    elif name == "attn_bwd_rows":
        n_bytes += refs * heads * 4 + feat_rows + 3 * nh + n * w * 4 + 2 * nh
        ops = e * heads * (14 + hash_ops) + 2 * e * w
    else:  # the column pass: own rows [h | s_src], gathered [g | 4 heads]
        n_bytes += n * (w + heads) * 4 + refs * 4 * heads * 4 + feat_rows \
            + n * w * 4 + nh
        ops = e * heads * (16 + hash_ops) + 4 * e * w
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def attn_inputs(n, heads, feats, dev, seed):
    rng = np.random.RandomState(seed)
    t = lambda *shape: torch.from_numpy(
        rng.randn(*shape).astype(np.float32)).to(dev)
    return t(n, heads, feats), t(n, heads), t(n, heads), t(n, heads * feats)


def check_attn_kernels(label, lists, h, ss, sd, g, salt, keep, timed=False,
                       cpu=False, profiled=False):
    """A1-A4 over ``lists`` against their plain versions on the card, each
    on its kernel's inputs, per element within ``KERNEL_RTOL * sum|terms|``
    (``attn_error_scales``); a second launch of each bit-equal to the
    first.  With ``timed``: kernel, plain version, bound and (layer 2's A2)
    ``torch.sparse.mm`` of the realized coefficients in CSR, and with
    ``profiled`` one call's device time by kernel (a profile; A3 and A4
    launch at most 3 kernels a call: the walk, the parts, the fix-up); with
    ``cpu``: the share of each output bit-equal to the plain version on the
    CPU."""
    from gnntf_tpu_torch.ops import attention as pa
    n, heads, feats = h.shape
    outs, calls = attn_calls(lists, h, ss, sd, g, salt, keep)
    torch.cuda.synchronize()
    again, _ = attn_calls(lists, h, ss, sd, g, salt, keep)
    ref, plain_calls = attn_calls(lists, h, ss, sd, g, salt, keep,
                                  plain=True, given=outs)
    tab = pa.pack_table(h.reshape(n, -1), ss)
    scales = pa.attn_error_scales(lists, tab, sd, outs["rmax0"],
                                  outs["dinv"], g, outs["rowdot"], heads,
                                  feats, ATTN_SLOPE, salt, keep)
    kept = None
    if salt is not None:
        kept = pa._attn_keep_scale(list_eids(lists.rows), salt, heads,
                                   keep) > 0
    res = {}
    for name in ATTN_KERNELS:
        r = dict(max_abs_err=max(
            check_close(f"{name} {label} {o}", outs[o], ref[o], scales[s])
            for o, s in attn_outputs(name)))
        for o, _ in attn_outputs(name):
            if not torch.isfinite(outs[o]).all():
                raise AssertionError(f"{name} {label}: {o} not finite")
            if not torch.equal(again[o], outs[o]):
                raise AssertionError(f"{name} {label}: two launches differ "
                                     f"in {o}")
        if timed:
            r["ms"] = time_ms(calls[name])
            r["plain_ms"] = time_ms(plain_calls[name], reps=5, warmup=1)
            kept_here = kept
            if kept is not None and name == "attn_bwd_cols":
                kept_here = pa._attn_keep_scale(list_eids(lists.cols), salt,
                                                heads, keep) > 0
            r["bound_ms"], r["bound_by"], r["bytes"] = attn_bound(
                name, lists, heads, feats, kept_here)
            r["library_ms"] = None
            if profiled:
                rows, busy_us, _, _ = device_profile(calls[name])
                r["device_ms"] = busy_us / 1e3
                r["device_us_by_kernel"] = {kernel_name(k): us
                                            for k, us, _ in rows}
                r["kernel_launches"] = sum(n for _, _, n in rows)
            if name in ("attn_bwd_rows", "attn_bwd_cols") and profiled \
                    and r["kernel_launches"] > 3:
                raise AssertionError(f"{name} {label}: "
                                     f"{r['kernel_launches']} launches "
                                     f"a call (at most 3)")
            # the fused walk: one launch, and the merge where a row is split
            most = 2 if lists.rows.split.shape[0] else 1
            if name == ATTN_FUSED and profiled \
                    and r["kernel_launches"] > most:
                raise AssertionError(f"{name} {label}: "
                                     f"{r['kernel_launches']} launches "
                                     f"a call (at most {most})")
        res[name] = r
    if timed and heads == 1:
        # yardstick only: one cuSPARSE product of the realized coefficients
        rows, src, _, alpha = pa._alpha_rows(
            lists.rows, lists.mult, tab, sd, outs["rmax0"], outs["dinv"],
            heads, feats, ATTN_SLOPE)
        if salt is not None:
            alpha = alpha * pa._attn_keep_scale(list_eids(lists.rows), salt,
                                                heads, keep)
        a = torch.sparse_coo_tensor(torch.stack([rows, src]), alpha[:, 0],
                                    (n, n)).coalesce().to_sparse_csr()
        x = h.reshape(n, feats)
        call = lambda: torch.sparse.mm(a, x)
        check_close(f"library sparse.mm {label}", call(), ref["out"],
                    scales["out"])
        res["attn_aggregate"]["library_ms"] = time_ms(call)
        res[ATTN_FUSED]["library_ms"] = res["attn_aggregate"]["library_ms"]
    if cpu:
        on_cpu = dataclasses.replace(
            lists, rows=list_to(lists.rows, "cpu"),
            cols=list_to(lists.cols, "cpu"),
            mult=None if lists.mult is None else lists.mult.cpu())
        given = {k: v.cpu() for k, v in outs.items()}
        cpu_ref, _ = attn_calls(on_cpu, h.cpu(), ss.cpu(), sd.cpu(), g.cpu(),
                                None if salt is None else salt.cpu(), keep,
                                plain=True, given=given)
        for name in ATTN_KERNELS:
            share = min((given[o] == cpu_ref[o]).double().mean().item()
                        for o, _ in attn_outputs(name))
            res[name]["bit_equal_to_cpu_plain"] = share
    for name in ATTN_KERNELS:
        log(f"{name} {label}: {res[name]}")
    return res


def check_attn_device_salts(lists, h, ss, sd, g, dev):
    """2e: the chain over per-edge lists with its salt pair in one device
    buffer: launched with draw A, the buffer rewritten to draw B and
    launched again with the same arguments, then the chain captured in a
    CUDA graph and replayed after a rewrite to draw C; each output must
    equal, bit for bit, a fresh launch with its draw's salts."""
    draws = [torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                           generator=torch.Generator().manual_seed(s))
             for s in (31, 32, 33)]
    buf = draws[0].to(dev, copy=True)
    checked = []

    def hold(label, outs, draw):
        fresh, _ = attn_calls(lists, h, ss, sd, g, draws[draw].to(dev),
                              ATTN_KEEP)
        for key, value in outs.items():
            if not torch.equal(value, fresh[key]):
                raise AssertionError(f"attention chain {label}: {key} "
                                     f"differs from a launch with draw "
                                     f"{draw}")
        checked.append(f"{label} draw {draw}")

    first, _ = attn_calls(lists, h, ss, sd, g, buf, ATTN_KEEP)
    first = {k: v.clone() for k, v in first.items()}
    buf.copy_(draws[1])
    second, _ = attn_calls(lists, h, ss, sd, g, buf, ATTN_KEEP)
    hold("first launch", first, 0)
    hold("relaunch after a rewrite", second, 1)
    if dev.type == "cuda":  # a rehearsal on the CPU: no graphs there
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            outs, _ = attn_calls(lists, h, ss, sd, g, buf, ATTN_KEEP)
        buf.copy_(draws[2])
        graph.replay()
        torch.cuda.synchronize()
        hold("graph replay after a rewrite", outs, 2)
    log(f"attention chain with device salts: equal to fresh launches: "
        f"{checked}")
    return checked


def phase_attention_kernels(graph, dev):
    """2e: the attention kernels A1-A4 and the fused forward against their
    plain versions, small (a random graph with duplicates, an isolated
    destination, a hub row and a hub column split over many units) and on
    the bench graph with its self-loops at GAT's layer shapes, per-edge
    lists with a dropout draw (keep ATTN_KEEP) and coalesced lists without,
    the fused forward's device time beside A1's and A2's; then the chain
    with device salts."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import attention as pa

    rng = np.random.RandomState(12)
    n = 3000
    src = np.concatenate([rng.randint(0, n - 1, 40_000),
                          np.zeros(6000, np.int64),
                          rng.randint(0, n - 1, 6000)])
    dst = np.concatenate([rng.randint(0, n - 1, 40_000),
                          rng.randint(0, n - 1, 6000),
                          np.ones(6000, np.int64)])
    src, dst = np.concatenate([src, src[:5000]]), np.concatenate(
        [dst, dst[:5000]])
    small = {}
    salt = torch.tensor([0x9E3779B9, 77], device=dev)
    for dedup in (False, True):
        lists = pa.attn_lists(np.concatenate([src, dst]),
                              np.concatenate([dst, src]), n, dev,
                              dedup=dedup)
        if not (lists.rows.split.shape[0] and lists.cols.split.shape[0]):
            raise AssertionError("the small attention lists split no row")
        for heads, feats in GAT_SHAPES:
            h, ss, sd, g = attn_inputs(n, heads, feats, dev, heads)
            label = (f"small {'coalesced' if dedup else 'per-edge'} "
                     f"H={heads} F={feats}")
            small[label] = check_attn_kernels(
                label, lists, h, ss, sd, g, None if dedup else salt,
                1.0 if dedup else ATTN_KEEP)
            out, _ = attn_calls(lists, h, ss, sd, g, None, 1.0)
            if out["out"][n - 1].abs().sum() or out["dh"][n - 1].abs().sum():
                raise AssertionError("the isolated node got a value")

    graph = tt.add_self_loops(graph)
    stats, bench = {}, {}
    for dedup in (False, True):
        t0 = time.perf_counter()
        lists = pa._attn_lists(graph, dedup=dedup)
        torch.cuda.synchronize()
        split = lists.rows.split.cpu().numpy()
        stats["coalesced" if dedup else "per_edge"] = dict(
            slots=lists.rows.n_edges, units=lists.rows.n_units,
            split_rows=len(split), pieces=int(split[:, 2].sum()),
            column_units=lists.cols.n_units,
            split_columns=int(lists.cols.split.shape[0]),
            build_s=time.perf_counter() - t0)
        for heads, feats in GAT_SHAPES:
            h, ss, sd, g = attn_inputs(N_NODES, heads, feats, dev,
                                       20 + heads)
            label = (f"bench {'coalesced' if dedup else 'per-edge'} "
                     f"H={heads} F={feats}")
            bench[dedup, heads] = check_attn_kernels(
                label, lists, h, ss, sd, g, None if dedup else salt,
                1.0 if dedup else ATTN_KEEP, timed=True,
                cpu=(dedup == (heads == 1)), profiled=True)
            r = bench[dedup, heads]
            r[ATTN_FUSED]["a1_a2_device_ms"] = (r["attn_stats"]["device_ms"]
                                                + r["attn_aggregate"][
                                                    "device_ms"])
            log(f"{ATTN_FUSED} {label}: device {r[ATTN_FUSED]['device_ms']} "
                f"ms {r[ATTN_FUSED]['device_us_by_kernel']} us against A1 + "
                f"A2 {r[ATTN_FUSED]['a1_a2_device_ms']} ms, bound "
                f"{r[ATTN_FUSED]['bound_ms']} ms")
            for name in ("attn_bwd_rows", "attn_bwd_cols"):
                r = bench[dedup, heads][name]
                if not dedup:
                    log(f"{name} {label}: device {r['device_ms']} ms "
                        f"{r['device_us_by_kernel']} us, events {r['ms']} "
                        f"ms, bound {r['bound_ms']} ms")
            if not dedup and heads == 8:
                stats["device_salts"] = check_attn_device_salts(
                    lists, h, ss, sd, g, dev)
    log(f"bench attention lists (the graph with its {N_NODES} self-loops, "
        f"{graph.n_edges} edges): {stats}")
    return dict(small=small, lists=stats,
                layer1=bench[False, 8], layer2=bench[False, 1],
                layer1_coalesced=bench[True, 8],
                layer2_coalesced=bench[True, 1])


def phase_native_builders(src, dst):
    """1b: the C++ host builders (``utils/native.py``) on the bench graph:
    ``from_edges`` (the radix argsort of its counted edges) and ``build_ell``
    without deduplication (the training grids' build), each timed with the
    library and with its numpy path (the library unloaded), equal results,
    and the library's calls counted."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import build_ell
    from gnntf_tpu_torch.utils import native

    def both(fn):
        runs = (native.lexsort_edges.runs, native.build_ell_native.runs)
        t0 = time.perf_counter()
        fast = fn()
        fast_s = time.perf_counter() - t0
        ran = (native.lexsort_edges.runs - runs[0],
               native.build_ell_native.runs - runs[1])
        load, native._load = native._load, lambda: None
        try:
            t0 = time.perf_counter()
            slow = fn()
            slow_s = time.perf_counter() - t0
        finally:
            native._load = load
        return fast, slow, fast_s, slow_s, ran

    g, g_np, edges_s, edges_np_s, ran = both(lambda: tt.from_edges(
        src, dst, n_nodes=N_NODES, directed=False, device="cpu"))
    if ran != (1, 0) or not all(torch.equal(getattr(g, k), getattr(g_np, k))
                                for k in ("row", "col", "val")):
        raise AssertionError(f"from_edges: native calls {ran} (expected "
                             "one sort), or its graph differs from numpy's")
    row, col = g.row.numpy(), g.col.numpy()
    ell, ell_np, ell_s, ell_np_s, ran = both(
        lambda: build_ell(col, row, N_NODES, dedup=False))
    if ran != (0, 1) or not all(np.array_equal(getattr(ell, k),
                                               getattr(ell_np, k))
                                for k in ("idx", "slot", "vrow_row")):
        raise AssertionError(f"build_ell: native calls {ran} (expected one "
                             "build), or its layout differs from numpy's")
    res = dict(from_edges_s=edges_s, from_edges_numpy_s=edges_np_s,
               build_ell_s=ell_s, build_ell_numpy_s=ell_np_s,
               edges=g.n_edges)
    log(f"native host builders on the bench graph: {res}")
    return res


def entry_numbers(res):
    """The numbers of a ``kernels`` entry from a check's results (with one
    call's device time where the check took one)."""
    return {k: res[k] for k in ("max_abs_err", "ms", "device_ms", "plain_ms",
                                "bound_ms", "bound_by", "library_ms")
            if k in res}


def bf16_bound(lst, f):
    """Least time for K2's bfloat16 mode over this list: the list as
    ``blocked_bound`` counts it, the referenced x rows read once in
    bfloat16 (2 B an element), out written once in float32; 2 flops per
    edge and feature."""
    x_rows = int(torch.unique(lst.idx).numel())
    edge_bytes = 8 if lst.eid is None else 12
    n_bytes = ((lst.n_rows + 1) * 4 + lst.n_edges * edge_bytes
               + x_rows * f * 2 + lst.n_rows * f * 4)
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = 2 * lst.n_edges * f / PEAK_FP32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), n_bytes


def check_bf16_kernel(label, lst, cpu_lst, val, x, library=False):
    """K2's bfloat16 mode over ``lst`` on ``x`` (float32, cast to bfloat16
    as ``spmm_pallas(bf16=True)`` casts it) against its plain version:
    the walk that ``bf16_plan`` picks ("walk": the staged walk,
    ``csrc/bf16_walk.cuh``, at F % 8 == 0, 16 <= F <= 40 on this list; the
    share walk, ``csrc/share_walk.cuh``, at F % 8 == 0, 64 <= F <= 256),
    the call from the float32 ``x`` (the cast, then that walk) and, where
    the staged or the share walk runs, the generic walk at its own load
    beside it, each within ``1e-5 * sum|terms|`` of the plain version on
    the card and compared with it on the CPU (``cpu_lst``: ``lst`` there),
    which the staged walk must equal bit for bit, and the share walk both
    there and on the card.  Each is timed (CUDA events; one call's device
    time) beside its bound, with the cast, the float32 walk, the plain
    version and (``library``) ``torch.sparse.mm`` of the same matrix in
    float32."""
    from gnntf_tpu_torch.ops import (blocked, blocked_spmm, blocked_spmm_bf16,
                                     blocked_spmm_bf16_plain,
                                     blocked_spmm_plain)

    f = x.shape[1]
    xb = x.to(torch.bfloat16)
    ref = blocked_spmm_bf16_plain(lst, val, xb)
    ref_cpu = blocked_spmm_bf16_plain(cpu_lst, val.cpu(), xb.cpu())
    scale = blocked_spmm_plain(lst, val.abs(), xb.to(torch.float32).abs())
    plan = blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                             lst.n_rows)
    runs = {"walk": lambda: blocked_spmm_bf16(lst, val, xb),
            "call": lambda: blocked_spmm_bf16(lst, val,
                                              x.to(torch.bfloat16))}
    if plan.staged or plan.share:
        runs["generic"] = lambda: blocked_spmm_bf16(lst, val, xb)
    res = {}
    old = blocked._BF16_STAGED_EDGES, blocked._BF16_SHARE_LISTS
    for name, run in runs.items():
        # the generic walk: the staged and the share walk at no width
        if name == "generic":
            blocked._BF16_STAGED_EDGES = {}
            blocked._BF16_SHARE_LISTS = {}
        try:
            p = blocked.bf16_plan(f, xb.data_ptr(), 0, lst.n_edges,
                                  lst.n_rows)
            out = run()
            torch.cuda.synchronize()
            r = dict(staged=p.staged, share=p.share, vec=p.vec,
                     group=p.group, ring=(p.depth, p.rows),
                     max_abs_err=check_close(f"K2 bf16 {name} {label}", out,
                                             ref, scale),
                     bit_equal=bool(torch.equal(out.cpu(), ref_cpu)),
                     bit_equal_card=bool(torch.equal(out, ref)),
                     ms=time_ms(run))
            rows, busy_us, _, _ = device_profile(run)
        finally:
            blocked._BF16_STAGED_EDGES, blocked._BF16_SHARE_LISTS = old
        r["device_ms"] = busy_us / 1e3
        r["us_by_kernel"] = {kernel_name(key): us for key, us, _ in rows}
        r["bound_ms"], r["bound_by"], r["bound_bytes"] = bf16_bound(lst, f)
        if p.staged and not r["bit_equal"]:
            raise AssertionError(f"K2 bf16 {name} {label}: the staged walk "
                                 f"is not bit-equal to the plain version on "
                                 f"the CPU")
        if p.share and not (r["bit_equal"] and r["bit_equal_card"]):
            raise AssertionError(f"K2 bf16 {name} {label}: the share walk "
                                 f"is not bit-equal to the plain version on "
                                 f"the card and on the CPU")
        res[name] = r
    cast = lambda: x.to(torch.bfloat16)
    common = dict(plain_ms=time_ms(lambda: blocked_spmm_bf16_plain(lst, val,
                                                                   xb)),
                  cast_ms=time_ms(cast),
                  cast_bound_ms=x.numel() * 6 / PEAK_BYTES_PER_S * 1e3,
                  float32_walk_ms=time_ms(lambda: blocked_spmm(lst, val, x)),
                  float32_bound_ms=blocked_bound(lst, f)[0],
                  library_ms=None)
    rows, busy_us, _, _ = device_profile(cast)
    common["cast_device_ms"] = busy_us / 1e3
    if library:
        rows, src = live_edges(lst)
        w = val if lst.eid is None else val[lst.eid.long()]
        a = torch.sparse_coo_tensor(torch.stack([rows, src]), w,
                                    (lst.n_rows, x.shape[0]))
        a = a.coalesce().to_sparse_csr()
        common["library_ms"] = time_ms(lambda: torch.sparse.mm(a, x))
    for r in res.values():
        r.update(common)
    log(f"K2 bf16 {label} (edges {lst.n_edges}, units {lst.n_units}, split "
        f"rows {lst.split.shape[0]}, N={lst.n_rows} F={f}): " + "; ".join(
            f"{name} (staged {r['staged']}, share {r['share']}, vec "
        f"{r['vec']}, group "
            f"{r['group']}, ring {r['ring']}) {r['ms']} ms, device "
            f"{r['device_ms']} ms {r['us_by_kernel']} us, bound "
            f"{r['bound_ms']} ms ({r['bound_bytes']} B), bit-equal "
            f"{r['bit_equal']}"
            for name, r in res.items()) + f"; {common}")
    return res


def phase_bf16_kernels(graph, g_rcm, dev, xs):
    """2f: K2's bfloat16 mode (``spmm_pallas(bf16=True)``) on the RCM bench
    graph's forward list at each F of ``xs`` ({F: x}) and at F=7 against
    its plain version, the share at F=40 bit-equal to the plain version on
    the CPU; a serving product at F=40, at F=7 (the generic walk's narrow
    walk) and at F=128 (the share walk) and a training step at F=40
    through ``spmm_pallas(bf16=True)`` with the counts zeroed just before
    and read just after, ``dx`` and ``dval`` against the CPU; then the
    masked and degree walks over a weighted copy of the bench graph's
    training lists, the values in bfloat16 beside float32; returns the
    results."""
    from gnntf_tpu_torch.ops import (blocked, blocked_spmm_bf16_plain,
                                     build_train_grids, ell_degree_masked,
                                     ell_gather_masked, normalize_adjacency,
                                     spmm_pallas)

    norm = normalize_adjacency(g_rcm, graph_dropout=0.0)
    prep = blocked.blocked_layout(norm)
    base = norm.materialized()
    val = base.val.to(torch.float32).contiguous()
    cpu = blocked.blocked_layout(norm.to("cpu"))
    res = {}
    x40, x128 = xs[N_CLASSES], xs[N_FEATURES]
    x7 = torch.from_numpy(np.random.RandomState(18).randn(
        N_NODES, CORA_CLASSES).astype(np.float32)).to(dev)
    for f, x in {**xs, CORA_CLASSES: x7}.items():
        res[f] = check_bf16_kernel(f"RCM bench F={f}", prep.forward,
                                   cpu.forward, val, x, library=True)
    x_cpu = x40.cpu()
    ref = blocked_spmm_bf16_plain(cpu.forward, val.cpu(),
                                  x_cpu.to(torch.bfloat16))
    out = blocked.blocked_spmm_bf16(prep.forward, val,
                                    x40.to(torch.bfloat16)).cpu()
    share = (out == ref).double().mean().item()
    res["bit_equal_to_cpu_plain_f40"] = share
    log(f"K2 bf16 RCM bench F=40 on the card against the plain version on "
        f"the CPU: bit-equal share {share}")
    if res["bit_equal_to_cpu_plain_f40"] != 1.0:
        raise AssertionError("K2's bfloat16 mode is not bit-equal to its "
                             "plain version on the CPU")

    # the slice's main path: a serving product at full width, then a
    # training step through it (its float32 backward)
    dy = torch.from_numpy(np.random.RandomState(16).randn(
        N_NODES, N_CLASSES).astype(np.float32)).to(dev)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    served = spmm_pallas(norm, x40, bf16=True)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    v = norm.val.detach().clone().requires_grad_()
    xg = x40.clone().requires_grad_()
    t0 = time.perf_counter()
    out = spmm_pallas(dataclasses.replace(norm, val=v), xg, bf16=True)
    out.backward(dy)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    served7 = spmm_pallas(norm, x7, bf16=True)
    torch.cuda.synchronize()
    serve7_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    served128 = spmm_pallas(norm, x128, bf16=True)
    torch.cuda.synchronize()
    serve128_ms = (time.perf_counter() - t0) * 1e3
    counts = launch_counts()
    # the staged walk in the F=40 product and step forward, the generic walk at
    # F=7, the share walk at F=128, K2's float32 walk for dx
    want = dict(NO_LAUNCHES, k2_bf16s=2, k2_bf16=1, k2_bf16sh=1, k2=1)
    log(f"spmm_pallas(bf16=True): serving product {serve_ms} ms, step "
        f"(forward, backward) {step_ms} ms, serving product at F=7 "
        f"{serve7_ms} ms, at F=128 {serve128_ms} ms, launches {counts}")
    if counts != want:
        raise AssertionError(f"launches {counts}, expected {want}")
    n_cpu = norm.to("cpu")
    v_cpu = n_cpu.val.detach().clone().requires_grad_()
    x_cpu = x_cpu.clone().requires_grad_()
    ref = spmm_pallas(dataclasses.replace(n_cpu, val=v_cpu), x_cpu,
                         bf16=True)
    ref.backward(dy.cpu())
    ref7 = spmm_pallas(n_cpu, x7.cpu(), bf16=True)
    ref128 = spmm_pallas(n_cpu, x128.cpu(), bf16=True)
    step = dict(serve_ms=serve_ms, step_ms=step_ms, serve7_ms=serve7_ms,
                serve128_ms=serve128_ms, launches=counts)
    for name, a, b in (("forward", served, ref), ("dx", xg.grad, x_cpu.grad),
                       ("dval", v.grad, v_cpu.grad),
                       ("forward_f7", served7, ref7),
                       ("forward_f128", served128, ref128)):
        a, b = a.detach().cpu(), b.detach()
        step[f"{name}_max_abs_err"] = (a - b).abs().max().item()
        step[f"{name}_bit_equal_share"] = (a == b).double().mean().item()
        if not (torch.isfinite(a).all()
                and torch.allclose(a, b, rtol=1e-5, atol=1e-5)):
            raise AssertionError(f"spmm_pallas(bf16=True) {name} on the "
                                 f"card differs from the CPU: "
                                 f"{step[f'{name}_max_abs_err']}")
        # the products are the plain version's sums, dx K2's float32 walk's
        if name != "dval" and step[f"{name}_bit_equal_share"] != 1.0:
            raise AssertionError(f"spmm_pallas(bf16=True) {name} on the "
                                 f"card is not bit-equal to the CPU's")
    log(f"spmm_pallas(bf16=True) card vs CPU: {step}")
    res["step"] = step

    # the dropout walks over a weighted copy of the bench training lists
    t0 = time.perf_counter()
    rows, cols = build_train_grids(graph.row.cpu().numpy(),
                                   graph.col.cpu().numpy(),
                                   np.ones(graph.n_edges, np.float32),
                                   N_NODES).lists(dev)
    lists_s = time.perf_counter() - t0
    weights = torch.from_numpy(np.random.RandomState(17).uniform(
        0.5, 1.5, graph.n_edges).astype(np.float32)).to(dev)
    salt = torch.randint(0, 1 << 32, (2,), dtype=torch.int64,
                         generator=torch.Generator().manual_seed(9)).to(dev)
    draw = (salt, KEEP, graph.n_edges)
    masked = dict(lists_s=lists_s)
    for dtype in (torch.bfloat16, torch.float32):
        w = weights.to(dtype)
        tag = "bf16" if dtype == torch.bfloat16 else "float32"
        for name, lst in (("row", rows), ("column", cols)):
            masked[tag, name] = check_masked_kernel(
                f"masked bench {name} list F=40, {tag} weighted values", lst,
                w, draw, x40, library=True)
        # the yardstick sums a hub column's weights with sparse.mm, not
        # with index_add_'s atomics, whose order moves their sum by more
        # than the tolerance
        masked[tag, "degree"] = check_masked_kernel(
            f"degree bench column list, {tag} weighted values", cols, w,
            draw, library="csr")
    wb = weights.to(torch.bfloat16)
    shares = dict(
        forward_f40=cpu_share("masked bench row list F=40 bf16 values",
                              ell_gather_masked(rows, wb, *draw, x40), rows,
                              wb, draw, x40),
        degree=cpu_share("degree bench column list bf16 values",
                         ell_degree_masked(cols, wb, *draw), cols, wb,
                         draw))
    if any(share != 1.0 for share in shares.values()):
        raise AssertionError(f"the walks over bfloat16 values are not "
                             f"bit-equal to their plain versions on the "
                             f"CPU: {shares}")
    res["masked"] = {f"{k[0]}_{k[1]}" if isinstance(k, tuple) else k: v
                     for k, v in masked.items()}
    res["masked"]["bit_equal_to_cpu_plain"] = shares
    return res


BF16_EPOCHS = 3
# launches an epoch of APPNP under GNNTF_GRID_VALUE_DTYPE=bfloat16: the
# masked and degree walks over the grids' bfloat16 values
BF16_LAUNCHES = dict(NO_LAUNCHES, k1s=10, masked_bf16=20, degree_bf16=10)


def phase_bf16_train(graph, features, dev):
    """2f, training: APPNP at its defaults on the bench graph (unit base
    values), 3 epochs without and 3 under ``GNNTF_GRID_VALUE_DTYPE=
    bfloat16``, from one seed, the counts zeroed just before each and read
    at each epoch's end: the bfloat16 run's losses bit-equal to the float32
    run's, its walks those over bfloat16 values."""
    import os

    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import stochastic

    tasks = fused_tasks()
    res = {}
    for name, want in (("float32", EPOCH_LAUNCHES[None]),
                       ("bfloat16", BF16_LAUNCHES)):
        os.environ["GNNTF_GRID_VALUE_DTYPE"] = name
        try:
            model = tt.APPNP(graph, features, num_classes=N_CLASSES,
                             device=dev)
            builds = stochastic.train_grids.builds
            hist, epoch_ms, peak_mb = counted_train(model, tasks,
                                                    BF16_EPOCHS, want)
            builds = stochastic.train_grids.builds - builds
        finally:
            os.environ.pop("GNNTF_GRID_VALUE_DTYPE")
        res[name] = dict(train_loss=hist["train_loss"],
                         valid_loss=hist["valid_loss"], epoch_ms=epoch_ms,
                         peak_mb=peak_mb, grid_builds=builds)
        log(f"APPNP under GNNTF_GRID_VALUE_DTYPE={name}: {res[name]}")
    if res["bfloat16"]["grid_builds"] != 1:
        raise AssertionError("the bfloat16 run did not build its grids")
    for key in ("train_loss", "valid_loss"):
        if res["bfloat16"][key] != res["float32"][key]:
            raise AssertionError(f"{key} under the knob differs: "
                                 f"{res['bfloat16'][key]} against "
                                 f"{res['float32'][key]}")
    res["launches"] = {k: v * BF16_EPOCHS for k, v in BF16_LAUNCHES.items()
                       if v}
    return res


def init_params(model, seed):
    """Every parameter of ``model`` from U(-INIT_SCALE, INIT_SCALE), drawn
    on the host (numpy), as ``{name: array}``."""
    rng = np.random.RandomState(seed)
    return {s.name: rng.uniform(-INIT_SCALE, INIT_SCALE, s.shape).astype(
        np.float32) for s in model.param_specs}


def timed(fn, reps=3):
    """Host-clock ms of ``reps`` calls of ``fn`` after one warm call, each
    ending in a synchronize."""
    fn()
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) * 1e3)
    return out


def counted_train(model, tasks, epochs, want, **kw):
    """``model.train(*tasks, epochs=...)`` with the counts zeroed just
    before and read at each epoch's end; raises unless every epoch launched
    ``want``.  Returns the history, the epochs' ms and the peak memory."""
    marks, times = [], []

    def mark(epoch, **_):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        marks.append(launch_counts())

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    hist = model.train(*tasks, epochs=epochs, patience=100, seed=0,
                       callbacks=[mark], **kw)
    counts = per_epoch(marks)
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    epoch_ms = np.diff([t0] + times) * 1e3
    log(f"launches an epoch: {counts}")
    if counts != [want] * epochs:
        raise AssertionError(f"launches an epoch {counts}, expected {want}")
    losses = np.array(hist["train_loss"] + hist["valid_loss"])
    if len(losses) != 2 * epochs or not np.isfinite(losses).all():
        raise AssertionError(f"bad losses {hist}")
    return hist, epoch_ms.tolist(), peak_mb


def step_fn(model, train):
    """One training step (forward, losses, gradients) of ``model``."""
    from gnntf_tpu_torch.train.trainer import _total_loss
    params = [p for p in model.params.values() if p.requires_grad]

    def step():
        loss = _total_loss(model, train, train.batch(), 5e-4,
                           torch.Generator().manual_seed(1))
        torch.autograd.grad(loss, params)
    return step


def check_predictions(model, valid):
    preds = model.predict(valid).cpu()
    accuracy = float(model.evaluate(valid))
    if preds.shape != (VALID_NODES,) or int(preds.max()) >= N_CLASSES:
        raise AssertionError(f"bad predictions {tuple(preds.shape)}")
    return accuracy


def phase_gcnii(graph, features, dev):
    """7: GCNII at its published configuration on the bench graph: serving
    (three forwards, three predict requests, one evaluate; 64 K1 walks a
    forward), the full-depth forward against the CPU's with the same
    random weights, ``train(epochs=3)`` with no spmm_impl (64 K1 walks and
    64 backward walks a step, no index_add_), and 3 epochs at depth
    CROSS_ITERATIONS without dropout on both devices."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch import config

    train, valid = fused_tasks()
    cfg = config.GCNIIConfig()
    if cfg.iterations != GCNII_ITERATIONS:
        raise AssertionError(f"GCNIIConfig has {cfg.iterations} iterations")
    model = cfg.build(graph, features, N_CLASSES, device=dev)
    init = init_params(model, 11)
    tt.params_from_jax(init, model)
    order = np.random.RandomState(7).permutation(N_NODES)
    requests = [order[i * REQUEST_NODES:(i + 1) * REQUEST_NODES]
                for i in range(N_REQUESTS)]
    eval_nodes = order[N_REQUESTS * REQUEST_NODES:
                       (N_REQUESTS + 1) * REQUEST_NODES]
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    t0 = time.perf_counter()
    model.adjacency()  # normalized graph + PreparedSpMM, built once
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    forward_ms, request_ms, answers = [], [], []
    for i in range(3):
        model._act_cache = None
        t0 = time.perf_counter()
        acts = model._activations()
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    for nodes in requests:
        t0 = time.perf_counter()
        answers.append(model.predict(tt.NodeClassification(nodes)).cpu())
        request_ms.append((time.perf_counter() - t0) * 1e3)
    accuracy = float(model.evaluate(
        tt.NodeClassification(eval_nodes, labels[eval_nodes])))
    serving = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want = dict(NO_LAUNCHES, k1s=3 * GCNII_ITERATIONS)
    if serving != want:
        raise AssertionError(f"GCNII serving launches {serving}, expected "
                             f"{want}")
    profile = profile_forward("one GCNII forward", clean_forward(model),
                              top=12)
    if profile["k1s_walks"] != GCNII_ITERATIONS or profile["k1_walks"]:
        raise AssertionError(f"{profile['k1s_walks']} K1 scaled walks and "
                             f"{profile['k1_walks']} hub-route K1 walks in "
                             "a GCNII forward")
    log(f"GCNII serving: set-up {setup_ms} ms, forward ms {forward_ms}, "
        f"predict ms {request_ms}, evaluate {accuracy}, peak memory "
        f"{peak_mb} MiB, launches {serving}")
    gpu = acts.cpu()
    if gpu.shape != (N_NODES, N_CLASSES) or not torch.isfinite(gpu).all():
        raise AssertionError(f"bad GCNII logits: shape {tuple(gpu.shape)}")
    for nodes, answer in zip(requests, answers):
        if not torch.equal(answer, gpu[torch.from_numpy(nodes)].argmax(1)):
            raise AssertionError("GCNII predict disagrees with the "
                                 "activations")
    t0 = time.perf_counter()
    cpu_model = cfg.build(graph.to("cpu"), features, N_CLASSES,
                          device="cpu")
    tt.params_from_jax(init, cpu_model)
    ref = cpu_model._activations()
    err = (gpu - ref).abs().max().item()
    agree = (gpu.argmax(1) == ref.argmax(1)).double().mean().item()
    forward = dict(max_abs_err=err, max_abs_logit=ref.abs().max().item(),
                   argmax_agreement=agree,
                   cpu_s=time.perf_counter() - t0)
    log(f"GCNII GPU vs CPU full-depth forward: {forward}")
    if not torch.allclose(gpu, ref, **GCNII_TOL):
        raise AssertionError(f"GCNII GPU forward differs from CPU ({err})")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"GCNII argmax agreement {agree}")
    del cpu_model, ref

    hist, epoch_ms, train_peak = counted_train(
        model, (train, valid), GCNII_EPOCHS, GCNII_LAUNCHES)
    step = step_fn(model, train)
    step_ms = timed(step)
    with torch.no_grad():
        eval_ms = timed(lambda: model.forward(model.features))
    prof = profile_step(step, top=12)
    want = dict(NO_LAUNCHES, k1s=GCNII_ITERATIONS,
                backward=GCNII_ITERATIONS)
    if prof["index_add_launches"] or prof["counted"] != want:
        raise AssertionError(f"GCNII step: {prof['index_add_launches']} "
                             f"index_add_ launches in the profile (expected "
                             f"0), launches {prof['counted']} (expected "
                             f"{want})")
    accuracy = check_predictions(model, valid)
    log(f"GCNII training: epoch ms {epoch_ms}, step ms {step_ms}, "
        f"validation forward ms {eval_ms}, peak memory {train_peak} MiB, "
        f"train loss {hist['train_loss']}, valid loss {hist['valid_loss']}, "
        f"accuracy {accuracy}")
    cross = cross_device_gcnii(graph, features, train, valid, dev)
    return dict(serving=dict(forward_ms=forward_ms, request_ms=request_ms,
                             setup_ms=setup_ms, peak_mb=peak_mb,
                             launches=serving, profile=profile),
                forward=forward, epoch_ms=epoch_ms, step_ms=step_ms,
                eval_forward_ms=eval_ms, peak_mb=train_peak,
                step_busy_ms=prof["busy_us"] / 1e3, profile=prof,
                launches_per_epoch=GCNII_LAUNCHES, cross=cross)


def cross_device_gcnii(graph, features, train, valid, dev):
    """7: GCNII at depth CROSS_ITERATIONS without dropout (no random draw
    separates the devices), 3 epochs on the card and on the CPU from the
    same weights: losses within LOSS_RTOL, parameters by phase 4b's
    rules."""
    from gnntf_tpu_torch import config

    cfg = dataclasses.replace(config.GCNIIConfig(),
                              iterations=CROSS_ITERATIONS, dropout=0.0)
    runs, params, adam, seconds, init = {}, {}, {}, {}, None
    for device, g in ((dev, graph), ("cpu", graph.to("cpu"))):
        model = cfg.build(g, features, N_CLASSES, device=device)
        init = init_params(model, 13) if init is None else init
        adam[str(device)] = recording_adam(LEARNING_RATE)
        zero_counts()
        t0 = time.perf_counter()
        runs[str(device)] = model.train(
            train, valid, epochs=CROSS_EPOCHS, patience=100, seed=0,
            optimizer=adam[str(device)], init_params=dict(init))
        seconds[str(device)] = time.perf_counter() - t0
        want = dict(GCNII_LAUNCHES, k1s=2 * CROSS_ITERATIONS,
                    backward=CROSS_ITERATIONS)
        want = {k: CROSS_EPOCHS * v for k, v in want.items()}
        if launch_counts() != (want if torch.device(device) == dev
                               else NO_LAUNCHES):
            raise AssertionError(f"GCNII-{CROSS_ITERATIONS} on {device}: "
                                 f"launches {launch_counts()}")
        params[str(device)] = {k: p.detach().cpu()
                               for k, p in model.params.items()}
    gpu, cpu = runs[str(dev)], runs["cpu"]
    log(f"GCNII-{CROSS_ITERATIONS} GPU vs CPU training, {CROSS_EPOCHS} "
        f"epochs, no dropout: GPU {gpu} ({seconds[str(dev)]} s), CPU {cpu} "
        f"({seconds['cpu']} s)")
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(gpu[key], cpu[key], rtol=LOSS_RTOL)
    worst, outside, total = compare_params(
        f"GCNII-{CROSS_ITERATIONS} training", params, adam, dev)
    return dict(max_param_diff=worst, outside=outside, elements=total,
                cpu_seconds=seconds["cpu"], gpu_seconds=seconds[str(dev)])


def phase_gcn(graph, features, dev):
    """8: GCN at its published configuration on the bench graph:
    ``train(epochs=5)`` with no spmm_impl (per step the masked walk at F=64
    forward and backward and the degree walk in the hidden layer, K1 and
    its backward walk at F=40 in the output layer; K1 twice in the
    validation forward), predict, then ``fit(block_epochs=5)`` against the
    host loop at ``epochs=10`` and a profile of a fused run's replays."""
    from gnntf_tpu_torch import config

    train, valid = fused_tasks()
    model = config.GCNConfig().build(graph, features, N_CLASSES, device=dev)
    hist, epoch_ms, peak_mb = counted_train(model, (train, valid),
                                            GCN_EPOCHS, GCN_LAUNCHES)
    step = step_fn(model, train)
    step_ms = timed(step)
    with torch.no_grad():
        eval_ms = timed(lambda: model.forward(model.features))
    prof = profile_step(step)
    want = dict(NO_LAUNCHES, k1s=1, masked=2, degree=1, backward=1)
    if prof["index_add_launches"] or prof["counted"] != want:
        raise AssertionError(f"GCN step: {prof['index_add_launches']} "
                             f"index_add_ launches in the profile (expected "
                             f"0), launches {prof['counted']} (expected "
                             f"{want})")
    accuracy = check_predictions(model, valid)
    log(f"GCN training: epoch ms {epoch_ms}, step ms {step_ms}, validation "
        f"forward ms {eval_ms}, peak memory {peak_mb} MiB, train loss "
        f"{hist['train_loss']}, valid loss {hist['valid_loss']}, accuracy "
        f"{accuracy}")

    fused, counts, t0, marks, _ = fused_run(model, (train, valid), None,
                                            FUSED_BLOCK)
    runs = 2 if dev.type == "cuda" else FUSED_EPOCHS
    want = {k: runs * v for k, v in GCN_LAUNCHES.items()}
    if counts != want:
        raise AssertionError(f"GCN fused: launches counted {counts}, "
                             f"expected {want}")
    fused_epoch_ms = (marks[2 * FUSED_BLOCK - 1]
                      - marks[FUSED_BLOCK - 1]) * 1e3 / FUSED_BLOCK
    host, host_counts, h0, host_marks, _ = fused_run(
        model, (train, valid), None, 1)
    if host_counts != {k: FUSED_EPOCHS * v for k, v in GCN_LAUNCHES.items()}:
        raise AssertionError(f"GCN host loop launches {host_counts}")
    rel = {}
    for key in ("train_loss", "valid_loss"):
        a, b = np.array(fused[key]), np.array(host[key])
        rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=FUSED_RTOL)
    if fused["best_epoch"] != host["best_epoch"]:
        raise AssertionError(f"GCN fused best epoch {fused['best_epoch']}, "
                             f"host loop {host['best_epoch']}")
    # the walks of a replay are logged, not checked; the losses equal to
    # the host loop's show that each replay ran them
    replay = replay_profile(
        "GCN fused", lambda primer: fused_run(model, (train, valid), None,
                                              FUSED_BLOCK, profile=True,
                                              primer=primer)[4],
        {"index_add": 0})
    host_ms = np.diff([h0] + host_marks) * 1e3
    fused_out = dict(fused_epoch_ms=fused_epoch_ms,
                     host_epoch_ms=host_ms.tolist(),
                     max_rel_loss_diff=rel, best_epoch=fused["best_epoch"],
                     counted=counts, replay=replay)
    log(f"GCN fused: {fused_out}")
    return dict(epoch_ms=epoch_ms, step_ms=step_ms, eval_forward_ms=eval_ms,
                peak_mb=peak_mb, step_busy_ms=prof["busy_us"] / 1e3,
                profile=prof, launches_per_epoch=GCN_LAUNCHES,
                fused=fused_out)


GAT_EPOCHS = SAGE_EPOCHS = 3
# GAT's serving forward, GPU vs CPU: float32, sums in another order through
# two attention layers
GAT_FORWARD_TOL = dict(rtol=1e-4, atol=1e-5)


def serving_run(label, model, per_forward):
    """A warm forward (set-up: the model's adjacency and lists), then, with
    the counts zeroed, three clean forwards, three predict requests of
    REQUEST_NODES nodes and one evaluate; raises unless the launches are
    three times ``per_forward`` or the predictions disagree with the
    logits.  Returns the times, the launches, the peak memory and the
    logits on the host."""
    import gnntf_tpu_torch as tt
    order = np.random.RandomState(7).permutation(N_NODES)
    requests = [order[i * REQUEST_NODES:(i + 1) * REQUEST_NODES]
                for i in range(N_REQUESTS)]
    eval_nodes = order[N_REQUESTS * REQUEST_NODES:
                       (N_REQUESTS + 1) * REQUEST_NODES]
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    t0 = time.perf_counter()
    model._act_cache = None
    model._activations()
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    forward_ms, request_ms, answers = [], [], []
    for _ in range(3):
        model._act_cache = None
        t0 = time.perf_counter()
        acts = model._activations()
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
    for nodes in requests:
        t0 = time.perf_counter()
        answers.append(model.predict(tt.NodeClassification(nodes)).cpu())
        request_ms.append((time.perf_counter() - t0) * 1e3)
    accuracy = float(model.evaluate(
        tt.NodeClassification(eval_nodes, labels[eval_nodes])))
    launches = launch_counts()
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    want = {k: 3 * v for k, v in per_forward.items()}
    if launches != want:
        raise AssertionError(f"{label} serving launches {launches}, "
                             f"expected {want}")
    logits = acts.cpu()
    if logits.shape != (N_NODES, N_CLASSES) or not torch.isfinite(
            logits).all():
        raise AssertionError(f"bad {label} logits: {tuple(logits.shape)}")
    for nodes, answer in zip(requests, answers):
        if not torch.equal(answer, logits[torch.from_numpy(nodes)].argmax(1)):
            raise AssertionError(f"{label} predict disagrees with the "
                                 "activations")
    log(f"{label} serving: set-up {setup_ms} ms (first forward), forward ms "
        f"{forward_ms}, predict ms {request_ms}, evaluate {accuracy}, peak "
        f"memory {peak_mb} MiB, launches {launches}")
    return dict(setup_ms=setup_ms, forward_ms=forward_ms,
                request_ms=request_ms, peak_mb=peak_mb,
                launches=launches), logits


def cpu_forward(label, build, g_cpu, logits, tol):
    """The same model built on the CPU with the same weights
    (``reset(seed=0)``): its forward against the card's ``logits``."""
    t0 = time.perf_counter()
    cpu_model = build(g_cpu, "cpu")
    cpu_model.reset(seed=0)
    ref = cpu_model._activations()
    err = (logits - ref).abs().max().item()
    agree = (logits.argmax(1) == ref.argmax(1)).double().mean().item()
    out = dict(max_abs_err=err, max_abs_logit=ref.abs().max().item(),
               argmax_agreement=agree, cpu_s=time.perf_counter() - t0)
    log(f"{label} GPU vs CPU forward: {out}")
    if not torch.allclose(logits, ref, **tol):
        raise AssertionError(f"{label} GPU forward differs from CPU ({err})")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"{label} argmax agreement {agree}")
    return out


def walks_of(counts):
    """The attention walks that the wrappers' ``counts`` launch, by
    profile name."""
    return {name + "_walk": counts[name] for name in ATTN_KERNELS}


def attn_profile(label, fn, top=12):
    """Device time by kernel over one ``fn()`` after a warm call: the
    attention walks and their shares of the busy time, the wrappers'
    counts over the session, and the launches of ``index_add_`` and
    scatter kernels."""
    fn()
    rows, busy_us, wall_us, counted = device_profile(fn)
    count = lambda *tags: sum(r[2] for r in rows
                              if any(t in r[0] for t in tags))
    out = dict(busy_us=busy_us, wall_us=wall_us, counted=counted,
               launches=sum(r[2] for r in rows),
               walks={w: count(w) for w in ATTN_WALKS},
               shares={w: sum(r[1] for r in rows if w in r[0]) / busy_us
                       for w in ATTN_WALKS},
               attn_us=sum(r[1] for r in rows if "attn_" in r[0]),
               attn_launches=count("attn_"),
               index_add=count("indexFunc", "index_add"),
               scatter=count("scatter"))
    out["attn_share"] = out["attn_us"] / busy_us
    log(f"profile of {label}: {out}")
    for key, us, n in rows[:top]:
        log(f"  {us} us in {n} launches: {key[:90]}")
    log_kernels("attention", rows, "attn_")
    return out


def phase_gat(graph, features, dev):
    """9: GAT at GATConfig (latent 8, 8 heads, dropout 0.6, attention
    dropout 0.6) on the bench graph with 40 classes: serving (the fused
    forward walk in each layer of a forward, on the coalesced lists, at
    most 2 attention kernels a layer: the walk and, for split rows, the
    merge), a profile of one forward and of one step, ``train(epochs=3)``
    under the default impl
    (the per-edge lists in the step), the serving forward against the
    CPU's, 3 epochs without dropout on the card and on the CPU, and
    ``fit(block_epochs=5)`` against the host loop at ``epochs=10``."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch import config
    from gnntf_tpu_torch.ops import attention as pa

    cfg = config.GATConfig()
    build = lambda g, device: cfg.build(g, features, N_CLASSES,
                                        device=device)
    train, valid = fused_tasks()
    model = build(graph, dev)
    model.reset(seed=0)
    per_forward = dict(NO_LAUNCHES, attn_softmax_aggregate=2)
    serving, logits = serving_run("GAT", model, per_forward)
    serving["profile"] = attn_profile(
        "one GAT forward",
        clean_forward(model))
    if (serving["profile"]["counted"] != per_forward
            or serving["profile"]["walks"] != walks_of(per_forward)
            or serving["profile"]["attn_launches"] > 2 * 2):
        raise AssertionError(f"a GAT forward's profile: {serving['profile']}")
    g_cpu = graph.to("cpu")
    forward = cpu_forward("GAT", build, g_cpu, logits, GAT_FORWARD_TOL)

    hist, epoch_ms, peak_mb = counted_train(model, (train, valid),
                                            GAT_EPOCHS, GAT_LAUNCHES)
    train_launches = launch_counts()
    step = step_fn(model, train)
    step_ms = timed(step)
    with torch.no_grad():
        eval_ms = timed(lambda: model.forward(model.features))
    prof = attn_profile("one GAT training step", step, top=14)
    want = dict(NO_LAUNCHES, attn_softmax_aggregate=2, attn_bwd_rows=2,
                attn_bwd_cols=2)
    if prof["index_add"] or prof["counted"] != want or prof[
            "walks"] != walks_of(want):
        raise AssertionError(f"GAT step: {prof['index_add']} index_add_ "
                             f"launches (expected 0), launches "
                             f"{prof['counted']} and walks {prof['walks']} "
                             f"(expected {want})")
    # the attention chain alone, forward and backward at layer 1's shape
    # with attention dropout: its kernels and no index_add_ or scatter
    sl = tt.add_self_loops(model.graph)
    h, ss, sd, _ = attn_inputs(N_NODES, 8, 8, dev, 40)
    h, ss, sd = (t.requires_grad_() for t in (h, ss, sd))
    salt = torch.tensor([3, 4], device=dev)
    chain = attn_profile(
        "the attention chain (layer 1, dropout 0.6), forward and backward",
        lambda: torch.autograd.backward(
            pa.gat_attention(sl, h, ss, sd, attn_dropout=0.6, salt=salt),
            torch.ones(N_NODES, 8, 8, device=dev)))
    want = dict(NO_LAUNCHES, attn_softmax_aggregate=1, attn_bwd_rows=1,
                attn_bwd_cols=1)
    if chain["index_add"] or chain["scatter"] or chain["counted"] != want \
            or chain["walks"] != walks_of(want):
        raise AssertionError(f"the attention chain's profile: {chain}")
    accuracy = check_predictions(model, valid)
    log(f"GAT training: epoch ms {epoch_ms}, step ms {step_ms}, validation "
        f"forward ms {eval_ms}, peak memory {peak_mb} MiB, train loss "
        f"{hist['train_loss']}, valid loss {hist['valid_loss']}, accuracy "
        f"{accuracy}")
    cross = cross_device_gat(graph, g_cpu, features, train, valid, dev)

    fused, counts, t0, marks, _ = fused_run(model, (train, valid), None,
                                            FUSED_BLOCK)
    runs = 2 if dev.type == "cuda" else FUSED_EPOCHS
    if counts != {k: runs * v for k, v in GAT_LAUNCHES.items()}:
        raise AssertionError(f"GAT fused: launches counted {counts}")
    fused_epoch_ms = (marks[2 * FUSED_BLOCK - 1]
                      - marks[FUSED_BLOCK - 1]) * 1e3 / FUSED_BLOCK
    host, host_counts, h0, host_marks, _ = fused_run(
        model, (train, valid), None, 1)
    if host_counts != {k: FUSED_EPOCHS * v for k, v in GAT_LAUNCHES.items()}:
        raise AssertionError(f"GAT host loop launches {host_counts}")
    rel = {}
    for key in ("train_loss", "valid_loss"):
        a, b = np.array(fused[key]), np.array(host[key])
        rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=FUSED_RTOL)
    if fused["best_epoch"] != host["best_epoch"]:
        raise AssertionError(f"GAT fused best epoch {fused['best_epoch']}, "
                             f"host loop {host['best_epoch']}")
    replay = replay_profile(
        "GAT fused", lambda primer: fused_run(model, (train, valid), None,
                                              FUSED_BLOCK, profile=True,
                                              primer=primer)[4],
        dict(walks_of(GAT_LAUNCHES), index_add=0))
    fused_out = dict(fused_epoch_ms=fused_epoch_ms,
                     host_epoch_ms=(np.diff([h0] + host_marks)
                                    * 1e3).tolist(),
                     max_rel_loss_diff=rel, best_epoch=fused["best_epoch"],
                     counted=counts, replay=replay)
    log(f"GAT fused: {fused_out}")
    return dict(serving=serving, forward=forward, epoch_ms=epoch_ms,
                step_ms=step_ms, eval_forward_ms=eval_ms, peak_mb=peak_mb,
                step_busy_ms=prof["busy_us"] / 1e3, profile=prof, chain=chain,
                launches_per_epoch=GAT_LAUNCHES, launches=train_launches,
                cross=cross,
                fused=fused_out)


def cross_device_gat(graph, g_cpu, features, train, valid, dev):
    """9: GAT at GATConfig's widths without feature or attention dropout
    (no random draw separates the devices), 3 epochs on the card and on the
    CPU from the same U(-0.1, 0.1) weights: losses within LOSS_RTOL,
    parameters by phase 4b's rules."""
    import gnntf_tpu_torch as tt

    runs, params, adam, seconds, init = {}, {}, {}, {}, None
    for device, g in ((dev, graph), ("cpu", g_cpu)):
        model = tt.GAT(g, features, num_classes=N_CLASSES, dropout=0.0,
                       attn_dropout=0.0, device=device)
        init = init_params(model, 17) if init is None else init
        adam[str(device)] = recording_adam(LEARNING_RATE)
        zero_counts()
        t0 = time.perf_counter()
        runs[str(device)] = model.train(
            train, valid, epochs=CROSS_EPOCHS, patience=100, seed=0,
            optimizer=adam[str(device)], init_params=dict(init))
        seconds[str(device)] = time.perf_counter() - t0
        want = {k: CROSS_EPOCHS * v for k, v in GAT_LAUNCHES.items()}
        if launch_counts() != (want if torch.device(device) == dev
                               else NO_LAUNCHES):
            raise AssertionError(f"GAT on {device}: launches "
                                 f"{launch_counts()}")
        params[str(device)] = {k: p.detach().cpu()
                               for k, p in model.params.items()}
    gpu, cpu = runs[str(dev)], runs["cpu"]
    log(f"GAT GPU vs CPU training, {CROSS_EPOCHS} epochs, no dropout: GPU "
        f"{gpu} ({seconds[str(dev)]} s), CPU {cpu} ({seconds['cpu']} s)")
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(gpu[key], cpu[key], rtol=LOSS_RTOL)
    worst, outside, total = compare_params("GAT training", params, adam, dev)
    return dict(max_param_diff=worst, outside=outside, elements=total,
                cpu_seconds=seconds["cpu"], gpu_seconds=seconds[str(dev)])


def phase_sage_gin(graph, features, dev):
    """10: GraphSAGE and GIN at GraphSAGEConfig and GINConfig on the bench
    graph with 40 classes: serving (K1 in each convolution of a forward),
    each forward against the CPU's with the same weights, and
    ``train(epochs=3)`` (K1 forward and its backward walk through the
    prepared operator)."""
    from gnntf_tpu_torch import config

    train, valid = fused_tasks()
    g_cpu = graph.to("cpu")
    out = {}
    for name, cfg, k1, epoch in (
            ("GraphSAGE", config.GraphSAGEConfig(), 2, SAGE_LAUNCHES),
            ("GIN", config.GINConfig(), 1, GIN_LAUNCHES)):
        build = lambda g, device, cfg=cfg: cfg.build(g, features, N_CLASSES,
                                                     device=device)
        model = build(graph, dev)
        model.reset(seed=0)
        serving, logits = serving_run(name, model,
                                      dict(NO_LAUNCHES, k1s=k1))
        forward = cpu_forward(name, build, g_cpu, logits, FORWARD_TOL)
        hist, epoch_ms, peak_mb = counted_train(model, (train, valid),
                                                SAGE_EPOCHS, epoch)
        step_ms = timed(step_fn(model, train))
        accuracy = check_predictions(model, valid)
        log(f"{name} training: epoch ms {epoch_ms}, step ms {step_ms}, peak "
            f"memory {peak_mb} MiB, train loss {hist['train_loss']}, valid "
            f"loss {hist['valid_loss']}, accuracy {accuracy}")
        out[name] = dict(serving=serving, forward=forward, epoch_ms=epoch_ms,
                         step_ms=step_ms, peak_mb=peak_mb,
                         launches_per_epoch=epoch)
    return out


# phase 11: NGCF link prediction at the configuration of
# demos/link_prediction.py (NGCF(num_classes=16): latent [16, 16], dropout
# 0.1), BPR over every edge with one negative redrawn each epoch by the C++
# sampler, validated by BCE on LP_HELD held edges with 2 negatives each
LP_CLASSES = 16
LP_HELD = 10_000
LP_EPOCHS = 3
LP_MEAN_NODES = 200
# K1 in each of NGCF's 3 convolutions of the step (F=128, 16, 16) and of the
# validation forward; the backward walk in the 2 convolutions whose input
# needs a gradient (the first one's input is the features)
LP_LAUNCHES = dict(NO_LAUNCHES, k1s=6, backward=2)
LP_REPLAY = {"ell_gather_scaled_walk": 6, "ell_gather_scaled_bwd_walk": 2,
             "blocked_spmm_walk": 0,
             "ell_gather_masked_walk": 0, DEGREE_WALK: 0,
             "index_add": 2}
# fused vs host loop on the card, NGCF without its output regularization
# (``without_output_regularization``): edge_dot's backward scatters with
# index_add_'s atomics, so the two runs' gradients differ in their last
# bits (relative ~1e-7), which 10 Adam steps leave far below this.  With
# the regularization on, each run's last bits re-roll its gradient's
# rounding noise, which Adam scales up, and the runs drift apart by more
# (logged, not held to a limit)
LP_FUSED_RTOL = 1e-4
# the card-vs-CPU run: a graph of LP_CROSS_EDGES pairs, symmetrized to at
# least 65,536 counted edges (the prepared operator's gate)
LP_CROSS_NODES, LP_CROSS_EDGES = 20_000, 40_000


def without_output_regularization(model):
    """NGCF's output regularization turned off: it is 0.5 a node and layer
    whatever the weights (each row l2-normalized), so in exact arithmetic
    its gradient is zero, and in float32 it is rounding noise that differs
    between devices and that Adam's first steps scale to whole steps."""
    for layer in model.layers():
        layer.output_regularize = 0.0
    return model


def link_tasks(tt, model, pos, graph, held, waits=None, seed=0):
    """``set_seed(seed)``, a prefetching sampler over every pair of ``pos``
    and the sampled BPR task over it (``waits`` gets each call's wait on
    the prefetch thread), and the static BCE task over ``held``."""
    edges, labels = held
    tt.set_seed(seed)
    sampler = tt.negative_sampling(pos, graph, samples=1)

    def draw():
        out = sampler()
        if waits is not None:
            waits.append(sampler.wait_seconds * 1e3)
        if not sampler.native:
            raise AssertionError("the sampler took its Python path: "
                                 f"{native_error()}")
        return out

    return (tt.LinkPrediction(draw, gnn=model, loss="diff"),
            tt.LinkPrediction(edges, labels, gnn=model, loss="bce"))


def native_error():
    from gnntf_tpu_torch.utils import native
    return native.error


def edge_dot_ms(model, train):
    """Device ms of the step's edge_dot, forward and backward, on the
    model's activations and the task's current edges."""
    from gnntf_tpu_torch.ops import edge_dot
    with torch.no_grad():
        acts = model.forward(model.features)
    x = acts.clone().requires_grad_()
    y = acts.clone().requires_grad_()
    edges = train.batch()[0].to(acts.device)
    u, v = edges[:, 0], edges[:, 1]
    return time_ms(lambda: torch.autograd.grad(edge_dot(u, v, x, y).sum(),
                                               [x, y]))


def phase_link_prediction(graph, src, dst, features, dev):
    """11: NGCF link prediction at full width: the native sampler over every
    edge, 3 epochs of the host loop (6 K1 and 2 backward walks an epoch),
    a step profile, evaluate's AUC, ``fit(block_epochs=5)`` against the
    host loop at ``epochs=10`` with a replay profile (as configured, then
    checked without the output regularization), MeanLinkPrediction over
    LP_MEAN_NODES nodes, and 3 epochs without dropout on the card and on
    the CPU on a smaller graph."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.utils import native

    pos = np.stack([src, dst], 1)
    model = tt.NGCF(graph, features, num_classes=LP_CLASSES, device=dev)
    tt.set_seed(0)
    held_pos = pos[np.random.RandomState(21).choice(len(pos), LP_HELD,
                                                    replace=False)]
    t1 = time.perf_counter()
    once = tt.negative_sampling(held_pos, graph, samples=2, prefetch=False)
    held = once()
    sync = tt.negative_sampling(pos, graph, samples=1, prefetch=False)
    sampler_build_s = time.perf_counter() - t1
    sampler_ms = []
    for _ in range(3):
        t1 = time.perf_counter()
        sync()
        sampler_ms.append((time.perf_counter() - t1) * 1e3)
    if not (once.native and sync.native and native.available()):
        raise AssertionError(f"the native sampler did not run: "
                             f"{native.error}")
    del sync
    log(f"link prediction: {len(pos)} positive pairs, "
        f"{2 * len(pos)} scored pairs an epoch, {len(held[0])} validation "
        f"pairs; sampler set-up {sampler_build_s} s, one sampler call ms "
        f"{sampler_ms} (C++ path)")

    waits = []
    train, valid = link_tasks(tt, model, pos, graph, held, waits)
    hist, epoch_ms, peak_mb = counted_train(model, (train, valid), LP_EPOCHS,
                                            LP_LAUNCHES)
    train_waits = waits[1:]  # the first call, at the task's construction,
    step = step_fn(model, train)  # joins no thread
    step_ms = timed(step)
    prof = profile_step(step, top=12)
    want = dict(NO_LAUNCHES, k1s=3, backward=2)
    if prof["counted"] != want or prof["index_add_launches"] != 2 or \
            prof["k1s_walks"] != 3:
        raise AssertionError(f"NGCF step: launches {prof['counted']} "
                             f"(expected {want}), index_add_ "
                             f"{prof['index_add_launches']} (expected 2, "
                             f"edge_dot's backward), K1 walks "
                             f"{prof['k1s_walks']}")
    dot_ms = edge_dot_ms(model, train)
    auc = float(model.evaluate(valid))
    if not 0.0 <= auc <= 1.0:
        raise AssertionError(f"AUC {auc}")
    log(f"NGCF link prediction host loop: epoch ms {epoch_ms}, sampler "
        f"wait ms an epoch {train_waits}, step ms {step_ms}, step busy "
        f"{prof['busy_us'] / 1e3} ms, edge_dot forward+backward "
        f"{dot_ms} ms ({dot_ms / (prof['busy_us'] / 1e3)} of the step's "
        f"busy time), peak memory {peak_mb} MiB, train loss "
        f"{hist['train_loss']}, valid loss {hist['valid_loss']}, AUC {auc}")

    # the fused stacked path against the host loop, from the same draws:
    # NGCF as configured (timed; its runs drift apart, LP_FUSED_RTOL), then
    # without the output regularization (held within LP_FUSED_RTOL)
    fused_waits, pair = [], {}
    for regularized in (True, False):
        if not regularized:
            without_output_regularization(model)
        torch.cuda.reset_peak_memory_stats()
        pair[regularized] = {block: fused_run(model, link_tasks(
            tt, model, pos, graph, held,
            fused_waits if block > 1 and regularized else None, seed=1),
            None, block) for block in (FUSED_BLOCK, 1)}
        if regularized:
            fused_peak_mb = torch.cuda.max_memory_allocated() / 2**20
            replay = replay_profile(
                "NGCF fused", lambda primer: fused_run(
                    model, link_tasks(tt, model, pos, graph, held, seed=1),
                    None, FUSED_BLOCK, profile=True, primer=primer)[4],
                LP_REPLAY)
    fused_runs = 2 if dev.type == "cuda" else FUSED_EPOCHS
    drift = {}
    for regularized, runs in pair.items():
        (fused, counts, _, marks, _), (host, host_counts, h0, host_marks,
                                       _) = runs[FUSED_BLOCK], runs[1]
        if counts != {k: fused_runs * v for k, v in LP_LAUNCHES.items()} or \
                host_counts != {k: FUSED_EPOCHS * v
                                for k, v in LP_LAUNCHES.items()}:
            raise AssertionError(f"NGCF fused launches {counts}, host loop "
                                 f"{host_counts}")
        rel = {}
        for key in ("train_loss", "valid_loss"):
            a, b = np.array(fused[key]), np.array(host[key])
            if not (np.isfinite(a).all() and np.isfinite(b).all()):
                raise AssertionError(f"NGCF fused losses {fused}, host {host}")
            rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        name = "as configured" if regularized else \
            "output regularization off"
        drift[name] = rel
        log(f"NGCF fused vs host loop ({name}): fused {fused}, host {host}, "
            f"max relative loss difference {rel}")
        if regularized:
            fused_epoch_ms = (marks[2 * FUSED_BLOCK - 1]
                              - marks[FUSED_BLOCK - 1]) * 1e3 / FUSED_BLOCK
            host_epoch_ms = (np.diff([h0] + host_marks) * 1e3).tolist()
            fused_counts = counts
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(fused[key], host[key], rtol=LP_FUSED_RTOL)
    if fused["best_epoch"] != host["best_epoch"]:
        raise AssertionError(f"NGCF fused best epoch {fused['best_epoch']}, "
                             f"host loop {host['best_epoch']}")
    log(f"NGCF fused: epoch {fused_epoch_ms} ms (second block, wall, its "
        f"{FUSED_BLOCK} draws stacked and uploaded before it), device busy "
        f"{replay['busy_ms_per_epoch']} ms an epoch; host loop epoch ms "
        f"{host_epoch_ms}; sampler waits in the fused run ms {fused_waits}; "
        f"peak memory {fused_peak_mb} MiB; fused vs host loop {drift} "
        f"(limit {LP_FUSED_RTOL} without the output regularization)")

    t0_mean = time.perf_counter()
    nodes = list(dict.fromkeys(int(u) for u in held_pos[:, 0]))[
        :LP_MEAN_NODES]
    mean = tt.MeanLinkPrediction(held_pos, np.ones(len(held_pos)),
                                 gnn=model, graph=graph,
                                 positive_nodes=nodes, k=5)
    f1 = model.evaluate(mean)
    mean_s = time.perf_counter() - t0_mean
    if not 0.0 <= f1 <= 1.0:
        raise AssertionError(f"mean F1 {f1}")
    log(f"MeanLinkPrediction(k=5) over {len(nodes)} nodes: mean F1@5 {f1} "
        f"in {mean_s} s")
    cross = cross_device_link_prediction(dev)
    return dict(pairs=2 * len(pos), sampler_ms=sampler_ms,
                sampler_build_s=sampler_build_s, epoch_ms=epoch_ms,
                sampler_wait_ms=train_waits, step_ms=step_ms,
                step_busy_ms=prof["busy_us"] / 1e3, profile=prof,
                edge_dot_ms=dot_ms,
                edge_dot_share=dot_ms / (prof["busy_us"] / 1e3),
                peak_mb=peak_mb, auc=auc, train_loss=hist["train_loss"],
                valid_loss=hist["valid_loss"],
                launches_per_epoch=LP_LAUNCHES,
                fused=dict(fused_epoch_ms=fused_epoch_ms,
                           host_epoch_ms=host_epoch_ms,
                           max_rel_loss_diff=drift,
                           best_epoch=fused["best_epoch"],
                           counted=fused_counts,
                           replay=replay, sampler_wait_ms=fused_waits,
                           peak_mb=fused_peak_mb),
                mean_f1=f1, mean_s=mean_s, cross=cross)


def cross_device_link_prediction(dev):
    """11: NGCF link prediction without dropout and without its output
    regularization (``without_output_regularization``), 3 epochs on the
    card and on the CPU from the same weights and one static draw of the
    sampler, on a graph of LP_CROSS_EDGES pairs: losses within LOSS_RTOL,
    parameters by phase 4b's rules."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges

    src, dst = random_power_law_edges(LP_CROSS_NODES, LP_CROSS_EDGES, seed=2)
    g_cpu = tt.from_edges(src, dst, n_nodes=LP_CROSS_NODES, directed=False,
                          device="cpu")
    if g_cpu.n_edges < 65_536:
        raise AssertionError(f"{g_cpu.n_edges} counted edges: below the "
                             "prepared operator's gate")
    features = np.random.RandomState(22).randn(
        LP_CROSS_NODES, N_FEATURES).astype(np.float32)
    pos = np.stack([src, dst], 1)
    tt.set_seed(3)
    draw = tt.negative_sampling(pos, g_cpu, samples=1, prefetch=False)()
    held = tt.negative_sampling(pos[:2000], g_cpu, samples=2,
                                prefetch=False)()
    runs, params, adam, seconds = {}, {}, {}, {}
    for device, g in ((dev, g_cpu.to(dev)), ("cpu", g_cpu)):
        model = without_output_regularization(tt.NGCF(
            g, features, num_classes=LP_CLASSES, dropout=0.0, device=device))
        train = tt.LinkPrediction(*draw, gnn=model, loss="diff")
        valid = tt.LinkPrediction(*held, gnn=model, loss="bce")
        adam[str(device)] = recording_adam(LEARNING_RATE)
        zero_counts()
        t0 = time.perf_counter()
        runs[str(device)] = model.train(
            train, valid, epochs=CROSS_EPOCHS, patience=100, seed=0,
            optimizer=adam[str(device)])
        seconds[str(device)] = time.perf_counter() - t0
        want = {k: CROSS_EPOCHS * v for k, v in LP_LAUNCHES.items()}
        if launch_counts() != (want if torch.device(device) == dev
                               else NO_LAUNCHES):
            raise AssertionError(f"NGCF on {device}: launches "
                                 f"{launch_counts()}")
        params[str(device)] = {k: p.detach().cpu()
                               for k, p in model.params.items()}
    gpu, cpu = runs[str(dev)], runs["cpu"]
    log(f"NGCF link prediction GPU vs CPU, {CROSS_EPOCHS} epochs, "
        f"{g_cpu.n_edges} counted edges, no dropout: GPU {gpu} "
        f"({seconds[str(dev)]} s), CPU {cpu} ({seconds['cpu']} s)")
    for key in ("train_loss", "valid_loss"):
        np.testing.assert_allclose(gpu[key], cpu[key], rtol=LOSS_RTOL)
    worst, outside, total = compare_params(
        "NGCF link prediction training", params, adam, dev)
    return dict(counted_edges=g_cpu.n_edges, max_param_diff=worst,
                outside=outside, elements=total, gpu=gpu, cpu=cpu,
                cpu_seconds=seconds["cpu"], gpu_seconds=seconds[str(dev)])


# phase 12: remat and resume
REMAT_EPOCHS = 2
RESUME_EPOCHS, RESUME_CUT = 6, 3


def trained(model, tasks, **kw):
    """``model.train(*tasks, patience=100, seed=0, **kw)``: the history,
    the parameters on the host and the peak memory (MiB) of the run."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = model.train(*tasks, patience=100, seed=0, **kw)
    peak = torch.cuda.max_memory_allocated() / 2**20
    return hist, {k: p.detach().cpu() for k, p in model.params.items()}, peak


def same_params(a, b):
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def phase_remat_resume(graph, features, dev):
    """12: GCNII-64 at GCNIIConfig trained REMAT_EPOCHS epochs with and
    without remat (dropout on, the same seed): equal histories and
    parameters, and each run's peak memory; APPNP under the default impl
    stopped after RESUME_CUT epochs and resumed from its checkpoint,
    against RESUME_EPOCHS epochs straight through, on the host loop and
    the fused path: equal histories and parameters."""
    import tempfile

    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch import config
    from gnntf_tpu_torch.utils import kernels

    tasks = fused_tasks()
    model = config.GCNIIConfig().build(graph, features, N_CLASSES,
                                       device=dev)
    model.train(*tasks, epochs=1, seed=0)  # builds the operator and lists
    remat = {flag: trained(model, tasks, epochs=REMAT_EPOCHS, remat=flag)
             for flag in (False, True)}
    (h0, p0, peak0), (h1, p1, peak1) = remat[False], remat[True]
    log(f"GCNII-64 remat: without {h0} peak {peak0} MiB; with {h1} peak "
        f"{peak1} MiB")
    if h0 != h1 or not same_params(p0, p1):
        raise AssertionError("GCNII-64 with remat differs from without")
    del model

    appnp = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
    resume = {}
    for block in (1, RESUME_CUT):
        straight = trained(appnp, tasks, epochs=RESUME_EPOCHS,
                           block_epochs=block)
        kernels.BUILD.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=kernels.BUILD) as ckpt:
            kw = dict(block_epochs=block, checkpoint_dir=ckpt,
                      checkpoint_every=RESUME_CUT)
            first = trained(appnp, tasks, epochs=RESUME_CUT, **kw)
            later = trained(appnp, tasks, epochs=RESUME_EPOCHS, resume=True,
                            **kw)
        joined = {k: first[0][k] + later[0][k]
                  for k in ("train_loss", "valid_loss")}
        equal = (joined == {k: straight[0][k] for k in joined}
                 and later[0]["best_epoch"] == straight[0]["best_epoch"]
                 and same_params(later[1], straight[1]))
        name = "host loop" if block == 1 else "fused"
        log(f"APPNP resume ({name}): straight {straight[0]}, stopped "
            f"{first[0]}, resumed {later[0]}; equal {equal}")
        if not equal:
            raise AssertionError(f"APPNP resumed ({name}) differs from the "
                                 "uninterrupted run")
        resume[name] = dict(train_loss=straight[0]["train_loss"],
                            valid_loss=straight[0]["valid_loss"])
    return dict(remat=dict(equal=True, peak_mib=peak1, plain_peak_mib=peak0,
                           train_loss=h1["train_loss"]),
                resume=resume)


# phase 14: single-host scale-out.  The card machine has one GPU, so the
# per-rank products run in one process over each rank's lists (the table a
# halo exchange would fill, built in the process) and fit(mesh=) runs over
# NCCL at world size 1; no multi-GPU figure exists.
MESH_PARTS = 4
MESH_KEEP = 0.9
MESH_EPOCHS = 5
# Cora's scale: 2,708 nodes, 5,278 undirected edges (10,556 counted)
CORA_NODES, CORA_EDGES, CORA_CLASSES = 2708, 5278, 7


def check_rank_walk(label, lst, val, draw, x):
    """One rank's walk over ``lst`` against its plain version on the card:
    K2's store-mode walk with the realized values, or K1's masked walk
    under ``draw``; timed (CUDA events over back-to-back calls, and one
    call's device time from a profile) beside ``torch.sparse.mm`` of the
    rank's block."""
    if draw is None:
        return check_blocked_kernel(label, lst, val, x, library=True)
    return check_masked_kernel(f"masked walk {label}", lst, val, draw, x,
                               library=True)


def phase_mesh_products(graph, dev, x40):
    """14a: the bench graph cut into MESH_PARTS parts by the halo and the
    ring plans; each rank's local and remote lists and its ring groups
    walked at F=40 against their plain versions, with realized values and
    with a lazy draw (keep MESH_KEEP) hashed by global edge id."""
    from gnntf_tpu_torch.ops import stochastic
    from gnntf_tpu_torch.parallel import (build_halo_partition,
                                          build_ring_partition)
    from gnntf_tpu_torch.parallel.halo import halo_lists, rank_table
    from gnntf_tpu_torch.parallel.ring import ring_lists

    t0 = time.perf_counter()
    halo = build_halo_partition(graph, MESH_PARTS)
    ring = build_ring_partition(graph, MESH_PARTS)
    plan_s = time.perf_counter() - t0
    val = graph.val.to(torch.float32).contiguous()
    salt = stochastic.device_salt(torch.tensor([0x2545F491, 0x9E3779B9]),
                                  dev)
    draw = (salt, MESH_KEEP, graph.n_edges)
    nr = halo.rows_per_part
    xp = torch.cat([x40, x40.new_zeros(halo.padded_nodes - N_NODES, 40)])
    stats = dict(halo_size=halo.halo_size, hub_rows=halo.hub_rows,
                 halo_bytes_per_device=halo.halo_bytes_per_device,
                 rows_per_part=nr, plan_seconds=plan_s, ranks=[])
    walks = []
    for r in range(MESH_PARTS):
        t0 = time.perf_counter()
        local, remote, _, _ = halo_lists(halo, r, dev)
        groups = ring_lists(ring, r, dev)
        lists_s = time.perf_counter() - t0
        own, table = rank_table(halo, x40, r)
        inputs = [("halo local", local, own), ("halo remote", remote, table)]
        inputs += [(f"ring step {s}", groups[s], xp[
            ((r + s) % MESH_PARTS) * nr:((r + s) % MESH_PARTS + 1) * nr])
            for s in range(MESH_PARTS)]
        edges = {}
        for name, lists, x in inputs:
            edges[name] = 0 if lists is None else lists[0].n_edges
            if lists is None:
                continue
            for mode, d in (("realized", None), ("lazy", draw)):
                res = check_rank_walk(f"rank {r} {name} ({mode})", lists[0],
                                      val, d, x.contiguous())
                walks.append(dict(res, rank=r, list=name, mode=mode,
                                  edges=lists[0].n_edges))
        stats["ranks"].append(dict(rank=r, edges=edges,
                                   list_seconds=lists_s))
    log(f"mesh partitions at P={MESH_PARTS}: {stats}")
    return dict(stats=stats, walks=walks)


def mesh_epoch_profile(model, tasks, executor):
    """Device busy and wall microseconds of one epoch's work (the step and
    the validation forward) under ``executor``."""
    from gnntf_tpu_torch.train.trainer import _scope, _train_step, keras_adam

    tx = keras_adam(LEARNING_RATE)
    state = tx.init({k: p.detach() for k, p in model.params.items()})
    names = list(model.params)
    deg = torch.tensor(1.0)

    def epoch():
        with _scope(None, executor):
            _train_step(model, tasks[0], tasks[0].batch(), 5e-4,
                        torch.Generator().manual_seed(9), False, names, tx,
                        state, deg)
            with torch.no_grad():
                acts = model.forward(model.features, training=False)
                tasks[1].loss(acts, tasks[1].batch())

    epoch()
    rows, busy_us, wall_us, counted = device_profile(epoch)
    return dict(busy_us=busy_us, wall_us=wall_us, counted=counted)


def timed_train(model, tasks, **kw):
    """``model.train(*tasks, patience=100, seed=0, **kw)`` with the counts
    zeroed just before and read just after: the history, the counts, and
    the wall seconds of each epoch (host clock after a synchronize)."""
    marks = []

    def mark(**_):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    hist = model.train(*tasks, patience=100, seed=0, callbacks=[mark], **kw)
    counts = launch_counts()
    return hist, counts, list(np.diff([t0] + marks))


def phase_mesh_train(graph, features, dev):
    """14b and 14c: APPNP at its defaults on the bench graph (dropout on),
    fit(mesh=make_mesh(1, 1), spmm=s) over NCCL at world size 1 for s in
    None, "halo", "ring", MESH_EPOCHS epochs, each against fit() on one
    device from the same seed: losses within FUSED_RTOL, the same best
    epoch; the launches of each run (counts zeroed just before, read just
    after), its epochs' wall seconds and one epoch's device busy time.
    Then fit(mesh=, block_epochs=MESH_EPOCHS) against the host loop's mesh
    run."""
    import torch.distributed as dist

    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.parallel import free_port, make_mesh
    from gnntf_tpu_torch.parallel.dist import executor_for

    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh(1, 1)
        tasks = fused_tasks()
        runs = {}
        model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
        single = timed_train(model, tasks, epochs=MESH_EPOCHS)
        for spmm in (None, "halo", "ring"):
            hist, counts, walls = timed_train(
                model, tasks, epochs=MESH_EPOCHS, mesh=mesh, spmm=spmm)
            name = spmm or "gspmd"
            for key in ("train_loss", "valid_loss"):
                if not np.allclose(hist[key], single[0][key],
                                   rtol=FUSED_RTOL, atol=0):
                    raise AssertionError(f"fit(mesh, spmm={spmm}) {key} "
                                         f"{hist[key]} vs one device "
                                         f"{single[0][key]}")
            if hist["best_epoch"] != single[0]["best_epoch"]:
                raise AssertionError(f"fit(mesh, spmm={spmm}): best epoch "
                                     f"{hist['best_epoch']} vs "
                                     f"{single[0]['best_epoch']}")
            for kernel in ("k2", "masked", "degree"):
                if counts[kernel] == 0:
                    raise AssertionError(f"fit(mesh, spmm={spmm}) launched "
                                         f"no {kernel} walk")
            profile = mesh_epoch_profile(model, tasks,
                                         executor_for(mesh, spmm))
            runs[name] = dict(
                train_loss=hist["train_loss"], valid_loss=hist["valid_loss"],
                launches=counts, launches_per_epoch={
                    k: v / MESH_EPOCHS for k, v in counts.items()},
                epoch_wall_s=walls, epoch_busy_us=profile["busy_us"],
                epoch_profile_wall_us=profile["wall_us"])
            log(f"fit(mesh=1x1, spmm={spmm}) over {backend}: losses "
                f"{hist['train_loss']}, valid {hist['valid_loss']}, best "
                f"epoch {hist['best_epoch']}; one device: "
                f"{single[0]['train_loss']}; epoch walls {walls} s; one "
                f"epoch's device busy {profile['busy_us']} us of "
                f"{profile['wall_us']} us; launches {counts}")
        runs["single"] = dict(train_loss=single[0]["train_loss"],
                              valid_loss=single[0]["valid_loss"],
                              launches=single[1], epoch_wall_s=single[2])
        runs["fused"] = mesh_fused(model, tasks, mesh, runs["gspmd"])
    finally:
        dist.destroy_process_group()
    return runs


def mesh_fused(model, tasks, mesh, host):
    """14c: fit(mesh=, block_epochs=MESH_EPOCHS) against the host loop's
    gspmd run: losses within FUSED_RTOL."""
    hist, counts, walls = timed_train(model, tasks, epochs=MESH_EPOCHS,
                                      mesh=mesh, block_epochs=MESH_EPOCHS)
    for key in ("train_loss", "valid_loss"):
        if not np.allclose(hist[key], host[key], rtol=FUSED_RTOL, atol=0):
            raise AssertionError(f"fused fit(mesh) {key} {hist[key]} vs the "
                                 f"host loop's {host[key]}")
    log(f"fused fit(mesh=1x1, block_epochs={MESH_EPOCHS}): losses "
        f"{hist['train_loss']}, block wall {sum(walls)} s, launches {counts}")
    return dict(train_loss=hist["train_loss"], launches=counts,
                block_wall_s=sum(walls))


def mesh_entry(products, train, mode, key):
    """A ``kernels`` entry's phase 14 part: each rank's walks at
    P=MESH_PARTS (``mode``: realized or lazy) and the launches (``key``)
    of each executor's fit(mesh=) run at world size 1."""
    fields = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
              "bound_by", "library_ms")
    return dict(
        parts=MESH_PARTS, world_size=1,
        walks=[dict(rank=w["rank"], list=w["list"], edges=w["edges"],
                    **{k: w[k] for k in fields})
               for w in products["walks"] if w["mode"] == mode],
        launches={name: train[name]["launches"][key]
                  for name in ("gspmd", "halo", "ring")},
        fused_launches=train["fused"]["launches"][key])


WALK_FIELDS = ("max_abs_err", "ms", "device_ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def multihost_launches(multihost, key):
    """A kernel's launches (its wrapper's count) in each of phase 15c's
    runs at world size 1."""
    return dict(hier=multihost["hier"]["launches"][key],
                hier_fused=multihost["hier_fused"]["launches"][key],
                gat_gspmd=multihost["gat"]["launches"][key],
                shard=multihost["shard"]["launches"][key])


def slice_entry(slices, multihost, key):
    """A ``kernels`` entry's phase 15b part: each gspmd slice's degree walk
    (``key`` "degree") or attention kernel ``key`` at P=MESH_PARTS, the
    merged result's error, and the launches of 15c's runs."""
    if key == "degree":
        return dict(parts=MESH_PARTS, merged_max_abs_err=slices["degree_err"],
                    walks=[{k: w[k] for k in ("rank", "edges") + WALK_FIELDS}
                           for w in slices["degree"]],
                    launches=multihost_launches(multihost, key))
    return dict(parts=MESH_PARTS,
                shape=f"H=8 F=8, per-edge lists with global ids, attention "
                      f"dropout keep {ATTN_KEEP}",
                merged_max_abs_err=slices["merged_err"],
                ranks=[dict(rank=a["rank"], slots=a["slots"], **a[key])
                       for a in slices["attention"]],
                launches=multihost_launches(multihost, key))


def hier_entry(products, multihost, mode, key):
    """A ``kernels`` entry's phase 15 part: each rank's walks under the
    hierarchical plan (``mode``: realized or lazy) and the launches of
    15c's runs."""
    return dict(
        hosts=HIER_HOSTS, chips=HIER_CHIPS, world_size=1,
        plan={k: v for k, v in products["stats"].items() if k != "ranks"},
        walks=[dict(rank=w["rank"], list=w["list"], edges=w["edges"],
                    **{k: w[k] for k in WALK_FIELDS})
               for w in products["walks"] if w["mode"] == mode],
        launches=multihost_launches(multihost, key))


def small_graph_walks(name, graph, dev):
    """K2 over one Cora-scale graph's normalized lists at F=1 (over a
    column of ones: the degree walk), CORA_CLASSES and 64, both ways: the
    lists as the program cuts them (``blocked_layout``, units of
    ``unit_items``) and cut at 128 items (``BlockedSpMM(items=128)``, the
    cut before ``unit_items``), each against its plain version and timed
    (events, and one call's device time by kernel from a profile); the
    program's cut equal bit for bit to the plain version on the CPU; the
    ``index_add_`` route that the walk replaced (and at F=1 ``index_add_``
    of the values, the degrees' route)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import blocked_spmm, blocked_spmm_plain
    from gnntf_tpu_torch.ops.blocked import (BlockedSpMM, blocked_layout,
                                             graph_lists)

    adj = tt.normalize_adjacency(graph)
    val = adj.val.to(torch.float32).contiguous()
    row, col = adj.row, adj.col
    lists = graph_lists(row.cpu().numpy(), col.cpu().numpy(), CORA_NODES)
    cuts = {cut: (prep.forward, prep.transposed) for cut, prep in (
        ("new", blocked_layout(adj)),
        ("items_128", BlockedSpMM(lists, dev, items=128)),
        ("cpu", BlockedSpMM(lists, "cpu")))}
    out = dict(edges=graph.n_edges)
    for cut in ("new", "items_128"):
        out[f"{cut}_lists"] = [dict(units=lst.n_units,
                                    split_rows=int(lst.split.shape[0]),
                                    pieces=int(lst.split[:, 2].sum()))
                               for lst in cuts[cut]]
    for f in (1, CORA_CLASSES, 64):
        x = (torch.ones(CORA_NODES, 1, device=dev) if f == 1 else
             torch.from_numpy(np.random.RandomState(f).randn(
                 CORA_NODES, f).astype(np.float32)).to(dev))
        res = {}
        for way, k, dst, src in (("", 0, row, col), ("_t", 1, col, row)):
            lst = cuts["new"][k]
            res["walk" + way] = check_blocked_kernel(
                f"Cora-scale {name} walk{way} F={f}", lst, val, x,
                library=True)
            res["items_128" + way] = check_blocked_kernel(
                f"Cora-scale {name} walk{way} F={f}, units of 128 items",
                cuts["items_128"][k], val, x)
            same = torch.equal(blocked_spmm(lst, val, x).cpu(),
                               blocked_spmm_plain(cuts["cpu"][k], val.cpu(),
                                                  x.cpu()))
            if not same:
                raise AssertionError(f"Cora-scale {name} walk{way} F={f} "
                                     "differs from the CPU plain version")
            res["bit_equal_to_cpu_plain" + way] = same
            call = lambda dst=dst, src=src: torch.zeros_like(x).index_add_(
                0, dst, x[src] * val[:, None])
            res["index_add" + way + "_ms"] = time_ms(call)
            res["index_add" + way + "_device_ms"] = device_profile(
                call)[1] / 1e3
            if f == 1:
                call = lambda dst=dst: torch.zeros(
                    CORA_NODES, device=dev).index_add_(0, dst, val)
                res["degree_index_add" + way + "_ms"] = time_ms(call)
                res["degree_index_add" + way + "_device_ms"] = \
                    device_profile(call)[1] / 1e3
        log(f"Cora-scale {name} F={f}: one call's device time, walk "
            f"{res['walk']['device_ms']} ms (A^T {res['walk_t']['device_ms']}"
            f"), units of 128 items {res['items_128']['device_ms']} ms (A^T "
            f"{res['items_128_t']['device_ms']}); index_add_ route "
            f"{res['index_add_device_ms']} ms (A^T "
            f"{res['index_add_t_device_ms']})")
        out[f"F{f}"] = res
    return out


def phase_small_graphs(dev):
    """14d: F7 on the card.  At Cora's scale two identical runs of APPNP
    and of GAT (5 epochs, every dropout on) are bit-equal, K2 launches in
    APPNP's runs, and a profiled step of each launches no index_add_
    kernel (APPNP's K2 walks all narrow); K2's walk over each Cora-scale
    graph's lists (``small_graph_walks``)."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges

    graph, features, tasks = cora_graph(dev)
    # hub rows longer than any unit, so rows split
    power_law = tt.from_edges(*random_power_law_edges(
        CORA_NODES, CORA_EDGES, seed=0), n_nodes=CORA_NODES, directed=False,
        device=dev)
    out = dict(edges=graph.n_edges)
    for name in ("APPNP", "GAT"):
        runs = []
        zero_counts()
        for _ in range(2):
            model = getattr(tt, name)(graph, features,
                                      num_classes=CORA_CLASSES, device=dev)
            hist = model.train(*tasks, epochs=5, seed=1)
            runs.append((hist, {k: p.detach().cpu()
                                for k, p in model.params.items()}))
        launches = launch_counts()
        equal = runs[0][0] == runs[1][0] and same_params(runs[0][1],
                                                         runs[1][1])
        step = step_fn(model, tasks[0])
        profile = profile_step(step)
        log(f"{name} at Cora's scale: two runs bit-equal {equal}; launches "
            f"{launches}; step profile: {profile['index_add_launches']} "
            f"index_add_ launches, {profile['k2_walks']} K2 walks, "
            f"{profile['narrow_walks']} of them narrow")
        if not equal:
            raise AssertionError(f"two identical {name} runs differ")
        if profile["index_add_launches"]:
            raise AssertionError(f"a {name} step at Cora's scale launches "
                                 "index_add_")
        if name == "APPNP" and not (
                launches["k2"] > 0 and profile["k2_walks"] > 0
                and profile["narrow_walks"] == profile["k2_walks"]):
            raise AssertionError(f"APPNP at Cora's scale: K2 launches "
                                 f"{launches['k2']}, step walks "
                                 f"{profile['k2_walks']} (narrow "
                                 f"{profile['narrow_walks']})")
        out[name] = dict(losses=runs[0][0]["train_loss"],
                         launches=launches,
                         step_busy_us=profile["busy_us"],
                         step_wall_us=profile["wall_us"],
                         step_k2_walks=profile["k2_walks"],
                         step_narrow_walks=profile["narrow_walks"],
                         step_k2_share=profile["shares"]["k2"],
                         step_ms=time_ms(step, reps=10))
    out["graphs"] = {name: small_graph_walks(name, g, dev) for name, g in
                     (("uniform", graph), ("power_law", power_law))}
    out["card"] = nvidia_smi("name,power.limit")
    log(f"14d's walks timed on {out['card']}")
    return out


# phase 15: multi-process scale-out.  The card machine has one GPU: the
# hierarchical plan's per-rank walks (2 hosts x 2 chips) and the gspmd
# slices' degree walks and A1-A4 run in one process, each rank's on its own
# lists (15a, 15b); launch_distributed, make_pod_mesh and fit(mesh=) run
# over NCCL at world size 1 (15c).  No multi-GPU figure exists.
HIER_HOSTS = HIER_CHIPS = 2
GAT_MESH_EPOCHS = 3
SHARD_STEPS = 5


def phase_hier_products(graph, dev, x40):
    """15a: the bench graph under build_hier_halo_partition(graph, 2, 2):
    each partition's local and remote lists walked at F=40 against their
    plain versions, with realized values (K2) and a lazy draw (keep
    MESH_KEEP, K1's masked walk hashed by global edge id), over the tables
    the three phases and the hub gather would fill (built in the process);
    the plan's sizes beside the flat plan's at P=4."""
    from gnntf_tpu_torch.ops import stochastic
    from gnntf_tpu_torch.parallel import (build_halo_partition,
                                          build_hier_halo_partition)
    from gnntf_tpu_torch.parallel.hier_halo import hier_lists, hier_rank_table

    t0 = time.perf_counter()
    hier = build_hier_halo_partition(graph, HIER_HOSTS, HIER_CHIPS)
    plan_s = time.perf_counter() - t0
    flat = build_halo_partition(graph, HIER_HOSTS * HIER_CHIPS)
    val = graph.val.to(torch.float32).contiguous()
    salt = stochastic.device_salt(torch.tensor([0x2545F491, 0x9E3779B9]),
                                  dev)
    draw = (salt, MESH_KEEP, graph.n_edges)
    stats = dict(s1=hier.s1, s2=hier.s2, s3=hier.s3, hub_rows=hier.hub_rows,
                 dcn_rows_per_device=hier.dcn_rows_per_device,
                 table_rows=hier.table_rows, rows_per_part=hier.rows_per_part,
                 plan_seconds=plan_s,
                 flat=dict(halo_size=flat.halo_size, hub_rows=flat.hub_rows,
                           rows_per_device=flat.n_parts * flat.halo_size,
                           table_rows=flat.table_rows),
                 ranks=[])
    if hier.dcn_rows_per_device > flat.n_parts * flat.halo_size:
        raise AssertionError(f"the hierarchical plan sends more rows "
                             f"between hosts than the flat one: {stats}")
    walks = []
    for h in range(HIER_HOSTS):
        for c in range(HIER_CHIPS):
            r = h * HIER_CHIPS + c
            lists = hier_lists(hier, h, c, dev)
            own, table = hier_rank_table(hier, x40, h, c)
            edges = {}
            for name, lst, x in (("hier local", lists[0], own),
                                 ("hier remote", lists[1], table)):
                edges[name] = 0 if lst is None else lst[0].n_edges
                if lst is None:
                    continue
                for mode, d in (("realized", None), ("lazy", draw)):
                    res = check_rank_walk(f"rank {r} {name} ({mode})",
                                          lst[0], val, d, x.contiguous())
                    walks.append(dict(res, rank=r, list=name, mode=mode,
                                      edges=lst[0].n_edges))
            stats["ranks"].append(dict(rank=r, edges=edges))
    log(f"hierarchical plan at {HIER_HOSTS}x{HIER_CHIPS}: {stats}")
    return dict(stats=stats, walks=walks)


def phase_gspmd_slices(graph, dev):
    """15b: the bench graph's gspmd slices at P=MESH_PARTS: each rank's
    degree walk over its slice's column list (a lazy draw, keep MESH_KEEP,
    hashed at its id base plus its ids) and A1-A4 over its slice of GAT's
    self-looped graph (GATConfig's layer 1, H=8 F=8, per-edge lists with
    attention dropout keep ATTN_KEEP), each against its plain version and
    timed; A3 with the merged rowdot against its plain version; then the
    MESH_PARTS partials merged in the process (ops.attention.folded) against
    the whole graph's degree walk and chain within KERNEL_RTOL of the sum of
    the terms' magnitudes."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.ops import attention as pa
    from gnntf_tpu_torch.ops import blocked_spmm_plain, stochastic
    from gnntf_tpu_torch.parallel.dist import RankSlice

    def slices(g):
        per = -(-g.n_edges // MESH_PARTS)
        return [RankSlice(g.row[r * per:(r + 1) * per],
                          g.col[r * per:(r + 1) * per], r * per, r * per,
                          g.n_nodes, dev) for r in range(MESH_PARTS)]

    salt = stochastic.device_salt(torch.tensor([0x2545F491, 0x9E3779B9]),
                                  dev)
    draw = (salt, MESH_KEEP, graph.n_edges)
    val = graph.val.to(torch.float32).contiguous()
    degree, parts = [], []
    for r, sl in enumerate(slices(graph)):
        cols = sl.grids()[1]
        vs = sl.values(graph)
        res = check_masked_kernel(f"rank {r} gspmd slice degree walk", cols,
                                  vs, draw + (sl.base,), library="csr")
        degree.append(dict(res, rank=r, edges=sl.n_edges))
        parts.append(stochastic.ell_degree_masked(cols, vs, *draw, sl.base))
    whole_cols = stochastic.train_grids(graph).lists(dev)[1]
    whole = stochastic.ell_degree_masked(whole_cols, val, *draw)
    w = stochastic.drawn_values(val, *draw)
    scale = blocked_spmm_plain(whole_cols, w.abs(),
                               torch.ones(N_NODES, 1, device=dev))[:, 0]
    degree_err = check_close("gspmd degrees merged from the slices",
                             pa.folded(parts, "sum"), whole, scale)

    looped = tt.add_self_loops(graph)
    heads, feats = GAT_SHAPES[0]
    h, ss, sd, g = attn_inputs(N_NODES, heads, feats, dev, 28)
    salt2 = torch.tensor([0x9E3779B9, 77], device=dev)
    lists = [sl.attention(dedup=False) for sl in slices(looped)]
    whole_lists = pa._attn_lists(looped, dedup=False)
    want = pa.attn_chain(whole_lists, h, ss, sd, g, ATTN_SLOPE, salt2,
                         ATTN_KEEP)
    attention = []
    for r, lst in enumerate(lists):
        res = check_attn_kernels(f"rank {r} gspmd slice H={heads} F={feats}",
                                 lst, h, ss, sd, g, salt2, ATTN_KEEP,
                                 timed=True, profiled=True)
        attention.append(dict(res, rank=r, slots=lst.rows.n_edges))
    tab = pa.pack_table(h.reshape(N_NODES, -1), ss)
    # the forward over the slices (what a gspmd rank runs, in one process):
    # A1 and A2, their only path since the whole graph's forward is one walk
    zero_counts()
    fwd = pa.sharded_forward(lists, tab, sd, heads, feats, ATTN_SLOPE, salt2,
                             ATTN_KEEP, reduce=pa.folded)
    sharded_launches = launch_counts()
    if sharded_launches != dict(NO_LAUNCHES, attn_stats=MESH_PARTS,
                                attn_aggregate=MESH_PARTS):
        raise AssertionError(f"the sharded forward launched "
                             f"{sharded_launches}")
    bwd = pa.sharded_backward(lists, tab, sd, fwd["rmax0"], fwd["dinv"], g,
                              heads, feats, ATTN_SLOPE, salt2, ATTN_KEEP,
                              reduce=pa.folded)
    scales = merged_scales(whole_lists, tab, sd, want, g, heads, feats,
                           salt2, ATTN_KEEP)
    merged_err = {name: check_close(f"gspmd attention merged: {name}", got,
                                    want[name], scales[name])
                  for name, got in {**fwd, **bwd}.items()}
    # A3 with the merged rowdot R: ds_dst = P - R * Q over the slice, held
    # to the magnitudes of P's and of R * Q's terms
    given = []
    w = heads * feats
    abs_tab = pa.pack_table(tab[:, :w].abs(), tab[:, w:w + heads])
    stats = (fwd["rmax0"], fwd["dinv"])
    for r, lst in enumerate(lists):
        args = (lst.rows, lst.mult, tab, sd, *stats, g, heads, feats,
                ATTN_SLOPE, salt2, ATTN_KEEP)
        got = pa.attn_bwd_rows(*args, rowdot=bwd["rowdot"])[1]
        ref = pa.attn_bwd_rows_plain(*args, rowdot=bwd["rowdot"])[1]
        sums = pa._row_pass_sums(lst.rows, lst.mult, abs_tab, sd, *stats,
                                 g.abs(), heads, feats, ATTN_SLOPE, salt2,
                                 ATTN_KEEP)
        scale = sums[:, heads:2 * heads] + bwd["rowdot"].abs() * sums[
            :, 2 * heads:]
        given.append(check_close(f"rank {r} A3 with the merged rowdot", got,
                                 ref, scale))
    log(f"gspmd slices at P={MESH_PARTS}: degree err {degree_err}, merged "
        f"attention errs {merged_err}, A3 with a given rowdot errs {given}")
    return dict(degree=degree, attention=attention, degree_err=degree_err,
                merged_err=merged_err, given_rowdot_err=given,
                sharded_forward_launches=sharded_launches,
                edges=graph.n_edges, looped_edges=looped.n_edges)


def merged_scales(lists, tab, sd, want, g, heads, feats, salt, keep):
    """``attn_error_scales`` of the whole graph's chain ``want`` for the
    chain merged from slices: its ``rowdot`` differs from the whole one by
    its own rounding, so ``ds_src`` (which adds ``alpha * rowdot`` terms)
    is held to the terms' magnitudes with ``rowdot``'s scale in place of
    ``|rowdot|``."""
    from gnntf_tpu_torch.ops import attention as pa
    args = (lists, tab, sd, want["rmax0"], want["dinv"], g)
    rest = (heads, feats, ATTN_SLOPE, salt, keep)
    scales = pa.attn_error_scales(*args, want["rowdot"], *rest)
    scales["ds_src"] = pa.attn_error_scales(*args, scales["rowdot"],
                                            *rest)["ds_src"]
    return scales


def check_mesh_run(label, hist, single, counts, kernels):
    """Raise unless a mesh run's losses are within FUSED_RTOL of one
    device's with the same best epoch, and each of ``kernels`` launched."""
    for key in ("train_loss", "valid_loss"):
        if not np.allclose(hist[key], single[key], rtol=FUSED_RTOL, atol=0):
            raise AssertionError(f"{label} {key} {hist[key]} vs one device "
                                 f"{single[key]}")
    if hist["best_epoch"] != single["best_epoch"]:
        raise AssertionError(f"{label}: best epoch {hist['best_epoch']} vs "
                             f"{single['best_epoch']}")
    for kernel in kernels:
        if counts[kernel] == 0:
            raise AssertionError(f"{label} launched no {kernel}")


def mesh_run_entry(label, hist, counts, walls, epochs, profile):
    log(f"{label}: losses {hist['train_loss']}, valid "
        f"{hist['valid_loss']}, best epoch {hist['best_epoch']}; epoch walls "
        f"{walls} s; one epoch's device busy {profile['busy_us']} us of "
        f"{profile['wall_us']} us; launches {counts}")
    return dict(train_loss=hist["train_loss"], valid_loss=hist["valid_loss"],
                launches=counts, launches_per_epoch={
                    k: v / epochs for k, v in counts.items()},
                epoch_wall_s=walls, epoch_busy_us=profile["busy_us"],
                epoch_profile_wall_us=profile["wall_us"])


def shard_steps(model, task, mesh=None, graph=None):
    """SHARD_STEPS train steps from seed 0's parameters, the draws of step
    i from a generator seeded i, with the counts zeroed just before and
    read just after: the losses, the counts, each step's wall seconds."""
    from gnntf_tpu_torch.parallel import (make_distributed_train_step,
                                          make_train_step_raw)
    from gnntf_tpu_torch.train.trainer import keras_adam
    model.reset(seed=0)
    tx = keras_adam(LEARNING_RATE)
    step = make_train_step_raw(model, task, tx) if mesh is None else \
        make_distributed_train_step(model, task, mesh, tx, graph=graph)
    state, losses, walls = tx.init(dict(model.params)), [], []
    torch.cuda.synchronize()
    zero_counts()
    for i in range(SHARD_STEPS):
        t0 = time.perf_counter()
        state, loss = step(state, torch.Generator().manual_seed(i),
                           torch.tensor(1.0), task.batch())
        losses.append(float(loss.detach()))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return losses, launch_counts(), walls


def phase_multihost_train(graph, features, dev):
    """15c: launch_distributed(localhost, 1 process) over NCCL, then on one
    device's runs from the same seed: APPNP under fit(mesh=make_pod_mesh(
    hierarchical=True), spmm="halo") and fused (block_epochs=MESH_EPOCHS),
    GAT at GATConfig under fit(mesh=make_mesh(1, 1)), and SHARD_STEPS
    steps of APPNP built on its shard_graph_local shard (the whole list at
    world size 1) through make_distributed_train_step; each within
    FUSED_RTOL of one device with the same best epoch, its launches, epoch
    walls and one epoch's device busy time."""
    import torch.distributed as dist

    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch import config
    from gnntf_tpu_torch.parallel import (free_port, launch_distributed,
                                          make_mesh, make_pod_mesh,
                                          shard_graph_local)
    from gnntf_tpu_torch.parallel.dist import executor_for

    device = "cuda" if dev.type == "cuda" else "cpu"
    if launch_distributed(f"localhost:{free_port()}", num_processes=1,
                          process_id=0, device=device):
        raise AssertionError("one process launched more than one")
    try:
        hier = make_pod_mesh(hierarchical=True)
        tasks = fused_tasks()
        out = dict(backend=dist.get_backend(), mesh=hier.shape)
        model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
        single = timed_train(model, tasks, epochs=MESH_EPOCHS)
        hist, counts, walls = timed_train(model, tasks, epochs=MESH_EPOCHS,
                                          mesh=hier, spmm="halo")
        check_mesh_run("fit(mesh=hierarchical, spmm=halo)", hist, single[0],
                       counts, ("masked", "degree"))
        out["hier"] = mesh_run_entry(
            "fit(mesh=hierarchical 1x1x1, spmm=halo)", hist, counts, walls,
            MESH_EPOCHS, mesh_epoch_profile(model, tasks,
                                            executor_for(hier, "halo")))
        fused, fcounts, fwalls = timed_train(
            model, tasks, epochs=MESH_EPOCHS, mesh=hier, spmm="halo",
            block_epochs=MESH_EPOCHS)
        check_mesh_run("fused fit(mesh=hierarchical)", fused, hist, fcounts,
                       ("masked", "degree"))
        out["hier_fused"] = dict(train_loss=fused["train_loss"],
                                 launches=fcounts, block_wall_s=sum(fwalls))
        out["single_appnp"] = dict(train_loss=single[0]["train_loss"],
                                   launches=single[1],
                                   epoch_wall_s=single[2])

        gat = config.GATConfig().build(graph, features, N_CLASSES,
                                       device=dev)
        g_single = timed_train(gat, tasks, epochs=GAT_MESH_EPOCHS)
        mesh = make_mesh(1, 1)
        ghist, gcounts, gwalls = timed_train(gat, tasks,
                                             epochs=GAT_MESH_EPOCHS,
                                             mesh=mesh)
        # a mesh of one rank runs one device's chain (GspmdExecutor.attention)
        check_mesh_run("GAT fit(mesh=1x1)", ghist, g_single[0], gcounts,
                       (ATTN_FUSED, "attn_bwd_rows", "attn_bwd_cols"))
        out["gat"] = mesh_run_entry(
            "GAT fit(mesh=1x1)", ghist, gcounts, gwalls, GAT_MESH_EPOCHS,
            mesh_epoch_profile(gat, tasks, executor_for(mesh, None)))
        out["single_gat"] = dict(train_loss=g_single[0]["train_loss"],
                                 launches=g_single[1],
                                 epoch_wall_s=g_single[2])

        flat = make_pod_mesh()
        shard = shard_graph_local(graph, flat, graph.n_edges, N_NODES)
        on_shard = tt.APPNP(shard, features, num_classes=N_CLASSES,
                            device=dev)
        losses, scounts, swalls = shard_steps(on_shard, tasks[0], flat,
                                              shard)
        want, _, _ = shard_steps(model, tasks[0])
        if not np.allclose(losses, want, rtol=FUSED_RTOL, atol=0):
            raise AssertionError(f"shard steps {losses} vs one device {want}")
        for kernel in ("masked", "degree"):
            if scounts[kernel] == 0:
                raise AssertionError(f"the shard steps launched no {kernel}")
        out["shard"] = dict(losses=losses, single=want, launches=scounts,
                            step_wall_s=swalls)
        log(f"shard_graph_local steps at world size 1: losses {losses}, one "
            f"device {want}, step walls {swalls} s, launches {scounts}")
    finally:
        dist.destroy_process_group()
    return out


# phase 16: the fused trainer's cases that earlier slices ran only on the
# host loop on a card: a small graph's eager edge masks, remat, an optimizer
# whose state is tensors, a layer's own draws
PHASE16_EPOCHS, PHASE16_BLOCK = 10, 5
REMAT16_EPOCHS, REMAT16_BLOCK = 4, 2
# a replay's walks by profile name, and the wrappers' counts each one is
# (the prepared operator's backward under the default impl is the scaled
# walk's backward)
WALK_COUNTERS = {"ell_gather_walk": ("k1",),
                 "ell_gather_scaled_walk": ("k1s",),
                 "ell_gather_scaled_bwd_walk": ("backward",),
                 "ell_gather_masked_walk": ("masked",),
                 DEGREE_WALK: ("degree",),
                 "blocked_spmm_walk": ("k2",)}


class MomentumSGD:
    """``optax.sgd(learning_rate, momentum)``: a trace ``t = g + m t``,
    the update ``-learning_rate * t``."""

    def __init__(self, learning_rate=0.1, momentum=0.9):
        self.learning_rate, self.momentum = learning_rate, momentum

    def init(self, params):
        return {"trace": {k: torch.zeros_like(p) for k, p in params.items()}}

    def update(self, grads, state):
        trace = {k: g + self.momentum * state["trace"][k]
                 for k, g in grads.items()}
        return ({k: -self.learning_rate * t for k, t in trace.items()},
                {"trace": trace})


class OptaxAdam:
    """``optax.adam(learning_rate)``: the moments bias-corrected by a count
    kept as a device tensor, ``eps`` added outside the square root."""

    def __init__(self, learning_rate=0.01, b1=0.9, b2=0.999, eps=1e-8):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params):
        zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}
        device = next(iter(params.values())).device
        return {"count": torch.zeros((), dtype=torch.int32, device=device),
                "mu": zeros(), "nu": zeros()}

    def update(self, grads, state):
        b1, b2 = self.b1, self.b2
        mu = {k: (1 - b1) * g + b1 * state["mu"][k] for k, g in grads.items()}
        nu = {k: (1 - b2) * torch.square(g) + b2 * state["nu"][k]
              for k, g in grads.items()}
        count = state["count"] + 1
        t = count.to(torch.float32)
        c1, c2 = 1 - torch.pow(b1, t), 1 - torch.pow(b2, t)
        updates = {k: -self.learning_rate * (mu[k] / c1)
                   / (torch.sqrt(nu[k] / c2) + self.eps) for k in grads}
        return updates, {"count": count, "mu": mu, "nu": nu}


def scales_by_a_draw():
    """A layer that scales its input by ``1 + 0.1 u``, ``u`` a draw from a
    generator of its own on the card (``Forward.next_generator``)."""
    import gnntf_tpu_torch as tt

    class ScalesByADraw(tt.Layer):
        def build(self, net):
            return net.top_shape()

        def apply(self, fw, x):
            if not fw.training:
                return x
            g = fw.next_generator(x.device)
            return x * (1.0 + 0.1 * torch.rand(1, generator=g,
                                               device=x.device))

    return ScalesByADraw()


def uniform_table_bytes():
    """Wrap ``DrawTape.stop`` to keep the bytes of the eager masks'
    uniform tables each recording makes; returns that list and the undo."""
    from gnntf_tpu_torch.nn import core
    stop, made = core.DrawTape.stop, []

    def recording_stop(self, *args, **kw):
        stop(self, *args, **kw)
        made.append(sum(t.numel() * t.element_size() for t in self.uniforms))

    core.DrawTape.stop = recording_stop
    return made, lambda: setattr(core.DrawTape, "stop", stop)


def fused_case(label, model, tasks, epochs, block, **kw):
    """16: ``fit(block_epochs=block)`` against the host loop on the card
    from the same seed (``kw`` to both): losses within ``FUSED_RTOL``, the
    same best epoch; the counts of the recorded epoch and the capture twice
    the host loop's an epoch; the second block's wall time an epoch; a
    second fused run's second block profiled, each walk a replay equal to
    the host loop's launches of its kernel an epoch; peak memory with the
    graph's pool.  A clean forward first builds the model's cached
    adjacency and operator, so that both runs launch alike."""
    model.reset(seed=0)
    model._activations()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fused, counts, t0, marks, _ = fused_run(model, tasks, None, block,
                                            epochs=epochs, block=block, **kw)
    peak = dict(allocated_mib=torch.cuda.max_memory_allocated() / 2**20,
                reserved_mib=torch.cuda.max_memory_reserved() / 2**20)
    host, host_counts, h0, host_marks, _ = fused_run(model, tasks, None, 1,
                                                     epochs=epochs, **kw)
    per_epoch = {k: v / epochs for k, v in host_counts.items()}
    # the recorded epoch and the capture (a rehearsal on the CPU runs every
    # epoch)
    runs = 2 if model.device.type == "cuda" else epochs
    if counts != {k: runs * v for k, v in per_epoch.items()}:
        raise AssertionError(f"{label}: launches counted {counts}, host loop "
                             f"an epoch {per_epoch}")
    rel = {}
    for key in ("train_loss", "valid_loss"):
        a, b = np.array(fused[key]), np.array(host[key])
        rel[key] = float(np.max(np.abs(a - b) / np.abs(b)))
        np.testing.assert_allclose(a, b, rtol=FUSED_RTOL)
    if fused["best_epoch"] != host["best_epoch"]:
        raise AssertionError(f"{label}: best epoch {fused['best_epoch']}, "
                             f"host loop {host['best_epoch']}")
    want = {tag: sum(per_epoch[c] for c in counters)
            for tag, counters in WALK_COUNTERS.items()}
    replay = replay_profile(
        label, lambda primer: fused_run(
            model, tasks, None, block, profile=True, primer=primer,
            epochs=epochs, block=block, **kw)[4], want, replays=block)
    epoch_ms = (marks[2 * block - 1] - marks[block - 1]) * 1e3 / block
    host_ms = np.diff([h0] + host_marks) * 1e3
    out = dict(fused_epoch_ms=epoch_ms,
               first_block_ms=(marks[block - 1] - t0) * 1e3,
               busy_ms_per_epoch=replay["busy_ms_per_epoch"],
               host_epoch_ms=host_ms.tolist(), max_rel_loss_diff=rel,
               best_epoch=fused["best_epoch"], counted=counts,
               host_per_epoch=per_epoch, walks_per_replay={
                   tag: replay["walks_per_epoch"][tag] for tag in want},
               peak=peak, train_loss=fused["train_loss"])
    log(f"{label}: fused epoch {epoch_ms} ms (second block, wall), device "
        f"busy {replay['busy_ms_per_epoch']} ms a replay; host loop epoch "
        f"ms {host_ms.tolist()}; max relative loss difference {rel} (limit "
        f"{FUSED_RTOL}), best epoch {fused['best_epoch']}; walks a replay "
        f"{out['walks_per_replay']}; peak memory with the graph pool {peak}"
        f"; card {nvidia_smi('name,power.limit')}")
    return out


def cora_graph(dev):
    """Phase 14d's graph at Cora's scale, features, labels and split."""
    import gnntf_tpu_torch as tt
    rng = np.random.RandomState(0)
    src = rng.randint(0, CORA_NODES, CORA_EDGES)
    dst = rng.randint(0, CORA_NODES, CORA_EDGES)
    graph = tt.from_edges(src, dst, n_nodes=CORA_NODES, directed=False,
                          device=dev)
    features = rng.rand(CORA_NODES, 64).astype(np.float32)
    labels = rng.randint(0, CORA_CLASSES, CORA_NODES)
    tasks = (tt.NodeClassification(np.arange(140), labels[:140]),
             tt.NodeClassification(np.arange(200, 700), labels[200:700]))
    return graph, features, tasks


def phase_fused_gaps(graph, features, dev):
    """16a: APPNP at its defaults at Cora's scale, its eager edge masks'
    uniforms from the tape's tables (K2's store-mode walks); 16b: GCNII-64
    at ``GCNIIConfig`` with remat, fused against the host loop with remat
    and against the fused run without it, both fused peaks; 16c: APPNP at
    its defaults on the bench graph with momentum SGD and optax-style Adam
    (the masked and degree walks); 16d: 16a's APPNP with a layer that
    scales by a draw from ``next_generator(device)``."""
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch import config
    from gnntf_tpu_torch.ops import stochastic

    out = {}
    cora, cora_features, cora_tasks = cora_graph(dev)
    if cora.n_edges >= stochastic.min_edges():
        raise AssertionError("the Cora-scale graph takes the lazy draw")
    made, undo = uniform_table_bytes()
    try:
        model = tt.APPNP(cora, cora_features, num_classes=CORA_CLASSES,
                         device=dev)
        out["16a"] = fused_case("16a APPNP eager masks (Cora scale)", model,
                                cora_tasks, PHASE16_EPOCHS, PHASE16_BLOCK)
    finally:
        undo()
    out["16a"]["uniform_table_bytes"] = made[0]
    log(f"16a: the uniform tables of a {PHASE16_BLOCK}-epoch block hold "
        f"{made[0]} bytes ({cora.n_edges} edges)")
    if out["16a"]["walks_per_replay"]["blocked_spmm_walk"] <= 0:
        raise AssertionError("16a: no K2 walk in a replay")

    model = config.GCNIIConfig().build(graph, features, N_CLASSES,
                                       device=dev)
    tasks = fused_tasks()
    plain = fused_case("16b GCNII-64 fused without remat", model, tasks,
                       REMAT16_EPOCHS, REMAT16_BLOCK)
    remat = fused_case("16b GCNII-64 fused with remat", model, tasks,
                       REMAT16_EPOCHS, REMAT16_BLOCK, remat=True)
    np.testing.assert_allclose(remat["train_loss"], plain["train_loss"],
                               rtol=FUSED_RTOL)
    if remat["best_epoch"] != plain["best_epoch"]:
        raise AssertionError("16b: remat changes the best epoch")
    walks = remat["walks_per_replay"]
    if walks["ell_gather_scaled_walk"] <= 0 or \
            walks["ell_gather_scaled_bwd_walk"] <= 0:
        raise AssertionError(f"16b: K1 or its backward walk missing from a "
                             f"replay: {walks}")
    log(f"16b: fused peaks without remat {plain['peak']}, with remat "
        f"{remat['peak']}")
    out["16b"] = dict(remat=remat, plain=plain)
    del model

    out["16c"] = {}
    for name, make in (("sgd_momentum", MomentumSGD),
                       ("optax_adam", OptaxAdam)):
        model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
        case = fused_case(f"16c APPNP with {name}", model, fused_tasks(),
                          PHASE16_EPOCHS, PHASE16_BLOCK, optimizer=make())
        walks = case["walks_per_replay"]
        if walks["ell_gather_masked_walk"] <= 0 or (
                walks[DEGREE_WALK] <= 0):
            raise AssertionError(f"16c {name}: no masked or degree walk in "
                                 f"a replay: {walks}")
        out["16c"][name] = case

    model = tt.APPNP(cora, cora_features, num_classes=CORA_CLASSES,
                     device=dev)
    model.add(scales_by_a_draw())
    out["16d"] = fused_case("16d APPNP with next_generator draws (Cora "
                            "scale)", model, cora_tasks, PHASE16_EPOCHS,
                            PHASE16_BLOCK)
    return out


def gaps_entry(gaps, tag, names):
    """A ``kernels`` entry's phase 16 part: its walk's launches in one
    replay of each case of ``names``."""
    cases = {"16a_eager_masks": gaps["16a"], "16b_remat": gaps["16b"]["remat"],
             "16b_plain": gaps["16b"]["plain"],
             **{f"16c_{k}": v for k, v in gaps["16c"].items()},
             "16d_next_generator": gaps["16d"]}
    return {name: cases[name]["walks_per_replay"][tag] for name in names}


def kernel_launches(gcnii, gcn, key):
    """A kernel's launches (its wrapper's count) a GCNII-64 serving forward
    and an epoch of GCNII-64's and of GCN's training."""
    return dict(
        gcnii=dict(serving_forward=gcnii["serving"]["launches"][key] // 3,
                   per_epoch=gcnii["launches_per_epoch"][key]),
        gcn=dict(per_epoch=gcn["launches_per_epoch"][key]))


def attention_entries(attention, gat, slices):
    """The ``kernels`` line's entries of A1-A4 and the fused forward: phase
    2e's numbers at GAT's layer 1 over the per-edge lists (the training
    step's shapes), with layer 2 and the coalesced lists beside them, and
    the launches of their path: phase 9's GAT training, or, for A1 and A2
    (which the fused walk replaces there), phase 15b's forward over the
    gspmd slices."""
    entries = []
    for name in ATTN_KERNELS:
        backward_pass = name.startswith("attn_bwd")
        sharded_only = name in ("attn_stats", "attn_aggregate")
        entries.append({
            "name": name, "route": "cuda",
            "source": "gnntf_tpu_torch/csrc/"
                      + ("softmax_walk.cuh" if name == ATTN_FUSED
                         else "attention.cu"),
            "replaces": "gnntf_tpu/ops/attention.py:"
                        + ("357" if backward_pass else "321"),
            "launches": (slices["sharded_forward_launches"][name]
                         if sharded_only else gat["launches"][name]),
            "launches_path": (f"phase 15b, the forward over {MESH_PARTS} "
                              f"gspmd slices (sharded_forward)"
                              if sharded_only else "phase 9, GAT training"),
            **({"a1_a2_device_ms": attention["layer1"][name][
                "a1_a2_device_ms"]} if name == ATTN_FUSED else {}),
            **{k: attention["layer1"][name][k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "device_ms", "device_us_by_kernel")},
            "shape": f"bench graph with self-loops, per-edge lists "
                     f"({attention['lists']['per_edge']['slots']} slots), "
                     f"H=8 F=8, attention dropout keep {ATTN_KEEP}",
            "bytes": attention["layer1"][name]["bytes"],
            "layer2": dict(attention["layer2"][name], shape="H=1 F=40"),
            "coalesced": dict(
                attention["layer1_coalesced"][name],
                shape=f"coalesced lists "
                      f"({attention['lists']['coalesced']['slots']} slots), "
                      f"H=8 F=8, no dropout",
                layer2=attention["layer2_coalesced"][name]),
            "per_serving_forward": gat["serving"]["launches"][name] // 3,
            "per_epoch": GAT_LAUNCHES[name],
            "fused": dict(
                per_replayed_epoch=gat["fused"]["replay"]["walks_per_epoch"][
                    name + "_walk"],
                counted=gat["fused"]["counted"][name])})
    return entries


def main(dev=None):
    """Every phase on the card; ``dev`` (another device) serves rehearsals
    of the control flow only."""
    if dev is None:
        if not torch.cuda.is_available():
            sys.exit("chip_smoke: torch.cuda.is_available() is False")
        dev = torch.device("cuda")
    import gnntf_tpu_torch as tt
    from gnntf_tpu_torch.data import random_power_law_edges
    from gnntf_tpu_torch.ops import ell_gather_scaled, spmm_impl
    from gnntf_tpu_torch.utils import kernels, native

    log(f"device: {torch.cuda.get_device_name(0)}, torch {torch.__version__}"
        f", CUDA {torch.version.cuda}")

    # 1. build: the CUDA kernels, and beside them the C++ sampler
    t0 = time.perf_counter()
    sampler_build = threading.Thread(target=native.available)
    sampler_build.start()
    built = kernels.build(force=True)
    sampler_build.join()
    if not native.available():
        raise RuntimeError(f"the C++ sampler did not build: {native.error}")
    log(f"build: {sorted(built)} and {native.LIBRARY.name} in "
        f"{time.perf_counter() - t0} s")
    for name, info in built.items():
        for line in info["ptxas"].splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill")):
                log(f"  {name}: {line.strip()}")

    # 1b. the C++ host builders against their numpy paths
    src, dst = random_power_law_edges(N_NODES, N_EDGES, seed=0)
    seconds = {}
    t0 = time.perf_counter()
    host_builders = phase_native_builders(src, dst)
    seconds["1b"] = time.perf_counter() - t0

    # 2. K1 against its plain version, small and on the bench rest list
    graph = tt.from_edges(src, dst, n_nodes=N_NODES, directed=False,
                          device=dev)
    features = np.random.RandomState(2).randn(
        N_NODES, N_FEATURES).astype(np.float32)
    x128 = torch.from_numpy(features).to(dev)
    x40 = torch.from_numpy(np.random.RandomState(3).randn(
        N_NODES, N_CLASSES).astype(np.float32)).to(dev)
    x64 = torch.from_numpy(np.random.RandomState(10).randn(
        N_NODES, 64).astype(np.float32)).to(dev)
    x16 = torch.from_numpy(np.random.RandomState(14).randn(
        N_NODES, LP_CLASSES).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    k1 = phase_ell_kernel(graph, dev, x16, x40, x64, x128)
    seconds["2"] = time.perf_counter() - t0

    # 2b. K2 against its plain version, small and on the RCM bench layout
    t0 = time.perf_counter()
    g_rcm, perm, inv, k2 = phase_blocked_kernel(graph, dev, x40, x128)
    seconds["2b"] = time.perf_counter() - t0

    # 2c. K1's masked and degree walks, small and on the bench grids' lists
    t0 = time.perf_counter()
    masked = phase_masked_kernels(graph, dev, x40, x64, x128)
    seconds["2c"] = time.perf_counter() - t0

    # 2d. the prepared operator's backward walks: the scaled walk over the
    # transposed whole list (auto), K2's entry over it (hybrid)
    t0 = time.perf_counter()
    backward = phase_backward_kernel(graph, dev, x16, x40, x64, x128)
    seconds["2d"] = time.perf_counter() - t0

    # 2e. the attention kernels A1-A4, small and on the bench graph's lists
    t0 = time.perf_counter()
    attention = phase_attention_kernels(graph, dev)
    seconds["2e"] = time.perf_counter() - t0

    # 2f. K2's bfloat16 mode and the dropout walks over bfloat16 values
    t0 = time.perf_counter()
    bf16 = phase_bf16_kernels(graph, g_rcm, dev, {
        N_FEATURES: x128, 64: x64, N_CLASSES: x40, LP_CLASSES: x16})
    seconds["2f"] = time.perf_counter() - t0

    # 2g. launches over one list on two streams and beside a graph replay
    t0 = time.perf_counter()
    streams = phase_streams(graph, dev, x40)
    seconds["2g"] = time.perf_counter() - t0

    log("card after the kernel timings (clocks.sm, power.draw, "
        f"temperature.gpu): "
        f"{nvidia_smi('clocks.sm,power.draw,temperature.gpu')}")

    # 3. the serving path at full width
    t0_phase = time.perf_counter()
    model = tt.APPNP(graph, features, num_classes=N_CLASSES, device=dev)
    order = np.random.RandomState(7).permutation(N_NODES)
    requests = [order[i * REQUEST_NODES:(i + 1) * REQUEST_NODES]
                for i in range(N_REQUESTS)]
    eval_nodes = order[N_REQUESTS * REQUEST_NODES:
                       (N_REQUESTS + 1) * REQUEST_NODES]
    labels = np.random.RandomState(8).randint(0, N_CLASSES, size=N_NODES)
    model.reset(seed=0)
    t0 = time.perf_counter()
    adj = model.adjacency()  # normalized graph + PreparedSpMM, built once
    torch.cuda.synchronize()
    setup_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    forward_ms, request_ms = [], []
    for i in range(3):
        model._act_cache = None  # each forward really runs
        t0 = time.perf_counter()
        acts = model._activations()
        torch.cuda.synchronize()
        forward_ms.append((time.perf_counter() - t0) * 1e3)
        if ell_gather_scaled.launches != 10 * (i + 1):
            raise AssertionError(f"forward {i}: {ell_gather_scaled.launches}"
                                 " K1 scaled launches, expected 10 per "
                                 "forward")
    answers = []
    for nodes in requests:
        t0 = time.perf_counter()
        answers.append(model.predict(tt.NodeClassification(nodes)).cpu())
        request_ms.append((time.perf_counter() - t0) * 1e3)
    accuracy = float(model.evaluate(
        tt.NodeClassification(eval_nodes, labels[eval_nodes])))
    serving_launches = launch_counts()
    launches = serving_launches["k1s"]
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    if serving_launches != dict(NO_LAUNCHES, k1s=30):
        raise AssertionError(f"launches on the serving path "
                             f"{serving_launches}, expected 30 of K1's "
                             "scaled walk and nothing else")
    op = model.operator(adj)
    spmm_ms = time_ms(lambda: op(acts))
    fwd_profile = profile_forward("one forward", clean_forward(model))
    spmm_profile = profile_forward(f"one SpMM at F={acts.shape[1]}",
                                   lambda: op(acts))
    # the split rows are finished inside the walk's launch
    spmm_kernels = {"ell_gather_scaled_walk"}
    if (fwd_profile["k1s_walks"] != 10 or spmm_profile["k1s_walks"] != 1
            or spmm_profile["gemm_us"] or spmm_profile["k1_walks"]
            or spmm_profile["launches"] != len(spmm_kernels)
            or set(spmm_profile["us_by_kernel"]) != spmm_kernels):
        raise AssertionError("the auto route's profiles: "
                             f"{fwd_profile['k1s_walks']} scaled walks a "
                             "forward (expected 10); one SpMM "
                             f"{spmm_profile['us_by_kernel']} (expected "
                             f"{sorted(spmm_kernels)} once each)")
    log(f"serving: set-up {setup_ms} ms (normalized graph + PreparedSpMM), "
        f"forward ms {forward_ms}, SpMM {spmm_ms} ms at F={acts.shape[1]}, "
        f"predict ms {request_ms}, evaluate {accuracy}, peak memory "
        f"{peak_mb} MiB, K1 scaled launches {launches}; device launches "
        f"per SpMM {spmm_profile['launches']}, per forward "
        f"{fwd_profile['launches']}")

    # the same forward under hybrid (the JAX package's hub slice beside K1
    # adding into its product), for K1's launches and the profiles beside
    with spmm_impl("hybrid"):
        model._act_cache = None
        model._activations()  # builds the hybrid operator
        torch.cuda.synchronize()
        zero_counts()
        hybrid_ms = []
        for _ in range(3):
            model._act_cache = None
            t0 = time.perf_counter()
            hybrid_acts = model._activations()
            torch.cuda.synchronize()
            hybrid_ms.append((time.perf_counter() - t0) * 1e3)
        hybrid_launches = launch_counts()
        hybrid_op = model.operator(model.adjacency())
        hybrid_spmm_ms = time_ms(lambda: hybrid_op(acts))
        hybrid_fwd = profile_forward("one forward under hybrid",
                                     clean_forward(model))
        hybrid_spmm = profile_forward(f"one SpMM under hybrid at "
                                      f"F={acts.shape[1]}",
                                      lambda: hybrid_op(acts))
        # one SpMM's dx under hybrid (K1's transposed list through K2's
        # store-mode entry) beside auto's (the scaled walk's backward)
        dy = torch.from_numpy(np.random.RandomState(9).randn(
            *acts.shape).astype(np.float32)).to(dev)
        xg = acts.detach().clone().requires_grad_()
        hybrid_op(xg).backward(dy)  # builds the transposed list
        xg.grad = None
        torch.cuda.synchronize()
        zero_counts()
        hybrid_op(xg).backward(dy)
        torch.cuda.synchronize()
        hybrid_bwd_launches = launch_counts()
        hybrid_dx = xg.grad
    xg.grad = None
    op(xg).backward(dy)
    bwd_err = (hybrid_dx - xg.grad).abs().max().item()
    if hybrid_launches != dict(NO_LAUNCHES, k1=30) or \
            hybrid_spmm["k1_walks"] != 1 or not hybrid_spmm["gemm_us"] or \
            hybrid_bwd_launches != dict(NO_LAUNCHES, k1=1, k1t=1):
        raise AssertionError(f"hybrid serving launches {hybrid_launches} "
                             "(expected 30 of K1), one SpMM "
                             f"{hybrid_spmm['us_by_kernel']}, one SpMM's "
                             f"forward and backward {hybrid_bwd_launches} "
                             "(expected 1 of K1 and 1 of its backward)")
    hybrid_err = (hybrid_acts - acts).abs().max().item()
    log(f"serving under hybrid: forward ms {hybrid_ms}, SpMM "
        f"{hybrid_spmm_ms} ms, launches {hybrid_launches}, max |logits - "
        f"auto's| {hybrid_err}; one SpMM's forward and backward launches "
        f"{hybrid_bwd_launches}, max |dx - auto's| {bwd_err}")
    if not torch.allclose(hybrid_acts, acts, **FORWARD_TOL):
        raise AssertionError(f"hybrid and auto logits differ ({hybrid_err})")
    if not torch.allclose(hybrid_dx, xg.grad, **FORWARD_TOL):
        raise AssertionError(f"hybrid and auto dx differ ({bwd_err})")
    del xg, dy, hybrid_dx
    model._act_cache = None

    gpu = acts.cpu()
    if gpu.shape != (N_NODES, N_CLASSES) or not torch.isfinite(gpu).all():
        raise AssertionError(f"bad logits: shape {tuple(gpu.shape)}")
    for nodes, answer in zip(requests, answers):
        if answer.shape != (REQUEST_NODES,) or not torch.equal(
                answer, gpu[torch.from_numpy(nodes)].argmax(1)):
            raise AssertionError("predict disagrees with the activations")
    t0 = time.perf_counter()
    cpu_model = tt.APPNP(graph.to("cpu"), features, num_classes=N_CLASSES,
                         device="cpu")
    cpu_model.reset(seed=0)
    for name, p in cpu_model.params.items():
        if not torch.equal(p, model.params[name].cpu()):
            raise AssertionError(f"parameter {name} differs between devices")
    ref = cpu_model._activations()
    err = (gpu - ref).abs().max().item()
    agree = (gpu.argmax(1) == ref.argmax(1)).double().mean().item()
    log(f"GPU vs CPU forward: max_abs_err {err}, max|logit| "
        f"{ref.abs().max().item()}, argmax agreement {agree} "
        f"(CPU forward {time.perf_counter() - t0} s)")
    if not torch.allclose(gpu, ref, **FORWARD_TOL):
        raise AssertionError(f"GPU forward differs from CPU ({err})")
    if agree < MIN_ARGMAX_AGREEMENT:
        raise AssertionError(f"argmax agreement {agree}")

    seconds["3"] = time.perf_counter() - t0_phase

    # 4a. the training path through K2, 4b. the pallas and the default
    # path on both devices, 5. the default training path
    from gnntf_tpu_torch.ops import stochastic
    t0 = time.perf_counter()
    trained = phase_train(g_rcm, perm, inv, features, dev)
    seconds["4a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    cross = phase_devices(g_rcm, perm, inv, features, dev)
    seconds["4b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    default = phase_default_train(graph, features, dev)
    seconds["5"] = time.perf_counter() - t0
    log(f"training summary: {json.dumps(dict(trained=trained, cross=cross, default=default))}")

    # 6. the fused trainer under the default impl, 6b. under pallas, 6c.
    # early stopping inside a block
    t0 = time.perf_counter()
    fused = phase_fused("fused (default impl)", graph, features, dev)
    seconds["6"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused_k2 = phase_fused("fused (pallas)", g_rcm, features[perm], dev,
                           impl="pallas", inv=inv)
    seconds["6b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    patience = phase_fused_patience(dev)
    seconds["6c"] = time.perf_counter() - t0
    log("fused summary: " + json.dumps(
        dict(default=fused, pallas=fused_k2, patience=patience)))

    # 7. GCNII at its published configuration, 8. GCN at its own
    t0 = time.perf_counter()
    gcnii = phase_gcnii(graph, features, dev)
    seconds["7"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    gcn = phase_gcn(graph, features, dev)
    seconds["8"] = time.perf_counter() - t0
    log("GCN family summary: " + json.dumps(dict(gcnii=gcnii, gcn=gcn)))

    # 9. GAT at its configuration, 10. GraphSAGE and GIN at theirs
    from gnntf_tpu_torch.ops import attention as pa
    t0 = time.perf_counter()
    gat = phase_gat(graph, features, dev)
    seconds["9"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    sage_gin = phase_sage_gin(graph, features, dev)
    seconds["10"] = time.perf_counter() - t0
    log("attention summary: " + json.dumps(dict(
        kernels=attention, gat=gat, sage_gin=sage_gin)))

    # 11. NGCF link prediction at full width, 12. remat and resume
    t0 = time.perf_counter()
    lp = phase_link_prediction(graph, src, dst, features, dev)
    seconds["11"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rr = phase_remat_resume(graph, features, dev)
    seconds["12"] = time.perf_counter() - t0
    log("link prediction summary: " + json.dumps(dict(
        link_prediction=lp, remat_resume=rr)))
    log(f"phase seconds: {seconds}")
    # one attention list build a structure and flavour: the bench graph's
    # per-edge and coalesced lists on the card (2e; phase 9 hits them), its
    # coalesced lists on the CPU (phase 9's CPU forward and CPU training; a
    # rehearsal on the CPU has one bench graph)
    builds = 3 if dev.type == "cuda" else 2
    if pa._attn_lists.builds != builds:
        raise AssertionError(f"{pa._attn_lists.builds} attention list "
                             f"builds over the run, expected {builds}")
    # one grid build a structure over the run: the RCM graph on the card
    # (4a; 4b and 6b hit it) and on the CPU (4b), the natural graph on the
    # card (5; 6 hits it), 6c's small graph (a rehearsal on the CPU has one
    # RCM graph)
    builds = 4 if dev.type == "cuda" else 3
    if stochastic.train_grids.builds != builds:
        raise AssertionError(f"{stochastic.train_grids.builds} grid builds "
                             f"over the run, expected {builds}")

    # 14. single-host scale-out: the per-rank walks at P=4, fit(mesh=) over
    # NCCL at world size 1 (the card machine has one GPU), fused on the
    # mesh, and small graphs (F7)
    t0 = time.perf_counter()
    mesh_products = phase_mesh_products(graph, dev, x40)
    seconds["14a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh_train = phase_mesh_train(graph, features, dev)
    seconds["14bc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    small = phase_small_graphs(dev)
    seconds["14d"] = time.perf_counter() - t0
    log("scale-out summary: " + json.dumps(dict(
        products=mesh_products, train=mesh_train, small_graphs=small)))
    log(f"phase seconds with 14: {seconds}")

    # 15. multi-process scale-out: the hierarchical plan's per-rank walks
    # and the gspmd slices' degree walks and A1-A4 at P=4 in one process,
    # launch_distributed and fit(mesh=) over NCCL at world size 1
    t0 = time.perf_counter()
    hier_products = phase_hier_products(graph, dev, x40)
    seconds["15a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    slices = phase_gspmd_slices(graph, dev)
    seconds["15b"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    multihost = phase_multihost_train(graph, features, dev)
    seconds["15c"] = time.perf_counter() - t0
    log("multi-process summary: " + json.dumps(dict(
        hier_products=hier_products, gspmd_slices=slices,
        train=multihost)))
    log(f"phase seconds with 15: {seconds}")

    # 16. the fused trainer's gaps closed on the card: eager edge masks,
    # remat, optimizers whose state is tensors, a layer's own draws
    t0 = time.perf_counter()
    gaps = phase_fused_gaps(graph, features, dev)
    seconds["16"] = time.perf_counter() - t0
    log("fused gaps summary: " + json.dumps(gaps))
    log(f"phase seconds with 16: {seconds}")

    # 2f, training: APPNP under GNNTF_GRID_VALUE_DTYPE=bfloat16
    t0 = time.perf_counter()
    bf16_train = phase_bf16_train(graph, features, dev)
    seconds["2f_train"] = time.perf_counter() - t0
    log("bfloat16 summary: " + json.dumps(dict(
        host_builders=host_builders, train=bf16_train,
        step=bf16["step"])))
    log(f"phase seconds with 2f: {seconds}")

    # 13. report
    # the top-level numbers are at the width each path propagates (F=40:
    # APPNP's 40 classes); F=128 is the bench width of the kernel table
    rest = k1["rest_list"]
    whole = k1["scaled"]["whole_list"]
    scaled_entry = {
        "name": "ell_gather_scaled", "route": "cuda",
        "source": "gnntf_tpu_torch/csrc/scaled_walk.cuh",
        "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
        "launches": launches, **k1["scaled"]["serving"],
        "kernel_ms": k1["scaled"]["serving"]["ms"],
        "shape": f"whole ELL list (auto, no hub slice) of the symmetric "
                 f"normalized bench graph, N=169343 rows, "
                 f"E={whole['live_slots']} live slots, F=40, the scales "
                 f"applied in the walk",
        "bench_width": dict(k1["scaled"]["bench"], shape="F=128"),
        "fused": fused_launches(fused, "ell_gather_scaled_walk", "k1s"),
        "fused_gaps": gaps_entry(gaps, "ell_gather_scaled_walk", (
            "16b_remat", "16b_plain", "16c_sgd_momentum",
            "16c_optax_adam")),
        **kernel_launches(gcnii, gcn, "k1s"),
        "gcn_width": dict(k1["scaled"]["gcn_width"], shape="F=64"),
        "ngcf_width": dict(k1["scaled"]["ngcf_width"], shape="F=16"),
        "small": k1["scaled"]["small"],
        "ngcf": dict(per_epoch=lp["launches_per_epoch"]["k1s"],
                     fused=fused_launches(lp["fused"],
                                          "ell_gather_scaled_walk", "k1s")),
        "whole_list": whole,
        "serving_profile": dict(forward=fwd_profile, spmm=spmm_profile)}
    entry = {"name": "ell_gather", "route": "cuda",
             "source": "gnntf_tpu_torch/csrc/ell_gather.cu",
             "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
             "launches": hybrid_launches["k1"], **k1["serving"],
             "kernel_ms": k1["serving"]["ms"],
             "shape": f"rest ELL list R={rest['held_rows']} held rows of "
                      f"N=169343, E={rest['live_slots']} live slots, F=40, "
                      f"added into the hub product (hybrid; launches: "
                      f"phase 3's three forwards under hybrid)",
             "bench_width": dict(k1["bench"], shape="F=128"),
             "fused": fused_launches(fused, "ell_gather_walk", "k1"),
             "fused_gaps": gaps_entry(gaps, "ell_gather_walk", (
                 "16b_remat", "16b_plain", "16c_sgd_momentum",
                 "16c_optax_adam")),
             **kernel_launches(gcnii, gcn, "k1"),
             "gcn_width": dict(k1["gcn_width"], shape="F=64"),
             "ngcf_width": dict(k1["ngcf_width"], shape="F=16"),
             "ngcf": dict(per_epoch=lp["launches_per_epoch"]["k1"],
                          fused=fused_launches(lp["fused"],
                                               "ell_gather_walk", "k1")),
             "backward": {
                 "name": "ell_gather_transposed", "route": "cuda",
                 "source": "gnntf_tpu_torch/csrc/blocked_spmm.cu",
                 "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
                 "launches": hybrid_bwd_launches["k1t"],
                 **backward["hybrid"],
                 "shape": f"whole list transposed, "
                          f"{backward['transposed_list']['slots']} slots "
                          f"over N=169343 columns, F=40 (launches: one "
                          f"SpMM's backward under hybrid in phase 3)",
                 "small": backward["small"]},
             "small": k1["small"], "rest_list": rest,
             "serving_profile": dict(forward=hybrid_fwd, spmm=hybrid_spmm)}
    scaled_bwd = backward["scaled"]
    scaled_backward_entry = {
        "name": "ell_gather_scaled_backward", "route": "cuda",
        "source": "gnntf_tpu_torch/csrc/scaled_walk.cuh",
        "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
        "launches": gcnii["launches_per_epoch"]["backward"] * GCNII_EPOCHS,
        **scaled_bwd["gcnii"],
        "shape": f"whole list transposed, "
                 f"{backward['transposed_list']['slots']} slots over "
                 f"N=169343 columns, F=64 (GCNII), dx = cs * (A^T (rs * "
                 f"dy)) + w * dy in one launch",
        **kernel_launches(gcnii, gcn, "backward"),
        "fused_gaps": gaps_entry(gaps, "ell_gather_scaled_bwd_walk", (
            "16b_remat", "16b_plain")),
        "gcn_width": dict(scaled_bwd["gcn"], shape="F=40 (GCN)"),
        "ngcf_width": dict(scaled_bwd["ngcf"], shape="F=16 (NGCF)"),
        "bench_width": dict(scaled_bwd["bench"], shape="F=128"),
        "ngcf": dict(per_epoch=lp["launches_per_epoch"]["backward"],
                     fused=fused_launches(lp["fused"],
                                          "ell_gather_scaled_bwd_walk",
                                          "backward")),
        "small": scaled_bwd["small"],
        "transposed_list": backward["transposed_list"]}
    lay = k2["layout"]
    entry2 = {"name": "blocked_spmm", "route": "cuda",
              "source": "gnntf_tpu_torch/csrc/blocked_spmm.cu",
              "replaces": "gnntf_tpu/ops/pallas/spmm.py:49",
              "launches": trained["launches"], **k2["train"],
              "kernel_ms": k2["train"]["ms"],
              "shape": f"RCM bench layout C={lay['chunks']} W=T=256 BE=1024 "
                       f"N=169343 F=40, forward list",
              "bench_width": dict(k2["bench"], shape="F=128"),
              "fused": fused_launches(fused_k2, "blocked_spmm_walk", "k2"),
              "fused_gaps": gaps_entry(gaps, "blocked_spmm_walk", (
                  "16a_eager_masks", "16d_next_generator")),
              **kernel_launches(gcnii, gcn, "k2"),
              "small": k2["small"],
              "mesh": mesh_entry(mesh_products, mesh_train, "realized",
                                 "k2"),
              "hier": hier_entry(hier_products, multihost, "realized", "k2"),
              "small_graphs": dict(
                  launches=small["APPNP"]["launches"]["k2"],
                  card=small["card"],
                  shape=f"Cora scale, N={CORA_NODES}, uniform and power-law "
                        f"edges, normalized; F=1 over a column of ones (the "
                        f"degree walk), F={CORA_CLASSES}, F=64; walk: "
                        f"unit_items' cut, items_128: units of 128 items",
                  **small["graphs"]),
              "transposed": dict(k2["train_t"], shape="A^T, F=40",
                                 bench_width=dict(k2["bench_t"],
                                                  shape="A^T, F=128"),
                                 small=k2["small_transposed"])}
    lists = masked["lists"]
    entry3 = {"name": "ell_gather_masked", "route": "cuda",
              "source": "gnntf_tpu_torch/csrc/ell_gather.cu",
              "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
              "launches": default["launches"]["masked"], **masked["forward"],
              "shape": f"bench training grids' row list, E={graph.n_edges} "
                       f"edges, N=169343, F=40, keep {KEEP}",
              "bench_width": dict(masked["forward_bench"], shape="F=128"),
              "fused": fused_launches(fused, "ell_gather_masked_walk",
                                      "masked"),
              "fused_gaps": gaps_entry(gaps, "ell_gather_masked_walk", (
                  "16c_sgd_momentum", "16c_optax_adam")),
              **kernel_launches(gcnii, gcn, "masked"),
              "gcn_width": dict(masked["forward_gcn"], shape="F=64",
                                backward=masked["backward_gcn"]),
              "backward": dict(masked["backward"], shape="column list, F=40",
                               bench_width=dict(masked["backward_bench"],
                                                shape="F=128")),
              "small": masked["small"], "lists": lists,
              "streams": streams,
              "mesh": mesh_entry(mesh_products, mesh_train, "lazy",
                                 "masked"),
              "hier": hier_entry(hier_products, multihost, "lazy", "masked")}
    entry4 = {"name": "ell_degree_masked", "route": "cuda",
              "source": "gnntf_tpu_torch/csrc/degree_walk.cuh",
              "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
              "launches": default["launches"]["degree"], **masked["degree"],
              "shape": f"bench training grids' column list, E={graph.n_edges} "
                       f"edges, N=169343, keep {KEEP}",
              "fused": fused_launches(fused, DEGREE_WALK, "degree"),
              "fused_gaps": gaps_entry(gaps, DEGREE_WALK, (
                  "16c_sgd_momentum", "16c_optax_adam")),
              **kernel_launches(gcnii, gcn, "degree"),
              "row_list": masked["degree_row"],
              "bf16_values": dict(masked["degree_bf16"],
                                  row_list=masked["degree_row_bf16"]),
              "gspmd_slices": slice_entry(slices, multihost, "degree")}
    attn_entries = attention_entries(attention, gat, slices)
    for e in attn_entries:
        e["gspmd_slices"] = slice_entry(slices, multihost, e["name"])
    bf16_widths = {f"F={f}": bf16[f] for f in (CORA_CLASSES, LP_CLASSES,
                                                 N_CLASSES, 64, N_FEATURES)}
    bf16_entries = [
        {"name": "blocked_spmm_bf16_staged", "route": "cuda",
         "source": "gnntf_tpu_torch/csrc/bf16_walk.cuh",
         "replaces": "gnntf_tpu/ops/pallas/spmm.py:49",
         "launches": bf16["step"]["launches"]["k2_bf16s"],
         **entry_numbers(bf16[N_CLASSES]["walk"]),
         "shape": "RCM bench graph's forward list, N=169343, F=40, over x "
                  "cast to bfloat16 (launches: one serving product and one "
                  "training step through spmm_pallas(bf16=True))",
         "call_from_float32_x": bf16[N_CLASSES]["call"],
         "widths": bf16_widths,
         "bit_equal_to_cpu_plain_f40": bf16["bit_equal_to_cpu_plain_f40"],
         "step": bf16["step"]},
        {"name": "blocked_spmm_bf16_share", "route": "cuda",
         "source": "gnntf_tpu_torch/csrc/share_walk.cuh",
         "replaces": "gnntf_tpu/ops/pallas/spmm.py:49",
         "launches": bf16["step"]["launches"]["k2_bf16sh"],
         **entry_numbers(bf16[N_FEATURES]["walk"]),
         "shape": "RCM bench graph's forward list, N=169343, F=128, over x "
                  "cast to bfloat16 (launches: one serving product through "
                  "spmm_pallas(bf16=True))",
         "generic_walk": bf16[N_FEATURES]["generic"],
         "f64": bf16[64]["walk"], "f64_generic_walk": bf16[64]["generic"]},
        {"name": "blocked_spmm_bf16", "route": "cuda",
         "source": "gnntf_tpu_torch/csrc/blocked_spmm.cu",
         "replaces": "gnntf_tpu/ops/pallas/spmm.py:49",
         "launches": bf16["step"]["launches"]["k2_bf16"],
         **entry_numbers(bf16[CORA_CLASSES]["walk"]),
         "shape": "the generic walk (its narrow walk) over x cast to "
                  "bfloat16 on the RCM bench graph's forward list at F=7 "
                  "(launches: one serving product at F=7, where neither "
                  "the staged nor the share walk runs)",
         "f40": bf16[N_CLASSES]["generic"]}]
    for name, key, walk, shape in (
            ("ell_gather_masked_bf16", "masked_bf16", "row", "row list, F=40"),
            ("ell_degree_masked_bf16", "degree_bf16", "degree",
             "column list")):
        bf16_entries.append({
            "name": name, "route": "cuda",
            "source": "gnntf_tpu_torch/csrc/ell_gather.cu",
            "replaces": "gnntf_tpu/ops/pallas/dma_gather.py:40",
            "launches": bf16_train["launches"][key],
            **entry_numbers(bf16["masked"][f"bf16_{walk}"]),
            "shape": f"bench training grids' {shape}, uniform(0.5, 1.5) "
                     f"values in bfloat16, keep {KEEP} (launches: APPNP, "
                     f"3 epochs under GNNTF_GRID_VALUE_DTYPE=bfloat16)",
            "float32_values": bf16["masked"][f"float32_{walk}"]})
    bf16_entries[3]["backward"] = bf16["masked"]["bf16_column"]
    print(json.dumps({"kernels": [scaled_entry, scaled_backward_entry,
                                  entry, entry2, entry3,
                                  entry4, *attn_entries, *bf16_entries]}),
          flush=True)
    print(nvidia_smi("name,power.limit"), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
