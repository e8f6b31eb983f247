"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the hand-written kernels (``src/repro_torch/kernels/csrc``) with
nvcc for sm_90a, then drives the port's main path -- the streaming
heavy-hitter endpoint behind the serving engine -- at a size its users
would call real: per-(src, dst) flow heavy hitters over a 32-bit
two-module key (the paper's graph-edge / IPv4-pair modular key), a
``4 x (4096 + 4096^2)`` int32 hierarchy (268 MB on the card) fed up to 2M
distinct weighted edges carrying 20M arrivals in blocks of 65,536 rows.

Phases, any failure of which exits non-zero:

1. build the kernels from the sources; print the card and its power limit;
2. drive the main path (ingest, ``heavy_hitters``, ``topk``, one ``flush``
   of 16 mixed requests) with the launch counts zeroed just before and
   read just after; hold every answer and table bit for bit against a
   second endpoint on the plain PyTorch path, and against the exact heavy
   hitters from numpy (no false negatives).  Then the flat sketch path
   (``KernelSketch`` ingest + point queries), the same way.  Then the
   turnstile path (signed Count-Sketch, ``mode="signed"``): the same
   stream inserted whole and a seeded half of its distinct edges deleted
   whole, shuffled together, into a signed hierarchy and a signed flat
   sketch of the same widths; the signed threshold descent at phi of the
   net mass (its grids on K9m, the median over rows in the launch), K9's
   per-row estimates of the answer keys, whose median must equal their
   estimates, a block of signed point queries (one K7m launch: the median
   over rows in the launch) and their rows (one K7 launch), whose median
   must equal the estimates bit for bit.  Deletion must cancel bit
   for bit (the tables equal those of the kept half alone), and tables and
   answers must equal the plain path's on the card; recall and precision
   against the exact answer are printed, not asserted (the median descent
   is probabilistic).  Then the accuracy path (the paper's pipeline at
   ``examples/quickstart.py``'s h = 4,096, w = 5): a 2% sample, Thm-3
   ranges and Thm-4/5 selection (``choose_sketch``), then count-min,
   equal-sketch, mod-sketch and the selected spec each built linearly (K1)
   and conservatively (K5, shared-memory route) over the whole stream and
   queried through K2 on the top-500 and a random 500; every query must
   satisfy true <= conservative <= linear and every conservative cell must
   be <= its linear cell; the observed-error table is printed.  Then
   conservative heavy hitters (``mode="conservative"``) on the main path's
   spec: the endpoint and engine over the whole stream (K5i over both
   levels, level 1 on the global-memory route; K4 for the descent) and a
   flat conservative ``KernelSketch`` (K5, global route); no false
   negatives, the answer a subset of the linear main path's at the same
   threshold, and every table <= its linear twin cell by cell;
   Then the float32 tables: the main stream into a float32 flat sketch
   (K1f) and a float32 hierarchy (K3f), the turnstile stream into a
   float32 signed flat sketch (K6f); every partial sum stays below 2^24
   (checked), so each equals its int32 twin bit for bit.  Then the
   training path: ``train()`` on starcoder2-7b at its published width
   (d_model 4,608, 36 heads, 4 KV heads, d_ff 18,432, vocab 49,152),
   depth cut to 2 layers, 5 steps of 8 x 1,024 tokens with gradient
   compression (each of 9 large leaves folded by one K8f launch a step)
   and the in-step bigram sketch (K1) on: finite losses, bigram rows
   summing to 5 x 8 x 1,023, tokens/s, each step's split into
   forward+backward, compression, optimizer and n-gram fold, and the
   compressor's median over rows (CUDA events), peak memory; then one
   more gradient through every compressed leaf: exactly k distinct
   coordinates, ``corrected == dense + residual`` exactly, and K8f
   against its plain version on that real gradient within 2^-10 of the
   sum of |v| per cell.  Then the windowed path: the main stream in 16
   timestamped batches, two an epoch, through the DStream harness into a
   ``WindowedTopKService`` on a ring of 4 epochs (8 epochs, four expiries),
   once tumbling (int32, running sum), landmark (int32) and decay 0.9
   (float32, lazy Horner), folds on K3 or K3f and descents on K4 or K4f
   (the service's defaults on the card), each K4 grid replayed against its
   plain version before the next ingest;
   after each epoch the merged tables equal ``reference_window_state`` of
   the live epochs bit for bit (host copies), no key at or above the
   threshold is missed (tumbling, landmark), and ``heavy_hitters``/
   ``topk(100)`` equal the plain grid's on host copies; the harness's ARE,
   recall, precision and F2, ingest rows/s and query ms printed; one
   ``SketchServeEngine`` over a tumbling twin with ``advance()`` between
   epochs.  Then the re-tuning path: an endpoint on
   ``benchmarks/migrate_bench.py``'s stale spec at h = 2^24, w = 4, behind
   an engine with a range-search ``AutoTuner`` (sigma sketches on the
   card), fed 16 blocks of 65,536 rows of a module-skew flip with
   ``sync()`` after each; at least one migration cuts over, each cutover
   leaves the endpoint equal bit for bit to a fresh endpoint on the new
   spec fed the blocks since ``begin_migration``; every decision, the
   ingest rows/s with the double-write window open and shut and the
   cutover ingest's ms printed.  Then the extended accuracy path: FCM and
   FMOD beside count-min (K1, K2) on ``ipv4_stream()`` at h = 4,096, w = 5
   (FCM and FMOD within 5% of count-min or below; the three errors
   printed) and on
   the reference's Fig. 10 test stream (FMOD <= FCM <= count-min within
   5%), the card's FCM tables equal to the host's, and the telecom stream
   through K1 equal to the plain fold on the host;
3. hold each kernel (K1-K9, K7m, K9m, K5i, K1f, K3f, K4f, K6f, K8f) against
   its plain version on the card at the shapes its path gives it (int32 and
   integer-valued float32: bit-identical; K4, K4f, K9 and K9m on every grid
   their paths launched, K4 and K4f on both routes, K9m also against the median of
   K9's rows bit for bit, K7m against the median of K7's; K2 at each of
   its 16 accuracy-path calls; K8f at all 9 leaf shapes; K5 and
   K5i also on float32 tables fed non-integer frequencies, bit-identical),
   K5, K3, K3f, K8 and K8f on both residency routes (K8 also on the
   stream's first block in its sorted order, K3 and K5's shared route also
   on the stream's heaviest block: the one whose top source holds the most
   rows), K1 at every shape its paths launch it (the accuracy path's
   count-min, equal-sketch and mod-sketch at blocks 0, 7 and 13, the flat
   path's heaviest block, the training path's bigram fold);
4. time each kernel, its plain version and the closest single PyTorch
   call with CUDA events, with L2 evicted before each call as the main
   path finds the tables cold; read the kernel's own device time with
   torch.profiler; set both beside the least time the card could take,
   and K5/K5i also beside their depth bound (one access to the table in
   HBM, then D_r dependent steps of the fold's recurrence in registers,
   both latencies measured by a probe kernel; D, D_r and S of each timed
   block from ``fold_depths``),
   K2, K7 and K7m also beside the sector bound (32 bytes a random cell
   read), K7m also beside K7 then ``median_rows``;
   K8f, K1, K6 and K6f beside probes of what bounds them (a finest level
   or a flat table that fits L2, all-zero values; for the flat folds also
   the adds a warp combine would save); K1 also at each of those shapes;
   K4 and K4f also at every (P, C) the main path and the decayed window
   launched (device time, and their sum over the launches) and at the
   largest, on the direct route too;
5. drive the main path, the turnstile path, the conservative path and one
   train step once more under torch.profiler for the device's busy and
   idle share and the share of its busy time in sorting kernels.

The second line from the end is one JSON object with a row per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import tree as tr  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import countsketch as cs  # noqa: E402
from repro_torch.core import window as win  # noqa: E402
from repro_torch.core.fcm import FCM, fcm_spec, fmod_spec  # noqa: E402
from repro_torch.core import hierarchy as hh  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.hashing import KeySchema, draw_hash_params_np  # noqa: E402
from repro_torch.core.range_opt import optimal_ranges_mod2  # noqa: E402
from repro_torch.core.selection import choose_sketch, seeded_draw  # noqa: E402
from repro_torch.core.summary import SpaceSaving  # noqa: E402
from repro_torch.device import as_index_tensor  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import hier_query as hq  # noqa: E402
from repro_torch.kernels import hier_update as hu  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import sketch_query as sq  # noqa: E402
from repro_torch.kernels import sketch_update as su  # noqa: E402
from repro_torch.kernels import sketch_update_conservative as scu  # noqa: E402
from repro_torch.kernels.hashes import all_indices, all_sign_bits, make_plan  # noqa: E402
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serving.autotune import AutoTuner, seeded_key_draw  # noqa: E402
from repro_torch.serving.sharded_topk import threshold_descent_topk  # noqa: E402
from repro_torch.serving.sketch_engine import (  # noqa: E402
    SketchServeEngine,
    SketchTopKEndpoint,
)
from repro_torch.serving.windowed_topk import WindowedTopKService  # noqa: E402
from repro_torch.streams import (  # noqa: E402
    DStreamHarness,
    exact_heavy_hitters,
    group_candidates,
    ipv4_stream,
    observed_error,
    skew_flip_batches,
    telecom_stream,
    timestamped_batches,
    zipf_graph_stream,
)
from repro_torch.training import grad_compression as gc  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import train_loop as tl  # noqa: E402

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, and
# the non-tensor 32-bit ALU rate, used for the kernels' integer and float
# operations
MEM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 67e12

DEVICE = "cuda"
BLOCK = 1 << 16
RANGES = (4096, 4096)
WIDTH = 4
PHI = 0.002
# candidate pools as wide as a level's range: a coarse level of 4096 cells
# cannot separate more prefixes than that, so wider pools only widen the
# saturated level-1 grids of low top-k thresholds
POOL = 4096
# 10x the reference's own "twitter-like" default (streams/synthetic.py)
STREAM = dict(n_src=200_000, n_tgt=600_000, n_edges=2_000_000,
              n_occurrences=20_000_000, s_src=1.1, s_tgt=1.1)
# the accuracy path: examples/quickstart.py's table, sample and query sets;
# K1 is timed there at blocks ACC_BLOCKS of the stream (block 7's top
# source holds 47,576 of its 65,536 rows, block 13's 26,715)
H_ACC, W_ACC, SAMPLE, N_QUERIES = 4096, 5, 0.02, 500
ACC_BLOCKS = (0, 7, 13)
# the training path: starcoder2-7b at its published width, depth cut to 2
# layers (32 would need 56 GB for the float32 Adam moments alone)
TRAIN_ARCH, TRAIN_LAYERS = "starcoder2-7b", 2
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 1024, 5
# K8f on the real gradient: |kernel - plain| <= REAL_GRAD_TOL * sum |v| per
# cell (float atomics add in another order; a level-0 cell sums ~10^5
# values, whose float32 sum in any order is off by far less)
REAL_GRAD_TOL = 2.0 ** -10
PLAIN_CHUNK = 1 << 25
# K6/K6f's bound probe: the flat table's ranges cut so that it fits the
# card's 50 MB L2 (4 x 2^20 int32 or float32 cells, 16 MB)
L2_RANGES = (1024, 1024)
# the windowed path: the main stream in 16 timestamped batches (its 16
# blocks' worth), two an epoch, on a ring of 4 epochs: 8 epochs, four expiries
WINDOW_EPOCHS, WINDOW_BATCHES, BATCHES_PER_EPOCH = 4, 16, 2
WINDOW_MODES = (("tumbling", 1.0), ("landmark", 1.0), ("decay", 0.9))
# the re-tuning path: benchmarks/migrate_bench.py's stale spec, (H // 64,
# 64), at h = 2^24, fed 16 blocks of a module-skew flip
RETUNE_H, RETUNE_BLOCKS = 1 << 24, 16
# the reference's Fig. 10 test (tests/test_fcm_countsketch.py): its stream
# and (h, w), where it asserts FMOD <= FCM <= count-min
FIG10_STREAM = dict(n_src=20_000, n_tgt=60_000, n_edges=300_000, n_occurrences=1_500_000,
                    s_src=0.7, s_tgt=0.7, seed=1)
FIG10_HW = (2048, 6)
CSRC = "src/repro_torch/kernels/csrc/"
# kernel name: (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "sketch_update": ("hier_fold.cuh", "src/repro/kernels/sketch_update.py:124"),
    "sketch_query": ("point_query.cuh", "src/repro/kernels/sketch_query.py:47"),
    "hier_update": ("hier_fold.cuh", "src/repro/kernels/hier_update.py:183"),
    "hier_query": ("hier_query.cuh", "src/repro/kernels/hier_query.py:53"),
    # K4's body on float32 tables: no Pallas kernel computes this grid, the
    # reference's jnp hier_candidate_query_ref on its float (decayed) tables
    "hier_query_f32": ("hier_query.cuh", "src/repro/core/hierarchy.py:560"),
    "sketch_update_signed": ("signed_kernels.cu",
                             "src/repro/kernels/sketch_update.py:184"),
    "sketch_query_signed": ("point_query.cuh", "src/repro/kernels/sketch_query.py:114"),
    # K7 with the median over rows fused (the reference takes it after the
    # kernel, src/repro/kernels/ops.py:211)
    "sketch_query_signed_median": ("point_query.cuh", "src/repro/kernels/sketch_query.py:114"),
    "hier_update_signed": ("hier_fold.cuh", "src/repro/kernels/hier_update.py:319"),
    "hier_query_signed": ("hier_query.cuh", "src/repro/kernels/hier_query.py:150"),
    # K9 with the median over rows fused (the reference takes it after the
    # kernel, src/repro/core/countsketch.py:371)
    "hier_query_signed_median": ("hier_query.cuh", "src/repro/kernels/hier_query.py:150"),
    "sketch_update_conservative": ("conservative_kernels.cu",
                                   "src/repro/kernels/sketch_update_conservative.py:114"),
    # no Pallas kernel computes this fold: the reference's jnp fori_loop
    "conservative_fold": ("conservative_kernels.cu", "src/repro/core/sketch.py:253"),
    # the float32 table bodies of K1, K3, K6 and K8
    "sketch_update_f32": ("hier_fold.cuh", "src/repro/kernels/sketch_update.py:60"),
    "hier_update_f32": ("hier_fold.cuh", "src/repro/kernels/hier_update.py:161"),
    "sketch_update_signed_f32": ("signed_kernels.cu",
                                 "src/repro/kernels/sketch_update.py:99"),
    "hier_update_signed_f32": ("hier_fold.cuh", "src/repro/kernels/hier_update.py:293"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"FAILED: {what}")


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card's clock, calls back
    to back after one warm-up call."""
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


def cold_ms(fn, reps: int, evict) -> float:
    """Mean milliseconds per call of ``fn`` on the card's clock with L2
    evicted (``evict()``) before each call.  Each call sits between its own
    pair of events, recorded after the eviction was queued: the host queues
    the call while the card evicts, so the pair spans the call alone."""
    fn()
    pairs = []
    for _ in range(reps):
        evict()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def device_kernels(fn):
    """Run ``fn`` under torch.profiler; returns (result, host seconds,
    [(kernel name, device microseconds)] for every kernel it ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out, secs = wall(fn)
    kernels = [(e.name, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == DeviceType.CUDA]
    return out, secs, kernels


def kernel_device_ms(fn, kernel: str, reps: int, evict):
    """Mean device milliseconds of the CUDA kernel whose name contains
    ``kernel``, per launch, over ``reps`` calls of ``fn`` each after an L2
    eviction.  A trace that holds no such kernel (the profiler has
    returned such traces) is taken again, up to three times in all; None
    after that."""
    fn()
    for _ in range(3):
        _, _, kernels = device_kernels(lambda: [(evict(), fn()) for _ in range(reps)])
        times = [us for name, us in kernels if kernel in name]
        if times:
            return sum(times) / len(times) / 1e3
    return None


def wall(fn):
    """(result, seconds) of ``fn`` on the host clock, ended by a sync."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t


def bound_ms(n_bytes: int, n_ops: int):
    t_bytes, t_ops = n_bytes / MEM_BYTES_PER_S, n_ops / ALU_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Exact for int32 and float32 values (both fit float64)."""
    return float((a.to(torch.float64) - b.to(torch.float64)).abs().max())


def nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def key_bytes(schema, n_keys: int) -> int:
    """Bytes of ``n_keys`` keys at their own width: one uint32 per module
    (every domain is at most 2^32), as the reference's uint32[B, modules]
    items.  The int64 chunks the port's kernels read are its own layout,
    not bytes the function needs."""
    return 4 * n_keys * schema.modularity


def param_bytes(q: torch.Tensor, r: torch.Tensor) -> int:
    """Hash params at their own width: uint32 each, as the reference holds
    them (the port keeps them in int64)."""
    return 4 * (q.numel() + r.numel())


def point_query_bytes(spec, plan, table, chunks, q, r, signs=(), out_bytes=0):
    """The bytes a block of point queries (K2, K7, K7m) must move, two ways:
    (bytes, sector bytes).  Both count the keys, the params (``signs``, the
    sign params, too) and the output ``out_bytes``; bytes then count 4 B a
    distinct cell read, sector bytes the int64 chunks the kernels read and
    32 B a distinct 32-byte sector the cells lie in (a random 4-byte read
    moves a sector)."""
    w, h_pad = table.shape
    idx = all_indices(plan, chunks, q, r)
    cells = (torch.arange(w, device=table.device)[:, None] * h_pad + idx).reshape(-1)
    params = param_bytes(q, r) + (param_bytes(*signs) if signs else 0)
    n_bytes = key_bytes(spec.schema, chunks.shape[0]) + params + out_bytes
    return (n_bytes + 4 * int(torch.unique(cells).numel()),
            params + out_bytes + nbytes(chunks) + 32 * int(torch.unique(cells // 8).numel()))


class AllGlobal:
    """The hierarchy folds' other route while installed (K3, K3f, K8, K8f):
    the residency rule (``hier_update.fold_geometry``) given no shared
    memory, so the same kernel adds every level with global atomics."""

    def __enter__(self):
        self._orig = rule = hu.fold_geometry
        hu.fold_geometry = lambda *args, **kw: rule(*args, **{**kw, "shared_bytes": 0})
        return self

    def __exit__(self, *exc):
        hu.fold_geometry = self._orig


def fold_geometry_note(hplan, w: int, n: int, itemsize: int) -> dict:
    """The launch the residency rule gives a hierarchy fold for n keys on
    this card: each level's route, the shared bytes a CTA, the CTAs and
    their span."""
    g = hu.fold_geometry(hplan, w, n, itemsize,
                         torch.cuda.get_device_properties(0).multi_processor_count)
    return {"levels": ["shared" if on else "global" for on in g.shared],
            "shared_bytes": g.shared_bytes, "ctas": g.ctas, "span_tiles": g.span_tiles}


def flat_deal_note(w: int, n: int) -> dict:
    """The CTAs a row and their span that K1/K1f launch for n keys into w
    rows on this card (``sketch_update.flat_deal``)."""
    ctas, span = su.flat_deal(w, n, torch.cuda.get_device_properties(0).multi_processor_count)
    return {"ctas": ctas, "span_tiles": span}


def both_routes_err(fold, plain) -> float:
    """Max |err| of a hierarchy fold (K3, K3f, K8, K8f) against ``plain()``
    on the rule's route and on the all-global route; ``fold()`` runs the
    kernel on a fresh table."""
    want = plain()
    err = max_abs_err(fold(), want)
    with AllGlobal():
        return max(err, max_abs_err(fold(), want))


class Recorded:
    """Records the inputs (and results) of every call of a function
    (``module.name``) while installed, so a kernel is checked and timed at
    the shapes the path gives it.  It wraps the wrapper and counts nothing:
    the launch count stays the wrapper's own."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls, self.kwargs, self.results = [], [], []
        self._orig = None

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def recording(*args, **kwargs):
            self.calls.append(args)
            self.kwargs.append(kwargs)
            out = self._orig(*args, **kwargs)
            self.results.append(out)
            return out

        setattr(self.module, self.name, recording)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)

    def shapes(self) -> dict:
        """{(P, C): number of calls} over the recorded calls (pp and cp are
        the second and third arguments of every grid wrapper)."""
        out = {}
        for call in self.calls:
            key = (call[1].shape[1], call[2].shape[1])
            out[key] = out.get(key, 0) + 1
        return out

    def call_at(self, shape):
        """The arguments and keywords of the first call at (P, C)."""
        i = next(i for i, call in enumerate(self.calls)
                 if (call[1].shape[1], call[2].shape[1]) == shape)
        return self.calls[i], self.kwargs[i]

    def most_launched(self):
        """The (P, C) launched most often (the larger grid on a tie), and
        one call's arguments and keywords at that shape."""
        shapes = self.shapes()
        shape = max(shapes, key=lambda s: (shapes[s], s[0] * s[1]))
        return shape, self.call_at(shape)


class Timed:
    """Records a CUDA event just before and just after every call of a
    function (``module.name``) while installed: a phase of the train step
    is timed by wrapping the function that does it, with no hook in the
    library."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.events = []
        self._orig = None

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def timed(*args, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self._orig(*args, **kwargs)
            end.record()
            self.events.append((start, end))
            return out

        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self._orig)


def step_split(loss, comp, optim, grams, fold) -> list:
    """Each train step's phases in ms from the events of :class:`Timed`:
    forward+backward from the loss's start to the compressor's, then the
    compressor, the optimizer, and the n-gram fold from its bigrams to the
    end of its K1 launch."""
    return [{"forward_backward": l[0].elapsed_time(c[0]),
             "compression": c[0].elapsed_time(c[1]),
             "optimizer": o[0].elapsed_time(o[1]),
             "ngram": g[0].elapsed_time(f[1])}
            for l, c, o, g, f in zip(loss.events, comp.events, optim.events,
                                     grams.events, fold.events, strict=True)]


def hash_ops(plan, n_keys: int) -> int:
    """Integer operations of one composite hash per (row, key): a multiply
    and an add per chunk, a Mersenne fold, a range mod and a stride
    multiply-add per group."""
    return plan.width * n_keys * (2 * plan.total_chunks + 8 * len(plan.ranges))


def same_answers(a, b) -> bool:
    return (a[0].shape == b[0].shape and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1]))


# --------------------------------------------------------------------------
# phase 2: the main path, and the flat sketch path
# --------------------------------------------------------------------------

def drive_endpoint(spec, params, stream, thr, *, kernels: bool):
    """Ingest the stream and answer the main path's queries through the
    engine; returns (engine, answers, timings)."""
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                            use_update_kernel=kernels, use_kernel=kernels,
                            device=None if kernels else DEVICE)
    eng = SketchServeEngine(ep, max_staleness=0)
    items, freqs = stream.items, stream.freqs

    def ingest():
        for s in range(0, items.shape[0], BLOCK):
            eng.ingest(items[s : s + BLOCK], freqs[s : s + BLOCK])
        eng.drain()

    _, t_ingest = wall(ingest)
    _, t_snap = wall(eng.sync)
    eng.heavy_hitters(thr)                       # warm-up: first launches
    hh_ans, t_hh = wall(lambda: eng.heavy_hitters(thr))
    top_ans, t_top = wall(lambda: eng.topk(100))
    for k in (1, 5, 10, 25, 50, 100, 200, 400):
        eng.submit_topk(k)
    for m in (0.5, 1, 2, 4, 8, 16, 32, 64):
        eng.submit_heavy_hitters(int(thr * m))
    done, t_flush = wall(eng.flush)
    check(len(done) == 16 and all(r.done for r in done), "flush served 16 requests")
    times = {"ingest_s": t_ingest, "ingest_rows_per_s": items.shape[0] / t_ingest,
             "ingest_arrivals_per_s": int(freqs.sum()) / t_ingest,
             "snapshot_ms": t_snap * 1e3, "heavy_hitters_ms": t_hh * 1e3,
             "topk100_ms": t_top * 1e3, "flush16_ms": t_flush * 1e3}
    answers = [hh_ans, top_ans] + [(r.items, r.est) for r in done]
    return eng, answers, times


def main_path(spec, params, stream, thr, exact_items):
    with Recorded(hq, "hier_candidate_query") as grids:
        _cuda.reset_launches()
        eng_k, ans_k, t_k = drive_endpoint(spec, params, stream, thr, kernels=True)
        launches = dict(_cuda.LAUNCHES)
    log(f"main path launches: {launches}; K4 grid shapes (P, C): {grids.shapes()}")
    check(launches["hier_update"] > 0, "K3 (hier_update) launched on the main path")
    check(launches["hier_query"] > 0, "K4 (hier_query) launched on the main path")
    check(len(grids.calls) == launches["hier_query"],
          "every K4 call of the main path was recorded")

    eng_p, ans_p, t_p = drive_endpoint(spec, params, stream, thr, kernels=False)
    sd_k, sd_p = eng_k.backend.state_dict(), eng_p.backend.state_dict()
    check(sd_k.keys() == sd_p.keys(), "state_dict keys agree")
    for key in sd_k:
        check(sd_k[key].dtype == sd_p[key].dtype and np.array_equal(sd_k[key], sd_p[key]),
              f"kernel and plain endpoints agree bit for bit on {key}")
    for i, (a, b) in enumerate(zip(ans_k, ans_p)):
        check(same_answers(a, b), f"answer {i} agrees between kernel and plain paths")

    hh_items, hh_est = ans_k[0]
    check(hh_items.dtype == np.uint32 and hh_items.shape[1] == 2
          and hh_est.dtype == np.int64 and np.all(hh_est >= thr),
          "heavy_hitters returns uint32[K, 2] keys with estimates >= threshold")
    found = {tuple(r) for r in hh_items.tolist()}
    missing = [tuple(r) for r in exact_items.tolist() if tuple(r) not in found]
    check(not missing, f"no false negatives ({len(missing)} exact heavy hitters missing)")
    top_items, top_est = ans_k[1]
    check(top_items.shape == (100, 2) and np.all(np.diff(top_est) <= 0),
          "topk(100) returns 100 keys by descending estimate")
    e2e = {"kernel": t_k, "plain": t_p, "heavy_hitters_found": int(hh_items.shape[0]),
           "exact_heavy_hitters": int(exact_items.shape[0])}
    return eng_k, launches, grids, e2e, ans_k[0]


def flat_path(spec, params, stream):
    items, freqs = stream.items, stream.freqs
    sel = np.random.default_rng(1).choice(items.shape[0], BLOCK, replace=False)
    queries = items[sel]
    _cuda.reset_launches()
    ks = KernelSketch(spec, params, block_b=BLOCK)
    _, t_ingest = wall(lambda: ks.update(items, freqs))
    est_k, t_query = wall(lambda: ks.query(queries))
    launches = dict(_cuda.LAUNCHES)
    log(f"flat path launches: {launches}")
    check(launches["sketch_update"] > 0, "K1 (sketch_update) launched on the flat path")
    check(launches["sketch_query"] > 0, "K2 (sketch_query) launched on the flat path")

    plain, t_plain = wall(lambda: sk.build_sketch(spec, params, items, freqs,
                                                  block=BLOCK, device=DEVICE))
    check(torch.equal(ks.state().table, plain.table), "flat tables agree bit for bit")
    est_p = sk.query(spec, plain, queries).cpu().numpy()
    check(np.array_equal(est_k, est_p), "flat point queries agree")
    check(bool(np.all(est_k >= freqs[sel])), "Count-Min estimates never underestimate")
    e2e = {"ingest_s": t_ingest, "ingest_rows_per_s": items.shape[0] / t_ingest,
           "query65536_ms": t_query * 1e3, "plain_ingest_s": t_plain}
    return ks, launches, e2e


# --------------------------------------------------------------------------
# the turnstile path: signed Count-Sketch
# --------------------------------------------------------------------------

def turnstile_deletions(n: int, seed: int):
    """The seeded half of the stream's n distinct edges that the turnstile
    deletes (a bool mask), and the generator that goes on to shuffle it."""
    rng = np.random.default_rng((seed, 12))
    gone = np.zeros(n, bool)
    gone[rng.permutation(n)[: n // 2]] = True
    return gone, rng


def turnstile_stream(stream, seed: int):
    """The stream inserted whole and a seeded random half of its distinct
    edges deleted whole (-f), the rows of both signs shuffled together so
    every block carries both.  Returns (items, freqs, kept items, kept
    freqs)."""
    gone, rng = turnstile_deletions(stream.items.shape[0], seed)
    items = np.concatenate([stream.items, stream.items[gone]])
    freqs = np.concatenate([stream.freqs, -stream.freqs[gone]])
    order = rng.permutation(items.shape[0])
    return items[order], freqs[order], stream.items[~gone], stream.freqs[~gone]


def ingest_blocks(target, items, freqs) -> None:
    for s in range(0, items.shape[0], BLOCK):
        target.update(items[s : s + BLOCK], freqs[s : s + BLOCK])


def answer_rows(hspec, state, items) -> torch.Tensor:
    """K9's per-row signed estimates of the descent's answer keys
    (``items`` uint32[K, 2] in schema order): the level-1 grid of their
    prefixes by their values, whose diagonal child (i, i) is key i,
    float32[w, K] (robustness filters on top of the median read these)."""
    level = hspec.n_levels - 1
    prefixes = hspec.level_items(level - 1, items)
    values = items[:, list(hspec.base.partition[level])]
    pp, cp, sp, sc = cs.candidate_signed_partials(hspec, state.params, level,
                                                  prefixes, values)
    grid = hq.hier_candidate_query_signed(state.tables[level], pp, cp, sp, sc,
                                          span=hh.candidate_span(hspec, level))
    diag = torch.arange(items.shape[0], device=grid.device)
    return grid[:, diag, diag].to(torch.float32)


def turnstile_path(spec, hspec, cs_params, stream, seed):
    items, freqs, kept_items, kept_freqs = turnstile_stream(stream, seed)
    net = int(kept_freqs.sum())
    thr = PHI * net
    exact_items, _ = exact_heavy_hitters(kept_items, kept_freqs, thr)
    cands = group_candidates(spec, stream.items)     # distinct sources, targets
    queries = stream.items[np.random.default_rng(3).choice(
        stream.items.shape[0], BLOCK, replace=False)]
    log(f"turnstile: {items.shape[0]} rows ({int((freqs < 0).sum())} deletions), "
        f"net mass {net}, threshold {thr}, {exact_items.shape[0]} exact heavy "
        f"hitters, candidates {[c.shape[0] for c in cands]}")

    def descend(state, use_kernel):
        return cs.find_heavy_hitters(hspec, state, thr, cands, use_kernel=use_kernel)

    with Recorded(hq, "hier_candidate_median_signed") as grids:
        _cuda.reset_launches()
        kh = KernelHierarchy(hspec, cs_params, block_b=BLOCK, mode="signed")
        ks = KernelSketch(spec, cs_params, block_b=BLOCK, mode="signed")
        _, t_hier = wall(lambda: ingest_blocks(kh, items, freqs))
        _, t_flat = wall(lambda: ingest_blocks(ks, items, freqs))
        descend(kh.cs_state(), True)                 # warm-up: first launches
        n_warm = len(grids.calls)
        hh_k, t_desc = wall(lambda: descend(kh.cs_state(), True))
        rows_k, t_rows = wall(lambda: answer_rows(hspec, kh.cs_state(), hh_k[0]))
        before_query = dict(_cuda.LAUNCHES)
        est_k, t_query = wall(lambda: ks.query(queries))
        before_rows = dict(_cuda.LAUNCHES)
        qrows_k, t_qrows = wall(lambda: ks.query_rows(queries))
        launches = dict(_cuda.LAUNCHES)
    log(f"turnstile path launches: {launches}; K9m grid shapes (P, C): {grids.shapes()}")
    for name, kid in (("sketch_update_signed", "K6"), ("sketch_query_signed", "K7"),
                      ("sketch_query_signed_median", "K7m"),
                      ("hier_update_signed", "K8"), ("hier_query_signed_median", "K9m"),
                      ("hier_query_signed", "K9")):
        check(launches[name] > 0, f"{kid} ({name}) launched on the turnstile path")
    check(before_rows["sketch_query_signed_median"] == before_query["sketch_query_signed_median"]
          + 1 and before_rows["sketch_query_signed"] == before_query["sketch_query_signed"],
          "the signed point queries took one K7m launch and no K7 launch")
    check(launches["sketch_query_signed"] == before_rows["sketch_query_signed"] + 1
          and launches["sketch_query_signed_median"] == before_rows["sketch_query_signed_median"],
          "query_rows took one K7 launch")
    check(np.array_equal(cs.median_rows(torch.from_numpy(qrows_k)).numpy().view(np.int32),
                         est_k.view(np.int32)),
          "median_rows of K7's rows equals the K7m estimates bit for bit")
    check(len(grids.calls) == launches["hier_query_signed_median"] == 2 * n_warm,
          "every K9m call of the turnstile path was recorded, the same grids in both "
          "descents")
    check(torch.equal(cs.median_rows(rows_k).cpu(), torch.from_numpy(hh_k[1])),
          "the median of K9's rows of each answer key equals its descent estimate")

    # deletion cancels exactly: the tables are those of the kept half alone
    kept_h = KernelHierarchy(hspec, cs_params, block_b=BLOCK, mode="signed")
    kept_f = KernelSketch(spec, cs_params, block_b=BLOCK, mode="signed")
    ingest_blocks(kept_h, kept_items, kept_freqs)
    ingest_blocks(kept_f, kept_items, kept_freqs)
    check(torch.equal(kh.table, kept_h.table),
          "signed hierarchy after deletions equals the kept half's, bit for bit")
    check(torch.equal(ks.table, kept_f.table),
          "signed flat sketch after deletions equals the kept half's, bit for bit")
    del kept_h, kept_f

    # the plain path on the same card
    plain_h = cs.init_hierarchy(hspec, cs_params, dtype=torch.int32, device=DEVICE)
    plain_f = cs.init_state(spec, cs_params, dtype=torch.int32, device=DEVICE)

    def plain_ingest():
        nonlocal plain_h, plain_f
        for s in range(0, items.shape[0], BLOCK):
            blk_i, blk_f = items[s : s + BLOCK], freqs[s : s + BLOCK]
            plain_h = cs.hier_update(hspec, plain_h, blk_i, blk_f)
            plain_f = cs.update(spec, plain_f, blk_i, blk_f)

    _, t_plain = wall(plain_ingest)
    for lvl, (a, b) in enumerate(zip(kh.cs_state().tables, plain_h.tables)):
        check(torch.equal(a, b), f"signed level {lvl} agrees with the plain path")
    check(torch.equal(ks.cs_state().table, plain_f.table),
          "signed flat table agrees with the plain path")
    hh_p, t_desc_plain = wall(lambda: descend(plain_h, False))
    check(same_answers(hh_k, hh_p), "signed descent: kernel and plain paths give the "
          "same items and float32 estimates")
    est_p = cs.query(spec, plain_f, queries).cpu().numpy()
    check(np.array_equal(est_k, est_p), "signed point queries agree")

    hh_items, hh_est = hh_k
    check(hh_items.dtype == np.uint32 and hh_items.shape[1] == 2
          and hh_est.dtype == np.float32 and bool(np.all(np.isfinite(hh_est)))
          and bool(np.all(np.abs(hh_est) >= thr))
          and bool(np.all(np.diff(np.abs(hh_est)) <= 0)),
          "signed heavy hitters: uint32[K, 2] keys, finite float32 estimates "
          "with |estimate| >= threshold, by descending |estimate|")
    check(est_k.shape == (BLOCK,) and est_k.dtype == np.float32
          and bool(np.all(np.isfinite(est_k))), "signed point queries: finite float32[Q]")
    found = {tuple(r) for r in hh_items.tolist()}
    truth = {tuple(r) for r in exact_items.tolist()}
    hits = len(found & truth)
    e2e = {"rows": int(items.shape[0]), "deletions": int((freqs < 0).sum()),
           "net_mass": net, "threshold": thr,
           "exact_heavy_hitters": len(truth), "found": len(found),
           "recall": hits / len(truth) if truth else None,
           "precision": hits / len(found) if found else None,
           "hier_ingest_s": t_hier, "hier_ingest_rows_per_s": items.shape[0] / t_hier,
           "flat_ingest_s": t_flat, "flat_ingest_rows_per_s": items.shape[0] / t_flat,
           "descent_ms": t_desc * 1e3, "descent_launches": n_warm,
           "answer_rows_ms": t_rows * 1e3, "query65536_ms": t_query * 1e3,
           "query_rows65536_ms": t_qrows * 1e3,
           "plain_ingest_s": t_plain, "plain_descent_ms": t_desc_plain * 1e3}
    del plain_h, plain_f
    return kh, ks, (items, freqs, queries), launches, grids, e2e


# --------------------------------------------------------------------------
# the accuracy path and conservative heavy hitters
# --------------------------------------------------------------------------

def accuracy_path(stream, seed):
    """The paper's pipeline at examples/quickstart.py's size, on the card:
    a uniform 2% sample, Thm-3 ranges and Thm-4/5 selection, then each of
    count-min, equal-sketch, mod-sketch and the selected spec built over
    the whole stream linearly (K1) and conservatively (K5) from one draw,
    and queried (K2).  Returns (the mod-sketch's conservative sketch, the
    linear sketches by name, launches, e2e, and K2's calls recorded with a
    label each -- spec, query set, linear or conservative -- and the spec)."""
    rng = np.random.default_rng((seed, 13))
    s_items, s_freqs = stream.sample(SAMPLE, rng)
    draw = seeded_draw(seed)
    result, t_choose = wall(lambda: choose_sketch(s_items, s_freqs, stream.schema,
                                                  H_ACC, W_ACC, draw))
    a, b = result.mod_ranges
    log(f"accuracy: {s_items.shape[0]} sampled edges; Thm-3 ranges a={a}, b={b}; "
        f"selected {result.choice} (sigma {result.sigma}) in {t_choose:.3f} s")
    specs = {"count-min": sk.count_min_spec(stream.schema, H_ACC, W_ACC),
             "equal-sketch": sk.equal_sketch_spec(stream.schema, H_ACC, W_ACC),
             "mod-sketch": sk.mod_sketch_spec(stream.schema, [(0,), (1,)], (a, b), W_ACC),
             "selected": result.spec}
    qsets = {"top-500": stream.top_k_queries(N_QUERIES),
             "random-500": stream.random_k_queries(N_QUERIES, rng)}
    _cuda.reset_launches()
    rows, built, linear, k2_labels = {}, {}, {}, []
    with Recorded(kops, "sketch_query") as k2_calls:
        for name, spec in specs.items():
            params = draw(0, spec)
            lin = KernelSketch(spec, params, block_b=BLOCK)
            cons = KernelSketch(spec, params, block_b=BLOCK, mode="conservative")
            check(scu.residency(W_ACC, cons.h_pad, 4) == "shared",
                  f"{name}: the {W_ACC} x {cons.h_pad} int32 table takes K5's shared route")
            _, t_lin = wall(lambda: lin.update(stream.items, stream.freqs))
            _, t_cons = wall(lambda: cons.update(stream.items, stream.freqs))
            check(bool((cons.table <= lin.table).all()),
                  f"{name}: every conservative cell <= its linear cell")
            errs = {}
            for qname, (qi, qf) in qsets.items():
                e_lin, e_cons = lin.query(qi), cons.query(qi)
                k2_labels += [(f"{name} {qname} {kind}", spec)
                              for kind in ("linear", "conservative")]
                check(bool(np.all(qf <= e_cons)) and bool(np.all(e_cons <= e_lin)),
                      f"{name} {qname}: true <= conservative <= linear on every query")
                errs[qname] = {"linear": observed_error(e_lin, qf),
                               "conservative": observed_error(e_cons, qf)}
            rows[name] = {"spec": spec.describe(), "errors": errs,
                          "linear_ingest_s": t_lin, "conservative_ingest_s": t_cons}
            log(f"  {name:13s} " + "  ".join(
                f"{q}: linear {e['linear']:.4f} conservative {e['conservative']:.4f}"
                for q, e in errs.items()) + f"   ({spec.describe()})")
            built[name], linear[name] = cons, lin
        launches = dict(_cuda.LAUNCHES)
    check(len(k2_calls.calls) == len(k2_labels) == launches["sketch_query"],
          "every K2 call of the accuracy path was recorded")
    log(f"accuracy path launches: {launches}")
    for kname, kid in (("sketch_update", "K1"), ("sketch_update_conservative", "K5"),
                       ("sketch_query", "K2")):
        check(launches[kname] > 0, f"{kid} ({kname}) launched on the accuracy path")
    e2e = {"sample_rows": int(s_items.shape[0]), "sample_mass": int(s_freqs.sum()),
           "choose_s": t_choose, "choice": result.choice, "sigma": result.sigma,
           "mod_ranges": [a, b], "specs": rows}
    return built["mod-sketch"], linear, launches, e2e, (k2_calls, k2_labels)


def conservative_path(spec, params, stream, thr, exact_items, lin_answer, lin_state,
                      lin_flat):
    """Conservative heavy hitters on the main path's spec: the endpoint and
    engine over the whole stream (K5i, K4) and a flat conservative sketch
    (K5), each held against its linear twin from the same draw."""
    _cuda.reset_launches()
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                            use_kernel=True, mode="conservative")
    eng = SketchServeEngine(ep, max_staleness=0)
    items, freqs = stream.items, stream.freqs

    def ingest():
        for s in range(0, items.shape[0], BLOCK):
            eng.ingest(items[s : s + BLOCK], freqs[s : s + BLOCK])
        eng.drain()

    _, t_ingest = wall(ingest)
    eng.heavy_hitters(thr)                       # warm-up: first launches
    hh_ans, t_hh = wall(lambda: eng.heavy_hitters(thr))
    top_ans, t_top = wall(lambda: eng.topk(100))
    ks = KernelSketch(spec, params, block_b=BLOCK, mode="conservative")
    _, t_flat = wall(lambda: ks.update(items, freqs))
    launches = dict(_cuda.LAUNCHES)
    log(f"conservative path launches: {launches}")
    for kname, kid in (("conservative_fold", "K5i"), ("hier_query", "K4"),
                       ("sketch_update_conservative", "K5")):
        check(launches[kname] > 0, f"{kid} ({kname}) launched on the conservative path")
    routes = [scu.residency(WIDTH, st.table.shape[1], 4) for st in ep.state.states]
    check(routes == ["shared", "global"] and
          scu.residency(WIDTH, ks.h_pad, 4) == "global",
          f"K5i folds level 0 in shared and level 1 in global memory, K5 the flat "
          f"table in global memory ({routes})")

    hh_items, hh_est = hh_ans
    check(hh_items.dtype == np.uint32 and hh_items.shape[1] == 2
          and hh_est.dtype == np.int64 and bool(np.all(hh_est >= thr)),
          "conservative heavy_hitters: uint32[K, 2] keys with estimates >= threshold")
    found = {tuple(r) for r in hh_items.tolist()}
    missing = [tuple(r) for r in exact_items.tolist() if tuple(r) not in found]
    check(not missing, f"conservative: no false negatives ({len(missing)} missing)")
    lin_found = {tuple(r) for r in lin_answer[0].tolist()}
    check(found <= lin_found, "conservative heavy hitters are a subset of the linear "
          "main path's at the same threshold")
    top_items, top_est = top_ans
    check(top_items.shape == (100, 2) and bool(np.all(np.diff(top_est) <= 0)),
          "conservative topk(100) returns 100 keys by descending estimate")
    for lvl, (a, b) in enumerate(zip(ep.state.states, lin_state.states)):
        check(bool((a.table <= b.table).all()),
              f"conservative level {lvl} <= the linear level, cell by cell")
    check(bool((ks.table <= lin_flat.table).all()),
          "conservative flat table <= the linear flat table, cell by cell")
    e2e = {"ingest_s": t_ingest, "ingest_rows_per_s": items.shape[0] / t_ingest,
           "heavy_hitters_ms": t_hh * 1e3, "topk100_ms": t_top * 1e3,
           "heavy_hitters_found": len(found), "linear_found": len(lin_found),
           "flat_ingest_s": t_flat, "flat_ingest_rows_per_s": items.shape[0] / t_flat,
           "level_routes": routes}
    return ep, ks, launches, e2e


# --------------------------------------------------------------------------
# the float32 tables (K1f, K3f, K6f) and the training path (K8f, K1)
# --------------------------------------------------------------------------

def float32_path(spec, hspec, params, cs_params, stream, turnstile, ks, ks_s):
    """The main stream into a float32 flat sketch (K1f) and a float32
    hierarchy (K3f), the turnstile stream into a float32 signed flat sketch
    (K6f).  The frequencies are integers, so wherever every cell's partial
    sums stay below 2^24 (checked here) each float32 table equals its int32
    twin of the same stream bit for bit."""
    items, freqs = stream.items, stream.freqs
    t_items, t_freqs, _ = turnstile
    i_hier = KernelHierarchy(hspec, params, block_b=BLOCK)
    ingest_blocks(i_hier, items, freqs)
    # sum |f| per cell bounds every partial sum of the signed table
    magnitude = KernelSketch(spec, params, block_b=BLOCK)
    ingest_blocks(magnitude, t_items, np.abs(t_freqs))
    _cuda.reset_launches()
    f_flat = KernelSketch(spec, params, block_b=BLOCK, dtype=torch.float32)
    f_hier = KernelHierarchy(hspec, params, block_b=BLOCK, dtype=torch.float32)
    f_signed = KernelSketch(spec, cs_params, block_b=BLOCK, dtype=torch.float32,
                            mode="signed")
    _, t_flat = wall(lambda: ingest_blocks(f_flat, items, freqs))
    _, t_hier = wall(lambda: ingest_blocks(f_hier, items, freqs))
    _, t_signed = wall(lambda: ingest_blocks(f_signed, t_items, t_freqs))
    launches = dict(_cuda.LAUNCHES)
    log(f"float32 path launches: {launches}")
    n_main, n_turn = -(-items.shape[0] // BLOCK), -(-t_items.shape[0] // BLOCK)
    for name, kid, n in (("sketch_update_f32", "K1f", n_main), ("hier_update_f32", "K3f", n_main),
                         ("sketch_update_signed_f32", "K6f", n_turn)):
        check(launches[name] == n > 0, f"{kid} ({name}) launched once per block on the "
              f"float32 path ({launches[name]} of {n})")
    check(launches["sketch_update"] == launches["hier_update"]
          == launches["sketch_update_signed"] == 0, "no int32 fold ran on the float32 path")
    limit = 1 << 24
    check(int(ks.table.max()) < limit and int(i_hier.table.max()) < limit,
          "insert-only tables: every cell, hence every partial sum, below 2^24")
    check(int(magnitude.table.max()) < limit,
          "turnstile: the sum of |f| into every cell below 2^24")
    check(torch.equal(f_flat.table, ks.table.to(torch.float32)),
          "float32 flat table (K1f) equals the int32 one (K1) bit for bit")
    check(torch.equal(f_hier.table, i_hier.table.to(torch.float32)),
          "float32 hierarchy (K3f) equals the int32 one (K3) bit for bit")
    check(torch.equal(f_signed.table, ks_s.table.to(torch.float32)),
          "float32 signed flat table (K6f) equals the int32 one (K6) bit for bit")
    e2e = {"flat_rows_per_s": items.shape[0] / t_flat,
           "hier_rows_per_s": items.shape[0] / t_hier,
           "signed_rows_per_s": t_items.shape[0] / t_signed,
           "max_cell": int(i_hier.table.max()),
           "max_turnstile_magnitude": int(magnitude.table.max())}
    return f_flat, f_hier, f_signed, launches, e2e


def train_setup():
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=TRAIN_LAYERS)
    tcfg = tl.TrainConfig(optimizer=opt.OptimizerConfig(lr=1e-3, warmup_steps=0),
                          compression=gc.CompressionConfig(enabled=True))
    return cfg, tcfg


def training_path(seed):
    """``train()`` on starcoder2-7b at its full width, 2 layers, 5 steps of
    8 x 1,024 tokens, gradient compression (K8f) and the in-step n-gram
    sketch (K1) on; each step split by CUDA events into its phases."""
    cfg, tcfg = train_setup()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    state, t_init = wall(lambda: tl.init_train_state(cfg, tcfg, gen, DEVICE))
    with (Timed(tfm, "loss_fn") as loss, Timed(tl, "compress_decompress") as comp,
          Timed(opt, "apply_updates") as optim, Timed(tl.ngram, "ngram_items") as grams,
          Timed(tl, "sketch_update") as fold, Timed(cs, "median_rows") as med):
        _cuda.reset_launches()
        (state, hist), t_train = wall(lambda: tl.train(
            cfg, tcfg, TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, state, log_every=1))
        launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    split = step_split(loss, comp, optim, grams, fold)
    per_step = len(med.events) // TRAIN_STEPS
    check(per_step * TRAIN_STEPS == len(med.events),
          "the compressor takes the same medians every step")
    median_ms = [sum(a.elapsed_time(b) for a, b in med.events[i * per_step:(i + 1) * per_step])
                 for i in range(TRAIN_STEPS)]
    comps = [(path, c) for path, c in tr.flatten(state["compression"].compressors)
             if c is not None]
    log(f"training path launches: {launches}")
    log(f"losses {hist['loss']}; step seconds {hist['step_time_s']}")
    log(f"step split (ms): {split}")
    log(f"the compressor's median_rows: {per_step} calls, {median_ms} ms a step")
    check(len(hist["loss"]) == TRAIN_STEPS and all(np.isfinite(hist["loss"])),
          "every loss is finite")
    check(launches["hier_update_signed_f32"] == len(comps) * TRAIN_STEPS > 0,
          f"K8f (hier_update_signed_f32) folded each of the {len(comps)} compressed "
          f"leaves once a step ({launches['hier_update_signed_f32']} launches)")
    check(launches["sketch_update"] == TRAIN_STEPS,
          "K1 (sketch_update) folded each step's bigrams once")
    sums = state["sketch_table"].to(torch.int64).sum(dim=1)
    want = TRAIN_STEPS * TRAIN_BATCH * (TRAIN_SEQ - 1)
    check(bool((sums == want).all()), f"every n-gram row sums to {want}")
    check(torch.equal(state["sketch_table"], plain_bigram_table(cfg, state)),
          "K1's n-gram table equals the plain fold of the same steps' bigrams")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    steady = hist["step_time_s"][1:]
    log(f"training: {TRAIN_STEPS * tokens / sum(hist['step_time_s']):.1f} tokens/s "
        f"({len(steady) * tokens / sum(steady):.1f} after the first step); peak "
        f"memory {peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    e2e = {"arch": TRAIN_ARCH, "layers": TRAIN_LAYERS, "d_model": cfg.d_model,
           "params": tfm.param_count(state["params"]), "compressed_leaves": len(comps),
           "compression_ratio": gc.compression_ratio(tcfg.compression, state["params"]),
           "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
           "losses": hist["loss"], "step_time_s": hist["step_time_s"],
           "tokens_per_s": TRAIN_STEPS * tokens / sum(hist["step_time_s"]),
           "tokens_per_s_after_first": len(steady) * tokens / sum(steady),
           "step_split_ms": split, "median_ms_per_step": median_ms,
           "median_calls_per_step": per_step, "init_s": t_init, "train_s": t_train,
           "peak_memory_gb": peak / 1e9}
    return cfg, tcfg, state, launches, e2e


def bigram_chunks(cfg, spec, step: int) -> torch.Tensor:
    """The chunks of the bigrams K1 folds in the training path's ``step``."""
    data = tl.synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    tokens = torch.from_numpy(data(step)["tokens"]).to(DEVICE)
    return spec.schema.module_chunks(tl.ngram.ngram_items(tokens, cfg.sketch_ngrams))


def plain_bigram_table(cfg, state) -> torch.Tensor:
    """The training phase's n-gram table rebuilt by K1's plain version on a
    zero [w, h] table: the same steps' batches, bigrams and (q, r), freqs 1."""
    spec = tl.make_sketch_spec(cfg)
    plan = tl.make_plan(spec)
    q, r = state["sketch_params"]
    table = torch.zeros_like(state["sketch_table"])
    for step in range(TRAIN_STEPS):
        chunks = bigram_chunks(cfg, spec, step)
        freqs = torch.ones((chunks.shape[0],), dtype=table.dtype, device=table.device)
        su.sketch_update_ref(plan, table, chunks, freqs, q, r)
    return table


def plain_signed_fold(hplan, table, chunks, vals, q, r, s_q, s_r):
    """K8's plain version over a long block, a chunk of keys at a time (the
    fold is additive in the keys, so for integer values the table is the
    same; it bounds the plain version's int64 temporaries)."""
    for s in range(0, chunks.shape[0], PLAIN_CHUNK):
        hu.hier_update_signed_ref(hplan, table, chunks[s : s + PLAIN_CHUNK],
                                  vals[s : s + PLAIN_CHUNK], q, r, s_q, s_r)
    return table


def leaf_chunks(comp):
    """A compressed leaf's coordinates as the K8 wrapper's int64 chunks."""
    hspec = comp.plan.hspec
    items = hspec.level_items(hspec.n_levels - 1, comp.coords.to(torch.int64))
    return hspec.levels[-1].schema.module_chunks(items)


def k8f_real_gradient(comp, vals) -> float:
    """K8f against its plain version on a real corrected gradient, on both
    routes: the largest |kernel - plain| over the sum of |v| into that
    cell."""
    hplan = hu.make_hier_plan(comp.plan.hspec, tile_h=1)
    (q, r), s_q, s_r = comp.params
    chunks = leaf_chunks(comp)
    w = comp.plan.hspec.base.width
    zero = torch.zeros((w, hplan.padded_cols), device=DEVICE)
    want = plain_signed_fold(hplan, zero.clone(), chunks, vals, q, r, s_q, s_r)
    mag = zero.clone()
    for s in range(0, chunks.shape[0], PLAIN_CHUNK):
        hu.hier_update_ref(hplan, mag, chunks[s : s + PLAIN_CHUNK],
                           vals[s : s + PLAIN_CHUNK].abs(), q, r)
    worst = 0.0
    for route in (contextlib.nullcontext(), AllGlobal()):
        with route:
            got = hu.hier_update_signed(hplan, zero.clone(), chunks, vals, q, r, s_q, s_r)
        diff = (got - want).abs()
        check(bool((diff[mag == 0] == 0).all()), "K8f: untouched cells stay 0")
        worst = max(worst, float((diff / mag.clamp_min(torch.finfo(torch.float32).tiny)).max()))
    return worst


def compression_checks(cfg, tcfg, state):
    """One more gradient (the next step's batch, at the trained params)
    through every compressed leaf: exactly k distinct coordinates are
    selected, ``corrected == dense + residual`` exactly, the output holds
    the corrected values there and 0 elsewhere; and K8f on that real
    gradient against its plain version within REAL_GRAD_TOL."""
    batch = tl.synthetic_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)(TRAIN_STEPS)
    tokens = torch.from_numpy(batch["tokens"]).to(DEVICE)
    pairs = tr.flatten(state["params"])
    paths = [path for path, _ in pairs]
    leaves = [p.detach().requires_grad_(True) for _, p in pairs]
    loss, _ = tfm.loss_fn(cfg, tr.unflatten(zip(paths, leaves)), tokens)
    grads = dict(zip(paths, torch.autograd.grad(loss, leaves)))
    del leaves, loss
    residual = dict(tr.flatten(state["compression"].residual))
    out = {}
    for path, comp in tr.flatten(state["compression"].compressors):
        if comp is None:
            continue
        name, k = "/".join(path), comp.plan.k
        g, r = grads[path], residual[path]
        with Recorded(gc, "_descend_topk") as sel:
            dense, new_r = gc._compress_leaf(tcfg.compression, comp, g, r)
        corrected = g.to(torch.float32) + r
        check(torch.equal(dense + new_r, corrected),
              f"{name}: corrected == dense + residual exactly")
        coords = sel.results[0]
        check(coords.numel() == k and int(torch.unique(coords).numel()) == k,
              f"{name}: exactly k = {k} distinct coordinates selected")
        flat_d, flat_c = dense.reshape(-1), corrected.reshape(-1)
        chosen = torch.zeros(flat_d.shape, dtype=torch.bool, device=DEVICE)
        chosen[coords] = True
        check(torch.equal(flat_d[coords], flat_c[coords]) and not bool(flat_d[~chosen].any()),
              f"{name}: the output holds the corrected values at the k coordinates, "
              "0 elsewhere")
        ratio = k8f_real_gradient(comp, flat_c)
        check(ratio <= REAL_GRAD_TOL, f"{name}: K8f within {REAL_GRAD_TOL} of sum |v| "
              f"per cell of its plain version on the real gradient ({ratio})")
        out[name] = {"shape": list(comp.plan.shape), "k": k, "beam": comp.plan.beam,
                     "nonzeros": int((flat_d != 0).sum()), "k8f_err_over_abs_sum": ratio}
        del dense, new_r, corrected, flat_d, flat_c, chosen, sel
    log(f"compression checks: {out}")
    return out


# --------------------------------------------------------------------------
# phases 3-4: each kernel against its plain version, timed, beside its bound
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# the windowed, re-tuning and extended accuracy phases
# --------------------------------------------------------------------------

def bitwise_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (float32 compared as its bits), on the host."""
    a, b = a.cpu(), b.cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.float32:
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))
    return torch.equal(a, b)


def cpu_state(state) -> hh.HierarchyState:
    """A host copy of a HierarchyState (params and tables)."""
    return hh.HierarchyState(states=tuple(
        sk.SketchState(params=sk.SketchParams(q=s.params.q.cpu(), r=s.params.r.cpu()),
                       table=s.table.cpu()) for s in state.states))


class GridReplay:
    """Records the K4 grids a path launches and, at each :meth:`check`,
    holds them against the plain version on the rule's route and on the
    direct route, then forgets them.  Call it while the tables still hold
    what the grids read: before the next ingest or advance, since the
    running window sum and the endpoint's tables are updated in place.
    The replays' launches are taken back out of the counts."""

    def __init__(self):
        self.err, self.grids = 0.0, 0
        self._rec = Recorded(hq, "hier_candidate_query")

    def __enter__(self):
        self._rec.__enter__()
        return self

    def __exit__(self, *exc):
        self._rec.__exit__(*exc)

    def check(self) -> None:
        rec = self._rec
        if not rec.calls:
            return
        counts = dict(_cuda.LAUNCHES)
        err = grid_replay_err(rec, rec._orig, hq.hier_candidate_query_ref)
        with DirectRoute():
            err = max(err, grid_replay_err(rec, rec._orig, hq.hier_candidate_query_ref))
        _cuda.LAUNCHES.update(counts)
        self.err, self.grids = max(self.err, err), self.grids + len(rec.calls)
        rec.calls.clear()
        rec.kwargs.clear()
        rec.results.clear()


def plain_answers(svc, thr: int):
    """``heavy_hitters(thr)`` and ``topk(100)`` of a service's current state
    with the plain grid, on host copies of its tables."""
    host = cpu_state(svc.state())
    cands = svc.candidates()

    def hh_fn(t, candidates):
        return hh.find_heavy_hitters(svc.hspec, host, t, candidates)

    return hh_fn(thr, cands), threshold_descent_topk(
        hh_fn, cands, 100, total=svc.total, n_modules=svc.wspec.base.schema.modularity)


def live_epoch_blocks(batches, upto: int, mode: str):
    """The live epochs' streams after batch ``upto`` (oldest first): one
    (items, freqs) a batch, or for decay one a whole epoch."""
    now = batches[upto].t
    live = [b for b in batches[: upto + 1]
            if mode == "landmark" or b.t > now - WINDOW_EPOCHS]
    if mode != "decay":
        return [(b.items, b.freqs) for b in live]
    out = []
    for t in sorted({b.t for b in live}):
        part = [b for b in live if b.t == t]
        out.append((np.concatenate([b.items for b in part]),
                    np.concatenate([b.freqs for b in part])))
    return out


def window_mode_run(spec, params, batches, mode: str, decay: float, replay: GridReplay):
    """One window mode over the timestamped batches through the DStream
    harness, K3 or K3f folding and K4 or K4f scoring; after each epoch the
    merged tables against ``reference_window_state`` of the live epochs
    (host copies, bitwise), the harness's recall (tumbling, landmark: no
    key at or above the threshold missed), and ``heavy_hitters``/``topk``
    against the plain grid on host copies.  Every K4 grid is replayed
    against its plain version before the next ingest.  Returns (service,
    e2e)."""
    svc = WindowedTopKService(spec, params, n_epochs=WINDOW_EPOCHS, window_mode=mode,
                              decay=decay, max_candidates_per_group=POOL)
    check(svc.use_kernel and svc.use_update_kernel,
          f"{mode}: a service on the card takes the kernels by default")
    harness = DStreamHarness(svc, phi=PHI)
    ingest_s = [0.0]
    fold = svc.ingest

    def timed_ingest(items, freqs=None):
        ingest_s[0] += wall(lambda: fold(items, freqs))[1]

    svc.ingest = timed_ingest
    hh_ms, top_ms, checks = [], [], 0
    for b, batch in enumerate(batches):
        report = harness.step(batch)
        replay.check()
        if b + 1 < len(batches) and batches[b + 1].t == batch.t:
            continue
        # the batch closed an epoch
        want = win.reference_window_state(svc.wspec, params,
                                          live_epoch_blocks(batches, b, mode), device="cpu")
        got = svc.state()
        check(all(bitwise_equal(g.table, w.table) for g, w in zip(got.states, want.states)),
              f"{mode}: epoch {batch.t}'s merged tables equal reference_window_state of "
              "the live epochs bit for bit")
        del got, want
        if mode != "decay":
            check(report.recall == 1.0, f"{mode}: epoch {batch.t}: no key whose exact "
                  f"window count is at or above the threshold is missed ({report.recall})")
        thr = max(1, int(PHI * report.window_total))
        ans_hh, t_hh = wall(lambda: svc.heavy_hitters(thr))
        ans_top, t_top = wall(lambda: svc.topk(100))
        hh_ms.append(t_hh * 1e3)
        top_ms.append(t_top * 1e3)
        p_hh, p_top = plain_answers(svc, thr)
        check(same_answers(ans_hh, p_hh) and same_answers(ans_top, p_top),
              f"{mode}: epoch {batch.t}: heavy_hitters and topk(100) equal the plain "
              "grid's on host copies")
        replay.check()
        checks += 1
    check(checks == batches[-1].t + 1, f"{mode}: checked after every epoch")
    last = harness.reports[-1]
    rows = sum(b.items.shape[0] for b in batches)
    e2e = {"mode": mode, "decay": decay, "epochs": batches[-1].t + 1,
           "ring": WINDOW_EPOCHS, "batches": len(batches),
           "batch_rows": [int(b.items.shape[0]) for b in batches[:2]],
           "ingest_s": ingest_s[0], "ingest_rows_per_s": rows / ingest_s[0],
           "heavy_hitters_ms": hh_ms, "topk100_ms": top_ms,
           "are_topk": last.are_topk, "recall": last.recall, "precision": last.precision,
           "f2_rel_err": last.f2_rel_err,
           "mean_are_topk": float(np.mean([r.are_topk for r in harness.reports])),
           "min_recall": min(r.recall for r in harness.reports),
           "min_precision": min(r.precision for r in harness.reports),
           "mean_f2_rel_err": float(np.mean([r.f2_rel_err for r in harness.reports])),
           "window_total": last.window_total, "window_distinct": last.window_distinct,
           "table_gb": sum(t.numel() * t.element_size() for t in
                           svc.wstate.ring + ((svc.wstate.retired,)
                                              if svc.wstate.retired is not None else ())
                           + ((svc._window_sum,) if svc.incremental else ())) / 1e9}
    log(f"windowed {mode}: ARE {last.are_topk:.4f}, recall {last.recall}, precision "
        f"{last.precision}, F2 rel err {last.f2_rel_err:.4f}; ingest "
        f"{e2e['ingest_rows_per_s']:.0f} rows/s; heavy_hitters {np.mean(hh_ms):.2f} ms, "
        f"topk(100) {np.mean(top_ms):.2f} ms (means over the epochs); "
        f"{e2e['table_gb']:.3f} GB of tables")
    svc.ingest = fold
    return svc, e2e


def windowed_engine_run(spec, params, batches, svc, replay: GridReplay) -> dict:
    """The tumbling window behind one SketchServeEngine, ``advance()``
    between epochs: every advance invalidates the snapshot, and the final
    answers equal those of the harness's service on the same batches."""
    twin = WindowedTopKService(spec, params, n_epochs=WINDOW_EPOCHS,
                               max_candidates_per_group=POOL)
    eng = SketchServeEngine(twin, max_staleness=0)
    for b, batch in enumerate(batches):
        if b and batch.t != batches[b - 1].t:
            eng.advance()
            check(eng._snap is None, "the engine's advance() invalidates its snapshot")
        eng.ingest(batch.items, batch.freqs)
    thr = max(1, int(PHI * svc.total))
    got = [eng.heavy_hitters(thr), eng.topk(100)]
    want = [svc.heavy_hitters(thr), svc.topk(100)]
    replay.check()
    check(all(same_answers(a, b) for a, b in zip(got, want)),
          "the engine over the tumbling window answers as the service does")
    return {"threshold": thr, "heavy_hitters_found": int(got[0][0].shape[0]),
            "engine_staleness": eng.staleness}


def windowed_path(spec, params, stream):
    """The main stream in 16 timestamped batches, two an epoch, on a ring
    of 4 epochs (8 epochs: four expiries), once for each window mode; the
    decay run's K4f grids recorded, every K4 grid replayed against its
    plain version as it goes.  Returns (launches per mode, K4f grids, K4's
    replay, e2e)."""
    batches = list(timestamped_batches(stream.items, stream.freqs, WINDOW_BATCHES,
                                       batches_per_epoch=BATCHES_PER_EPOCH))
    e2e, launches, f32_grids = {}, {}, None
    replay = GridReplay()
    for mode, decay in WINDOW_MODES:
        t0 = time.perf_counter()
        with Recorded(hq, "hier_candidate_query_f32") as grids, replay:
            _cuda.reset_launches()
            replayed = replay.grids
            svc, e2e[mode] = window_mode_run(spec, params, batches, mode, decay, replay)
            if mode == "tumbling":
                e2e["engine"] = windowed_engine_run(spec, params, batches, svc, replay)
            launches[mode] = dict(_cuda.LAUNCHES)
        check(replay.grids - replayed == launches[mode]["hier_query"],
              f"{mode}: every K4 grid of the window was replayed against its plain version")
        e2e[mode]["phase_s"] = time.perf_counter() - t0
        log(f"windowed {mode} launches: {launches[mode]}; {e2e[mode]['phase_s']:.1f} s "
            "with its checks")
        if mode == "decay":
            check(launches[mode]["hier_update_f32"] > 0 and launches[mode]["hier_query_f32"] > 0,
                  "K3f and K4f launched on the decayed window")
            check(launches[mode]["hier_update"] == launches[mode]["hier_query"] == 0,
                  "no int32 fold or grid ran on the decayed window")
            check(len(grids.calls) == launches[mode]["hier_query_f32"],
                  "every K4f call of the decayed window was recorded")
            f32_grids = grids
        else:
            check(launches[mode]["hier_update"] > 0 and launches[mode]["hier_query"] > 0,
                  f"K3 and K4 launched on the {mode} window")
        del svc
        torch.cuda.empty_cache()
    check(replay.err == 0, f"every K4 grid of the windowed phase equals its plain "
          f"version (max |err| {replay.err})")
    return launches, f32_grids, replay, e2e


def retune_path(seed):
    """A SketchTopKEndpoint on benchmarks/migrate_bench.py's stale spec at
    h = 2^24, w = 4, behind a SketchServeEngine with a range-search
    AutoTuner, fed skew_flip_batches in 16 blocks of 65,536 rows with
    ``sync()`` after each.  At least one migration cuts over; after each
    cutover the endpoint equals, bit for bit, a fresh endpoint on the new
    spec and params fed the blocks since ``begin_migration``."""
    schema = KeySchema((1 << 32, 1 << 32))
    stale = sk.mod_sketch_spec(schema, [(0,), (1,)], (RETUNE_H // 64, 64), WIDTH)
    rng = np.random.default_rng((seed, 22))
    params = (draw_hash_params_np(rng, (WIDTH, stale.schema.total_chunks)),
              draw_hash_params_np(rng, (WIDTH, stale.n_groups)))
    blocks = list(skew_flip_batches((1 << 32, 1 << 32), RETUNE_BLOCKS, BLOCK, seed=seed))
    mass = int(blocks[0].freqs.sum())
    draw = seeded_key_draw(seed)
    ep = SketchTopKEndpoint(stale, params, max_candidates_per_group=POOL)
    check(ep.use_kernel and ep._kh is not None,
          "an endpoint on the card takes the kernels by default")
    tuner = AutoTuner(ep, draw, retune_every=4 * mass, warmup=2 * mass,
                      min_improvement=0.9, sample_k=256, min_threshold=1,
                      search="ranges")
    eng = SketchServeEngine(ep, max_staleness=0, tuner=tuner)
    times = {"shut": [], "open": [], "cutover": []}
    begun, cutovers, forced = None, [], None
    twin_launches = dict.fromkeys(_cuda.LAUNCHES, 0)
    replay = GridReplay().__enter__()
    _cuda.reset_launches()
    for b, blk in enumerate(blocks):
        was = ep.migrating
        _, secs = wall(lambda: eng.ingest(blk.items, blk.freqs))
        kind = "cutover" if was and not ep.migrating else ("open" if was else "shut")
        times[kind].append((int(blk.items.shape[0]), secs))
        if kind == "cutover":
            start, new_spec, new_params = begun
            before = dict(_cuda.LAUNCHES)
            fresh = SketchTopKEndpoint(new_spec, new_params, max_candidates_per_group=POOL)
            for blk2 in blocks[start : b + 1]:
                fresh.ingest(blk2.items, blk2.freqs)
            sd_m, sd_f = ep.state_dict(), fresh.state_dict()
            check(sd_m.keys() == sd_f.keys() and all(
                sd_m[k].dtype == sd_f[k].dtype and np.array_equal(sd_m[k], sd_f[k])
                for k in sd_m), f"after the cutover at block {b} the endpoint equals a "
                "fresh endpoint on the new spec fed the same blocks, bit for bit")
            for k, v in _cuda.LAUNCHES.items():
                twin_launches[k] += v - before[k]
            cutovers.append({"block": b, "begun_after_block": start - 1,
                             "ranges": list(new_spec.ranges), "ms": secs * 1e3})
            del fresh, sd_m, sd_f
        n = len(tuner.decisions)
        eng.sync()
        replay.check()
        if len(tuner.decisions) > n and tuner.decisions[-1].migrated:
            d = tuner.decisions[-1]
            spec_d = sk.SketchSpec(schema, d.proposed_partition, d.proposed_ranges, WIDTH)
            begun = (b + 1, spec_d, draw((len(tuner.decisions), 2), spec_d))
        if (b == len(blocks) - 3 and not cutovers and not ep.migrating
                and tuner.decisions):
            # the tuner declined every proposal: open the window on its last
            # one, so the cutover runs all the same
            d = tuner.decisions[-1]
            spec_d = sk.SketchSpec(schema, d.proposed_partition or stale.partition,
                                   d.proposed_ranges or stale.ranges, WIDTH)
            forced = {"after_block": b, "reason": d.reason, "ranges": list(spec_d.ranges)}
            begun = (b + 1, spec_d, draw((len(tuner.decisions), 2), spec_d))
            ep.begin_migration(spec_d, begun[2], warmup=2 * mass)
    launches = {k: v - twin_launches[k] for k, v in _cuda.LAUNCHES.items()}
    decisions = [dataclasses.asdict(d) for d in tuner.decisions]
    for d in decisions:
        log(f"TuneDecision {d}")
    check(len(cutovers) >= 1, "at least one migration cut over")
    check(launches["hier_update"] > 0 and launches["hier_query"] > 0,
          "K3 and K4 launched on the re-tuning path")
    check(replay.grids == launches["hier_query"],
          "every K4 grid of the re-tuning path was replayed against its plain version")
    top = eng.topk(100)
    replay.check()
    replay.__exit__()
    check(replay.err == 0, f"every K4 grid of the re-tuning path equals its plain "
          f"version (max |err| {replay.err})")
    check(top[0].shape == (100, 2) and bool(np.all(np.diff(top[1]) <= 0)),
          "topk(100) after the re-tuning answers 100 keys by descending estimate")

    def rate(kind):
        rows, secs = sum(r for r, _ in times[kind]), sum(s for _, s in times[kind])
        return rows / secs if secs else None

    e2e = {"stale_ranges": list(stale.ranges), "blocks": len(blocks), "block_rows": BLOCK,
           "decisions": decisions, "cutovers": cutovers, "forced": forced,
           "final_ranges": list(ep.hspec.base.ranges),
           "ingest_rows_per_s_window_shut": rate("shut"),
           "ingest_rows_per_s_window_open": rate("open"),
           "cutover_ingest_ms": [s * 1e3 for _, s in times["cutover"]],
           "blocks_by_kind": {k: len(v) for k, v in times.items()}}
    log(f"re-tuning launches: {launches}")
    log(f"re-tuning: cutovers {cutovers}; forced {forced}; ingest rows/s with the "
        f"double-write window shut {e2e['ingest_rows_per_s_window_shut']}, open "
        f"{e2e['ingest_rows_per_s_window_open']}; cutover ingest ms "
        f"{e2e['cutover_ingest_ms']}")
    return launches, replay, e2e


def fcm_pair(spec, params, stream, seed: int):
    """An FCM on the card and its twin on the host, both fed the stream in
    blocks of 2^15; their tables must be equal."""
    card = FCM(spec, params, seed=seed)
    host = FCM(spec, params, seed=seed, device="cpu")
    for s in range(0, stream.items.shape[0], 1 << 15):
        for f in (card, host):
            f.update(stream.items[s : s + (1 << 15)], stream.freqs[s : s + (1 << 15)])
    check(torch.equal(card.table.cpu(), host.table), "the card's FCM table equals the "
          "same FCM run on the host")
    return card


def fig10_errors(stream, h: int, w: int, seed: int, what: str) -> dict:
    """Count-min on K1/K2, FCM and FMOD (FMOD's ranges from a 3% sample, as
    the reference's Fig. 10 test takes them) on ``stream``: their observed
    errors on 500 random keys."""
    rng = np.random.default_rng(0)
    s_items, s_freqs = stream.sample(0.03, rng)
    a, b = optimal_ranges_mod2(s_items, s_freqs, h)
    draw = np.random.default_rng((seed, 10))
    params = (draw_hash_params_np(draw, (w, stream.schema.total_chunks)),
              draw_hash_params_np(draw, (w, 1)))
    cm = KernelSketch(sk.count_min_spec(stream.schema, h, w), params, block_b=BLOCK)
    cm.update(stream.items, stream.freqs)
    fcm = fcm_pair(fcm_spec(stream.schema, h, w, mg_k=512), params, stream, seed)
    fparams = (params[0], draw_hash_params_np(draw, (w, 2)))
    fmod = fcm_pair(fmod_spec(stream.schema, [(0,), (1,)], (a, b), w, mg_k=512), fparams,
                    stream, seed)
    qi, qf = stream.random_k_queries(N_QUERIES, rng)
    out = {"h": h, "w": w, "fmod_ranges": [a, b],
           "count_min": observed_error(cm.query(qi), qf),
           "fcm": observed_error(fcm.query(qi), qf),
           "fmod": observed_error(fmod.query(qi), qf)}
    log(f"{what}: observed error count-min {out['count_min']:.4f}, FCM {out['fcm']:.4f}, "
        f"FMOD {out['fmod']:.4f} (FMOD ranges {a} x {b})")
    return out


def accuracy_extended_path(seed):
    """The paper's remaining workloads: FCM and FMOD beside count-min (K1,
    K2) on ipv4_stream() at its defaults, h = 4,096, w = 5, and on the
    reference's Fig. 10 regime; the card's FCM tables equal the host's; the
    telecom stream's arbitrary positive counts through a flat KernelSketch
    on K1, held against the plain fold on the host."""
    _cuda.reset_launches()
    ipv4 = ipv4_stream()
    e2e = {"ipv4": fig10_errors(ipv4, H_ACC, W_ACC, seed, "ipv4 (3M occurrences)")}
    check(e2e["ipv4"]["fcm"] <= e2e["ipv4"]["count_min"] * 1.05
          and e2e["ipv4"]["fmod"] <= e2e["ipv4"]["count_min"] * 1.05,
          "ipv4: FCM's and FMOD's observed errors within 5% of count-min's or below")
    regime = zipf_graph_stream(**FIG10_STREAM)
    e2e["fig10_regime"] = fig10_errors(regime, *FIG10_HW, seed, "Fig. 10 regime")
    r = e2e["fig10_regime"]
    check(r["fcm"] <= r["count_min"] * 1.05 and r["fmod"] <= r["fcm"] * 1.05,
          "Fig. 10 order in its regime: FMOD <= FCM <= count-min, within 5%")
    tel = telecom_stream()
    spec = sk.count_min_spec(tel.schema, H_ACC, W_ACC)
    tparams = (draw_hash_params_np(np.random.default_rng((seed, 11)),
                                   (W_ACC, tel.schema.total_chunks)),
               draw_hash_params_np(np.random.default_rng((seed, 12)), (W_ACC, 1)))
    card = KernelSketch(spec, tparams, block_b=BLOCK)
    host = KernelSketch(spec, tparams, block_b=BLOCK, device="cpu")
    card.update(tel.items, tel.freqs)
    launches = dict(_cuda.LAUNCHES)
    host.update(tel.items, tel.freqs)
    check(torch.equal(card.table.cpu(), host.table),
          "telecom: K1's table equals the plain fold's on the host")
    e2e["telecom"] = {"rows": int(tel.items.shape[0]), "total": int(tel.total),
                      "max_count": int(tel.freqs.max())}
    log(f"extended accuracy launches: {launches}; telecom {e2e['telecom']}")
    check(launches["sketch_update"] > 0 and launches["sketch_query"] > 0,
          "K1 and K2 launched on the extended accuracy path")
    return launches, e2e



class KernelRows:
    """Holds each kernel against its plain version, times both and the
    library yardstick, and sets them beside the bound; collects the rows of
    the ``kernels`` line."""

    def __init__(self, launches):
        self.launches = launches
        self.rows = []
        # the paths find the tables cold (each block and each grid touches
        # other cells), so every timed call runs after the 50 MB L2 is
        # evicted by rewriting a 256 MB buffer
        self._l2 = torch.zeros(1 << 26, dtype=torch.int32, device=DEVICE)

    def evict(self) -> None:
        self._l2.add_(1)

    def measure(self, name, symbol, *, err, call, plain, library, n_bytes, n_ops,
                shape, reps=(100, 20, 50, 200)) -> dict:
        """One kernel's row: ``reps`` counts the cold, plain, device and warm
        calls (the sequential folds take tens of ms a call, their plain
        versions seconds)."""
        check(err == 0, f"{name} bit-identical to its plain version (max |err| {err})")
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        source, replaces = KERNELS[name]
        n_cold, n_plain, n_dev, n_warm = reps
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": replaces, "launches": self.launches[name],
               "max_abs_err": err, "ms": cold_ms(call, n_cold, self.evict),
               "plain_ms": cold_ms(plain, n_plain, self.evict), "bound_ms": b_ms,
               "bound_by": b_by,
               "library_ms": cold_ms(library, 50, self.evict) if library else None,
               "device_ms": kernel_device_ms(call, symbol, n_dev, self.evict),
               "warm_call_ms": cuda_ms(call, n_warm), "shape": shape}
        log(f"{name}: {out['ms']:.5f} ms cold, {out['device_ms']} ms on the device "
            f"(profiler), {out['warm_call_ms']:.5f} ms per warm back-to-back call; "
            f"plain {out['plain_ms']:.5f}, bound {b_ms:.5f} by {b_by}, library "
            f"{out['library_ms']} at {shape}")
        return out

    def add(self, name, symbol, **kw) -> None:
        self.rows.append(self.measure(name, symbol, **kw))


def grid_replay_err(grids, kernel, plain) -> float:
    """Max |err| of the kernel against its plain version over every
    recorded grid call of a path (the kernel with the call's keywords, the
    plain version without)."""
    return max(max_abs_err(kernel(*call, **kw), plain(*call))
               for call, kw in zip(grids.calls, grids.kwargs))


def grid_shape_note(grids, p, c) -> str:
    shapes = grids.shapes()
    return (f"P={p} C={c}; {shapes[(p, c)]} of {len(grids.calls)} launches; all (P, C): "
            + ", ".join(f"{a}x{b}:{n}" for (a, b), n in sorted(shapes.items())))


def grid_touched(view, pp, cp) -> int:
    """The distinct cells a candidate grid reads."""
    w = view.shape[0]
    cells = (torch.arange(w, device=view.device)[:, None] * view.stride(0)
             + (pp[:, :, None] + cp[:, None, :]).reshape(w, -1))
    return int(torch.unique(cells).numel())


class DirectRoute:
    """The query kernels' direct route while installed (K4, K9, K9m): the
    route rule (``hier_query.query_geometry``) never stages a window."""

    def __enter__(self):
        self._orig = hq.query_geometry
        hq.query_geometry = lambda *args, **kw: hq.QueryGeometry(0, hq.THREADS, 0)
        return self

    def __exit__(self, *exc):
        hq.query_geometry = self._orig


def query_route(call, kw) -> str:
    """The route the rule picks for a recorded grid call."""
    view, pp, cp = call[:3]
    g = hq.query_geometry(view.shape[0], pp.shape[1], cp.shape[1], kw.get("span"),
                          torch.cuda.get_device_properties(0).multi_processor_count)
    return "window" if g.span else "direct"


def grid_bytes(view, pp, cp) -> int:
    """The bytes a candidate grid must move: its partials and output (4 B a
    value, as the reference's uint32 partials) and each distinct cell it
    reads (4-byte cells, int32 or float32)."""
    w, p, c = view.shape[0], pp.shape[1], cp.shape[1]
    return 4 * w * (p + c) + 4 * p * c + 4 * grid_touched(view, pp, cp)


def grid_kernel_row(kr, name: str, symbol: str, kernel, grids) -> dict:
    """A candidate-grid kernel's row (K4, K4f) over the grids a path
    launched: each held against the plain version on the rule's route and
    on the direct route; timed at the (P, C) launched most often (the
    descent chunks each level's grid into max_batch // C prefixes a launch)
    and at the largest, and on the device at every (P, C) launched."""
    plain = hq.hier_candidate_query_ref
    err = grid_replay_err(grids, kernel, plain)
    with DirectRoute():
        err = max(err, grid_replay_err(grids, kernel, plain))

    def launch(call, kw):
        return lambda: kernel(*call, **kw)

    (p, c), (call, kw) = grids.most_launched()
    view, pp, cp = call
    w = view.shape[0]
    row = kr.measure(name, symbol, err=err, call=launch(call, kw),
                     plain=lambda: plain(*call), library=None,
                     n_bytes=grid_bytes(view, pp, cp), n_ops=3 * w * p * c,
                     shape=f"w={w} cols={view.shape[1]} {view.dtype}; "
                     + grid_shape_note(grids, p, c))
    with DirectRoute():
        row["direct_route_ms"] = cold_ms(launch(call, kw), 100, kr.evict)
    by_shape = {}
    for (sp_, sc_), n in sorted(grids.shapes().items()):
        a, k = grids.call_at((sp_, sc_))
        by_shape[f"{sp_}x{sc_}"] = {
            "launches": n, "route": query_route(a, k),
            "device_ms": kernel_device_ms(launch(a, k), symbol, 20, kr.evict)}
    row["by_shape"] = by_shape
    row["launches_x_device_ms"] = sum(e["launches"] * e["device_ms"]
                                      for e in by_shape.values() if e["device_ms"])
    big = max(grids.shapes(), key=lambda s_: s_[0] * s_[1])
    a, k = grids.call_at(big)
    largest = {"shape": f"{big[0]}x{big[1]}", "route": query_route(a, k),
               "ms": cold_ms(launch(a, k), 50, kr.evict),
               "device_ms": kernel_device_ms(launch(a, k), symbol, 20, kr.evict),
               "plain_ms": cold_ms(lambda: plain(*a), 5, kr.evict),
               "bound_ms": bound_ms(grid_bytes(*a), 3 * w * big[0] * big[1])[0]}
    with DirectRoute():
        largest["direct_route_ms"] = cold_ms(launch(a, k), 50, kr.evict)
        largest["direct_device_ms"] = kernel_device_ms(launch(a, k), symbol, 20, kr.evict)
    row["largest"] = largest
    log(f"{name} by (P, C): {by_shape}; sum of launches x device ms "
        f"{row['launches_x_device_ms']:.5f}; direct route {row['direct_route_ms']:.5f} ms; "
        f"largest {largest}")
    return row


def top_source_rows(items) -> int:
    """Rows of the most frequent source (module 0) among ``items``."""
    return int(np.unique(items[:, 0], return_counts=True)[1].max())


def heaviest_block(items) -> int:
    """The index of the BLOCK-row block of the stream whose top source
    holds the most rows (the first such block on a tie)."""
    tops = [top_source_rows(items[s : s + BLOCK]) for s in range(0, items.shape[0], BLOCK)]
    return int(np.argmax(tops))


def k3_block(hspec, hplan, table, blk_items, f, q, r):
    """One block's K3/K3f inputs: its chunks, and for ``index_add_`` the
    flat cells and values of every (level, row, key), and the cells the
    block touches."""
    dev = table.device
    ordered = hspec.level_items(hspec.n_levels - 1, as_index_tensor(blk_items, dev))
    chunks = hspec.levels[-1].schema.module_chunks(ordered)
    w, cols = table.shape
    idx = all_indices(hplan.plan, chunks, q, r)
    base = torch.arange(w, device=dev)[:, None] * cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(hplan.level_offsets, hplan.level_divs)])
    f_all = f.to(table.dtype).expand(w * hplan.n_levels, f.shape[0]).reshape(-1)
    return chunks, flat, f_all, int(torch.unique(flat[f_all != 0]).numel())


def k1_cells(plan, table, chunks, f, q, r):
    """One block's K1/K1f cells: each (row, key)'s column, and for
    ``index_add_`` the flat cells and values of every (row, key), and the
    cells the block touches."""
    w, h_pad = table.shape
    idx = all_indices(plan, chunks, q, r)
    flat = (torch.arange(w, device=table.device)[:, None] * h_pad + idx).reshape(-1)
    f_all = f.to(table.dtype).expand(w, f.shape[0]).reshape(-1)
    return idx, flat, f_all, int(torch.unique(flat[f_all != 0]).numel())


def warp_combinable(idx, f) -> dict:
    """A flat fold's live (row, key) adds, and how many of them a warp
    combine would save: the live adds less the distinct (row, warp, cell)
    they hit.  ``idx`` is int64[w, B], each (row, key)'s column."""
    w, n = idx.shape
    warp = torch.arange(n, device=idx.device) // 32
    cells = (torch.arange(w, device=idx.device)[:, None] * (n // 32 + 1) + warp) \
        * (int(idx.max()) + 1) + idx
    live = f != 0
    adds = w * int(live.sum())
    return {"live_adds": adds,
            "warp_combinable_adds": adds - int(torch.unique(cells[:, live]).numel())}


def k1_shape(kr, spec, plan, table, chunks, f, q, r, what: str) -> dict:
    """K1 on one block into a zero table of ``table``'s shape: bit for bit
    with the plain fold; cold and device ms (L2 evicted), ``index_add_`` of
    the same cells, the bytes and operations bounds, and the adds a warp
    combine would save."""
    w, h_pad = table.shape
    n = f.shape[0]
    idx, flat, f_all, touched = k1_cells(plan, table, chunks, f, q, r)
    zero = torch.zeros_like(table)
    err = max_abs_err(su.sketch_update(plan, zero.clone(), chunks, f, q, r),
                      su.sketch_update_ref(plan, zero.clone(), chunks, f, q, r))
    check(err == 0, f"K1 on {what} bit-identical to its plain version ({err})")
    scratch = zero.clone()

    def call():
        su.sketch_update(plan, scratch, chunks, f, q, r)

    return {"w": w, "h_pad": h_pad, "keys": n, **flat_deal_note(w, n), "max_abs_err": err,
            "ms": cold_ms(call, 100, kr.evict),
            "device_ms": kernel_device_ms(call, "sk_flat_update_kernel<int", 20, kr.evict),
            "library_ms": cold_ms(lambda: scratch.view(-1).index_add_(0, flat, f_all), 100,
                                  kr.evict),
            "bytes_bound_ms": (key_bytes(spec.schema, n) + nbytes(f) + param_bytes(q, r)
                               + 8 * touched) / MEM_BYTES_PER_S * 1e3,
            "ops_bound_ms": (hash_ops(plan, n) + 2 * w * n) / ALU_OPS_PER_S * 1e3,
            **warp_combinable(idx, f)}


def k1_by_shape(kr, stream, acc_sketches, ks, bigram) -> dict:
    """K1 at the shapes its paths launch it, each block into a zero table:
    the accuracy path's count-min, equal-sketch and mod-sketch at blocks
    ACC_BLOCKS of the stream (h = 4,096, w = 5), the flat
    path's heaviest block (the one whose top source holds the most rows)
    and the training path's first bigram fold."""
    dev = torch.device(DEVICE)
    out = {}

    def block(sketch, b):
        items = stream.items[b * BLOCK : (b + 1) * BLOCK]
        f = torch.from_numpy(stream.freqs[b * BLOCK : (b + 1) * BLOCK]).to(dev, torch.int32)
        chunks = sketch.spec.schema.module_chunks(as_index_tensor(items, dev))
        what = f"{sketch.spec.describe()} block {b}"
        row = k1_shape(kr, sketch.spec, sketch.plan, sketch.table, chunks, f,
                       sketch.params.q, sketch.params.r, what)
        return {"block": b, "top_source_rows": top_source_rows(items), **row}

    for name in ("count-min", "equal-sketch", "mod-sketch"):
        for b in ACC_BLOCKS:
            out[f"accuracy {name} block {b}"] = block(acc_sketches[name], b)
    hb = heaviest_block(stream.items)
    out[f"flat heaviest block {hb}"] = block(ks, hb)
    spec, plan, q, r, chunks, table = bigram
    ones = torch.ones(chunks.shape[0], dtype=torch.int32, device=dev)
    out["training bigram step 0"] = k1_shape(kr, spec, plan, table, chunks, ones, q, r,
                                             "the bigram fold")
    log("K1 by shape: " + json.dumps(out))
    return out


def point_lanes(w: int, n: int) -> int:
    """The lanes a query takes in K2, K7 and K7m at w rows and n queries."""
    return sq.point_lanes(w, n, torch.cuda.get_device_properties(0).multi_processor_count)


def point_probes(kr, spec, chunks, q, r) -> dict:
    """What bounds K2 on a block of queries: the same keys and params into a
    zero flat table that fits L2 (the same schema and partition, ranges cut
    to L2_RANGES), timed with L2 evicted first and with the table read into
    L2 first."""
    small = sk.mod_sketch_spec(spec.schema, spec.partition, L2_RANGES, spec.width)
    plan = make_plan(small)
    table = torch.zeros((spec.width, su.padded_table_size(small.table_size, 512)),
                        dtype=torch.int32, device=chunks.device)
    out = {"l2_table_cells": table.numel(),
           "l2_table_cold_ms": cold_ms(lambda: sq.sketch_query(plan, table, chunks, q, r), 100,
                                       kr.evict),
           "l2_table_resident_ms": cold_ms(lambda: sq.sketch_query(plan, table, chunks, q, r),
                                           100, lambda: (kr.evict(), table.sum()))}
    del table
    return out


def k2_by_shape(kr, recorded) -> dict:
    """K2 at each of the accuracy path's recorded calls (500 queries into a
    [5, 4,096] table): bit for bit with the plain version; cold and device
    ms (L2 evicted), the bytes and sector bounds; and the sum over the
    calls of the device time."""
    calls, labels = recorded
    out = {}
    for call, (label, spec) in zip(calls.calls, labels):
        plan, table, chunks, q, r = call
        err = max_abs_err(sq.sketch_query(*call), sq.sketch_query_ref(*call))
        check(err == 0, f"K2 on the accuracy path's {label} bit-identical to its plain "
              f"version ({err})")
        n_bytes, sector_bytes = point_query_bytes(spec, plan, table, chunks, q, r,
                                                  out_bytes=4 * chunks.shape[0])

        def k2(call=call):
            sq.sketch_query(*call)

        out[label] = {"w": table.shape[0], "h_pad": table.shape[1],
                      "queries": chunks.shape[0],
                      "lanes": point_lanes(table.shape[0], chunks.shape[0]), "max_abs_err": err,
                      "ms": cold_ms(k2, 100, kr.evict),
                      "device_ms": kernel_device_ms(k2, "sk_query_kernel", 20, kr.evict),
                      "bytes_bound_ms": n_bytes / MEM_BYTES_PER_S * 1e3,
                      "sector_bound_ms": sector_bytes / MEM_BYTES_PER_S * 1e3}
    total = sum(e["device_ms"] for e in out.values() if e["device_ms"])
    log(f"K2 by shape: {json.dumps(out)}; sum of device ms {total:.5f}")
    return {"calls": out, "launches_x_device_ms": total}


def kernel_rows(kr, hspec, eng, ks, stream, grids):
    dev = torch.device(DEVICE)
    q, r = ks.params.q, ks.params.r
    blk_items = stream.items[:BLOCK]
    f = torch.from_numpy(stream.freqs[:BLOCK]).to(dev, torch.int32)

    # K3: one 65,536-row block into the live concatenated hierarchy table,
    # on the rule's route and on the all-global route; then the stream's
    # heaviest block, whose top source's rows all add to one level-0 cell
    kh = KernelHierarchy(hspec, (q, r))
    kh.load_state(eng.sync().state)
    hplan, table = kh.hplan, kh.table
    w, cols = table.shape
    chunks, flat, f_all, touched = k3_block(hspec, hplan, table, blk_items, f, q, r)
    scratch = table.clone()

    def fold(c, v):
        return lambda: hu.hier_update(hplan, scratch, c, v, q, r)

    row = kr.measure(
        "hier_update", "sk_hier_update_kernel<int",
        err=both_routes_err(lambda: hu.hier_update(hplan, table.clone(), chunks, f, q, r),
                            lambda: hu.hier_update_ref(hplan, table.clone(), chunks, f, q, r)),
        call=fold(chunks, f),
        plain=lambda: hu.hier_update_ref(hplan, scratch, chunks, f, q, r),
        library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
        n_bytes=key_bytes(hspec.base.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + 8 * touched,
        n_ops=hash_ops(hplan.plan, BLOCK) + 3 * w * BLOCK * hplan.n_levels,
        shape=f"B={BLOCK} w={w} levels={hplan.n_levels} cols={cols}, block 0 "
              f"(top source {top_source_rows(blk_items)} rows)")
    row["geometry"] = fold_geometry_note(hplan, w, BLOCK, table.element_size())
    with AllGlobal():
        row["global_route_ms"] = cold_ms(fold(chunks, f), 100, kr.evict)
    hb = heaviest_block(stream.items)
    h_items = stream.items[hb * BLOCK : (hb + 1) * BLOCK]
    hf = torch.from_numpy(stream.freqs[hb * BLOCK : (hb + 1) * BLOCK]).to(dev, torch.int32)
    hchunks, hflat, hf_all, htouched = k3_block(hspec, hplan, table, h_items, hf, q, r)
    err = both_routes_err(lambda: hu.hier_update(hplan, table.clone(), hchunks, hf, q, r),
                          lambda: hu.hier_update_ref(hplan, table.clone(), hchunks, hf, q, r))
    check(err == 0, f"K3 on the heaviest block bit-identical to its plain version ({err})")
    n_h = h_items.shape[0]
    heavy = {"block": hb, "rows": n_h, "top_source_rows": top_source_rows(h_items),
             "ms": cold_ms(fold(hchunks, hf), 100, kr.evict),
             "library_ms": cold_ms(lambda: scratch.view(-1).index_add_(0, hflat, hf_all),
                                   100, kr.evict),
             "bound_ms": bound_ms(
                 key_bytes(hspec.base.schema, n_h) + nbytes(hf) + param_bytes(q, r)
                 + 8 * htouched, hash_ops(hplan.plan, n_h) + 3 * w * n_h * hplan.n_levels)[0],
             "max_abs_err": err,
             "geometry": fold_geometry_note(hplan, w, n_h, table.element_size())}
    with AllGlobal():
        heavy["global_route_ms"] = cold_ms(fold(hchunks, hf), 100, kr.evict)
    row["heaviest_block"] = heavy
    log(f"K3 geometry {row['geometry']}; global route {row['global_route_ms']:.5f} ms; "
        f"heaviest block {heavy}")
    kr.rows.append(row)
    del scratch, kh, chunks, flat, f_all, hchunks, hflat, hf_all

    # K4: every grid the main path launched
    kr.rows.append(grid_kernel_row(kr, "hier_query", "sk_hier_query_kernel",
                                   hq.hier_candidate_query, grids))

    # K1 / K2: the flat sketch's block fold and a block of point queries
    plan, flat_table = ks.plan, ks.table
    fchunks = ks.spec.schema.module_chunks(as_index_tensor(blk_items, dev))
    w, h_pad = flat_table.shape
    _, flat, f_all, touched = k1_cells(plan, flat_table, fchunks, f, q, r)
    scratch = flat_table.clone()
    row = kr.measure(
        "sketch_update", "sk_flat_update_kernel<int",
        err=max_abs_err(su.sketch_update(plan, flat_table.clone(), fchunks, f, q, r),
                        su.sketch_update_ref(plan, flat_table.clone(), fchunks, f, q, r)),
        call=lambda: su.sketch_update(plan, scratch, fchunks, f, q, r),
        plain=lambda: su.sketch_update_ref(plan, scratch, fchunks, f, q, r),
        library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
        n_bytes=key_bytes(ks.spec.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + 8 * touched,
        n_ops=hash_ops(plan, BLOCK) + 2 * w * BLOCK,
        shape=f"B={BLOCK} w={w} h_pad={h_pad}")
    row["geometry"] = flat_deal_note(w, BLOCK)
    row["bound_probes"] = flat_probes(kr, ks.spec, plan, scratch, fchunks, f, q, r)
    log(f"K1 geometry {row['geometry']}; bound probes {row['bound_probes']}")
    kr.rows.append(row)
    del scratch

    rng = np.random.default_rng(2)
    qitems = stream.items[rng.choice(stream.items.shape[0], BLOCK, replace=False)]
    qchunks = ks.spec.schema.module_chunks(as_index_tensor(qitems, dev))
    n_bytes, sector_bytes = point_query_bytes(ks.spec, plan, flat_table, qchunks, q, r,
                                              out_bytes=4 * BLOCK)
    kr.add("sketch_query", "sk_query_kernel",
           err=max_abs_err(sq.sketch_query(plan, flat_table, qchunks, q, r),
                           sq.sketch_query_ref(plan, flat_table, qchunks, q, r)),
           call=lambda: sq.sketch_query(plan, flat_table, qchunks, q, r),
           plain=lambda: sq.sketch_query_ref(plan, flat_table, qchunks, q, r), library=None,
           n_bytes=n_bytes, n_ops=hash_ops(plan, BLOCK) + 2 * w * BLOCK,
           shape=f"Q={BLOCK} w={w} h_pad={h_pad}")
    row = kr.rows[-1]
    row["sector_bound_ms"] = sector_bytes / MEM_BYTES_PER_S * 1e3
    row["lanes"] = point_lanes(w, BLOCK)
    row["bound_probes"] = point_probes(kr, ks.spec, qchunks, q, r)
    log(f"K2 lanes {row['lanes']}; bound probes {row['bound_probes']}")


def signed_values(bits, level: int, f: torch.Tensor) -> torch.Tensor:
    """s_level * f per (row, key), int32, as the signed kernels add it."""
    return ((1 - 2 * ((bits >> level) & 1)) * f.to(torch.int64)).to(torch.int32)


def k8_block(hspec, hplan, table, blk_items, f, q, r, s_q, s_r):
    """One block's K8 inputs: its chunks, and for ``index_add_`` the flat
    cells and signed values of every (level, row, key), and the cells the
    block touches."""
    dev = table.device
    ordered = hspec.level_items(hspec.n_levels - 1, as_index_tensor(blk_items, dev))
    chunks = hspec.levels[-1].schema.module_chunks(ordered)
    w, cols = table.shape
    idx = all_indices(hplan.plan, chunks, q, r)
    bits = all_sign_bits(hplan.plan, chunks, s_q, s_r)
    base = torch.arange(w, device=dev)[:, None] * cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(hplan.level_offsets, hplan.level_divs)])
    vals = torch.cat([signed_values(bits, l, f).reshape(-1) for l in range(hplan.n_levels)])
    return chunks, flat, vals, int(torch.unique(flat[vals != 0]).numel())


def flat_probes(kr, spec, plan, table, chunks, f, q, r, signs=()) -> dict:
    """What bounds a flat fold on a block (K1, K1f; K6, K6f with ``signs``,
    their (s_q, s_r)): the same keys, values and params into a flat table
    that fits L2 (the same schema and partition, ranges cut to L2_RANGES),
    timed with L2 evicted first and with the table read into L2 first;
    all-zero values, which skip the hash and the atomics; and the adds a
    warp combine would save, counted: the live (row, key) adds less the
    distinct (row, warp, cell) they hit."""
    dev, (w, h_pad) = table.device, table.shape

    def fold(p, t, v):
        if signs:
            return su.sketch_update_signed(p, t, chunks, v, q, r, *signs)
        return su.sketch_update(p, t, chunks, v, q, r)

    small = sk.mod_sketch_spec(spec.schema, spec.partition, L2_RANGES, w)
    small_plan = make_plan(small)
    small_table = torch.zeros((w, su.padded_table_size(small.table_size, 512)),
                              dtype=table.dtype, device=dev)
    zeros = torch.zeros_like(f)
    out = {
        "l2_table_cells": small_table.numel(),
        "l2_table_cold_ms": cold_ms(lambda: fold(small_plan, small_table, f), 100, kr.evict),
        "l2_table_resident_ms": cold_ms(lambda: fold(small_plan, small_table, f), 100,
                                        lambda: (kr.evict(), small_table.sum())),
        "zero_values_ms": cold_ms(lambda: fold(plan, table, zeros), 100, kr.evict),
        **warp_combinable(all_indices(plan, chunks, q, r), f)}
    del small_table, zeros
    return out


def signed_kernel_rows(kr, hspec, kh, ks, turnstile, grids, stream, seed):
    dev = torch.device(DEVICE)
    items, freqs, queries = turnstile
    (q, r), s_q, s_r = ks.cs_params
    blk_items = items[:BLOCK]
    f = torch.from_numpy(freqs[:BLOCK]).to(dev, torch.int32)

    # K8: one 65,536-row turnstile block into the live signed hierarchy
    # table, on the rule's route and on the all-global route; then the
    # stream's first block in its sorted order (stream.items[:BLOCK], the
    # edges the turnstile deletes negated), whose heavy sources come in runs
    hplan, table = kh.hplan, kh.table
    w, cols = table.shape
    chunks, flat, vals, touched = k8_block(hspec, hplan, table, blk_items, f, q, r, s_q, s_r)
    scratch = table.clone()

    def fold(c, v):
        return lambda: hu.hier_update_signed(hplan, scratch, c, v, q, r, s_q, s_r)

    row = kr.measure(
        "hier_update_signed", "sk_hier_update_signed_kernel<int",
        err=both_routes_err(
            lambda: hu.hier_update_signed(hplan, table.clone(), chunks, f, q, r, s_q, s_r),
            lambda: hu.hier_update_signed_ref(hplan, table.clone(), chunks, f, q, r, s_q,
                                              s_r)),
        call=fold(chunks, f),
        plain=lambda: hu.hier_update_signed_ref(hplan, scratch, chunks, f, q, r, s_q, s_r),
        library=lambda: scratch.view(-1).index_add_(0, flat, vals),
        n_bytes=key_bytes(hspec.base.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + param_bytes(s_q, s_r) + 8 * touched,
        n_ops=2 * hash_ops(hplan.plan, BLOCK) + 4 * w * BLOCK * hplan.n_levels,
        shape=f"B={BLOCK} w={w} levels={hplan.n_levels} cols={cols}, "
              f"{int((f < 0).sum())} deletions, shuffled")
    row["geometry"] = fold_geometry_note(hplan, w, BLOCK, table.element_size())
    with AllGlobal():
        row["global_route_ms"] = cold_ms(fold(chunks, f), 100, kr.evict)
    gone, _ = turnstile_deletions(stream.items.shape[0], seed)
    sf = torch.from_numpy(np.where(gone[:BLOCK], -stream.freqs[:BLOCK],
                                   stream.freqs[:BLOCK])).to(dev, torch.int32)
    schunks, sflat, svals, stouched = k8_block(hspec, hplan, table, stream.items[:BLOCK], sf,
                                               q, r, s_q, s_r)
    err = both_routes_err(
        lambda: hu.hier_update_signed(hplan, table.clone(), schunks, sf, q, r, s_q, s_r),
        lambda: hu.hier_update_signed_ref(hplan, table.clone(), schunks, sf, q, r, s_q, s_r))
    check(err == 0, f"K8 on the sorted block bit-identical to its plain version ({err})")
    sorted_row = {"ms": cold_ms(fold(schunks, sf), 100, kr.evict),
                  "library_ms": cold_ms(lambda: scratch.view(-1).index_add_(0, sflat, svals),
                                        100, kr.evict),
                  "bound_ms": bound_ms(
                      key_bytes(hspec.base.schema, BLOCK) + nbytes(sf) + param_bytes(q, r)
                      + param_bytes(s_q, s_r) + 8 * stouched,
                      2 * hash_ops(hplan.plan, BLOCK) + 4 * w * BLOCK * hplan.n_levels)[0],
                  "max_abs_err": err,
                  "top_source_rows": top_source_rows(stream.items[:BLOCK])}
    with AllGlobal():
        sorted_row["global_route_ms"] = cold_ms(fold(schunks, sf), 100, kr.evict)
    row["sorted_block"] = sorted_row
    log(f"K8 geometry {row['geometry']}; global route {row['global_route_ms']:.5f} ms; "
        f"sorted block {sorted_row}")
    kr.rows.append(row)
    del scratch, chunks, flat, vals, schunks, sflat, svals

    # K9m: every grid the signed descent launched, held against its plain
    # version and, bit for bit, against median_rows of K9's rows on the same
    # grid; K9 against its plain version there; both timed at the (P, C)
    # launched most often
    err9 = grid_replay_err(grids, hq.hier_candidate_query_signed,
                           hq.hier_candidate_query_signed_ref)
    err9m = grid_replay_err(grids, hq.hier_candidate_median_signed,
                            hq.hier_candidate_median_signed_ref)
    for call, kw in zip(grids.calls, grids.kwargs):
        rows = hq.hier_candidate_query_signed(*call, **kw)
        check(torch.equal(hq.hier_candidate_median_signed(*call, **kw).view(torch.int32),
                          cs.median_rows(rows).view(torch.int32)),
              "K9m equals median_rows of K9's rows bit for bit on every descent grid")
    del rows
    (p, c), (call, kw) = grids.most_launched()
    view, pp, cp, sp, sc = call
    w = view.shape[0]
    touched = grid_touched(view, pp, cp)
    shape = f"w={w} cols={view.shape[1]}; " + grid_shape_note(grids, p, c)
    kr.add("hier_query_signed", "sk_hier_query_signed_kernel", err=err9,
           call=lambda: hq.hier_candidate_query_signed(*call, **kw),
           plain=lambda: hq.hier_candidate_query_signed_ref(*call), library=None,
           n_bytes=8 * w * (p + c) + 4 * w * p * c + 4 * touched, n_ops=4 * w * p * c,
           shape=shape + "; launched on the path by the answer's per-row read")
    kr.add("hier_query_signed_median", "sk_hier_query_signed_median_kernel", err=err9m,
           call=lambda: hq.hier_candidate_median_signed(*call, **kw),
           plain=lambda: hq.hier_candidate_median_signed_ref(*call), library=None,
           n_bytes=8 * w * (p + c) + 4 * p * c + 4 * touched,
           n_ops=(4 * w + w * (w - 1)) * p * c, shape=shape)

    # K6 / K7: the signed flat sketch's block fold and a block of point queries
    plan, flat_table = ks.plan, ks.table
    fchunks = ks.spec.schema.module_chunks(as_index_tensor(blk_items, dev))
    w, h_pad = flat_table.shape
    idx = all_indices(plan, fchunks, q, r)
    bits = all_sign_bits(plan, fchunks, s_q, s_r)
    flat = (torch.arange(w, device=dev)[:, None] * h_pad + idx).reshape(-1)
    vals = signed_values(bits, len(plan.ranges) - 1, f).reshape(-1)
    touched = int(torch.unique(flat[vals != 0]).numel())
    scratch = flat_table.clone()
    row = kr.measure(
        "sketch_update_signed", "sk_update_signed_kernel<int",
        err=max_abs_err(
            su.sketch_update_signed(plan, flat_table.clone(), fchunks, f, q, r, s_q, s_r),
            su.sketch_update_signed_ref(plan, flat_table.clone(), fchunks, f, q, r,
                                        s_q, s_r)),
        call=lambda: su.sketch_update_signed(plan, scratch, fchunks, f, q, r, s_q, s_r),
        plain=lambda: su.sketch_update_signed_ref(plan, scratch, fchunks, f, q, r,
                                                  s_q, s_r),
        library=lambda: scratch.view(-1).index_add_(0, flat, vals),
        n_bytes=key_bytes(ks.spec.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + param_bytes(s_q, s_r) + 8 * touched,
        n_ops=2 * hash_ops(plan, BLOCK) + 3 * w * BLOCK,
        shape=f"B={BLOCK} w={w} h_pad={h_pad}, {int((f < 0).sum())} deletions")
    row["bound_probes"] = flat_probes(kr, ks.spec, plan, scratch, fchunks, f, q, r,
                                      (s_q, s_r))
    log(f"K6 bound probes {row['bound_probes']}")
    kr.rows.append(row)
    del scratch

    # K7 / K7m: a block of signed point queries, the rows (K7, the path's
    # query_rows) and their median (K7m, the path's query), each also
    # against the sector bound; K7m also bit for bit against median_rows of
    # K7's rows, and beside the time of K7 then median_rows, the signed
    # query before K7m
    qchunks = ks.spec.schema.module_chunks(as_index_tensor(queries, dev))
    args = (plan, flat_table, qchunks, q, r, s_q, s_r)
    for name, symbol, kernel, plain, out_bytes, n_ops in (
            ("sketch_query_signed", "sk_query_signed_kernel", sq.sketch_query_signed,
             sq.sketch_query_signed_ref, 4 * w * BLOCK,
             2 * hash_ops(plan, BLOCK) + 2 * w * BLOCK),
            ("sketch_query_signed_median", "sk_query_signed_median_kernel",
             sq.sketch_query_signed_median, sq.sketch_query_signed_median_ref, 4 * BLOCK,
             2 * hash_ops(plan, BLOCK) + (2 * w + w * (w - 1)) * BLOCK)):
        n_bytes, sector_bytes = point_query_bytes(ks.spec, plan, flat_table, qchunks, q, r,
                                                  (s_q, s_r), out_bytes)
        kr.add(name, symbol, err=max_abs_err(kernel(*args), plain(*args)),
               call=lambda kernel=kernel: kernel(*args), plain=lambda plain=plain: plain(*args),
               library=None, n_bytes=n_bytes, n_ops=n_ops,
               shape=f"Q={BLOCK} w={w} h_pad={h_pad}")
        kr.rows[-1]["sector_bound_ms"] = sector_bytes / MEM_BYTES_PER_S * 1e3
        kr.rows[-1]["lanes"] = point_lanes(w, BLOCK)
    check(torch.equal(sq.sketch_query_signed_median(*args).view(torch.int32),
                      cs.median_rows(sq.sketch_query_signed(*args)).view(torch.int32)),
          "K7m equals median_rows of K7's rows bit for bit")
    kr.rows[-1]["k7_then_median_rows_ms"] = cold_ms(
        lambda: cs.median_rows(sq.sketch_query_signed(*args)), 100, kr.evict)
    log(f"K7 then median_rows: {kr.rows[-1]['k7_then_median_rows_ms']:.5f} ms cold")


def probe_step_ms(evict, n_cells: int = 0, steps: int = BLOCK) -> float:
    """Milliseconds per dependent step of the probe kernel of
    csrc/conservative_kernels.cu: with ``n_cells``, one load whose address
    is the last load's value, over one random cycle through ``n_cells``
    int32 cells in global memory (an access to the table's memory); else
    the fold's recurrence m <- max(m, m + f) in registers."""
    dev = torch.device(DEVICE)
    if n_cells:
        order = torch.randperm(n_cells, device=dev, dtype=torch.int32)
        cells = torch.empty_like(order)
        cells[order.long()] = order.roll(-1)
    else:
        cells = torch.tensor([0, 1], dtype=torch.int32, device=dev)
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _cuda.library()

    def probe():
        _cuda.check(lib.sk_chain_probe(cells.data_ptr(), cells.numel(), steps, int(n_cells > 0),
                                       out.data_ptr(), _cuda.stream_of(cells)),
                    "chain probe")

    return cold_ms(probe, 3, evict) / steps


def fold_touched(tables, idxs, f) -> int:
    """Distinct cells a block with frequencies ``f`` touches, over tables."""
    keep = f != 0
    return sum(int(torch.unique(idx[:, keep] + torch.arange(
        t.shape[0], device=idx.device)[:, None] * t.shape[1]).numel())
        for t, idx in zip(tables, idxs))


def depth_note(idx: torch.Tensor, f: torch.Tensor, probe: dict) -> dict:
    """D, D_r and S of one block's cells ``idx`` [w, B] (``fold_depths``),
    and the depth bound: one access to the table's memory, then D_r
    dependent steps of the recurrence (``probe``'s two times, in ns)."""
    d = scu.fold_depths(idx, f)
    return {"D": d.depth, "D_r": d.run_depth, "S": d.window_steps,
            "depth_bound_ms": (probe["access"] + d.run_depth * probe["step"]) * 1e-6}


def host_err(got, want) -> float:
    """Max |err| of kernel tables against plain ones computed on host copies."""
    got, want = ([got], [want]) if torch.is_tensor(got) else (got, want)
    return max(max_abs_err(a.cpu(), b) for a, b in zip(got, want))


def conservative_kernel_rows(kr, hspec, ep, ks, acc_ks, stream):
    """K5i on the first block into copies of the live conservative levels;
    K5 on the first block into copies of the flat conservative table
    (global route) and of the accuracy path's mod-sketch table (shared
    route, also on the stream's heaviest block).  The plain folds of the
    timed int32 rows run on the card, one Python step per row; the float32
    checks (the block's frequencies times 0.37, so not integers) and the
    heaviest block's compare with the plain fold of host copies.  Each row
    carries D, D_r and S of its block and the depth bound: one access to
    the table in HBM (where it starts on both routes, L2 evicted), then D_r
    dependent steps of the fold's recurrence in registers."""
    dev = torch.device(DEVICE)
    blk_items = stream.items[:BLOCK]
    f = torch.from_numpy(stream.freqs[:BLOCK]).to(dev, torch.int32)
    f32 = f.to(torch.float32) * 0.37
    reps = (5, 1, 5, 5)
    probe = {"access": probe_step_ms(kr.evict, WIDTH * ks.h_pad) * 1e6,
             "step": probe_step_ms(kr.evict, steps=16 * BLOCK) * 1e6}
    log(f"depth probe: {probe['access']:.2f} ns an access through "
        f"{WIDTH * ks.h_pad} cells in global memory, {probe['step']:.3f} ns a step of "
        f"the recurrence in registers")

    # K5i: both levels, one launch
    tables = [st.table for st in ep.state.states]
    idxs = hh.hierarchy_indices(hspec, ep.state.states[-1].params, blk_items)
    got, want = [t.clone() for t in tables], [t.clone() for t in tables]
    scu.conservative_fold_tables(got, idxs, f)
    scu.conservative_fold_tables_ref(want, idxs, f)
    err = max(max_abs_err(a, b) for a, b in zip(got, want))
    got = [t.to(torch.float32) for t in tables]
    want = [t.cpu() for t in got]
    scu.conservative_fold_tables(got, idxs, f32)
    err_f32 = host_err(got, scu.conservative_fold_tables_ref(
        want, [i.cpu() for i in idxs], f32.cpu()))
    check(err_f32 == 0, f"K5i on float32 levels bit-identical to its plain version ({err_f32})")
    del got, want
    scratch = [t.clone() for t in tables]
    n_lv = len(tables)
    routes = [scu.residency(WIDTH, t.shape[1], t.element_size()) for t in tables]
    row = kr.measure(
        "conservative_fold", "sk_conservative_fold_kernel", err=err,
        call=lambda: scu.conservative_fold_tables(scratch, idxs, f),
        plain=lambda: scu.conservative_fold_tables_ref(scratch, idxs, f), library=None,
        n_bytes=4 * WIDTH * BLOCK * n_lv + nbytes(f) + 8 * fold_touched(tables, idxs, f),
        n_ops=4 * WIDTH * BLOCK * n_lv,
        shape=f"B={BLOCK} w={WIDTH} levels={n_lv} cols={[t.shape[1] for t in tables]}",
        reps=reps)
    depths = [depth_note(i, f, probe) for i in idxs]
    row.update(residency=", ".join(f"level {l} {rt}" for l, rt in enumerate(routes)),
               probe_ns=probe, depths=depths, depth_bound_ms=max(d["depth_bound_ms"] for d in depths),
               f32_max_abs_err=err_f32)
    log(f"K5i depths per level (D, D_r, S, depth bound ms): {depths}")
    kr.rows.append(row)
    del scratch

    # K5: the flat 268 MB table (global route), then the accuracy path's
    # 5 x 4,096 table (shared route), also on the heaviest block
    def k5_inputs(sketch, items):
        chunks = sketch.spec.schema.module_chunks(as_index_tensor(items, dev))
        return chunks, all_indices(sketch.plan, chunks, *sketch.params)

    def k5_host_err(sketch, table, chunks, freqs):
        q, r = sketch.params
        got = scu.sketch_update_conservative(sketch.plan, table.clone(), chunks, freqs, q, r)
        return host_err(got, scu.sketch_update_conservative_ref(
            sketch.plan, table.cpu(), chunks.cpu(), freqs.cpu(), q.cpu(), r.cpu()))

    def k5(sketch):
        plan, table = sketch.plan, sketch.table
        q, r = sketch.params
        chunks, idx = k5_inputs(sketch, blk_items)
        err = max_abs_err(
            scu.sketch_update_conservative(plan, table.clone(), chunks, f, q, r),
            scu.sketch_update_conservative_ref(plan, table.clone(), chunks, f, q, r))
        err_f32 = k5_host_err(sketch, table.to(torch.float32), chunks, f32)
        check(err_f32 == 0, f"K5 on a float32 table bit-identical to its plain version "
                            f"({err_f32})")
        scratch = table.clone()
        w, h_pad = table.shape
        out = kr.measure(
            "sketch_update_conservative", "sk_conservative_update_kernel", err=err,
            call=lambda: scu.sketch_update_conservative(plan, scratch, chunks, f, q, r),
            plain=lambda: scu.sketch_update_conservative_ref(plan, scratch, chunks, f,
                                                             q, r),
            library=None,
            n_bytes=key_bytes(sketch.spec.schema, BLOCK) + nbytes(f)
            + param_bytes(q, r) + 8 * fold_touched([table], [idx], f),
            n_ops=hash_ops(plan, BLOCK) + 4 * w * BLOCK,
            shape=f"B={BLOCK} w={w} h_pad={h_pad}", reps=reps)
        out.update(residency=scu.residency(w, h_pad, table.element_size()),
                   probe_ns=probe, f32_max_abs_err=err_f32, **depth_note(idx, f, probe))
        log(f"K5 {out['residency']} route: D {out['D']}, D_r {out['D_r']}, S {out['S']}, "
            f"depth bound {out['depth_bound_ms']:.5f} ms")
        return out

    row = k5(ks)
    shared = k5(acc_ks)
    check(row["residency"] == "global" and shared["residency"] == "shared",
          "K5 measured on both residency routes")
    hb = heaviest_block(stream.items)
    h_items = stream.items[hb * BLOCK : (hb + 1) * BLOCK]
    hf = torch.from_numpy(stream.freqs[hb * BLOCK : (hb + 1) * BLOCK]).to(dev, torch.int32)
    plan, table, (q, r) = acc_ks.plan, acc_ks.table, acc_ks.params
    hchunks, hidx = k5_inputs(acc_ks, h_items)
    err = k5_host_err(acc_ks, table, hchunks, hf)
    check(err == 0, f"K5 on the heaviest block bit-identical to its plain version ({err})")
    scratch = table.clone()
    n_h = h_items.shape[0]
    heavy = {"block": hb, "rows": n_h, "top_source_rows": top_source_rows(h_items),
             "ms": cold_ms(lambda: scu.sketch_update_conservative(plan, scratch, hchunks, hf,
                                                                  q, r), 5, kr.evict),
             "bound_ms": bound_ms(
                 key_bytes(acc_ks.spec.schema, n_h) + nbytes(hf) + param_bytes(q, r)
                 + 8 * fold_touched([table], [hidx], hf),
                 hash_ops(plan, n_h) + 4 * W_ACC * n_h)[0],
             "max_abs_err": err, **depth_note(hidx, hf, probe)}
    log(f"K5 shared route on the heaviest block: {heavy}")
    row["max_abs_err"] = max(row["max_abs_err"], shared["max_abs_err"])
    row["f32_max_abs_err"] = max(row["f32_max_abs_err"], shared["f32_max_abs_err"])
    row["shared_route"] = {k: shared[k] for k in (
        "ms", "device_ms", "warm_call_ms", "plain_ms", "bound_ms", "bound_by",
        "probe_ns", "D", "D_r", "S", "depth_bound_ms", "max_abs_err", "shape")}
    row["shared_route"]["heaviest_block"] = heavy
    kr.rows.append(row)


def f32_kernel_rows(kr, hspec, stream, turnstile, f_flat, f_hier, f_signed, leaves):
    """K1f, K3f and K6f on the first 65,536-row block into copies of the
    float32 path's live tables; K8f at every compressed leaf's shape of the
    training path, timed at the largest.  Values are integers, so each is
    bit-identical to its plain version."""
    dev = torch.device(DEVICE)
    blk_items = stream.items[:BLOCK]
    f = torch.from_numpy(stream.freqs[:BLOCK]).to(dev, torch.float32)

    # K3f: the float32 hierarchy, on the rule's route and the all-global one
    q, r = f_hier.params
    hplan, table = f_hier.hplan, f_hier.table
    w, cols = table.shape
    chunks, flat, f_all, touched = k3_block(hspec, hplan, table, blk_items, f, q, r)
    scratch = table.clone()
    row = kr.measure(
        "hier_update_f32", "sk_hier_update_kernel<float",
        err=both_routes_err(lambda: hu.hier_update(hplan, table.clone(), chunks, f, q, r),
                            lambda: hu.hier_update_ref(hplan, table.clone(), chunks, f, q, r)),
        call=lambda: hu.hier_update(hplan, scratch, chunks, f, q, r),
        plain=lambda: hu.hier_update_ref(hplan, scratch, chunks, f, q, r),
        library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
        n_bytes=key_bytes(hspec.base.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + 8 * touched,
        n_ops=hash_ops(hplan.plan, BLOCK) + 3 * w * BLOCK * hplan.n_levels,
        shape=f"B={BLOCK} w={w} levels={hplan.n_levels} cols={cols}, float32")
    row["geometry"] = fold_geometry_note(hplan, w, BLOCK, table.element_size())
    with AllGlobal():
        row["global_route_ms"] = cold_ms(lambda: hu.hier_update(hplan, scratch, chunks, f, q, r),
                                         100, kr.evict)
    log(f"K3f geometry {row['geometry']}; global route {row['global_route_ms']:.5f} ms")
    kr.rows.append(row)
    del scratch, chunks, flat, f_all

    # K1f: the float32 flat sketch
    plan, ftable = f_flat.plan, f_flat.table
    fchunks = f_flat.spec.schema.module_chunks(as_index_tensor(blk_items, dev))
    w, h_pad = ftable.shape
    _, flat, f_all, touched = k1_cells(plan, ftable, fchunks, f, q, r)
    scratch = ftable.clone()
    row = kr.measure(
        "sketch_update_f32", "sk_flat_update_kernel<float",
        err=max_abs_err(su.sketch_update(plan, ftable.clone(), fchunks, f, q, r),
                        su.sketch_update_ref(plan, ftable.clone(), fchunks, f, q, r)),
        call=lambda: su.sketch_update(plan, scratch, fchunks, f, q, r),
        plain=lambda: su.sketch_update_ref(plan, scratch, fchunks, f, q, r),
        library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
        n_bytes=key_bytes(f_flat.spec.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
        + 8 * touched,
        n_ops=hash_ops(plan, BLOCK) + 2 * w * BLOCK,
        shape=f"B={BLOCK} w={w} h_pad={h_pad}, float32")
    row["geometry"] = flat_deal_note(w, BLOCK)
    kr.rows.append(row)
    del scratch

    # K6f: the float32 signed flat sketch, the turnstile's first block
    t_items, t_freqs, _ = turnstile
    (q, r), s_q, s_r = f_signed.cs_params
    tf = torch.from_numpy(t_freqs[:BLOCK]).to(dev, torch.float32)
    plan, stable = f_signed.plan, f_signed.table
    tchunks = f_signed.spec.schema.module_chunks(as_index_tensor(t_items[:BLOCK], dev))
    idx = all_indices(plan, tchunks, q, r)
    bits = all_sign_bits(plan, tchunks, s_q, s_r)
    flat = (torch.arange(w, device=dev)[:, None] * h_pad + idx).reshape(-1)
    vals = ((1 - 2 * ((bits >> (len(plan.ranges) - 1)) & 1)).to(torch.float32)
            * tf).reshape(-1)
    touched = int(torch.unique(flat[vals != 0]).numel())
    scratch = stable.clone()
    row = kr.measure(
        "sketch_update_signed_f32", "sk_update_signed_kernel<float",
        err=max_abs_err(
            su.sketch_update_signed(plan, stable.clone(), tchunks, tf, q, r, s_q, s_r),
            su.sketch_update_signed_ref(plan, stable.clone(), tchunks, tf, q, r,
                                        s_q, s_r)),
        call=lambda: su.sketch_update_signed(plan, scratch, tchunks, tf, q, r, s_q, s_r),
        plain=lambda: su.sketch_update_signed_ref(plan, scratch, tchunks, tf, q, r,
                                                  s_q, s_r),
        library=lambda: scratch.view(-1).index_add_(0, flat, vals),
        n_bytes=key_bytes(f_signed.spec.schema, BLOCK) + nbytes(tf) + param_bytes(q, r)
        + param_bytes(s_q, s_r) + 8 * touched,
        n_ops=2 * hash_ops(plan, BLOCK) + 3 * w * BLOCK,
        shape=f"B={BLOCK} w={w} h_pad={h_pad}, float32, {int((tf < 0).sum())} deletions")
    row["bound_probes"] = flat_probes(kr, f_signed.spec, plan, scratch, tchunks, tf, q, r,
                                      (s_q, s_r))
    log(f"K6f bound probes {row['bound_probes']}")
    kr.rows.append(row)
    del scratch, flat, vals

    # K8f: every compressed leaf's shape of the training path, integer
    # values in [-8, 8], on both routes; timed at the largest leaf
    gen = torch.Generator(device=dev).manual_seed(14)
    errs, per_leaf = [], {}
    for name, comp in leaves:
        hplan = hu.make_hier_plan(comp.plan.hspec, tile_h=1)
        (q, r), s_q, s_r = comp.params
        chunks = leaf_chunks(comp)
        n = chunks.shape[0]
        v = torch.randint(-8, 9, (n,), generator=gen, device=dev).to(torch.float32)
        zero = torch.zeros((comp.plan.hspec.base.width, hplan.padded_cols), device=dev)
        errs.append(both_routes_err(
            lambda: hu.hier_update_signed(hplan, zero.clone(), chunks, v, q, r, s_q, s_r),
            lambda: plain_signed_fold(hplan, zero.clone(), chunks, v, q, r, s_q, s_r)))

        def call():
            hu.hier_update_signed(hplan, zero, chunks, v, q, r, s_q, s_r)

        per_leaf[name] = {"keys": n, "cold_ms": cold_ms(call, 5, kr.evict),
                          "geometry": fold_geometry_note(hplan, zero.shape[0], n, 4)}
        with AllGlobal():
            per_leaf[name]["global_route_cold_ms"] = cold_ms(call, 5, kr.evict)
        del chunks, v, zero
    log(f"K8f per leaf: {per_leaf}")
    name, comp = max(leaves, key=lambda nc: math.prod(nc[1].plan.shape))
    hspec8 = comp.plan.hspec
    hplan = hu.make_hier_plan(hspec8, tile_h=1)
    (q, r), s_q, s_r = comp.params
    chunks = leaf_chunks(comp)
    n = chunks.shape[0]
    v = torch.randint(-8, 9, (n,), generator=gen, device=dev).to(torch.float32)
    w, cols = hspec8.base.width, hplan.padded_cols
    table = torch.zeros((w, cols), device=dev)
    # touched cells: a fold of the keys' nonzero marks, counted
    marks = hu.hier_update(hplan, torch.zeros_like(table), chunks, (v != 0).float(), q, r)
    touched = int((marks != 0).sum())
    del marks
    idx = all_indices(hplan.plan, chunks, q, r)
    bits = all_sign_bits(hplan.plan, chunks, s_q, s_r)
    base = torch.arange(w, device=dev)[:, None] * cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(hplan.level_offsets, hplan.level_divs)])
    signed = torch.cat([((1 - 2 * ((bits >> l) & 1)).to(torch.float32) * v).reshape(-1)
                        for l in range(hplan.n_levels)])
    del idx, bits
    row = kr.measure(
        "hier_update_signed_f32", "sk_hier_update_signed_kernel<float", err=max(errs),
        call=lambda: hu.hier_update_signed(hplan, table, chunks, v, q, r, s_q, s_r),
        plain=lambda: hu.hier_update_signed_ref(hplan, table, chunks, v, q, r, s_q, s_r),
        library=lambda: table.view(-1).index_add_(0, flat, signed),
        n_bytes=key_bytes(hspec8.base.schema, n) + nbytes(v) + param_bytes(q, r)
        + param_bytes(s_q, s_r) + 8 * touched,
        n_ops=2 * hash_ops(hplan.plan, n) + 4 * w * n * hplan.n_levels,
        shape=f"{name} {list(comp.plan.shape)}: B={n} w={w} levels={hplan.n_levels} "
              f"cols={cols}, float32; compared at all {len(leaves)} leaf shapes",
        reps=(10, 2, 5, 10))
    row["geometry"] = fold_geometry_note(hplan, w, n, 4)
    # what bounds K8f: the same keys and params into a finest level that
    # fits L2 (64 columns of a row range), and all-zero values, which skip
    # the hash; each beside the kernel's time above
    small = hu.make_hier_plan(hh.HierarchySpec.from_spec(sk.mod_sketch_spec(
        hspec8.base.schema, hspec8.base.partition, (hspec8.base.ranges[0], 64), w)), tile_h=1)
    small_table = torch.zeros((w, small.padded_cols), device=dev)
    zeros = torch.zeros_like(v)
    row["bound_probes"] = {
        "finest_fits_l2_ms": cold_ms(lambda: hu.hier_update_signed(
            small, small_table, chunks, v, q, r, s_q, s_r), 10, kr.evict),
        "finest_fits_l2_cols": small.padded_cols,
        "zero_values_ms": cold_ms(lambda: hu.hier_update_signed(
            hplan, table, chunks, zeros, q, r, s_q, s_r), 10, kr.evict)}
    del small_table, zeros
    with AllGlobal():
        row["global_route_ms"] = cold_ms(
            lambda: hu.hier_update_signed(hplan, table, chunks, v, q, r, s_q, s_r), 10,
            kr.evict)
    row["per_leaf"] = per_leaf
    row["step_cold_ms"] = sum(x["cold_ms"] for x in per_leaf.values())
    row["global_route_step_cold_ms"] = sum(x["global_route_cold_ms"]
                                           for x in per_leaf.values())
    row["lm_head_over_embed"] = per_leaf["lm_head"]["cold_ms"] / per_leaf["embed"]["cold_ms"]
    log(f"K8f geometry {row['geometry']}; global route {row['global_route_ms']:.5f} ms; "
        f"lm_head / embed {row['lm_head_over_embed']:.4f}; bound probes "
        f"{row['bound_probes']}")
    kr.rows.append(row)


def busy_share(run) -> dict:
    """Run ``run`` under torch.profiler: the device's busy and idle share of
    its wall time, the share of the busy time in sorting kernels, and the
    kernels that take the device time."""
    _, secs, kernels = device_kernels(run)
    busy = sum(us for _, us in kernels) / 1e6
    by_name = {}
    for name, us in kernels:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    sort = sum(us for name, us in kernels if "sort" in name.lower()) / 1e6
    return {"wall_s": secs, "device_busy_s": busy,
            "idle_share": 1 - busy / secs if secs else None,
            "sort_s": sort, "sort_share_of_busy": sort / busy if busy else None,
            "top_kernels": [[name[:80], tot / 1e3, n] for name, (tot, n) in top]}


def device_profile(spec, params, stream, thr):
    """The main path once more (ingest, ``heavy_hitters``, ``topk``) under
    the profiler."""
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                            use_update_kernel=True, use_kernel=True)
    eng = SketchServeEngine(ep, max_staleness=0)

    def run():
        for s in range(0, stream.items.shape[0], BLOCK):
            eng.ingest(stream.items[s : s + BLOCK], stream.freqs[s : s + BLOCK])
        eng.heavy_hitters(thr)
        eng.topk(100)

    return busy_share(run)


def turnstile_profile(spec, hspec, cs_params, turnstile, thr, cands):
    """The turnstile path once more (both ingests, the descent, the point
    queries) under the profiler."""
    items, freqs, queries = turnstile
    kh = KernelHierarchy(hspec, cs_params, block_b=BLOCK, mode="signed")
    ks = KernelSketch(spec, cs_params, block_b=BLOCK, mode="signed")

    def run():
        ingest_blocks(kh, items, freqs)
        ingest_blocks(ks, items, freqs)
        cs.find_heavy_hitters(hspec, kh.cs_state(), thr, cands, use_kernel=True)
        ks.query(queries)

    return busy_share(run)


def conservative_profile(spec, params, stream, thr):
    """The conservative path once more (endpoint ingest, ``heavy_hitters``,
    ``topk``, the flat sketch's ingest) under the profiler."""
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                            use_kernel=True, mode="conservative")
    eng = SketchServeEngine(ep, max_staleness=0)
    ks = KernelSketch(spec, params, block_b=BLOCK, mode="conservative")

    def run():
        for s in range(0, stream.items.shape[0], BLOCK):
            eng.ingest(stream.items[s : s + BLOCK], stream.freqs[s : s + BLOCK])
        eng.heavy_hitters(thr)
        eng.topk(100)
        ks.update(stream.items, stream.freqs)

    return busy_share(run)


def training_profile(seed):
    """One more train step at the training path's size (after one warm-up
    step) under the profiler."""
    cfg, tcfg = train_setup()
    state = tl.init_train_state(cfg, tcfg,
                                torch.Generator(device=DEVICE).manual_seed(seed + 1), DEVICE)
    state, _ = tl.train(cfg, tcfg, 1, TRAIN_BATCH, TRAIN_SEQ, state)
    return busy_share(lambda: tl.train(cfg, tcfg, 1, TRAIN_BATCH, TRAIN_SEQ, state))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # phase 1: build every kernel from the checkout's sources
    lib, t_build = wall(lambda: _cuda.build(force=True))
    log(f"built {lib.name} in {t_build:.1f} s")

    t0 = time.perf_counter()
    stream = zipf_graph_stream(**STREAM, seed=args.seed)
    thr = max(1, int(PHI * stream.total))
    exact_items, _ = exact_heavy_hitters(stream.items, stream.freqs, thr)
    rng = np.random.default_rng(args.seed)
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], RANGES, WIDTH)
    hspec = hh.HierarchySpec.from_spec(spec)
    params = (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
              draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
    cs_params = params + (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
                          draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
    log(f"stream: {stream.items.shape[0]} distinct edges, {stream.total} arrivals, "
        f"threshold {thr}, {exact_items.shape[0]} exact heavy hitters "
        f"({time.perf_counter() - t0:.1f} s to make)")

    # the host's share of ingest: the candidate pools alone
    t = time.perf_counter()
    pools = [SpaceSaving(POOL, 1) for _ in range(2)]
    for s in range(0, stream.items.shape[0], BLOCK):
        for j, pool in enumerate(pools):
            pool.offer(stream.items[s : s + BLOCK, [j]], stream.freqs[s : s + BLOCK])
    t_pools = time.perf_counter() - t

    eng, main_launches, grids, e2e, main_answer = main_path(spec, params, stream, thr,
                                                            exact_items)
    e2e["pools_only_s"] = t_pools
    ks, flat_launches, flat_e2e = flat_path(spec, params, stream)
    e2e["flat"] = flat_e2e
    e2e.update(rows=int(stream.items.shape[0]), arrivals=int(stream.total),
               block=BLOCK, threshold=thr,
               table_mb=hspec.table_cells * 4 / 1e6)

    kh_s, ks_s, turnstile, turn_launches, sgrids, turn_e2e = turnstile_path(
        spec, hspec, cs_params, stream, args.seed)
    e2e["turnstile"] = turn_e2e

    acc_ks, acc_linear, acc_launches, acc_e2e, acc_k2 = accuracy_path(stream, args.seed)
    e2e["accuracy"] = acc_e2e
    ep_c, ks_c, cons_launches, cons_e2e = conservative_path(
        spec, params, stream, thr, exact_items, main_answer, eng.backend.state, ks)
    e2e["conservative"] = cons_e2e
    f_flat, f_hier, f_signed, f32_launches, f32_e2e = float32_path(
        spec, hspec, params, cs_params, stream, turnstile, ks, ks_s)
    e2e["float32"] = f32_e2e

    cfg, tcfg, state, train_launches, train_e2e = training_path(args.seed)
    train_e2e["compression_checks"] = compression_checks(cfg, tcfg, state)
    e2e["training"] = train_e2e
    leaves = [("/".join(path), c) for path, c in tr.flatten(state["compression"].compressors)
              if c is not None]
    bspec = tl.make_sketch_spec(cfg)
    bigram = (bspec, tl.make_plan(bspec), *state["sketch_params"], bigram_chunks(cfg, bspec, 0),
              state["sketch_table"])
    del state
    torch.cuda.empty_cache()

    win_launches, f32_grids, win_replay, e2e["windowed"] = windowed_path(spec, params, stream)
    # K4f's row now: its grids hold the decayed window's merged buffers
    k4f_row = grid_kernel_row(
        KernelRows({"hier_query_f32": win_launches["decay"]["hier_query_f32"]}),
        "hier_query_f32", "sk_hier_query_f32_kernel", hq.hier_candidate_query_f32, f32_grids)
    del f32_grids
    torch.cuda.empty_cache()
    (retune_launches, retune_replay, e2e["retune"]), t_retune = wall(
        lambda: retune_path(args.seed))
    (ext_launches, e2e["accuracy_extended"]), t_ext = wall(
        lambda: accuracy_extended_path(args.seed))
    e2e["retune"]["phase_s"], e2e["accuracy_extended"]["phase_s"] = t_retune, t_ext
    log(f"re-tuning phase {t_retune:.1f} s, extended accuracy phase {t_ext:.1f} s")
    by_path = {
        "hier_update": {"main": main_launches["hier_update"],
                        "windowed": sum(v["hier_update"] for v in win_launches.values()),
                        "retune": retune_launches["hier_update"]},
        "hier_query": {"main": main_launches["hier_query"],
                       "windowed": sum(v["hier_query"] for v in win_launches.values()),
                       "retune": retune_launches["hier_query"]},
        "hier_update_f32": {"float32": f32_launches["hier_update_f32"],
                            "windowed": win_launches["decay"]["hier_update_f32"]},
        "hier_query_f32": {"windowed": win_launches["decay"]["hier_query_f32"]},
        "sketch_update": {"flat": flat_launches["sketch_update"],
                          "accuracy": acc_launches["sketch_update"],
                          "training": train_launches["sketch_update"],
                          "accuracy_extended": ext_launches["sketch_update"]},
        "sketch_query": {"flat": flat_launches["sketch_query"],
                         "accuracy": acc_launches["sketch_query"],
                         "accuracy_extended": ext_launches["sketch_query"]}}

    kr = KernelRows({**main_launches,
                     **{k: sum(v.values()) for k, v in by_path.items()},
                     **{k: v for k, v in turn_launches.items()
                        if k.endswith(("_signed", "_signed_median"))},
                     "conservative_fold": cons_launches["conservative_fold"],
                     "sketch_update_conservative": (
                         acc_launches["sketch_update_conservative"]
                         + cons_launches["sketch_update_conservative"]),
                     **{k: f32_launches[k] for k in (
                         "sketch_update_f32", "sketch_update_signed_f32")},
                     "hier_update_signed_f32": train_launches["hier_update_signed_f32"]})
    kernel_rows(kr, hspec, eng, ks, stream, grids)
    k1 = next(row for row in kr.rows if row["name"] == "sketch_update")
    k1["by_shape"] = k1_by_shape(kr, stream, acc_linear, ks, bigram)
    k2 = next(row for row in kr.rows if row["name"] == "sketch_query")
    k2["by_shape"] = k2_by_shape(kr, acc_k2)
    del acc_k2
    del bigram
    signed_kernel_rows(kr, hspec, kh_s, ks_s, turnstile, sgrids, stream, args.seed)
    conservative_kernel_rows(kr, hspec, ep_c, ks_c, acc_ks, stream)
    kr.rows[-1]["launches_by_path"] = {
        "accuracy": acc_launches["sketch_update_conservative"],
        "conservative": cons_launches["sketch_update_conservative"]}
    f32_kernel_rows(kr, hspec, stream, turnstile, f_flat, f_hier, f_signed, leaves)
    kr.rows.append(k4f_row)
    # K4's error over every grid it launched: the main path's, replayed
    # above, and the windowed and re-tuning paths', replayed as they ran
    k4 = next(row for row in kr.rows if row["name"] == "hier_query")
    k4["max_abs_err"] = max(k4["max_abs_err"], win_replay.err, retune_replay.err)
    k4["grids_replayed_by_path"] = {"main": len(grids.calls), "windowed": win_replay.grids,
                                    "retune": retune_replay.grids}
    for row in kr.rows:
        if row["name"] in by_path:
            row["launches_by_path"] = by_path[row["name"]]
    check(len(kr.rows) == len(KERNELS) and {r["name"] for r in kr.rows} == set(KERNELS),
          "a row for every kernel")
    del eng, ks, grids, kh_s, ks_s, sgrids, ep_c, ks_c, acc_ks, acc_linear, f_flat, f_hier
    del f_signed
    del leaves
    torch.cuda.empty_cache()
    e2e["profile"] = device_profile(spec, params, stream, thr)
    turn_e2e["profile"] = turnstile_profile(
        spec, hspec, cs_params, turnstile, turn_e2e["threshold"],
        group_candidates(spec, stream.items))
    cons_e2e["profile"] = conservative_profile(spec, params, stream, thr)
    train_e2e["profile"] = training_profile(args.seed)
    log("e2e " + json.dumps(e2e))
    print(json.dumps({"kernels": kr.rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
