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
   net mass and a block of signed point queries.  Deletion must cancel bit
   for bit (the tables equal those of the kept half alone), and tables and
   answers must equal the plain path's on the card; recall and precision
   against the exact answer are printed, not asserted (the median descent
   is probabilistic);
3. hold each kernel (K1-K4, K6-K9) against its plain version on the card
   at the shapes its path gives it (int32: bit-identical);
4. time each kernel, its plain version and the closest single PyTorch
   call with CUDA events, with L2 evicted before each call as the main
   path finds the tables cold; read the kernel's own device time with
   torch.profiler; set both beside the least time the card could take;
5. drive the main path and the turnstile path once more under
   torch.profiler for the device's busy and idle share.

The second line from the end is one JSON object with a row per kernel;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card
it exits with code 2 and prints no result.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.core import countsketch as cs  # noqa: E402
from repro_torch.core import hierarchy as hh  # noqa: E402
from repro_torch.core import sketch as sk  # noqa: E402
from repro_torch.core.hashing import KeySchema, draw_hash_params_np  # noqa: E402
from repro_torch.core.summary import SpaceSaving  # noqa: E402
from repro_torch.device import as_index_tensor  # noqa: E402
from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import hier_query as hq  # noqa: E402
from repro_torch.kernels import hier_update as hu  # noqa: E402
from repro_torch.kernels import sketch_query as sq  # noqa: E402
from repro_torch.kernels import sketch_update as su  # noqa: E402
from repro_torch.kernels.hashes import all_indices, all_sign_bits  # noqa: E402
from repro_torch.kernels.ops import KernelHierarchy, KernelSketch  # noqa: E402
from repro_torch.serving.sketch_engine import (  # noqa: E402
    SketchServeEngine,
    SketchTopKEndpoint,
)
from repro_torch.streams import (  # noqa: E402
    exact_heavy_hitters,
    group_candidates,
    zipf_graph_stream,
)

# H100 SXM published peaks (NVIDIA H100 datasheet): HBM bytes/s, and
# the non-tensor 32-bit ALU rate, used for the kernels' integer operations
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
CSRC = "src/repro_torch/kernels/csrc/"
# kernel name: (its CUDA source, the TPU kernel it replaces)
KERNELS = {
    "sketch_update": ("sketch_kernels.cu", "src/repro/kernels/sketch_update.py:124"),
    "sketch_query": ("sketch_kernels.cu", "src/repro/kernels/sketch_query.py:47"),
    "hier_update": ("sketch_kernels.cu", "src/repro/kernels/hier_update.py:183"),
    "hier_query": ("sketch_kernels.cu", "src/repro/kernels/hier_query.py:53"),
    "sketch_update_signed": ("signed_kernels.cu",
                             "src/repro/kernels/sketch_update.py:184"),
    "sketch_query_signed": ("signed_kernels.cu", "src/repro/kernels/sketch_query.py:114"),
    "hier_update_signed": ("signed_kernels.cu", "src/repro/kernels/hier_update.py:319"),
    "hier_query_signed": ("signed_kernels.cu", "src/repro/kernels/hier_query.py:150"),
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
    eviction (None when the profiler records no such kernel)."""
    fn()
    _, _, kernels = device_kernels(lambda: [(evict(), fn()) for _ in range(reps)])
    times = [us for name, us in kernels if kernel in name]
    return sum(times) / len(times) / 1e3 if times else None


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


class Recorded:
    """Records the inputs of every call of a grid wrapper (``module.name``)
    while installed, so its kernel is checked and timed at the shapes the
    path gives it.  It wraps the wrapper and counts nothing: the launch
    count stays the wrapper's own."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []
        self._orig = None

    def __enter__(self):
        self._orig = getattr(self.module, self.name)

        def recording(*args):
            self.calls.append(args)
            return self._orig(*args)

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

    def most_launched(self):
        """The (P, C) launched most often (the larger grid on a tie), and
        one call at that shape."""
        shapes = self.shapes()
        p, c = max(shapes, key=lambda s: (shapes[s], s[0] * s[1]))
        return (p, c), next(call for call in self.calls
                            if (call[1].shape[1], call[2].shape[1]) == (p, c))


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
    return eng_k, launches, grids, e2e


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

def turnstile_stream(stream, seed: int):
    """The stream inserted whole and a seeded random half of its distinct
    edges deleted whole (-f), the rows of both signs shuffled together so
    every block carries both.  Returns (items, freqs, kept items, kept
    freqs)."""
    rng = np.random.default_rng((seed, 12))
    n = stream.items.shape[0]
    gone = np.zeros(n, bool)
    gone[rng.permutation(n)[: n // 2]] = True
    items = np.concatenate([stream.items, stream.items[gone]])
    freqs = np.concatenate([stream.freqs, -stream.freqs[gone]])
    order = rng.permutation(items.shape[0])
    return items[order], freqs[order], stream.items[~gone], stream.freqs[~gone]


def ingest_blocks(target, items, freqs) -> None:
    for s in range(0, items.shape[0], BLOCK):
        target.update(items[s : s + BLOCK], freqs[s : s + BLOCK])


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

    with Recorded(hq, "hier_candidate_query_signed") as grids:
        _cuda.reset_launches()
        kh = KernelHierarchy(hspec, cs_params, block_b=BLOCK, mode="signed")
        ks = KernelSketch(spec, cs_params, block_b=BLOCK, mode="signed")
        _, t_hier = wall(lambda: ingest_blocks(kh, items, freqs))
        _, t_flat = wall(lambda: ingest_blocks(ks, items, freqs))
        descend(kh.cs_state(), True)                 # warm-up: first launches
        hh_k, t_desc = wall(lambda: descend(kh.cs_state(), True))
        est_k, t_query = wall(lambda: ks.query(queries))
        launches = dict(_cuda.LAUNCHES)
    log(f"turnstile path launches: {launches}; K9 grid shapes (P, C): {grids.shapes()}")
    for name, kid in (("sketch_update_signed", "K6"), ("sketch_query_signed", "K7"),
                      ("hier_update_signed", "K8"), ("hier_query_signed", "K9")):
        check(launches[name] > 0, f"{kid} ({name}) launched on the turnstile path")
    check(len(grids.calls) == launches["hier_query_signed"],
          "every K9 call of the turnstile path was recorded")

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
           "descent_ms": t_desc * 1e3, "query65536_ms": t_query * 1e3,
           "plain_ingest_s": t_plain, "plain_descent_ms": t_desc_plain * 1e3}
    del plain_h, plain_f
    return kh, ks, (items, freqs, queries), launches, grids, e2e


# --------------------------------------------------------------------------
# phases 3-4: each kernel against its plain version, timed, beside its bound
# --------------------------------------------------------------------------

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

    def add(self, name, symbol, *, err, call, plain, library, n_bytes, n_ops, shape):
        check(err == 0, f"{name} bit-identical to its plain version (max |err| {err})")
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        source, replaces = KERNELS[name]
        out = {"name": name, "route": "cuda", "source": CSRC + source,
               "replaces": replaces, "launches": self.launches[name],
               "max_abs_err": err, "ms": cold_ms(call, 100, self.evict),
               "plain_ms": cold_ms(plain, 20, self.evict), "bound_ms": b_ms,
               "bound_by": b_by,
               "library_ms": cold_ms(library, 50, self.evict) if library else None,
               "device_ms": kernel_device_ms(call, symbol, 50, self.evict),
               "warm_call_ms": cuda_ms(call, 200), "shape": shape}
        self.rows.append(out)
        log(f"{name}: {out['ms']:.5f} ms cold, {out['device_ms']} ms on the device "
            f"(profiler), {out['warm_call_ms']:.5f} ms per warm back-to-back call; "
            f"plain {out['plain_ms']:.5f}, bound {b_ms:.5f} by {b_by}, library "
            f"{out['library_ms']} at {shape}")


def grid_replay_err(calls, kernel, plain) -> float:
    """Max |err| of the kernel against its plain version over every
    recorded grid call of a path."""
    return max(max_abs_err(kernel(*call), plain(*call)) for call in calls)


def grid_shape_note(grids, p, c) -> str:
    shapes = grids.shapes()
    return (f"P={p} C={c}; {shapes[(p, c)]} of {len(grids.calls)} launches; all (P, C): "
            + ", ".join(f"{a}x{b}:{n}" for (a, b), n in sorted(shapes.items())))


def kernel_rows(kr, hspec, eng, ks, stream, grids):
    dev = torch.device(DEVICE)
    q, r = ks.params.q, ks.params.r
    blk_items = stream.items[:BLOCK]
    f = torch.from_numpy(stream.freqs[:BLOCK]).to(dev, torch.int32)

    # K3: one 65,536-row block into the live concatenated hierarchy table
    kh = KernelHierarchy(hspec, (q, r))
    kh.load_state(eng.sync().state)
    hplan, table = kh.hplan, kh.table
    ordered = hspec.level_items(hspec.n_levels - 1, as_index_tensor(blk_items, dev))
    chunks = hspec.levels[-1].schema.module_chunks(ordered)
    w, cols = table.shape
    idx = all_indices(hplan.plan, chunks, q, r)
    base = torch.arange(w, device=dev)[:, None] * cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(hplan.level_offsets, hplan.level_divs)])
    f_all = f.expand(w * hplan.n_levels, BLOCK).reshape(-1)
    touched = int(torch.unique(flat[f_all != 0]).numel())
    scratch = table.clone()
    kr.add("hier_update", "sk_hier_update_kernel",
           err=max_abs_err(hu.hier_update(hplan, table.clone(), chunks, f, q, r),
                           hu.hier_update_ref(hplan, table.clone(), chunks, f, q, r)),
           call=lambda: hu.hier_update(hplan, scratch, chunks, f, q, r),
           plain=lambda: hu.hier_update_ref(hplan, scratch, chunks, f, q, r),
           library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
           n_bytes=key_bytes(hspec.base.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
           + 8 * touched,
           n_ops=hash_ops(hplan.plan, BLOCK) + 3 * w * BLOCK * hplan.n_levels,
           shape=f"B={BLOCK} w={w} levels={hplan.n_levels} cols={cols}")
    del scratch, kh

    # K4: every grid the main path launched, each held against the plain
    # version; timed at the (P, C) it launched most often -- the descent
    # chunks each level's grid into max_batch // C prefixes per launch
    err = grid_replay_err(grids.calls, hq.hier_candidate_query, hq.hier_candidate_query_ref)
    (p, c), (view, pp, cp) = grids.most_launched()
    w = view.shape[0]
    cells = (torch.arange(w, device=dev)[:, None] * view.stride(0)
             + (pp[:, :, None] + cp[:, None, :]).reshape(w, -1))
    touched = int(torch.unique(cells).numel())
    del cells
    kr.add("hier_query", "sk_hier_query_kernel", err=err,
           call=lambda: hq.hier_candidate_query(view, pp, cp),
           plain=lambda: hq.hier_candidate_query_ref(view, pp, cp), library=None,
           n_bytes=4 * w * (p + c) + 4 * p * c + 4 * touched, n_ops=3 * w * p * c,
           shape=f"w={w} cols={view.shape[1]}; " + grid_shape_note(grids, p, c))

    # K1 / K2: the flat sketch's block fold and a block of point queries
    plan, flat_table = ks.plan, ks.table
    fchunks = ks.spec.schema.module_chunks(as_index_tensor(blk_items, dev))
    w, h_pad = flat_table.shape
    idx = all_indices(plan, fchunks, q, r)
    flat = (torch.arange(w, device=dev)[:, None] * h_pad + idx).reshape(-1)
    f_all = f.expand(w, BLOCK).reshape(-1)
    touched = int(torch.unique(flat[f_all != 0]).numel())
    scratch = flat_table.clone()
    kr.add("sketch_update", "sk_update_kernel",
           err=max_abs_err(su.sketch_update(plan, flat_table.clone(), fchunks, f, q, r),
                           su.sketch_update_ref(plan, flat_table.clone(), fchunks, f, q, r)),
           call=lambda: su.sketch_update(plan, scratch, fchunks, f, q, r),
           plain=lambda: su.sketch_update_ref(plan, scratch, fchunks, f, q, r),
           library=lambda: scratch.view(-1).index_add_(0, flat, f_all),
           n_bytes=key_bytes(ks.spec.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
           + 8 * touched,
           n_ops=hash_ops(plan, BLOCK) + 2 * w * BLOCK,
           shape=f"B={BLOCK} w={w} h_pad={h_pad}")
    del scratch

    rng = np.random.default_rng(2)
    qitems = stream.items[rng.choice(stream.items.shape[0], BLOCK, replace=False)]
    qchunks = ks.spec.schema.module_chunks(as_index_tensor(qitems, dev))
    idx = all_indices(plan, qchunks, q, r)
    touched = int(torch.unique(
        (torch.arange(w, device=dev)[:, None] * h_pad + idx).reshape(-1)).numel())
    kr.add("sketch_query", "sk_query_kernel",
           err=max_abs_err(sq.sketch_query(plan, flat_table, qchunks, q, r),
                           sq.sketch_query_ref(plan, flat_table, qchunks, q, r)),
           call=lambda: sq.sketch_query(plan, flat_table, qchunks, q, r),
           plain=lambda: sq.sketch_query_ref(plan, flat_table, qchunks, q, r), library=None,
           n_bytes=key_bytes(ks.spec.schema, BLOCK) + param_bytes(q, r) + 4 * BLOCK
           + 4 * touched,
           n_ops=hash_ops(plan, BLOCK) + 2 * w * BLOCK,
           shape=f"Q={BLOCK} w={w} h_pad={h_pad}")


def signed_values(bits, level: int, f: torch.Tensor) -> torch.Tensor:
    """s_level * f per (row, key), int32, as the signed kernels add it."""
    return ((1 - 2 * ((bits >> level) & 1)) * f.to(torch.int64)).to(torch.int32)


def signed_kernel_rows(kr, hspec, kh, ks, turnstile, grids):
    dev = torch.device(DEVICE)
    items, freqs, queries = turnstile
    (q, r), s_q, s_r = ks.cs_params
    blk_items = items[:BLOCK]
    f = torch.from_numpy(freqs[:BLOCK]).to(dev, torch.int32)

    # K8: one 65,536-row turnstile block into the live signed hierarchy table
    hplan, table = kh.hplan, kh.table
    ordered = hspec.level_items(hspec.n_levels - 1, as_index_tensor(blk_items, dev))
    chunks = hspec.levels[-1].schema.module_chunks(ordered)
    w, cols = table.shape
    idx = all_indices(hplan.plan, chunks, q, r)
    bits = all_sign_bits(hplan.plan, chunks, s_q, s_r)
    base = torch.arange(w, device=dev)[:, None] * cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(hplan.level_offsets, hplan.level_divs)])
    vals = torch.cat([signed_values(bits, l, f).reshape(-1) for l in range(hplan.n_levels)])
    touched = int(torch.unique(flat[vals != 0]).numel())
    scratch = table.clone()
    kr.add("hier_update_signed", "sk_hier_update_signed_kernel",
           err=max_abs_err(
               hu.hier_update_signed(hplan, table.clone(), chunks, f, q, r, s_q, s_r),
               hu.hier_update_signed_ref(hplan, table.clone(), chunks, f, q, r, s_q, s_r)),
           call=lambda: hu.hier_update_signed(hplan, scratch, chunks, f, q, r, s_q, s_r),
           plain=lambda: hu.hier_update_signed_ref(hplan, scratch, chunks, f, q, r, s_q, s_r),
           library=lambda: scratch.view(-1).index_add_(0, flat, vals),
           n_bytes=key_bytes(hspec.base.schema, BLOCK) + nbytes(f) + param_bytes(q, r)
           + param_bytes(s_q, s_r) + 8 * touched,
           n_ops=2 * hash_ops(hplan.plan, BLOCK) + 4 * w * BLOCK * hplan.n_levels,
           shape=f"B={BLOCK} w={w} levels={hplan.n_levels} cols={cols}, "
                 f"{int((f < 0).sum())} deletions")
    del scratch

    # K9: every grid the signed descent launched, each held against the
    # plain version; timed at the (P, C) it launched most often
    err = grid_replay_err(grids.calls, hq.hier_candidate_query_signed,
                          hq.hier_candidate_query_signed_ref)
    (p, c), (view, pp, cp, sp, sc) = grids.most_launched()
    w = view.shape[0]
    cells = (torch.arange(w, device=dev)[:, None] * view.stride(0)
             + (pp[:, :, None] + cp[:, None, :]).reshape(w, -1))
    touched = int(torch.unique(cells).numel())
    del cells
    kr.add("hier_query_signed", "sk_hier_query_signed_kernel", err=err,
           call=lambda: hq.hier_candidate_query_signed(view, pp, cp, sp, sc),
           plain=lambda: hq.hier_candidate_query_signed_ref(view, pp, cp, sp, sc),
           library=None,
           n_bytes=8 * w * (p + c) + 4 * w * p * c + 4 * touched, n_ops=4 * w * p * c,
           shape=f"w={w} cols={view.shape[1]}; " + grid_shape_note(grids, p, c))

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
    kr.add("sketch_update_signed", "sk_update_signed_kernel",
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
    del scratch

    qchunks = ks.spec.schema.module_chunks(as_index_tensor(queries, dev))
    idx = all_indices(plan, qchunks, q, r)
    touched = int(torch.unique(
        (torch.arange(w, device=dev)[:, None] * h_pad + idx).reshape(-1)).numel())
    kr.add("sketch_query_signed", "sk_query_signed_kernel",
           err=max_abs_err(
               sq.sketch_query_signed(plan, flat_table, qchunks, q, r, s_q, s_r),
               sq.sketch_query_signed_ref(plan, flat_table, qchunks, q, r, s_q, s_r)),
           call=lambda: sq.sketch_query_signed(plan, flat_table, qchunks, q, r, s_q, s_r),
           plain=lambda: sq.sketch_query_signed_ref(plan, flat_table, qchunks, q, r,
                                                    s_q, s_r),
           library=None,
           n_bytes=key_bytes(ks.spec.schema, BLOCK) + param_bytes(q, r)
           + param_bytes(s_q, s_r) + 4 * w * BLOCK + 4 * touched,
           n_ops=2 * hash_ops(plan, BLOCK) + 2 * w * BLOCK,
           shape=f"Q={BLOCK} w={w} h_pad={h_pad}")


def busy_share(run) -> dict:
    """Run ``run`` under torch.profiler: the device's busy and idle share of
    its wall time, and the kernels that take the device time."""
    _, secs, kernels = device_kernels(run)
    busy = sum(us for _, us in kernels) / 1e6
    by_name = {}
    for name, us in kernels:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + us, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    return {"wall_s": secs, "device_busy_s": busy,
            "idle_share": 1 - busy / secs if secs else None,
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

    eng, main_launches, grids, e2e = main_path(spec, params, stream, thr, exact_items)
    e2e["pools_only_s"] = t_pools
    ks, flat_launches, flat_e2e = flat_path(spec, params, stream)
    e2e["flat"] = flat_e2e
    e2e.update(rows=int(stream.items.shape[0]), arrivals=int(stream.total),
               block=BLOCK, threshold=thr,
               table_mb=hspec.table_cells * 4 / 1e6)

    kh_s, ks_s, turnstile, turn_launches, sgrids, turn_e2e = turnstile_path(
        spec, hspec, cs_params, stream, args.seed)
    e2e["turnstile"] = turn_e2e

    kr = KernelRows({**main_launches,
                     "sketch_update": flat_launches["sketch_update"],
                     "sketch_query": flat_launches["sketch_query"],
                     **{k: v for k, v in turn_launches.items() if k.endswith("_signed")}})
    kernel_rows(kr, hspec, eng, ks, stream, grids)
    signed_kernel_rows(kr, hspec, kh_s, ks_s, turnstile, sgrids)
    del eng, ks, grids, kh_s, ks_s, sgrids
    e2e["profile"] = device_profile(spec, params, stream, thr)
    turn_e2e["profile"] = turnstile_profile(
        spec, hspec, cs_params, turnstile, turn_e2e["threshold"],
        group_candidates(spec, stream.items))
    log("e2e " + json.dumps(e2e))
    print(json.dumps({"kernels": kr.rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
