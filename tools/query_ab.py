"""Time the candidate-grid queries (K4, K9, K9m) and the descents and
training step around them, or (``--point``) the flat point queries (K2,
K7, K7m), for two source trees on one card, in turns.

    python3 tools/query_ab.py --trees OLD NEW [--point] [--out FILE]

Each tree is a checkout of this repository (its ``src/repro_torch``).  The
trees run in the order OLD, NEW, NEW, OLD, each in a process of its own
(both packages are named ``repro_torch``), which builds that tree's kernels
and, on ``chip_smoke.py``'s stream, spec and hash draws (seed 0):

- the main path: the endpoint and engine over the whole stream, then
  ``heavy_hitters`` (after a warm-up call), ``topk(100)`` and a ``flush``
  of 16 requests (host clock, ended by a synchronise), every K4 call
  recorded; then K4 at each recorded (P, C): one call with L2 evicted
  (CUDA events) and the kernel's device time (torch.profiler, L2 evicted),
  and the sum over the recorded launches of the device time; on a tree
  with K4's window route also each shape's device time on the direct
  route and on both routes at fixed tiles of candidates a CTA;
- the turnstile path: the signed hierarchy over the turnstile stream (the
  stream and a seeded half of its edges deleted, shuffled), the signed
  descent (the warm-up, then three timed runs), every grid call recorded,
  and one descent under torch.profiler with the share of its device time
  in sorting kernels; K9 at the most launched grid (cold and device time),
  K9m there on a tree that has it (also at fixed tiles), and
  ``median_rows`` of K9's rows there;
- the training path: ``train()`` on starcoder2-7b at full width, 2
  layers, 5 steps of 8 x 1,024 tokens with compression on (CUDA events
  around ``compress_decompress`` and ``median_rows``), tokens/s after the
  first step, peak memory.

With ``--point``, on the same stream and draws:

- the flat path: a ``KernelSketch`` over the stream, then K2 on
  ``chip_smoke.py``'s 65,536 query keys (cold: one call with L2 evicted,
  CUDA events; device: the kernel alone, torch.profiler, L2 evicted) and
  ``query()`` of those keys on the host clock (five calls after a warm-up),
  one of them profiled (host ops, device kernels and copies);
- the accuracy path's shapes: ``chip_smoke.py``'s 2% sample,
  ``choose_sketch`` and its four specs at h = 4,096, w = 5 built linearly
  (K1), and K2 on their top-500 and random-500 queries;
- the turnstile path: a signed ``KernelSketch`` over the turnstile stream,
  then on 65,536 query keys K7, K7 followed by ``median_rows`` (the
  parent's signed ``query()``: cold, and the device time of all its
  kernels), K7m on a tree that has it, and ``query()`` on the host clock,
  profiled once;
- on a tree with the lane rule (``sketch_query.point_lanes``), K2 on the
  flat table and the accuracy path's count-min table and K7m on the
  signed table at 500 to 65,536 queries, forced to each lane count a query
  may take, beside the rule's pick (device ms).

Only the wrappers' public signatures are used, so trees from before and
after the queries' redesign run the same script.  Prints one JSON object a
run and, last, the card's name and power limit with every run's figures.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

STREAM = dict(n_src=200_000, n_tgt=600_000, n_edges=2_000_000,
              n_occurrences=20_000_000, s_src=1.1, s_tgt=1.1)   # chip_smoke.STREAM
BLOCK = 1 << 16
RANGES, WIDTH, PHI, POOL = (4096, 4096), 4, 0.002, 4096
H_ACC, W_ACC, SAMPLE, N_QUERIES = 4096, 5, 0.02, 500               # chip_smoke's
# query counts of the lane sweep: the accuracy path's 500 up to the flat
# paths' 65,536, with 132 x 256 (an H100's SMs times a CTA) between
LANE_SWEEP_QUERIES = (500, 2048, 8192, 16384, 33792, 65536)


class Clock:
    """Timers on the card: L2 is evicted by rewriting a 256 MB buffer."""

    def __init__(self):
        import torch
        self.torch = torch
        self.l2 = torch.zeros(1 << 26, dtype=torch.int32, device="cuda")

    def evict(self):
        self.l2.add_(1)

    def cold_ms(self, fn, reps=50):
        """Mean ms of one call of ``fn`` after an eviction (CUDA events)."""
        torch = self.torch
        fn()
        pairs = []
        for _ in range(reps):
            self.evict()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def kernels_of(self, run):
        """[(name, device us)] of the CUDA kernels ``run`` ran, and its
        host seconds (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            self.torch.cuda.synchronize()
            secs = time.perf_counter() - t
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA], secs

    def device_ms(self, fn, kernel, reps=20):
        """Mean device ms of the kernel whose name holds ``kernel``, one
        launch after each eviction; None if three traces hold none."""
        fn()
        for _ in range(3):
            ks, _ = self.kernels_of(lambda: [(self.evict(), fn()) for _ in range(reps)])
            times = [us for name, us in ks if kernel in name]
            if times:
                return sum(times) / len(times) / 1e3
        return None

    def call_device_ms(self, fn, reps=20):
        """(device ms, kernels) of one call of ``fn`` over all the kernels
        it runs, each call after an eviction (whose kernels are left out)."""
        fn()
        evicting = {name for name, _ in self.kernels_of(self.evict)[0]}
        ks, _ = self.kernels_of(lambda: [(self.evict(), fn()) for _ in range(reps)])
        mine = [us for name, us in ks if name not in evicting]
        return sum(mine) / reps / 1e3, len(mine) / reps

    def wall_ms(self, fn):
        torch = self.torch
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def profile_call(self, fn):
        """One call of ``fn`` (after a warm-up) under torch.profiler: host
        ms, the host ops that took the most of it (self time), and every
        device kernel and copy with its us."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        self.torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, ms = self.wall_ms(fn)
        device = [[e.name[:70], e.time_range.elapsed_us()] for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
        ops = sorted(prof.key_averages(), key=lambda a: -a.self_cpu_time_total)[:12]
        return {"wall_ms": ms, "device": device,
                "device_us": sum(us for _, us in device),
                "host_ops": [[a.key[:60], a.count, a.self_cpu_time_total,
                              a.cpu_time_total] for a in ops]}


def _draws(np, spec):
    """chip_smoke.py's bucket and sign draws (seed 0)."""
    from repro_torch.core.hashing import draw_hash_params_np
    rng = np.random.default_rng(0)
    params = (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
              draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
    return params, params + (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
                             draw_hash_params_np(rng, (WIDTH, spec.n_groups)))


def _turnstile(np, stream):
    """chip_smoke.py's turnstile stream (seed 0): items, freqs, kept freqs."""
    trng = np.random.default_rng((0, 12))
    n = stream.items.shape[0]
    gone = np.zeros(n, bool)
    gone[trng.permutation(n)[: n // 2]] = True
    items = np.concatenate([stream.items, stream.items[gone]])
    freqs = np.concatenate([stream.freqs, -stream.freqs[gone]])
    order = trng.permutation(items.shape[0])
    return items[order], freqs[order], stream.freqs[~gone]


def one_point(tree: str) -> dict:
    """The flat point queries of one tree (see the top of this file)."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.core import countsketch as cs
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.core.selection import choose_sketch, seeded_draw
    from repro_torch.device import as_index_tensor
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import sketch_query as sq
    from repro_torch.kernels.ops import KernelSketch
    from repro_torch.streams import zipf_graph_stream

    _cuda.build(force=True)
    clock = Clock()
    stream = zipf_graph_stream(**STREAM, seed=0)
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], RANGES, WIDTH)
    params, cs_params = _draws(np, spec)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    n = stream.items.shape[0]

    def chunks_of(sketch, items):
        return sketch.spec.schema.module_chunks(as_index_tensor(items, "cuda"))

    def k2_row(sketch, items):
        c = chunks_of(sketch, items)
        call = lambda: sq.sketch_query(sketch.plan, sketch.table, c,  # noqa: E731
                                       sketch.params.q, sketch.params.r)
        return {"queries": int(items.shape[0]), "cold_ms": clock.cold_ms(call, 100),
                "device_ms": clock.device_ms(call, "sk_query_kernel")}

    def lanes_sweep(sketch, pool, signed=False):
        """On a tree with the lane rule: K2 (K7m if ``signed``) device ms
        at LANE_SWEEP_QUERIES query counts, forced to each lane count up to
        w's, beside the rule's pick."""
        rule, w, out = sq.point_lanes, sketch.table.shape[0], {}
        kernel = "sk_query_signed_median_kernel" if signed else "sk_query_kernel"
        try:
            for n_q in LANE_SWEEP_QUERIES:
                c = chunks_of(sketch, pool[:n_q])
                if signed:
                    call = lambda: sq.sketch_query_signed_median(  # noqa: E731
                        sketch.plan, sketch.table, c, sketch.params.q, sketch.params.r,
                        sketch.cs_params.sign_q, sketch.cs_params.sign_r)
                else:
                    call = lambda: sq.sketch_query(  # noqa: E731
                        sketch.plan, sketch.table, c, sketch.params.q, sketch.params.r)
                row = {"rule": rule(w, n_q, _cuda.sm_count(0))}
                for lanes in (1, 2, 4, 8):
                    if lanes <= sq.max_lanes(w):
                        sq.point_lanes = lambda *args, lanes=lanes: lanes
                        row[str(lanes)] = clock.device_ms(call, kernel)
                out[str(n_q)] = row
        finally:
            sq.point_lanes = rule
        return out

    def host_query(sketch, items):
        sketch.query(items)
        return {"query_ms": [clock.wall_ms(lambda: sketch.query(items))[1] for _ in range(5)],
                "profile": clock.profile_call(lambda: sketch.query(items))}

    # the flat path (chip_smoke.flat_path's query keys)
    ks = KernelSketch(spec, params, block_b=BLOCK)
    ks.update(stream.items, stream.freqs)
    queries = stream.items[np.random.default_rng(1).choice(n, BLOCK, replace=False)]
    out["k2_flat"] = k2_row(ks, queries)
    out["flat_query65536"] = host_query(ks, queries)
    has_lanes = hasattr(sq, "point_lanes")
    if has_lanes:
        out["k2_lanes_flat"] = lanes_sweep(ks, queries)
    del ks
    torch.cuda.empty_cache()

    # the accuracy path's shapes (chip_smoke.accuracy_path's sample, specs
    # and query sets)
    rng = np.random.default_rng((0, 13))
    s_items, s_freqs = stream.sample(SAMPLE, rng)
    draw = seeded_draw(0)
    result = choose_sketch(s_items, s_freqs, stream.schema, H_ACC, W_ACC, draw)
    a, b = result.mod_ranges
    specs = {"count-min": sk.count_min_spec(stream.schema, H_ACC, W_ACC),
             "equal-sketch": sk.equal_sketch_spec(stream.schema, H_ACC, W_ACC),
             "mod-sketch": sk.mod_sketch_spec(stream.schema, [(0,), (1,)], (a, b), W_ACC),
             "selected": result.spec}
    qsets = {"top-500": stream.top_k_queries(N_QUERIES)[0],
             "random-500": stream.random_k_queries(N_QUERIES, rng)[0]}
    acc = {}
    for name, aspec in specs.items():
        lin = KernelSketch(aspec, draw(0, aspec), block_b=BLOCK)
        lin.update(stream.items, stream.freqs)
        for qname, qi in qsets.items():
            acc[f"{name} {qname}"] = k2_row(lin, qi)
        if has_lanes and name == "count-min":
            out["k2_lanes_accuracy_count_min"] = lanes_sweep(lin, queries)
    out["k2_accuracy"] = acc

    # the turnstile path (chip_smoke.turnstile_path's query keys)
    items, freqs, _ = _turnstile(np, stream)
    ks = KernelSketch(spec, cs_params, block_b=BLOCK, mode="signed")
    for s in range(0, items.shape[0], BLOCK):
        ks.update(items[s : s + BLOCK], freqs[s : s + BLOCK])
    tq = stream.items[np.random.default_rng(3).choice(n, BLOCK, replace=False)]
    c = chunks_of(ks, tq)
    args = (ks.plan, ks.table, c, ks.params.q, ks.params.r, ks.cs_params.sign_q,
            ks.cs_params.sign_r)
    k7 = lambda: sq.sketch_query_signed(*args)  # noqa: E731
    out["k7"] = {"cold_ms": clock.cold_ms(k7, 100),
                 "device_ms": clock.device_ms(k7, "sk_query_signed_kernel")}
    k7_med = lambda: cs.median_rows(sq.sketch_query_signed(*args))  # noqa: E731
    dev_ms, kernels = clock.call_device_ms(k7_med)
    out["k7_then_median_rows"] = {"cold_ms": clock.cold_ms(k7_med, 100), "device_ms": dev_ms,
                                  "kernels_a_call": kernels}
    if hasattr(sq, "sketch_query_signed_median"):
        k7m = lambda: sq.sketch_query_signed_median(*args)  # noqa: E731
        out["k7m"] = {"cold_ms": clock.cold_ms(k7m, 100),
                      "device_ms": clock.device_ms(k7m, "sk_query_signed_median_kernel"),
                      "equals_k7_then_median_rows": bool(torch.equal(
                          k7m().view(torch.int32), k7_med().view(torch.int32)))}
    out["turnstile_query65536"] = host_query(ks, tq)
    if has_lanes:
        out["k7m_lanes"] = lanes_sweep(ks, tq, signed=True)
    return out


def one(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import countsketch as cs
    from repro_torch.core import hierarchy as hh
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import hier_query as hq
    from repro_torch.kernels.ops import KernelHierarchy
    from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
    from repro_torch.streams import group_candidates, zipf_graph_stream
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl

    _cuda.build(force=True)
    clock = Clock()
    cold_ms, kernels_of, device_ms, wall_ms = (clock.cold_ms, clock.kernels_of,
                                               clock.device_ms, clock.wall_ms)

    class Record:
        """Records every call of ``module.name`` (args and keywords)."""

        def __init__(self, module, name):
            self.module, self.name, self.calls = module, name, []

        def __enter__(self):
            self.orig = fn = getattr(self.module, self.name)

            def rec(*args, **kw):
                self.calls.append((args, kw))
                return fn(*args, **kw)

            setattr(self.module, self.name, rec)
            return self

        def __exit__(self, *exc):
            setattr(self.module, self.name, self.orig)

        def by_shape(self):
            out = {}
            for args, kw in self.calls:
                key = (args[1].shape[1], args[2].shape[1])
                out.setdefault(key, [0, (args, kw)])[0] += 1
            return out

    def tiles(p, c, args, kw, fn, kernel):
        """(the rule's route, {geometry: device ms}): the direct route at
        the rule's tile and at 256, 512 and 1,024 candidates a CTA, and the
        window route at 1,024, 2,048 and 4,096."""
        rule, span = hq.query_geometry, kw.get("span") or RANGES[-1]
        g = rule(WIDTH, p, c, span, _cuda.sm_count(0))
        direct = g if not g.span else rule(WIDTH, p, c, None, _cuda.sm_count(0))
        geos = {"direct": direct}
        geos.update({f"direct_{t}": hq.QueryGeometry(0, t, 0) for t in (256, 512, 1024)})
        geos.update({f"window_{t}": hq.QueryGeometry(span, t, hq.window_bytes(WIDTH, span))
                     for t in (1024, 2048, 4096)})
        out = {}
        try:
            for name, geo in geos.items():
                hq.query_geometry = lambda *a, geo=geo, **k: geo
                out[name] = device_ms(lambda: fn(*args, **kw), kernel)
        finally:
            hq.query_geometry = rule
        return ("window" if g.span else "direct"), out

    stream = zipf_graph_stream(**STREAM, seed=0)
    thr = max(1, int(PHI * stream.total))
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], RANGES, WIDTH)
    hspec = hh.HierarchySpec.from_spec(spec)
    params, cs_params = _draws(np, spec)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    windowed = hasattr(hq, "query_geometry")

    # the main path, every K4 call recorded
    ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                            use_update_kernel=True, use_kernel=True)
    eng = SketchServeEngine(ep, max_staleness=0)
    for s in range(0, stream.items.shape[0], BLOCK):
        eng.ingest(stream.items[s : s + BLOCK], stream.freqs[s : s + BLOCK])
    eng.drain()
    eng.sync()
    eng.heavy_hitters(thr)
    with Record(hq, "hier_candidate_query") as k4:
        _, out["heavy_hitters_ms"] = wall_ms(lambda: eng.heavy_hitters(thr))
        _, out["topk100_ms"] = wall_ms(lambda: eng.topk(100))
        for k in (1, 5, 10, 25, 50, 100, 200, 400):
            eng.submit_topk(k)
        for m in (0.5, 1, 2, 4, 8, 16, 32, 64):
            eng.submit_heavy_hitters(int(thr * m))
        _, out["flush16_ms"] = wall_ms(eng.flush)
    shapes = {}
    for (p, c), (n, (args, kw)) in sorted(k4.by_shape().items()):
        row = {"launches": n, "cold_ms": cold_ms(lambda: hq.hier_candidate_query(*args, **kw)),
               "device_ms": device_ms(lambda: hq.hier_candidate_query(*args, **kw),
                                      "sk_hier_query_kernel")}
        if windowed:
            row["route"], row["tiles"] = tiles(p, c, args, kw, hq.hier_candidate_query,
                                               "sk_hier_query_kernel")
            row["direct_device_ms"] = row["tiles"]["direct"]
        shapes[f"{p}x{c}"] = row
    out["k4_by_shape"] = shapes
    out["k4_launches"] = len(k4.calls)
    out["k4_total_device_ms"] = sum(r["launches"] * r["device_ms"] for r in shapes.values())
    del eng, ep, k4
    torch.cuda.empty_cache()

    # the turnstile path
    items, freqs, kept = _turnstile(np, stream)
    tthr = PHI * int(kept.sum())
    cands = group_candidates(spec, stream.items)
    kh = KernelHierarchy(hspec, cs_params, block_b=BLOCK, mode="signed")
    for s in range(0, items.shape[0], BLOCK):
        kh.update(items[s : s + BLOCK], freqs[s : s + BLOCK])
    state = kh.cs_state()

    def descend():
        return cs.find_heavy_hitters(hspec, state, tthr, cands, use_kernel=True)

    descend()
    grid_fn = ("hier_candidate_median_signed" if hasattr(hq, "hier_candidate_median_signed")
               else "hier_candidate_query_signed")
    with Record(hq, grid_fn) as grids:
        found, t = wall_ms(descend)
    out["descent_ms"] = [t] + [wall_ms(descend)[1] for _ in range(2)]
    out["descent_found"] = int(found[0].shape[0])
    out["descent_launches"] = len(grids.calls)
    ks, secs = kernels_of(descend)
    busy = sum(us for _, us in ks) / 1e3
    out["descent_profile"] = {
        "wall_ms": secs * 1e3, "device_busy_ms": busy,
        "sort_ms": sum(us for name, us in ks if "ort" in name) / 1e3,
        "grid_kernel_ms": sum(us for name, us in ks if "sk_hier_query" in name) / 1e3}
    (p, c), (_, (args, kw)) = max(grids.by_shape().items(), key=lambda kv: kv[1][0])
    out["grid_shape"] = f"{p}x{c}"
    k9 = lambda: hq.hier_candidate_query_signed(*args, **kw)  # noqa: E731
    out["k9_cold_ms"] = cold_ms(k9)
    out["k9_device_ms"] = device_ms(k9, "sk_hier_query_signed_kernel")
    rows = k9()
    out["median_rows_cold_ms"] = cold_ms(lambda: cs.median_rows(rows))
    if grid_fn == "hier_candidate_median_signed":
        k9m = lambda: hq.hier_candidate_median_signed(*args, **kw)  # noqa: E731
        out["k9m_cold_ms"] = cold_ms(k9m)
        out["k9m_device_ms"] = device_ms(k9m, "sk_hier_query_signed_median_kernel")
        out["k9m_route"], out["k9m_tiles"] = tiles(
            p, c, args, kw, hq.hier_candidate_median_signed,
            "sk_hier_query_signed_median_kernel")
    del kh, state, rows, grids, args, kw
    torch.cuda.empty_cache()

    # the training path
    cfg = dataclasses.replace(get_config("starcoder2-7b"), n_layers=2)
    tcfg = tl.TrainConfig(optimizer=opt.OptimizerConfig(lr=1e-3, warmup_steps=0),
                          compression=gc.CompressionConfig(enabled=True))
    torch.cuda.reset_peak_memory_stats()
    tstate = tl.init_train_state(cfg, tcfg, torch.Generator(device="cuda").manual_seed(0),
                                 "cuda")
    events = {"compression": [], "median": []}
    wrapped = [(tl, "compress_decompress", "compression"), (cs, "median_rows", "median")]
    origs = [getattr(m, name) for m, name, _ in wrapped]

    def timed(fn, key):
        def inner(*a, **k):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            r = fn(*a, **k)
            e1.record()
            events[key].append((e0, e1))
            return r
        return inner

    for (m, name, key), fn in zip(wrapped, origs):
        setattr(m, name, timed(fn, key))
    try:
        tstate, hist = tl.train(cfg, tcfg, 5, 8, 1024, tstate)
    finally:
        for (m, name, _), fn in zip(wrapped, origs):
            setattr(m, name, fn)
    torch.cuda.synchronize()
    steady = hist["step_time_s"][1:]
    comp = [a.elapsed_time(b) for a, b in events["compression"]]
    med = [a.elapsed_time(b) for a, b in events["median"]]
    per_step = len(med) // 5
    out["training"] = {
        "tokens_per_s_after_first": len(steady) * 8 * 1024 / sum(steady),
        "compression_ms": comp, "median_ms_per_step": [
            sum(med[i * per_step : (i + 1) * per_step]) for i in range(5)],
        "median_calls_per_step": per_step,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": hist["loss"]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--point", action="store_true",
                    help="time the flat point queries (K2, K7, K7m) instead")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps((one_point if args.point else one)(args.one)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("query_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    old, new = args.trees
    runs = []
    for tree in (old, new, new, old):
        done = subprocess.run([sys.executable, __file__, "--one", tree]
                              + ["--point"] * args.point, capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    result = {"card": card, "order": [old, new, new, old], "runs": runs}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    if args.point:
        for run in runs:
            print(run["tree"], "K2 flat", run["k2_flat"], "K7", run["k7"],
                  "K7 + median_rows", run["k7_then_median_rows"], "K7m", run.get("k7m"))
            print(run["tree"], "query65536 ms: flat", run["flat_query65536"]["query_ms"],
                  "turnstile", run["turnstile_query65536"]["query_ms"])
            print(run["tree"], "K2 accuracy device ms:",
                  {k: r["device_ms"] for k, r in run["k2_accuracy"].items()})
            for key in ("k2_lanes_flat", "k2_lanes_accuracy_count_min", "k7m_lanes"):
                if key in run:
                    print(run["tree"], key, run[key])
        return 0
    for key in ("heavy_hitters_ms", "topk100_ms", "flush16_ms", "k4_total_device_ms",
                "descent_ms", "k9_device_ms", "k9m_device_ms", "median_rows_cold_ms"):
        print(key, " ".join(str(run.get(key)) for run in runs))
    for run in runs:
        print(run["tree"], "K4 device ms by shape:",
              {s: r["device_ms"] for s, r in run["k4_by_shape"].items()})
        t = run["training"]
        print(run["tree"], "training:", t["tokens_per_s_after_first"], "tokens/s,",
              "compression ms", t["compression_ms"], "median ms a step",
              t["median_ms_per_step"], "peak GB", t["peak_memory_gb"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
