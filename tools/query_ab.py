"""Time the candidate-grid queries (K4, K9, K9m) and the descents and
training step around them for two source trees on one card, in turns.

    python3 tools/query_ab.py --trees OLD NEW [--out FILE]

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


def one(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import countsketch as cs
    from repro_torch.core import hierarchy as hh
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema, draw_hash_params_np
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import hier_query as hq
    from repro_torch.kernels.ops import KernelHierarchy
    from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
    from repro_torch.streams import group_candidates, zipf_graph_stream
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import optimizer as opt
    from repro_torch.training import train_loop as tl

    _cuda.build(force=True)
    l2 = torch.zeros(1 << 26, dtype=torch.int32, device="cuda")

    def cold_ms(fn, reps=50):
        fn()
        pairs = []
        for _ in range(reps):
            l2.add_(1)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            pairs.append((a, b))
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / reps

    def kernels_of(run):
        """[(name, device us)] of the CUDA kernels ``run`` ran, and its
        host seconds (torch.profiler)."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            run()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
        return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
                if e.device_type == DeviceType.CUDA], secs

    def device_ms(fn, kernel, reps=20):
        fn()
        for _ in range(3):
            ks, _ = kernels_of(lambda: [(l2.add_(1), fn()) for _ in range(reps)])
            times = [us for name, us in ks if kernel in name]
            if times:
                return sum(times) / len(times) / 1e3
        return None

    def wall_ms(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

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
    rng = np.random.default_rng(0)
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], RANGES, WIDTH)
    hspec = hh.HierarchySpec.from_spec(spec)
    params = (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
              draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
    cs_params = params + (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
                          draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
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
    trng = np.random.default_rng((0, 12))
    n = stream.items.shape[0]
    gone = np.zeros(n, bool)
    gone[trng.permutation(n)[: n // 2]] = True
    items = np.concatenate([stream.items, stream.items[gone]])
    freqs = np.concatenate([stream.freqs, -stream.freqs[gone]])
    order = trng.permutation(items.shape[0])
    items, freqs = items[order], freqs[order]
    tthr = PHI * int(stream.freqs[~gone].sum())
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
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
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
        done = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    result = {"card": card, "order": [old, new, new, old], "runs": runs}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
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
