"""Time the folds (K1, K1f, K3, K3f, K8, K8f, K6, K6f, K5, K5i) of two source
trees on one card, in turns, beside ``index_add_`` of the same values where
one call computes the same function.

    python3 tools/fold_ab.py --trees OLD NEW [--k5] [--out FILE]
    python3 tools/fold_ab.py --spans TREE [--out FILE]

Each tree is a checkout of this repository (its ``src/repro_torch``).  The
trees run in the order OLD, NEW, NEW, OLD, each in a process of its own
(both packages are named ``repro_torch``), which builds that tree's kernels
and times, with L2 evicted before every call (CUDA events):

- K3 and K3f: block 0 of ``chip_smoke.py``'s main stream (65,536 rows in
  the generator's order, sorted by source) and, for K3, the block whose
  top source holds the most rows, into zero ``4 x (4096 + 4096^2)`` tables;
- K8: the turnstile stream's first block (shuffled, a seeded half of the
  edges deleted) into a zero signed hierarchy of the same spec;
- K6 and K6f: the same block into a zero ``4 x 4096^2`` signed flat
  sketch, int32 and float32;
- K5, the conservative fold, on block 0 and the heaviest block of the
  main stream into a zero ``4 x 4096^2`` flat sketch (its global route:
  claim rounds on a tree that has them), and on block 0 and the heaviest
  block into a zero ``5 x 4092`` mod-sketch of ranges 62 x 66 (its shared
  route: ``chip_smoke.py``'s accuracy path), int32;
- K5 at the block shape of the benchmark's ``twitter-cu.ingest``: blocks
  128-133 of its pool (the first the window folds; ``edge_blocks`` with
  the traffic's stream seed and the run seed ``CELL_SEED``) with the
  configuration's ``hash_seed``, each into a zero table; a tree with claim
  rounds also reports each block's rounds, items folded in rounds and
  tail (its counter) and the round sizes of the plain model, and times
  the first 256 to 65,536 items of block 128 on both of K5's global
  routes (``ROUNDS_MIN_ITEMS`` forced);
- K5i on block 0 into zero int32 hierarchy levels of the main spec
  (level 0 shared, level 1 global), one launch; the conservative rows
  also carry the kernel's device time (torch.profiler, L2 evicted);
- K8f: starcoder2-7b's embed leaf (49,152 x 4,608 keys, the compressor's
  two-level plan, integer values in [-8, 8]);
- K1 at ``chip_smoke.py``'s three shapes: the accuracy path's count-min,
  equal-sketch (64 x 64) and mod-sketch (62 x 66) at h = 4,096, w = 5,
  blocks 0, 7 (the heaviest) and 13 of the main stream, into zero
  ``5 x 4096`` int32 tables; the flat path's zero ``4 x 4096^2`` table at
  blocks 0 and 7 (K1f too, float32); and the training path's bigram fold
  (starcoder2-7b's first batch of 8 x 1,024 tokens, 8,184 keys, into a
  zero ``5 x 65536`` table).  Each K1 row also has the kernel's device
  time (torch.profiler, L2 evicted);
- the accuracy path's linear ingest: the whole main stream into a fresh
  ``KernelSketch`` of each of its three specs (16 K1 launches), host
  seconds from a sync to a sync, five times.

The conservative rows have no ``index_add_``; a tree whose module has
``fold_depths`` also reports each block's D, D_r and S.

``--spans TREE`` times one tree's K1 (a tree whose ``sketch_update`` has
``flat_deal``) at the accuracy path's nine (spec, block) shapes and the
flat path's blocks 0 and 7 with its span forced to 1, 2, 4, 8, 16, 32 and
64 tiles (one CTA a span), cold and device ms.

Each row also has the wrapper's warm time: the mean of back-to-back calls,
which the host's launch cost sets when it exceeds the kernel's.  Only the
wrappers' public signatures are used, so trees from before and after a
kernel's redesign run the same script.  Prints one JSON object per run
and, last, the card's name and power limit with every run's rows.  Needs
a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CELL_BLOCKS = range(128, 134)     # the ingest cell's first timed blocks (after 128 warm-up)
CELL_SEED = 2_654_435_761
SWEEP = (256, 512, 1024, 2048, 4096, 16384, 65536)
STREAM = dict(n_src=200_000, n_tgt=600_000, n_edges=2_000_000,
              n_occurrences=20_000_000, s_src=1.1, s_tgt=1.1)   # chip_smoke.STREAM
BLOCK = 1 << 16
EMBED = (49152, 4608)


SPANS = (1, 2, 4, 8, 16, 32, 64)
ACC_BLOCKS = (0, 7, 13)


def accuracy_specs(sk, schema):
    """chip_smoke.py's accuracy path: h = 4,096, w = 5 (the mod-sketch at
    the Thm-3 ranges its seed-0 sample gives)."""
    return {"count-min": sk.count_min_spec(schema, 4096, 5),
            "equal-sketch": sk.equal_sketch_spec(schema, 4096, 5),
            "mod-sketch": sk.mod_sketch_spec(schema, [(0,), (1,)], (62, 66), 5)}


def timers(torch, l2):
    """cold_ms, warm_ms and device_ms on one card, L2 evicted by rewriting
    ``l2`` before each cold call."""

    def cold_ms(fn, reps):
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

    def warm_ms(fn, reps=200):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / reps

    def device_ms(fn, kernel, reps):
        """Mean device ms of the kernel whose name holds ``kernel``, over
        ``reps`` calls each after an L2 eviction (torch.profiler); None if
        the trace holds no such kernel."""
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                l2.add_(1)
                fn()
            torch.cuda.synchronize()
        times = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and kernel in e.name]
        return sum(times) / len(times) / 1e3 if times else None

    return cold_ms, warm_ms, device_ms


def k1_inputs(tree: str):
    """The main stream, its schema, a seeded params draw and the chunks of
    a block for a spec, on the card, from the tree's own modules."""
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.core.hashing import KeySchema, draw_hash_params_np
    from repro_torch.streams import zipf_graph_stream

    dev = torch.device("cuda")
    stream = zipf_graph_stream(**STREAM, seed=0)
    schema = KeySchema((1 << 32, 1 << 32))

    def params(rng, spec):
        return (torch.from_numpy(draw_hash_params_np(rng, (spec.width, spec.schema.total_chunks))
                                 ).to(dev, torch.int64),
                torch.from_numpy(draw_hash_params_np(rng, (spec.width, spec.n_groups))
                                 ).to(dev, torch.int64))

    def block(spec, b, dtype=torch.int32, blocks=1):
        sl = slice(b * BLOCK, (b + blocks) * BLOCK)
        items = torch.from_numpy(stream.items[sl].astype(np.int64)).to(dev)
        return (spec.schema.module_chunks(items),
                torch.from_numpy(stream.freqs[sl]).to(dev, dtype))

    return stream, schema, params, block


def spans(tree: str) -> dict:
    """K1 of one tree at the accuracy path's and the flat path's shapes, at
    every span of SPANS tiles (see the module's docstring)."""
    stream, schema, params, block = k1_inputs(tree)
    import numpy as np
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import hier_update as hu
    from repro_torch.kernels import sketch_update as su
    from repro_torch.kernels.hashes import make_plan

    dev = torch.device("cuda")
    _cuda.build(force=True)
    sms = _cuda.sm_count(0)
    cold_ms, _, device_ms = timers(torch, torch.zeros(1 << 26, dtype=torch.int32, device=dev))
    rng = np.random.default_rng(20)
    rule = su.flat_deal
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "sms": sms, "rows": []}
    shapes = [(name, spec, b) for name, spec in accuracy_specs(sk, schema).items()
              for b in ACC_BLOCKS]
    shapes += [("flat", sk.mod_sketch_spec(schema, [(0,), (1,)], (4096, 4096), 4), b)
               for b in (0, 7)]
    for name, spec, b in shapes:
        plan = make_plan(spec)
        q, r = params(rng, spec)
        chunks, f = block(spec, b)
        n = f.shape[0]
        w, h_pad = spec.width, su.padded_table_size(spec.table_size, 512)
        table = torch.zeros((w, h_pad), dtype=torch.int32, device=dev)
        want = su.sketch_update_ref(plan, table.clone(), chunks, f, q, r)
        base = {"shape": name, "block": b, "w": w, "h_pad": h_pad, "keys": n,
                "top_source_rows": int(np.unique(stream.items[b * BLOCK:(b + 1) * BLOCK, 0],
                                                 return_counts=True)[1].max()),
                "rule": rule(w, n, sms)}
        for span in SPANS:
            deal = (-(-n // (hu.THREADS * span)), span)
            su.flat_deal = lambda *a, _d=deal: _d
            got = su.sketch_update(plan, table.clone(), chunks, f, q, r)
            check = bool(torch.equal(got, want))
            scratch = table.clone()
            call = lambda: su.sketch_update(plan, scratch, chunks, f, q, r)  # noqa: E731
            out["rows"].append({
                **base, "ctas": deal[0], "span_tiles": span, "equal_plain": check,
                "ms": cold_ms(call, 100), "device_ms": device_ms(call, "update_kernel<int", 10)})
            su.flat_deal = rule
            print(json.dumps(out["rows"][-1]), flush=True)
            if not check:
                raise SystemExit(f"K1 differs from its plain version: {out['rows'][-1]}")
    return out


def cell_rows(out: dict, scu, cold_ms, device_ms, rounds: bool) -> None:
    """K5 at the ingest cell's block shape (see the module's docstring):
    ``K5_cell`` per block, and on a tree with claim rounds ``K5_sweep``."""
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    from perfbench import harness
    from perfbench.reference import hashing as ref_hash
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.kernels import sketch_update as su
    from repro_torch.kernels.hashes import all_indices, make_plan

    dev = torch.device("cuda")
    cfg = harness.load_json(harness.BENCH / "configs" / "twitter-edges-cu.json")
    tf = dict(harness.load_json(harness.BENCH / "traffic" / "edge_blocks_random.json"),
              pool_blocks=CELL_BLOCKS[-1] + 1)
    keys, freqs = harness.generator(tf["generator"]).generate(
        cfg, tf, harness.seed_for(CELL_SEED, 1), "cuda")
    g = torch.Generator(device=dev).manual_seed(int(cfg["hash_seed"]))
    n_digits = sum(ref_hash.digits_per_module(cfg["key_domains"]))
    q = torch.randint(0, ref_hash.P31, (cfg["width"], n_digits), generator=g, device=dev)
    r = torch.randint(0, ref_hash.P31, (cfg["width"], len(cfg["partition"])), generator=g,
                      device=dev)
    spec = sk.mod_sketch_spec(KeySchema(tuple(cfg["key_domains"])), cfg["partition"],
                              cfg["ranges"], cfg["width"])
    plan = make_plan(spec)
    w, h_pad = spec.width, su.padded_table_size(spec.table_size, 512)
    table = torch.zeros((w, h_pad), dtype=torch.int32, device=dev)
    grid = scu.rounds_grid(plan, w, torch.int32, dev) if rounds else None
    rows = []
    for b in CELL_BLOCKS:
        chunks = spec.schema.module_chunks(torch.from_numpy(keys[b].astype(np.int64)).to(dev))
        f = torch.from_numpy(freqs[b]).to(dev, torch.int32)
        idx = all_indices(plan, chunks, q, r)
        if rounds:
            scratch = scu.RoundScratch(dev)
            scu.sketch_update_conservative(plan, table.clone(), chunks, f, q, r, scratch)
            row = {"counts": scratch.counts(), "round_sizes": [
                int(x.size) for part in scu.claim_rounds(idx, f, *grid) for x in part.rounds]}
            call = lambda: scu.sketch_update_conservative(  # noqa: E731
                plan, table, chunks, f, q, r, scratch)
        else:
            row = {}
            call = lambda: scu.sketch_update_conservative(plan, table, chunks, f, q, r)  # noqa: E731
        row.update(block=b, ms=cold_ms(call, 20),
                   device_ms=device_ms(call, "sk_conservative_update", 5),
                   depths=scu.fold_depths(idx, f)._asdict())
        rows.append(row)
        print(json.dumps(row), file=sys.stderr, flush=True)
    out["K5_cell"] = {"rows": rows, "ms": sum(x["ms"] for x in rows) / len(rows),
                      "warm_ms": float("nan"), "grid": grid}
    if not rounds:
        return
    chunks = spec.schema.module_chunks(
        torch.from_numpy(keys[CELL_BLOCKS[0]].astype(np.int64)).to(dev))
    f = torch.from_numpy(freqs[CELL_BLOCKS[0]]).to(dev, torch.int32)
    sweep = []
    rule = scu.ROUNDS_MIN_ITEMS
    for n in SWEEP:
        entry = {"items": n}
        for route, least in (("rounds", 1), ("one_cta", 1 << 40)):
            scu.ROUNDS_MIN_ITEMS = least
            scratch = scu.RoundScratch(dev)
            entry[route + "_ms"] = cold_ms(lambda: scu.sketch_update_conservative(
                plan, table, chunks[:n], f[:n], q, r, scratch), 20)
        sweep.append(entry)
    scu.ROUNDS_MIN_ITEMS = rule
    out["K5_sweep"] = sweep


def one(tree: str, k5_only: bool = False) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import hierarchy as hh
    from repro_torch.core import sketch as sk
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import hier_update as hu
    from repro_torch.kernels import sketch_update as su
    from repro_torch.kernels.hashes import all_indices, all_sign_bits, make_plan
    from repro_torch.kernels.ops import KernelSketch
    from repro_torch.training import grad_compression as gc
    from repro_torch.training import train_loop as tl

    dev = torch.device("cuda")
    _cuda.build(force=True)
    l2 = torch.zeros(1 << 26, dtype=torch.int32, device=dev)
    cold_ms, warm_ms, device_ms = timers(torch, l2)
    stream, schema, params, k1_block = k1_inputs(tree)

    def block(hspec, hplan, items, vals, q, r, signs=None):
        """chunks, and the flat cells and values that index_add_ adds."""
        ordered = hspec.level_items(hspec.n_levels - 1, torch.from_numpy(
            np.ascontiguousarray(items).astype(np.int64)).to(dev))
        chunks = hspec.levels[-1].schema.module_chunks(ordered)
        w, cols = hspec.base.width, hplan.padded_cols
        idx = all_indices(hplan.plan, chunks, q, r)
        bits = all_sign_bits(hplan.plan, chunks, *signs) if signs else None
        base = torch.arange(w, device=dev)[:, None] * cols
        flat = torch.cat([(base + idx // d + o).reshape(-1)
                          for o, d in zip(hplan.level_offsets, hplan.level_divs)])
        vals_all = torch.cat([
            (vals if bits is None else (1 - 2 * ((bits >> l) & 1)).to(vals.dtype) * vals)
            .expand(w, vals.shape[0]).reshape(-1) for l in range(hplan.n_levels)])
        return chunks, flat, vals_all

    rng = np.random.default_rng(0)
    spec = sk.mod_sketch_spec(schema, [(0,), (1,)], (4096, 4096), 4)
    hspec = hh.HierarchySpec.from_spec(spec)
    hplan = hu.make_hier_plan(hspec)
    q, r = params(rng, spec)
    s_q, s_r = params(rng, spec)
    tops = [int(np.unique(stream.items[s : s + BLOCK, 0], return_counts=True)[1].max())
            for s in range(0, stream.items.shape[0], BLOCK)]
    hb = int(np.argmax(tops))
    out = {"tree": tree, "device": torch.cuda.get_device_name(0), "heaviest_block": hb,
           "heaviest_top_source_rows": tops[hb], "block0_top_source_rows": tops[0]}

    def row(name, fold, table, chunks, vals, flat, vals_all, reps=100):
        scratch = table.clone()
        out[name] = {"ms": cold_ms(lambda: fold(scratch, chunks, vals), reps),
                     "index_add_ms": cold_ms(
                         lambda: scratch.view(-1).index_add_(0, flat, vals_all), reps),
                     "warm_ms": warm_ms(lambda: fold(scratch, chunks, vals), 2 * reps)}
        out[name]["ratio"] = out[name]["ms"] / out[name]["index_add_ms"]

    def k3(table, chunks, vals):
        hu.hier_update(hplan, table, chunks, vals, q, r)

    # K5 on both routes and K5i, into zero int32 tables
    from repro_torch.kernels import sketch_update_conservative as scu

    rounds = hasattr(scu, "RoundScratch")

    def cons_row(name, call, idxs, vals, reps=20):
        kernel = "sk_conservative_" + ("fold" if name == "K5i" else "update")
        out[name] = {"ms": cold_ms(call, reps), "warm_ms": warm_ms(call, reps),
                     "device_ms": device_ms(call, kernel, reps // 4)}
        if hasattr(scu, "fold_depths"):
            out[name]["depths"] = [scu.fold_depths(i, vals)._asdict() for i in idxs]

    def k5_call(cplan, table, chunks, vals, cq, cr):
        """One K5 call, with a scratch of its own where the tree has claim
        rounds; (call, the counts of one call or None)."""
        if not rounds:
            return (lambda: scu.sketch_update_conservative(cplan, table, chunks, vals, cq, cr),
                    None)
        scratch = scu.RoundScratch(table.device)
        scu.sketch_update_conservative(cplan, table.clone(), chunks, vals, cq, cr, scratch)
        counts = scratch.counts()
        return (lambda: scu.sketch_update_conservative(cplan, table, chunks, vals, cq, cr,
                                                       scratch), counts)

    def main_block(b):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        return (torch.from_numpy(stream.items[sl].astype(np.int64)).to(dev),
                torch.from_numpy(stream.freqs[sl]).to(dev, torch.int32))

    items0, vals0 = main_block(0)
    acc = sk.mod_sketch_spec(spec.schema, [(0,), (1,)], (62, 66), 5)
    for name, cspec, b in (("K5_global", spec, 0), ("K5_shared", acc, 0),
                           ("K5_shared_heaviest", acc, hb), ("K5_global_heaviest", spec, hb)):
        cplan = make_plan(cspec)
        cq, cr = params(rng, cspec)
        it, vals = main_block(b)
        chunks = cspec.schema.module_chunks(it)
        table = torch.zeros((cspec.width, su.padded_table_size(cspec.table_size, 128)),
                            dtype=torch.int32, device=dev)
        call, counts = k5_call(cplan, table, chunks, vals, cq, cr)
        cons_row(name, call, [all_indices(cplan, chunks, cq, cr)], vals)
        out[name]["route"] = scu.residency(cspec.width, table.shape[1], 4)
        out[name]["rounds"] = counts
    cell_rows(out, scu, cold_ms, device_ms, rounds)
    idxs = hh.hierarchy_indices(hspec, sk.SketchParams(q=q, r=r), items0)
    tables = [torch.zeros((4, lv.table_size), dtype=torch.int32, device=dev)
              for lv in hspec.levels]
    cons_row("K5i", lambda: scu.conservative_fold_tables(tables, idxs, vals0), idxs, vals0)
    del tables, idxs
    if k5_only:
        return out

    for name, b, dtype in (("K3", 0, torch.int32), ("K3_heaviest", hb, torch.int32),
                           ("K3f", 0, torch.float32)):
        sl = slice(b * BLOCK, (b + 1) * BLOCK)
        vals = torch.from_numpy(stream.freqs[sl]).to(dev, dtype)
        chunks, flat, vals_all = block(hspec, hplan, stream.items[sl], vals, q, r)
        table = torch.zeros((4, hplan.padded_cols), dtype=dtype, device=dev)
        row(name, k3, table, chunks, vals, flat, vals_all)

    # the turnstile stream's first block, as chip_smoke.turnstile_stream makes it
    trng = np.random.default_rng((0, 12))
    n = stream.items.shape[0]
    gone = np.zeros(n, bool)
    gone[trng.permutation(n)[: n // 2]] = True
    items = np.concatenate([stream.items, stream.items[gone]])
    freqs = np.concatenate([stream.freqs, -stream.freqs[gone]])
    order = trng.permutation(items.shape[0])[:BLOCK]
    vals = torch.from_numpy(freqs[order]).to(dev, torch.int32)
    chunks, flat, vals_all = block(hspec, hplan, items[order], vals, q, r, (s_q, s_r))
    table = torch.zeros((4, hplan.padded_cols), dtype=torch.int32, device=dev)
    row("K8", lambda t, c, v: hu.hier_update_signed(hplan, t, c, v, q, r, s_q, s_r),
        table, chunks, vals, flat, vals_all)
    del chunks, flat, vals_all

    # K6 / K6f: the same block into a zero signed flat sketch of the spec
    plan = make_plan(spec)
    h_pad = su.padded_table_size(spec.table_size, 512)
    chunks = spec.schema.module_chunks(torch.from_numpy(items[order].astype(np.int64)).to(dev))
    idx = all_indices(plan, chunks, q, r)
    sign = 1 - 2 * ((all_sign_bits(plan, chunks, s_q, s_r) >> (len(plan.ranges) - 1)) & 1)
    flat = (torch.arange(4, device=dev)[:, None] * h_pad + idx).reshape(-1)
    for name, dtype in (("K6", torch.int32), ("K6f", torch.float32)):
        v = vals.to(dtype)
        row(name, lambda t, c, vv: su.sketch_update_signed(plan, t, c, vv, q, r, s_q, s_r),
            torch.zeros((4, h_pad), dtype=dtype, device=dev), chunks, v, flat,
            (sign.to(dtype) * v).reshape(-1))
    del chunks, idx, sign, flat


    # K1 and K1f at chip_smoke.py's shapes (see the module's docstring)
    k1_rng = np.random.default_rng(20)

    def k1_row(name, kspec, chunks, vals, kq, kr, h_pad):
        kplan = make_plan(kspec)
        idx = all_indices(kplan, chunks, kq, kr)
        flat = (torch.arange(kspec.width, device=dev)[:, None] * h_pad + idx).reshape(-1)
        table = torch.zeros((kspec.width, h_pad), dtype=vals.dtype, device=dev)

        def fold(t, c, v):
            su.sketch_update(kplan, t, c, v, kq, kr)

        row(name, fold, table, chunks, vals, flat, vals.expand(kspec.width, -1).reshape(-1))
        kernel = "update_kernel<" + ("int" if vals.dtype == torch.int32 else "float")
        out[name]["device_ms"] = device_ms(lambda: fold(table, chunks, vals), kernel, 20)
        if hasattr(su, "flat_deal"):
            out[name]["ctas"], out[name]["span_tiles"] = su.flat_deal(
                kspec.width, chunks.shape[0], _cuda.sm_count(0))

    for kind, aspec in accuracy_specs(sk, schema).items():
        kq, kr = params(k1_rng, aspec)
        for b in ACC_BLOCKS:
            k1_row(f"K1_{kind}_b{b}", aspec, *k1_block(aspec, b), kq, kr,
                   su.padded_table_size(aspec.table_size, 512))
    kq, kr = params(k1_rng, spec)
    for b in (0, hb):
        for name, dtype in (("K1", torch.int32), ("K1f", torch.float32)):
            k1_row(f"{name}_flat_b{b}", spec, *k1_block(spec, b, dtype), kq, kr,
                   su.padded_table_size(spec.table_size, 512))
    cfg = get_config("starcoder2-7b")
    bspec = tl.make_sketch_spec(cfg)
    tokens = torch.from_numpy(tl.synthetic_batches(cfg, 8, 1024)(0)["tokens"]).to(dev)
    grams = tl.ngram.ngram_items(tokens, cfg.sketch_ngrams)
    kq, kr = params(k1_rng, bspec)
    k1_row("K1_bigram", bspec, bspec.schema.module_chunks(grams),
           torch.ones(grams.shape[0], dtype=torch.int32, device=dev), kq, kr,
           bspec.table_size)

    # the accuracy path's linear ingest of the whole stream (host seconds)
    for kind, aspec in accuracy_specs(sk, schema).items():
        secs = []
        for _ in range(5):
            sketch = KernelSketch(aspec, params(k1_rng, aspec), block_b=BLOCK)
            torch.cuda.synchronize()
            t = time.perf_counter()
            sketch.update(stream.items, stream.freqs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t)
        out[f"linear_ingest_{kind}"] = {"s": secs}
        del sketch

    plan = gc._leaf_plan(gc.CompressionConfig(enabled=True), EMBED)
    lspec = plan.hspec.levels[-1]
    lplan = hu.make_hier_plan(plan.hspec, tile_h=1)
    lq, lr = params(rng, lspec)
    lsq, lsr = params(rng, lspec)
    rows_, cols_ = EMBED
    coords = torch.stack([torch.arange(rows_, device=dev).repeat_interleave(cols_),
                          torch.arange(cols_, device=dev).repeat(rows_)], dim=-1)
    lchunks = lspec.schema.module_chunks(plan.hspec.level_items(plan.hspec.n_levels - 1,
                                                                coords))
    del coords
    gen = torch.Generator(device=dev).manual_seed(14)
    v = torch.randint(-8, 9, (lchunks.shape[0],), generator=gen, device=dev).to(torch.float32)
    w = lspec.width
    idx = all_indices(lplan.plan, lchunks, lq, lr)
    bits = all_sign_bits(lplan.plan, lchunks, lsq, lsr)
    base = torch.arange(w, device=dev)[:, None] * lplan.padded_cols
    flat = torch.cat([(base + idx // d + o).reshape(-1)
                      for o, d in zip(lplan.level_offsets, lplan.level_divs)])
    del idx
    signed = torch.cat([((1 - 2 * ((bits >> l) & 1)).to(torch.float32) * v).reshape(-1)
                        for l in range(lplan.n_levels)])
    del bits
    table = torch.zeros((w, lplan.padded_cols), device=dev)
    row("K8f_embed",
        lambda t, c, vv: hu.hier_update_signed(lplan, t, c, vv, lq, lr, lsq, lsr),
        table, lchunks, v, flat, signed, reps=10)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--spans", metavar="TREE")
    ap.add_argument("--k5", action="store_true", help="time K5 and K5i alone")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one, args.k5)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("fold_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    if args.spans:
        result = {"card": card, **spans(args.spans)}
        if args.out:
            Path(args.out).write_text(json.dumps(result, indent=1))
        print(card)
        return 0
    old, new = args.trees
    runs = []
    for tree in (old, new, new, old):
        done = subprocess.run([sys.executable, __file__, "--one", tree,
                               *(["--k5"] if args.k5 else [])],
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
    for name in ("K3", "K3_heaviest", "K3f", "K8", "K6", "K6f", "K8f_embed", "K5_global",
                 "K5_global_heaviest", "K5_shared", "K5_shared_heaviest", "K5i", "K5_cell",
                 *(name for name in runs[0] if name.startswith("K1"))):
        if name not in runs[0]:
            continue
        print(name, " ".join(f"{run[name]['ms']:.5f}/{run[name].get('index_add_ms')}"
                             f"/{run[name]['warm_ms']:.5f}/{run[name].get('device_ms')}"
                             for run in runs))
    for name in (name for name in runs[0] if name.startswith("linear_ingest")):
        print(name, " ".join(f"{min(run[name]['s']):.6f}/{sorted(run[name]['s'])[2]:.6f}"
                             for run in runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
