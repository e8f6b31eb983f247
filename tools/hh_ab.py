"""Time the conservative heavy-hitters ingest of two source trees on one
card, in turns, and profile its host time.

    python3 tools/hh_ab.py --trees OLD NEW [--pairs 2] [--out FILE]

Each tree is a checkout of this repository (its ``src/repro_torch``).  The
trees run in the order OLD, NEW, NEW, OLD, ``--pairs`` times over, each in
a process of its own (both packages are named ``repro_torch``), which
builds that tree's kernels (cached under the tree's ``build/``) and drives
``chip_smoke.py``'s conservative path: the main stream (seed 0) through a
``mode="conservative"`` endpoint behind a ``SketchServeEngine``, 65,536
rows a block, on a new endpoint each time.  A process reports:

- ``rows_per_s``: three ingests, the first of which also takes the
  kernels' first launches (as ``chip_smoke.py``'s single ingest does);
- ``fold_host_ms`` / ``fold_ms``: the host time inside the K5i wrapper
  (``conservative_fold_tables``) over the third ingest, and the device
  time of its launches (CUDA events around each call);
- ``profile``: a fourth ingest under cProfile, its ten functions of the
  most own time (paths from ``repro_torch/`` on, so the trees compare).

Prints one JSON object per run and, last, the card's name and power limit
with every run's rates.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import cProfile
import json
import pstats
import subprocess
import sys
import time
from pathlib import Path

STREAM = dict(n_src=200_000, n_tgt=600_000, n_edges=2_000_000,
              n_occurrences=20_000_000, s_src=1.1, s_tgt=1.1)   # chip_smoke.STREAM
BLOCK = 1 << 16
RANGES, WIDTH, POOL = (4096, 4096), 4, 4096


def one(tree: str) -> dict:
    sys.path.insert(0, str(Path(tree).resolve() / "src"))
    import numpy as np
    import torch

    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema, draw_hash_params_np
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import sketch_update_conservative as scu
    from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
    from repro_torch.streams import zipf_graph_stream

    _cuda.build()
    stream = zipf_graph_stream(**STREAM, seed=0)
    rng = np.random.default_rng(0)
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], RANGES, WIDTH)
    params = (draw_hash_params_np(rng, (WIDTH, spec.schema.total_chunks)),
              draw_hash_params_np(rng, (WIDTH, spec.n_groups)))
    items, freqs = stream.items, stream.freqs

    def ingest():
        ep = SketchTopKEndpoint(spec, params, max_candidates_per_group=POOL,
                                use_kernel=True, mode="conservative")
        eng = SketchServeEngine(ep, max_staleness=0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for s in range(0, items.shape[0], BLOCK):
            eng.ingest(items[s : s + BLOCK], freqs[s : s + BLOCK])
        eng.drain()
        torch.cuda.synchronize()
        return items.shape[0] / (time.perf_counter() - t)

    rates = [ingest(), ingest()]
    fold, host, events = scu.conservative_fold_tables, [], []

    def timed_fold(*args, **kwargs):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        a.record()
        out = fold(*args, **kwargs)
        b.record()
        host.append(time.perf_counter() - t)
        events.append((a, b))
        return out

    scu.conservative_fold_tables = timed_fold
    rates.append(ingest())
    scu.conservative_fold_tables = fold
    torch.cuda.synchronize()
    prof = cProfile.Profile()
    prof.enable()
    ingest()
    prof.disable()
    stats = pstats.Stats(prof).stats
    top = sorted(stats.items(), key=lambda kv: -kv[1][2])[:10]

    def where(fn):
        path, line, name = fn
        cut = path.find("repro_torch/")
        return f"{path[cut:] if cut >= 0 else Path(path).name}:{line}:{name}"

    return {"tree": tree, "device": torch.cuda.get_device_name(0), "rows_per_s": rates,
            "fold_calls": len(host), "fold_host_ms": sum(host) * 1e3,
            "fold_ms": sum(a.elapsed_time(b) for a, b in events),
            "profile": [{"fn": where(fn), "calls": st[1], "tottime_s": st[2],
                         "cumtime_s": st[3]} for fn, st in top]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs=2, metavar=("OLD", "NEW"))
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(one(args.one)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("hh_ab: no CUDA device is available", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    old, new = args.trees
    order = [old, new, new, old] * args.pairs
    runs = []
    for tree in order:
        done = subprocess.run([sys.executable, __file__, "--one", tree],
                              capture_output=True, text=True)
        if done.returncode != 0:
            print(done.stdout + done.stderr, file=sys.stderr)
            return done.returncode
        runs.append(json.loads(done.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    result = {"card": card, "order": order, "runs": runs}
    if args.out:
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(card)
    for run in runs:
        print(run["tree"], " ".join(f"{r:.1f}" for r in run["rows_per_s"]),
              f"fold host {run['fold_host_ms']:.2f} ms device {run['fold_ms']:.2f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
