"""Run the benchmark's ingest cell once, traced, and break its idle time
down by the program's spans, gap by gap.

    python3 tools/ingest_spans.py --seed N [--workload twitter-cu.ingest] [--out FILE]

It runs the cell as ``perfbench/run.py --trace 1`` does (the cell's
``trace_seconds``, all of it under the profiler) and prints one JSON object:
the run's result line (``line``); the window's blocks beside the number
of ``repro_torch.ingest.update`` spans in it; the idle time by part
(``perfbench/program_spans.py``) and its sum beside the window's idle time;
the device ops launched inside the update spans by name, per span; and the
card's idle gaps, each split by part: how many, and their milliseconds, by
the part that holds most of a gap and by the gap's length, and the ten
longest gaps with their split.  Needs a CUDA card.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, program_spans as ps, run as bench, trace as tr  # noqa: E402

LENGTHS_US = (50, 200, 1000)     # the gaps' length classes: below each, and above the last


def _length_class(us: float) -> str:
    for edge in LENGTHS_US:
        if us < edge:
            return f"<{edge}us"
    return f">={LENGTHS_US[-1]}us"


def gaps_by_part(trace: tr.Trace, t0: float, t1: float, tid) -> dict:
    busy = tr.union(trace.device, t0, t1)
    edges = [(t0, t0)] + busy + [(t1, t1)]
    gaps = [(edges[i][1], edges[i + 1][0]) for i in range(len(edges) - 1)
            if edges[i + 1][0] > edges[i][1]]
    spans = sorted((op for op in trace.host if op.tid == tid and op.name.startswith(ps.PREFIX)),
                   key=lambda op: op.ts)
    starts = [op.ts for op in spans]
    longest_span = max((op.dur for op in spans), default=0.0)
    by_part: dict = {}
    by_length: dict = {}
    split = []
    for s, e in gaps:
        parts: dict = {}
        # only the spans that can overlap [s, e]: none lasts longer than longest_span
        near = spans[bisect.bisect_left(starts, s - longest_span):bisect.bisect_left(starts, e)]
        near_trace = tr.Trace(device=[], launches=[], host=near)
        for name, us in (ps.idle_split(near_trace, s, e, tid) or {ps.CALLER: e - s}).items():
            part = ps.part_of(name) or name
            parts[part] = parts.get(part, 0.0) + us
        major = max(parts, key=parts.get)
        for table, key in ((by_part, major), (by_length, _length_class(e - s))):
            row = table.setdefault(key, {"gaps": 0, "ms": 0.0})
            row["gaps"] += 1
            row["ms"] += (e - s) / 1e3
        split.append((e - s, s - t0, parts))
    split.sort(key=lambda g: -g[0])
    longest = [{"ms": us / 1e3, "at_ms": at / 1e3,
                "parts_ms": {k: v / 1e3 for k, v in parts.items()}}
               for us, at, parts in split[:10]]
    return {"gaps": len(gaps), "by_major_part": by_part, "by_length": by_length,
            "longest": longest}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--workload", default="twitter-cu.ingest")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    bench.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ingest_spans: no CUDA card")
    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    config = harness.config_of(man, wl)
    run = harness.Run(workload=wl["name"], config=config, traffic=harness.traffic(wl["traffic"]),
                      cell=harness.cell(wl["name"]), seed=args.seed,
                      seconds=float(man["run_seconds"]), trace=True, t_process=T_PROCESS)
    text = json.dumps(report(man, wl, harness.system(config["system"]).run(run)))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


def report(man: dict, wl: dict, out: harness.Outcome) -> dict:
    rd = out.readings
    t0, t1 = rd.window_us
    tid = ps.caller_tid(rd.trace, t0)
    blocks = rd.counters["blocks"]
    spans = [op for op in rd.trace.spans(ps.UPDATE) if t0 <= op.ts < t1]
    split = ps.idle_split(rd.trace, t0, t1, tid) or {}
    parts = {part: sum(us for n, us in split.items() if ps.part_of(n) == part) / 1e3 / blocks
             for part in ps.PARTS}
    ops: dict = {}
    for op in ps.ops_in_spans(rd.trace, ps.UPDATE, t0, t1):
        ops[op.name] = ops.get(op.name, 0) + 1
    return {
        "line": bench.result_line(man, wl, out, True),
        "blocks": blocks, "update_spans": len(spans),
        "window_ms": (t1 - t0) / 1e3,
        "idle_ms": ((t1 - t0) - tr.busy_us(rd.trace, t0, t1)) / 1e3,
        "parts_ms_per_block": parts,
        "parts_ms_sum_x_blocks": sum(parts.values()) * blocks,
        "ops_per_update_by_name": {k: v / max(len(spans), 1) for k, v in
                                   sorted(ops.items(), key=lambda kv: -kv[1])},
        "idle_gaps": gaps_by_part(rd.trace, t0, t1, tid),
    }


if __name__ == "__main__":
    main()
