"""The readings that a cell's limits are set from; not part of a run.

    python3 perfbench/calibrate.py --workload <cell> --what traffic --seeds 1,2,3
    python3 perfbench/calibrate.py --workload <cell> --what program --seeds 1,2,3 --seconds 20
    python3 perfbench/calibrate.py --workload <cell> --what control --seeds 1,2,3 --blocks 25000

``traffic``: what the generator made on each seed (one pass: its distinct
edges, its arrivals and those the pool holds, the blocks a pass holds, the
largest edge frequency) and how long it took.  ``program``: the cell's
system on each seed with a window of ``--seconds``, every number compared
and the reference's largest cell.  ``control``: on each seed, the plain
reference put in the program's place with the guarantee broken (the
block-parallel fold, each block against the table as it stood before the
block) over ``--blocks`` blocks, against the serial fold.  One JSON line a
reading, on standard output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def _run_for(man, args, seed: int) -> harness.Run:
    wl = harness.workload(man, args.workload)
    return harness.Run(workload=args.workload, config=harness.config_of(man, wl),
                       traffic=harness.traffic(wl["traffic"]), cell=harness.cell(args.workload),
                       seed=seed, seconds=args.seconds, trace=False,
                       t_process=time.perf_counter())


def _traffic(r: harness.Run) -> dict:
    import torch

    gen = harness.generator(r.traffic["generator"])
    g = torch.Generator(device=r.device).manual_seed(int(r.traffic["stream_seed"]))
    edges, arrivals = gen.one_pass(r.config, g)
    g.manual_seed(harness.seed_for(r.seed, 1))
    arrivals = arrivals[torch.randperm(arrivals.numel(), generator=g, device=g.device)]
    rows = int(r.traffic["block_rows"])
    try:
        gen.interval_ends(arrivals, rows, 1 << 40)
    except RuntimeError as e:   # names how many blocks the pass holds
        held = str(e)
    freq = torch.bincount(arrivals)
    p = gen.pool(r.config, r.traffic, harness.seed_for(r.seed, 1), r.device)
    return {"distinct_edges": edges.numel(), "arrivals": arrivals.numel(),
            "pass": held, "pool_arrivals": p["arrivals"],
            "largest_edge_frequency": int(freq.max()),
            "largest_count_in_a_block": int(p["counts"].max())}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--what", choices=("traffic", "program", "control"), required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.01)
    ap.add_argument("--blocks", type=int, default=25000)
    args = ap.parse_args(argv)
    import torch

    man = harness.manifest()
    for seed in [int(s) for s in args.seeds.split(",")]:
        r = _run_for(man, args, seed)
        system = harness.system(r.config["system"])
        t = time.perf_counter()
        if args.what == "traffic":
            line = {"seed": seed, **_traffic(r)}
        elif args.what == "program":
            out = system.run(r)
            line = {"seed": seed, "checks": out.checks.values, "correct": out.checks.ok,
                    **out.details, "end_to_end": out.end_to_end, "host": out.host}
        else:
            made = system.inputs(r)
            _, serial, want = system.reference(r, made, args.blocks)
            _, parallel, got = system.reference(r, made, args.blocks, block_parallel=True)
            line = {"seed": seed, "blocks": args.blocks,
                    "table_cells_differing": int((serial != parallel).sum()),
                    "answers_differing": int((want != got).sum()),
                    "max_cell": int(serial.max())}
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
