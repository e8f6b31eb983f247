"""The readings that the serving cell's limits and bound are set from; not
part of a run.

    python3 perfbench/calibrate_serve.py --workload mixtral-8x22b.decode --seeds 1,2,3 --seconds 1
    python3 perfbench/calibrate_serve.py --workload mixtral-8x22b.decode --seeds 1,2,3 --faults state_unchanged,cache_short
    python3 perfbench/calibrate_serve.py --workload mixtral-8x22b.decode --seeds 1 --trace
    python3 perfbench/calibrate_serve.py --spread runs.jsonl

The first form runs, on each seed in one process, the cell's system with a
window of ``--seconds`` (one cohort at least): every number compared, the
widest readings beside them, the reference's seconds.  Then, over the same
requests (the last cohort's sampled prompts and served tokens), the plain reference put
in the program's place as each control: ``e4m3`` (float8 operands in every
product of a linear layer), ``top1`` (one expert a token in place of two)
and ``short`` (a decode position that does not see itself: the cache read
one position short); a control's served token is its own best.  With
``--faults``, the program itself, run again on the seed with each fault of
``faults_serve.py`` planted in it (one cohort), and its numbers compared as a
run compares them.  One JSON line a reading, on standard output.  With ``--trace`` a traced run instead:
its per-layer metrics and ``keep_ms``, the device milliseconds of the
benchmark's own copy of the sampled logits (span ``perfbench.keep``) a
call, beside ``decode_ms.serve``.

The second form reads result lines of ``run.py`` (one JSON object a line,
as the last line of each run prints it) and gives, for each end-to-end
metric, the median and the spread: the interquartile range of
``statistics.quantiles(values, n=4)`` over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402
from perfbench.reference import mixtral as ref  # noqa: E402

CONTROLS = {"e4m3": ref.Variant(matmul="e4m3"), "top1": ref.Variant(top_k=1)}


def spread(lines):
    """{metric: {median, spread, n}} over result lines."""
    values = {}
    for line in lines:
        for k, v in line["metrics"].items():
            values.setdefault(k, []).append(v["value"])
    out = {}
    for k, v in values.items():
        q1, med, q3 = statistics.quantiles(v, n=4) if len(v) > 1 else (v[0], v[0], v[0])
        out[k] = {"median": statistics.median(v), "spread": (q3 - q1) / statistics.median(v),
                  "n": len(v)}
    return out


def _run(workload: str, seed: int, seconds: float, traced: bool = False):
    from perfbench.systems import model_serve as ms

    man = harness.manifest()
    wl = harness.workload(man, workload)
    r = harness.Run(workload=workload, config=harness.config_of(man, wl),
                    traffic=harness.traffic(wl["traffic"]), cell=harness.cell(workload),
                    seed=seed, seconds=seconds, trace=traced, t_process=time.perf_counter())
    return r, ms.run(r)


def calibrate(workload: str, seed: int, seconds: float, traced: bool = False,
              faults=()) -> None:
    import torch

    from perfbench import faults_serve, serve_spans
    from perfbench.systems import model_serve as ms

    r, out = _run(workload, seed, seconds, traced)
    served = out.details.pop("served")
    if traced:
        metrics = {m["name"]: harness.metric_reader(m["name"]).read(out.readings)
                   for m in harness.per_layer_metrics(man, workload)}
        print(json.dumps({"seed": seed, "what": "traced", "checks": out.checks.values,
                          "keep_ms": serve_spans.device_ms_per_span(out.readings, "keep_span"),
                          **metrics}), flush=True)
        return
    print(json.dumps({"seed": seed, "what": "program", "checks": out.checks.values,
                      "correct": out.checks.ok, **out.details, "end_to_end": out.end_to_end}),
          flush=True)
    m, tf = r.config["model"], r.traffic
    prompts, sampled = harness.generator(tf["generator"]).generate(
        r.config, tf, harness.seed_for(seed, 1))
    weights = ms.make_weights(m, seed, r.device, float(r.config["query_key_gain"]))
    checked = ms.checked_requests(prompts, sampled, served[-1:])
    prompt = int(tf["prompt_tokens"])
    short = ref.Variant(short_from=prompt)
    for name, variant in {**CONTROLS, "short": short}.items():
        t = time.perf_counter()
        got = ms.compare(m, weights, checked, [], prompt, r.device, variant)
        print(json.dumps({"seed": seed, "what": name, **got,
                          "seconds": time.perf_counter() - t}), flush=True)
    del weights
    torch.cuda.empty_cache()
    for fault in faults:
        with faults_serve.planted(fault):
            _, bad = _run(workload, seed, 0.0)
        print(json.dumps({"seed": seed, "what": f"fault:{fault}", "checks": bad.checks.values,
                          "correct": bad.checks.ok}), flush=True)
        torch.cuda.empty_cache()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="mixtral-8x22b.decode")
    ap.add_argument("--seeds")
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--faults", default="", help="faults_serve.py's faults to plant, by name")
    ap.add_argument("--spread", help="a file of run.py result lines")
    args = ap.parse_args(argv)
    if args.spread:
        lines = [json.loads(x) for x in Path(args.spread).read_text().splitlines() if x.strip()]
        print(json.dumps(spread(lines), indent=1))
        return
    for seed in [int(s) for s in args.seeds.split(",")]:
        calibrate(args.workload, seed, args.seconds, args.trace,
                  [f for f in args.faults.split(",") if f])


if __name__ == "__main__":
    main()
