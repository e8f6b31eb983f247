"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration names the
system (``perfbench/systems/<system>.py``) that loads the port,
warms it up, measures for ``--seconds`` and compares what the window
produced with the plain reference.  With ``--trace 0`` the line carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read by ``perfbench/metrics/<metric>.py`` from a traced window of the
cell's ``trace_seconds``.

Exit codes: 0 with a result line; 2 when a file of the benchmark or the
program is missing; 3 without the cards the cell asks for; 4 when a module
of ``jax`` or the JAX package was loaded.  Only code 0 prints a result.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness  # noqa: E402


def cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout."""
    cache = ROOT / "perfbench" / ".cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(code: int, msg: str) -> None:
    print(f"perfbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def result_line(man: dict, wl: dict, out: harness.Outcome, trace: bool) -> dict:
    import torch

    metrics = {}
    if trace:
        for m in harness.per_layer_metrics(man, wl["name"]):
            value = harness.metric_reader(m["name"]).read(out.readings)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        for m in harness.end_to_end_metrics(man, wl["name"]):
            metrics[m["name"]] = {"value": float(out.end_to_end[m["name"]]), "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": int(wl["chips"]), "memory_peak_bytes": int(out.peak_bytes)}
    line = {"correct": bool(out.checks.ok), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace:
        from perfbench import trace as tr

        rd = out.readings
        t0, t1 = rd.window_us
        device["busy_s"] = tr.busy_us(rd.trace, t0, t1) / 1e6
        device["window_s"] = (t1 - t0) / 1e6
        line["breakdown"] = {"device_ops": tr.top_device_ops(rd.trace, t0, t1),
                             "idle_gaps": tr.idle_gaps(rd.trace, t0, t1)}
    if out.host:
        line["host"] = out.host
    line["checks"] = out.checks.as_dict()
    return line


def main(argv=None) -> None:
    args = parse(argv)
    try:
        man = harness.manifest()
        wl = harness.workload(man, args.workload)
        config = harness.config_of(man, wl)
        traffic = harness.traffic(wl["traffic"])
        cell = harness.cell(wl["name"])
        system = harness.system(config["system"])
    except harness.BenchError as e:
        fail(2, str(e))
    if not (ROOT / "src" / "repro_torch").is_dir():
        fail(2, "the program (src/repro_torch) is not in this checkout")
    cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(wl["chips"]):
        fail(3, f"the cell needs {wl['chips']} CUDA card(s); "
                f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    run = harness.Run(workload=wl["name"], config=config, traffic=traffic, cell=cell,
                      seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      t_process=T_PROCESS)
    out = system.run(run)
    loaded = harness.forbidden_loaded()
    if loaded:
        fail(4, f"modules of {', '.join(loaded)} were loaded in this process")
    line = result_line(man, wl, out, run.trace)
    for text in out.checks.lines():
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
