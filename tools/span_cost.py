"""What the program's spans (``repro_torch.tracing.span``) cost the host,
with no profiler recording and under a CPU and CUDA profiler, beside the
two reads of the profiler's flag that could gate them and an ungated
``record_function``.

    python3 tools/span_cost.py [--reps 200000] [--out FILE]

Each figure is the median over five rounds of ``--reps`` enters and exits
(a tenth as many for the ungated ``record_function``, a fiftieth under
the profiler, which keeps every event), in microseconds.  Prints one JSON
object with the card's name and torch's version; needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch import tracing  # noqa: E402

ROUNDS = 5


def per_call_us(fn, reps: int) -> float:
    rounds = []
    for _ in range(ROUNDS):
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        rounds.append((time.perf_counter() - t) / reps * 1e6)
    return statistics.median(rounds)


def span():
    with tracing.span("repro_torch.span_cost"):
        pass


def record_function():
    with torch.profiler.record_function("repro_torch.span_cost"):
        pass


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--reps", type=int, default=200_000)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("span_cost: no CUDA card")
    torch.ones(1, device="cuda").sum().item()
    reps = args.reps
    out = {
        "device": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "flag_python_us": per_call_us(lambda: torch.autograd.profiler._is_profiler_enabled,
                                      reps),
        "flag_c_us": per_call_us(torch._C._autograd._profiler_enabled, reps),
        "empty_call_us": per_call_us(lambda: None, reps),
        "span_off_us": per_call_us(span, reps),
        "record_function_off_us": per_call_us(record_function, reps // 10),
    }
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        out["span_on_us"] = per_call_us(span, reps // 50)
        out["record_function_on_us"] = per_call_us(record_function, reps // 50)
    text = json.dumps(out)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
