"""Run the benchmark's ingest cell and read the sketch's staging counters,
with the keys crossing to the card either way the staging can send them.

    python3 tools/ingest_staging.py --seeds N[,N...] [--keys uint32,int64]
        [--seconds S] [--trace 0|1] [--workload twitter-cu.ingest] [--out FILE]

For each way of sending the keys and each seed, in turns, it runs the cell
as ``perfbench/run.py`` does (``--seconds`` long, the manifest's
``run_seconds`` by default; ``--trace 1`` traces the cell's
``trace_seconds``) and prints one JSON object: the card's name and power
limit, and per run the result line, ``staged_blocks``, ``staging_waits``
and the page-locked bytes of the sketch's staging ring.  ``uint32`` is the
program's way: the caller's 32-bit words cross to the card and widen to
int64 there.  ``int64`` widens them on the host and sends twice the bytes
(a patch of this script's, for the comparison).
Needs a CUDA card.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, run as bench  # noqa: E402

KEYS = ("uint32", "int64")


def _send_keys_as_int64(send):
    """``Slot.send`` with the keys widened to int64 on the host before they
    are staged (the program's ``.to(torch.int64)`` after it is then a
    no-op)."""
    import numpy as np

    def patched(self, key, array):
        return send(self, key, array.astype(np.int64) if key == "keys" else array)

    return patched


def one_run(man: dict, wl: dict, seed: int, seconds: float, trace: bool, keys: str) -> dict:
    from repro_torch import staging

    rings = []
    make, send = staging.StagingRing.__init__, staging.Slot.send

    def recorded(self):
        make(self)
        rings.append(self)

    staging.StagingRing.__init__ = recorded
    if keys == "int64":
        staging.Slot.send = _send_keys_as_int64(send)
    try:
        config = harness.config_of(man, wl)
        run = harness.Run(workload=wl["name"], config=config,
                          traffic=harness.traffic(wl["traffic"]), cell=harness.cell(wl["name"]),
                          seed=seed, seconds=seconds, trace=trace,
                          t_process=time.perf_counter())
        out = harness.system(config["system"]).run(run)
    finally:
        staging.StagingRing.__init__, staging.Slot.send = make, send
    ring = rings[0]
    return {"keys": keys, "seed": seed, "line": bench.result_line(man, wl, out, trace),
            "staged_blocks": ring.staged_blocks, "staging_waits": ring.staging_waits,
            "pinned_bytes": sum(host.nbytes for slot in ring.slots
                                for _, host in slot.buffers.values())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", required=True)
    p.add_argument("--keys", default="uint32")
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--workload", default="twitter-cu.ingest")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    ways = args.keys.split(",")
    if not set(ways) <= set(KEYS):
        sys.exit(f"ingest_staging: --keys takes {', '.join(KEYS)}")
    bench.cache_dirs()
    import torch

    if not torch.cuda.is_available():
        sys.exit("ingest_staging: no CUDA card")
    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    seconds = float(man["run_seconds"]) if args.seconds is None else args.seconds
    power = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True).stdout
    # the ways in turns, the order flipped every other seed (a b, b a, ...)
    runs = [one_run(man, wl, int(seed), seconds, bool(args.trace), keys)
            for i, seed in enumerate(args.seeds.split(","))
            for keys in (ways if i % 2 == 0 else ways[::-1])]
    text = json.dumps({"card": power.strip(), "torch": torch.__version__,
                       "seconds": seconds, "runs": runs})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
