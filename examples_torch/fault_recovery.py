"""Kill -9 a sketch server on the PyTorch port and get every bit back.

    PYTHONPATH=src python examples_torch/fault_recovery.py [--device cpu] [--seed 0]

The twin of ``examples/fault_recovery.py``; it walks the durability layer
end to end:

  1. wrap a serving engine in DurableSketchEngine: every ingest block is
     WAL-appended before it touches the tables, and periodic snapshots
     (CRC-verified, versioned) bound how much log a recovery replays,
  2. crash it mid-stream through the fault-injection supervisor -- a hard
     kill, no drain, no goodbye snapshot -- then recover() and finish the
     stream: the result is bit-identical to a run that never crashed,
  3. corrupt the newest snapshot on disk before a second crash: the CRC
     check rejects it, recovery falls back to replaying the whole log,
     and the answers are STILL bit-identical,
  4. remesh a sharded service 2 -> 4 shards mid-stream and verify the
     top-k is bit-identical at any shard count.

Every endpoint the supervisor's factory builds takes the key's hash
parameters, so a recovery replays the log into the same hash functions.
On the card the folds run on K3 and the descents on K4.
"""
import sys
import tempfile

import numpy as np

from _common import SeedKey, data_mesh, parser
from repro_torch.core import sketch as sk
from repro_torch.device import resolve_device
from repro_torch.serving.faults import FaultPlan, ServingSupervisor
from repro_torch.serving.sharded_topk import ShardedTopKService
from repro_torch.serving.sketch_engine import SketchTopKEndpoint
from repro_torch.streams import zipf_hh_workload

BLOCK = 128


def run(device, key, *, n_occurrences=60_000, n_edges=8_000) -> dict:
    device = resolve_device(device)
    wl = zipf_hh_workload(n_occurrences=n_occurrences, n_edges=n_edges, seed=5)
    spec = sk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (128, 128), 4)
    items, freqs = wl.stream.items, wl.stream.freqs
    ops = [("block", items[s:s + BLOCK], freqs[s:s + BLOCK])
           for s in range(0, len(items), BLOCK)]

    def endpoint():
        return SketchTopKEndpoint(spec, key.params(spec), device=device)

    # the run that never crashes, as ground truth
    ref = endpoint()
    for _, it, fr in ops:
        ref.ingest(it, fr)
    ref_ids, ref_est = ref.topk(10)

    # --- 1+2: hard kill mid-stream, recover, finish; then 3: the newest
    # snapshot corrupted on disk before the kill
    recoveries = {}
    for name, corrupt in (("kill", False), ("corrupt", True)):
        with tempfile.TemporaryDirectory() as d:
            sup = ServingSupervisor(d, endpoint, snapshot_every=8)
            plan = FaultPlan(crash_after_ops=len(ops) // 2, corrupt_newest_snapshot=corrupt)
            eng, rep = sup.run(ops, plan)
            ids, est = eng.topk(10)
            assert np.array_equal(ids, ref_ids) and np.array_equal(est, ref_est)
            r = rep.recoveries[-1]
            recoveries[name] = dict(restored_step=r.restored_step,
                                    replayed_blocks=r.replayed_blocks,
                                    corrupted_steps=list(r.corrupted_steps))

    # --- 4: elastic 2 -> 4 shard remesh mid-stream
    svc = ShardedTopKService(spec, key.params(spec), data_mesh(2, device), sync_every=4)
    half = len(ops) // 2
    for _, it, fr in ops[:half]:
        svc.ingest(it, fr)
    svc.remesh(data_mesh(4, device))
    for _, it, fr in ops[half:]:
        svc.ingest(it, fr)
    ids, est = svc.topk(10)
    assert np.array_equal(ids, ref_ids) and np.array_equal(est, ref_est)
    return dict(n_ops=len(ops), stream_total=wl.stream.total, topk_items=ref_ids,
                topk_est=ref_est, recoveries=recoveries, remesh_total=svc.total)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    n, kill, corrupt = out["n_ops"], out["recoveries"]["kill"], out["recoveries"]["corrupt"]
    print(f"stream: {n} blocks, {out['stream_total']} total mass")
    print(f"killed after {n // 2} ops: restored snapshot step={kill['restored_step']}, "
          f"replayed {kill['replayed_blocks']} WAL blocks -> top-10 bit-identical to the "
          f"uninterrupted run")
    print(f"corrupted snapshot(s) {corrupt['corrupted_steps']} rejected by CRC, fell back "
          f"and replayed {corrupt['replayed_blocks']} blocks -> still bit-identical")
    print(f"remeshed 2 -> 4 shards mid-stream -> top-10 bit-identical "
          f"(total={out['remesh_total']})")
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
