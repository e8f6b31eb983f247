"""Async sketch serving on the PyTorch port: pipelined ingest and
bounded-staleness queries.

    PYTHONPATH=src python examples_torch/async_serving.py [--device cpu] [--seed 0]

The twin of ``examples/async_serving.py``: it exercises the
SketchServeEngine the way a serving deployment would (K3 ingest and K4
descents on the card):

  1. the staleness contract: ingest moves the engine's mass watermark
     while queries serve from a snapshot; a query only refreshes when the
     mass ingested since the snapshot exceeds ``max_staleness``, and after
     any query the observed staleness is back within the bound,
  2. an ingest thread streams blocks while the main thread submits
     concurrent top-k / heavy-hitter requests and serves them with one
     batched flush per round (every answer mutually consistent on one
     snapshot),
  3. after the ingest thread joins, drain + sync gives staleness 0 and
     answers bit-identical to a synchronous SketchTopKEndpoint fed the
     same stream.

Both threads stay on the default stream: the fold updates the tables in
place, and the main thread's snapshot copies are ordered against it only
on one stream.
"""
import sys
import threading

import numpy as np

from _common import SeedKey, parser
from repro_torch.core import sketch as sk
from repro_torch.device import resolve_device
from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
from repro_torch.streams import zipf_hh_workload

BLOCK = 1024


def run(device, key, *, n_occurrences=120_000, n_edges=12_000) -> dict:
    device = resolve_device(device)
    wl = zipf_hh_workload(n_occurrences=n_occurrences, n_edges=n_edges, seed=7)
    spec = sk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (128, 128), 4)
    items, freqs = wl.stream.items, wl.stream.freqs
    blocks = [(items[s:s + BLOCK], freqs[s:s + BLOCK]) for s in range(0, len(items), BLOCK)]
    bound = wl.stream.total // 4

    eng = SketchServeEngine(SketchTopKEndpoint(spec, key.params(spec), device=device),
                            max_staleness=bound)

    # phase 1: the staleness contract, single-threaded so it is observable
    half = len(blocks) // 2
    max_seen = 0
    staleness = []
    for b, (bi, bf) in enumerate(blocks[:half]):
        eng.ingest(bi, bf)
        if (b + 1) % 2 == 0:
            before = eng.staleness
            max_seen = max(max_seen, before)
            eng.topk(5)
            assert eng.staleness <= bound, "query served beyond the bound"
            staleness.append((b + 1, before, eng.staleness))
    assert max_seen > 0, "pipelined ingest should have outrun the snapshot"

    # phase 2: ingest thread + concurrent batched queries
    def feed():
        for bi, bf in blocks[half:]:
            eng.ingest(bi, bf)

    t = threading.Thread(target=feed)
    t.start()
    rounds = 0
    while t.is_alive() or rounds == 0:
        eng.submit_topk(10)
        eng.submit_topk(3)
        eng.submit_heavy_hitters(wl.threshold)
        top10, top3, hhs = eng.flush()
        # one snapshot per flush: the smaller request is a prefix of the larger
        assert np.array_equal(top3.items, top10.items[:3])
        rounds += 1
    t.join()

    # phase 3: barrier; the engine now answers exactly like a synchronous endpoint
    eng.drain()
    eng.sync()
    assert eng.staleness == 0
    ref = SketchTopKEndpoint(spec, key.params(spec), device=device)
    ref.ingest(items, freqs)
    e_items, e_est = eng.topk(10)
    r_items, r_est = ref.topk(10)
    assert np.array_equal(e_items, r_items) and np.array_equal(e_est, r_est)
    hh_items, hh_est = eng.heavy_hitters(wl.threshold)
    got = {tuple(r) for r in hh_items.tolist()}
    exact = {tuple(r) for r in wl.exact_items.tolist()}
    assert exact <= got
    return dict(bound=bound, staleness=staleness, rounds=rounds, topk_items=e_items,
                topk_est=e_est, hh_items=hh_items, hh_est=hh_est, threshold=wl.threshold,
                reported=len(got), false_neg=len(exact - got))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    for b, before, after in out["staleness"]:
        print(f"block {b}: staleness {before:,} -> {after:,} (bound {out['bound']:,})")
    print(f"served {out['rounds']} batched rounds (3 requests each) during ingest")
    print(f"after sync: topk(10) bit-identical to the synchronous endpoint; "
          f"heavy_hitters(>={out['threshold']}) reported={out['reported']} "
          f"false_neg={out['false_neg']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
