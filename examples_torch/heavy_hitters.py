"""Hierarchical heavy hitters on the PyTorch port in 60 lines.

    PYTHONPATH=src python examples_torch/heavy_hitters.py [--device cpu] [--seed 0]

The twin of ``examples/heavy_hitters.py``: builds a Zipf edge stream and a
bigram token stream, stacks a prefix hierarchy of composite-hash sketches
over each, and recovers every key above a frequency threshold by
recursive descent -- the candidate kernel (K4 on the card) against the
plain descent and against exact ground truth -- then serves top-k through
the SketchTopKEndpoint (K3 ingest, K4 descent), a conservative endpoint
(K5i) and the sharded service, whose output is bit-identical at any shard
count (its positions dealt round the visible cards, or on the CPU).
"""
import sys

import numpy as np

from _common import SeedKey, data_mesh, parser
from repro_torch.core import hierarchy as hh
from repro_torch.core import sketch as sk
from repro_torch.device import resolve_device
from repro_torch.serving.engine import SketchTopKEndpoint
from repro_torch.serving.sharded_topk import ShardedTopKService
from repro_torch.streams import ngram_hh_workload, zipf_hh_workload


def _keys(items: np.ndarray) -> set:
    return {tuple(r) for r in items.tolist()}


def run(device, key, *, n_occurrences=100_000, vocab_size=512) -> dict:
    device = resolve_device(device)
    descents = []
    for wl, part, ranges in (
        (zipf_hh_workload(n_occurrences=n_occurrences), [(0,), (1,)], (256, 256)),
        (ngram_hh_workload(vocab_size=vocab_size, n=2), [(0,), (1,)], (128, 128)),
    ):
        stream = wl.stream
        base = sk.mod_sketch_spec(stream.schema, part, ranges, 4)
        hspec = hh.HierarchySpec.from_spec(base)
        state = hh.build_hierarchy(hspec, key.params(base), stream.items, stream.freqs,
                                   device=device)
        cands = wl.candidates(base)

        got_ref, est_ref = hh.find_heavy_hitters(hspec, state, wl.threshold, cands)
        got_krn, est_krn = hh.find_heavy_hitters(hspec, state, wl.threshold, cands,
                                                 use_kernel=True)
        assert np.array_equal(got_ref, got_krn), "kernel/reference disagree"
        exact, got = _keys(wl.exact_items), _keys(got_ref)
        descents.append(dict(
            name=stream.name, total=stream.total, threshold=wl.threshold,
            items=got_ref, est=est_ref, exact=len(exact), reported=len(got),
            false_neg=len(exact - got), false_pos=len(got - exact),
            table_cells=hspec.table_cells, n_levels=hspec.n_levels))

    # serving endpoint: ingest in shards, merge, query top-k
    wl = zipf_hh_workload(n_occurrences=n_occurrences, seed=1)
    items_all, freqs_all = wl.stream.items, wl.stream.freqs
    spec = sk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (256, 256), 4)
    shards = [SketchTopKEndpoint(spec, key.params(spec), device=device) for _ in range(2)]
    half = len(items_all) // 2
    shards[0].ingest(items_all[:half], freqs_all[:half])
    shards[1].ingest(items_all[half:], freqs_all[half:])
    shards[0].merge_from(shards[1])
    items, est = shards[0].topk(10)
    true_top = wl.exact_freqs[:10]

    # conservative endpoint: tighter estimates, but single-shard (non-linear
    # tables refuse merge_from)
    cons = SketchTopKEndpoint(spec, key.params(spec), mode="conservative", device=device)
    cons.ingest(items_all, freqs_all)
    cons_items, est_cons = cons.topk(10)
    # same hash params + same stream => per-key dominance
    lin_est = {tuple(k): e for k, e in zip(items.tolist(), est.tolist())}
    overlap = [(c, lin_est[tuple(k)])
               for k, c in zip(cons_items.tolist(), est_cons.tolist()) if tuple(k) in lin_est]
    assert overlap and all(c <= l for c, l in overlap), "conservative must be tighter per key"

    # sharded service: the same stream through a 1-shard and a 4-shard mesh
    # (different block splits!) yields bit-identical level tables and top-k
    svc1 = ShardedTopKService(spec, key.params(spec), data_mesh(1, device))
    svc4 = ShardedTopKService(spec, key.params(spec), data_mesh(4, device), sync_every=2)
    svc1.ingest(items_all, freqs_all)
    third = len(items_all) // 3
    for s, e in ((0, third), (third, 2 * third), (2 * third, None)):
        svc4.ingest(items_all[s:e], freqs_all[s:e])
    tables = [a.table.cpu().numpy() for a in svc1.state().states]
    for a, b in zip(tables, svc4.state().states):
        assert np.array_equal(a, b.table.cpu().numpy())
    s1_items, s1_est = svc1.topk(10)
    s4_items, s4_est = svc4.topk(10)
    assert np.array_equal(s1_items, s4_items) and np.array_equal(s1_est, s4_est)
    return dict(descents=descents, topk_items=items, topk_est=est, exact_top=true_top,
                cons_items=cons_items, cons_est=est_cons, sharded_tables=tables,
                sharded_items=s4_items, sharded_est=s4_est)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    for d in out["descents"]:
        print(f"{d['name']}: L={d['total']:,} threshold={d['threshold']} "
              f"exact={d['exact']} reported={d['reported']} "
              f"false_neg={d['false_neg']} false_pos={d['false_pos']} "
              f"(tables: {d['table_cells']:,} cells over {d['n_levels']} levels)")
    print(f"endpoint top-10 estimates: {out['topk_est'].tolist()}")
    print(f"exact top frequencies:     {out['exact_top'].tolist()}")
    print(f"conservative top-10:       {out['cons_est'].tolist()} (<= linear per key)")
    print(f"sharded top-10 (1==4 shards): {out['sharded_est'].tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
