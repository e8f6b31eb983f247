"""Sharded heavy-hitter serving on the PyTorch port, production shape.

    PYTHONPATH=src python examples_torch/sharded_serving.py [--device cpu] [--seed 0]

The twin of ``examples/sharded_serving.py``, on an 8-position mesh dealt
round the visible cards (``launch.mesh.make_mesh``; all eight on one card
when there is one), or on eight CPU positions:

  1. a single-shard SketchTopKEndpoint handles early traffic,
  2. traffic grows, so the endpoint is promoted in place to a
     ShardedTopKService (to_sharded carries tables, hash params, candidate
     pools, and totals over),
  3. ingest workers feed uneven blocks; the psum sync runs every few
     blocks (lazy local tables between sync points),
  4. top-k and threshold queries serve from the merged level tables, and a
     1-shard reference service run over the identical stream verifies the
     answers are bit-identical (shard-count invariance).

On the card each shard's block folds on K3 and the queries descend on K4.
"""
import sys

import numpy as np

from _common import SeedKey, data_mesh, parser
from repro_torch.core import sketch as sk
from repro_torch.device import resolve_device
from repro_torch.serving.engine import SketchTopKEndpoint
from repro_torch.serving.sharded_topk import ShardedTopKService
from repro_torch.streams import zipf_hh_workload


def run(device, key, *, n_occurrences=150_000, n_edges=15_000, n_shards=8) -> dict:
    device = resolve_device(device)
    wl = zipf_hh_workload(n_occurrences=n_occurrences, n_edges=n_edges, seed=4)
    spec = sk.mod_sketch_spec(wl.stream.schema, [(0,), (1,)], (256, 256), 4)
    items, freqs = wl.stream.items, wl.stream.freqs

    # phase 1: single-shard endpoint takes the first quarter of the stream
    q = len(items) // 4
    ep = SketchTopKEndpoint(spec, key.params(spec), device=device)
    ep.ingest(items[:q], freqs[:q])
    endpoint_total = ep.total

    # phase 2: promote to an n-shard service on the mesh
    svc = ep.to_sharded(data_mesh(n_shards, device), sync_every=4)

    # phase 3: ingest workers push uneven blocks; sync every 4 blocks
    rng = np.random.default_rng(0)
    cuts = np.sort(rng.choice(np.arange(q + 1, len(items)), 6, replace=False))
    for s, e in zip(np.r_[q, cuts], np.r_[cuts, len(items)]):
        svc.ingest(items[s:e], freqs[s:e])
    svc.sync()

    # phase 4: serve queries from the merged tables
    top_items, top_est = svc.topk(10)
    hh_items, hh_est = svc.heavy_hitters(wl.threshold)
    exact = {tuple(r) for r in wl.exact_items.tolist()}
    got = {tuple(r) for r in hh_items.tolist()}
    assert exact <= got

    # verification: a 1-shard service over the identical stream agrees bit
    # for bit -- linear tables + exact integer psum make sharding invisible
    ref = ShardedTopKService(spec, key.params(spec), data_mesh(1, device))
    ref.ingest(items, freqs)
    tables = [a.table.cpu().numpy() for a in svc.state().states]
    for a, b in zip(tables, ref.state().states):
        assert np.array_equal(a, b.table.cpu().numpy())
    r_items, r_est = ref.topk(10)
    assert np.array_equal(top_items, r_items) and np.array_equal(top_est, r_est)
    return dict(endpoint_total=endpoint_total, stream_total=wl.stream.total,
                n_shards=svc.n_shards, data_axes=svc.data_axes, tables=tables,
                topk_items=top_items, topk_est=top_est, hh_items=hh_items, hh_est=hh_est,
                threshold=wl.threshold, reported=len(got), false_neg=len(exact - got),
                false_pos=len(got - exact))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    print(f"endpoint: ingested {out['endpoint_total']:,} of {out['stream_total']:,} "
          f"occurrences")
    print(f"promoted to {out['n_shards']} shards over axes {out['data_axes']}")
    print(f"topk(10) estimates: {out['topk_est'].tolist()}")
    print(f"heavy_hitters(>={out['threshold']}): reported={out['reported']} "
          f"false_neg={out['false_neg']} false_pos={out['false_pos']}")
    print("1-shard reference agrees bit-exactly: shard count is invisible")
    return 0


if __name__ == "__main__":
    sys.exit(main())
