"""End to end on the PyTorch port: high-modularity stream
summarization at scale.

    PYTHONPATH=src python examples_torch/stream_pipeline.py [--device cpu] [--occurrences N]

The twin of ``examples/stream_pipeline.py``: a modularity-8 IPv4-like
trace is processed in streaming blocks through the kernel path
(``KernelSketch``: K1 ingest and K2 queries on the card, K5 ingest under
``--mode conservative``), with the greedy Algorithm-1 configuration found
from a 2% sample; frequency queries are answered from the sketch and
scored against exact ground truth, and the baselines are built on the
plain path.
"""
import sys
import time

import numpy as np
import torch

from _common import SeedKey, device_name, parser
from repro_torch.core import sketch as sk
from repro_torch.core.greedy import greedy_config
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import KernelSketch
from repro_torch.streams import ipv4_stream, observed_error, reinterpret_modularity

INGEST_BLOCK = 1 << 14


def run(device, key, sketch_key, *, occurrences=2_000_000, modularity=8, h=4096, w=5,
        mode="linear") -> dict:
    """``key`` stands in for the example's ``PRNGKey(0)`` (the search),
    ``sketch_key`` for its ``PRNGKey(1)`` (the sketch and the baselines)."""
    device = resolve_device(device)
    base = ipv4_stream(n_src_hosts=30_000, n_tgt_hosts=3_000, n_pairs=120_000,
                       n_occurrences=occurrences)
    stream = base if modularity == 2 else reinterpret_modularity(base, modularity)

    # --- configure from a 2% sample (Algorithm 1) --------------------------
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    s_items, s_freqs = stream.sample(0.02, rng)
    g = greedy_config(s_items, s_freqs, stream.schema, h, w, key.draw, device=device)
    greedy_s = time.perf_counter() - t0

    # --- stream the full trace through the kernel path ---------------------
    ks = KernelSketch(g.spec, sketch_key.params(g.spec), block_b=1024, mode=mode,
                      device=device)
    t0 = time.perf_counter()
    seen = 0
    for s in range(0, len(stream.items), INGEST_BLOCK):
        blk_f = stream.freqs[s : s + INGEST_BLOCK]
        ks.update(stream.items[s : s + INGEST_BLOCK], blk_f)
        seen += int(blk_f.sum())
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    ingest_s = time.perf_counter() - t0

    # --- queries -----------------------------------------------------------
    queries = {}
    for qname, (qi, qf) in (("top-500", stream.top_k_queries(500)),
                            ("random-500", stream.random_k_queries(500, rng))):
        est = ks.query(qi)
        queries[qname] = dict(est=est, error=observed_error(est, qf))

    # compare against the baselines on the same budget
    baselines = {}
    for name, spec in {"count-min": sk.count_min_spec(stream.schema, h, w),
                       "equal-sketch": sk.equal_sketch_spec(stream.schema, h, w)}.items():
        st = sk.build_sketch(spec, sketch_key.params(spec), stream.items, stream.freqs,
                             device=device)
        qi, qf = stream.top_k_queries(500)
        est = sk.query(spec, st, qi).cpu().numpy()
        baselines[name] = dict(est=est, error=observed_error(est, qf))
    return dict(name=stream.name, modularity=stream.schema.modularity,
                distinct=len(stream.items), total=stream.total, greedy_s=greedy_s,
                n_candidates=g.n_candidates, spec=g.spec, describe=g.spec.describe(),
                seen=seen, ingest_s=ingest_s, mode=mode, device=device_name(device),
                queries=queries, baselines=baselines)


def main(argv=None) -> int:
    ap = parser(__doc__)
    ap.add_argument("--occurrences", type=int, default=2_000_000)
    ap.add_argument("--modularity", type=int, default=8, choices=(2, 4, 8))
    ap.add_argument("--h", type=int, default=4096)
    ap.add_argument("--w", type=int, default=5)
    ap.add_argument("--mode", default="linear", choices=("linear", "conservative"),
                    help="conservative = tighter estimates, single-shard only "
                         "(non-linear table, no merge); its fold is sequential in "
                         "the items, so pair it with a smaller --occurrences")
    args = ap.parse_args(argv)
    out = run(args.device, SeedKey(args.seed), SeedKey(args.seed + 1),
              occurrences=args.occurrences, modularity=args.modularity, h=args.h,
              w=args.w, mode=args.mode)
    print(f"stream {out['name']}: modularity={out['modularity']}, "
          f"{out['distinct']:,} distinct, L={out['total']:,}")
    print(f"greedy config in {out['greedy_s']:.1f}s "
          f"({out['n_candidates']} candidates): {out['describe']}")
    print(f"ingested {out['seen']:,} occurrences in {out['ingest_s']:.1f}s ({out['mode']} "
          f"update, {out['seen'] / out['ingest_s']:.0f} weighted-items/s on {out['device']})")
    for qname, q in out["queries"].items():
        print(f"{qname}: observed error = {q['error']:.4f}")
    for name, b in out["baselines"].items():
        print(f"{name}: top-500 observed error = {b['error']:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
