"""Quickstart on the PyTorch port: MOD-Sketch in 60 lines.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu] [--seed 0]

The twin of ``examples/quickstart.py``: builds a Twitter-like edge stream,
runs the paper's full pipeline (sample -> Thm-3 ranges -> Thm-4/5
selection -> build -> query) and prints the observed error of every
method.  Like the example it runs the plain sketch path, so it launches
no kernel.
"""
import sys

import numpy as np

from _common import SeedKey, parser
from repro_torch.core import sketch as sk
from repro_torch.core.selection import choose_sketch
from repro_torch.device import resolve_device
from repro_torch.streams import observed_error, zipf_graph_stream

STREAM = dict(n_src=20_000, n_tgt=60_000, n_edges=400_000, n_occurrences=2_000_000,
              s_src=0.7, s_tgt=0.7)


def run(device, key, *, stream=STREAM, h=4096, w=5) -> dict:
    device = resolve_device(device)
    stream = zipf_graph_stream(**stream)
    rng = np.random.default_rng(0)

    # 1. uniform 2% sample (paper SIV: "2~4% of the stream")
    s_items, s_freqs = stream.sample(0.02, rng)

    # 2+3. optimal MOD ranges (Thm 3) + sigma-based selection (Thm 4/5)
    result = choose_sketch(s_items, s_freqs, stream.schema, h, w, key.draw, device=device)
    a, b = result.mod_ranges

    # 4. build each sketch over the full stream and compare on both query mixes
    qsets = {"top-500": stream.top_k_queries(500),
             "random-500": stream.random_k_queries(500, rng)}
    specs = {
        "count-min": sk.count_min_spec(stream.schema, h, w),
        "equal-sketch": sk.equal_sketch_spec(stream.schema, h, w),
        "mod-sketch": sk.mod_sketch_spec(stream.schema, [(0,), (1,)], (a, b), w),
        "selected": result.spec,
    }
    methods = {}
    for name, spec in specs.items():
        state = sk.build_sketch(spec, key.params(spec), stream.items, stream.freqs,
                                device=device)
        est = {qname: sk.query(spec, state, qi).cpu().numpy()
               for qname, (qi, _) in qsets.items()}
        methods[name] = dict(
            describe=spec.describe(), est=est,
            error={qname: observed_error(est[qname], qf) for qname, (_, qf) in qsets.items()})
    return dict(distinct=len(stream.items), total=stream.total, h=h,
                ranges=(a, b), choice=result.choice, sigma=result.sigma, methods=methods)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    print(f"stream: {out['distinct']:,} distinct edges, L={out['total']:,}")
    a, b = out["ranges"]
    print(f"Thm-3 ranges: a={a}, b={b} (equal split would be {int(out['h']**0.5)}^2); "
          f"selected: {out['choice']} (sigma={out['sigma']})")
    for name, m in out["methods"].items():
        errs = "  ".join(f"{qname}={err:.3f}" for qname, err in m["error"].items())
        print(f"{name:13s} {errs}   ({m['describe']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
