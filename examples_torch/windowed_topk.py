"""Sliding-window and time-decayed top-k on the PyTorch port.

    PYTHONPATH=src python examples_torch/windowed_topk.py [--device cpu] [--seed 0]

The twin of ``examples/windowed_topk.py``: a drifting stream (the heavy
set is re-permuted partway through) flows through three windowed
services -- tumbling, exponential-decay, landmark -- driven by the
DStream-style harness, which advances the epoch clock from batch
timestamps and scores every batch against exact windowed ground truth.
On the card the int32 modes fold on K3 and descend on K4, the decayed
(float32) window on K3f and K4f.  The closing check shows the tumbling
window is bit-exact against a hierarchy rebuilt from scratch over the
live epochs.
"""
import sys

import numpy as np

from _common import SeedKey, parser
from repro_torch.core import sketch as sk
from repro_torch.core import window as win
from repro_torch.core.hashing import KeySchema
from repro_torch.device import resolve_device
from repro_torch.serving.windowed_topk import WindowedTopKService
from repro_torch.streams import DStreamHarness, drifting_batches

DOMAINS = (1 << 20, 1 << 20)


def run(device, key, *, n_epochs=3, n_batches=16, batches_per_epoch=2,
        rows_per_batch=4_000) -> dict:
    device = resolve_device(device)
    spec = sk.mod_sketch_spec(KeySchema(domains=DOMAINS), [(0,), (1,)], (64, 64), 4)
    params = key.params(spec)

    def batches():
        return drifting_batches(DOMAINS, n_batches, rows_per_batch=rows_per_batch,
                                batches_per_epoch=batches_per_epoch, drift_every=4,
                                n_keys=1_000, seed=0)

    services = {
        "tumbling": WindowedTopKService(spec, params, n_epochs=n_epochs, device=device),
        "decay": WindowedTopKService(spec, params, n_epochs=n_epochs, window_mode="decay",
                                     decay=0.5, device=device),
        "landmark": WindowedTopKService(spec, params, n_epochs=n_epochs,
                                        window_mode="landmark", device=device),
    }
    reports = {}
    for name, svc in services.items():
        harness = DStreamHarness(svc, k=16, phi=0.01)
        for batch in batches():
            harness.step(batch)
        reports[name] = harness.reports
        assert harness.reports[-1].recall == 1.0, "no-false-negative guarantee broken"

    # the windowed merge is exact: rebuild a hierarchy from scratch over the
    # live epochs' batches and compare tables bit for bit
    svc = services["tumbling"]
    per_epoch = {}
    for batch in batches():
        per_epoch.setdefault(batch.t, []).append(batch)
    live_epochs = sorted(per_epoch)[-n_epochs:]
    blocks = [(np.concatenate([b.items for b in per_epoch[e]]),
               np.concatenate([b.freqs for b in per_epoch[e]]))
              for e in live_epochs]
    ref = win.reference_window_state(svc.wspec, params, blocks, device=device)
    tables = [got.table.cpu().numpy() for got in svc.state().states]
    for got, want in zip(tables, ref.states):
        assert np.array_equal(got, want.table.cpu().numpy())
    items, est = svc.topk(5)
    return dict(reports=reports, n_epochs=n_epochs, tumbling_tables=tables,
                decay_tables=[st.table.cpu().numpy()
                              for st in services["decay"].state().states],
                topk_items=items, topk_est=est)


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    for name, reports in out["reports"].items():
        last = reports[-1]
        print(f"{name:9s} epoch={last.epoch} window_mass={last.window_total:,.0f} "
              f"are(top16)={last.are_topk:.4f} recall={last.recall:.2f} "
              f"f2_rel_err={last.f2_rel_err:.4f}")
    print(f"window == rebuild-from-scratch over last {out['n_epochs']} epochs: bit-exact")
    print("tumbling top-5:", [(tuple(k), int(e))
                              for k, e in zip(out["topk_items"].tolist(), out["topk_est"])])
    return 0


if __name__ == "__main__":
    sys.exit(main())
