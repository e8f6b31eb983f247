"""LM-framework integration on the PyTorch port: MOD-Sketch n-gram
statistics during training.

    PYTHONPATH=src python examples_torch/ngram_stats.py [--device cpu] [--seed 0]

The twin of ``examples/ngram_stats.py``: trains a reduced gemma2 for a few
dozen steps; the train step folds every batch's bigrams into a MOD-Sketch
inside the step (K1 on the card: zero extra data passes).  Afterwards the
sketch answers corpus-frequency queries on the plain path, compared
against exact counts collected on the host.
"""
import collections
import sys

import numpy as np
import torch

from _common import SeedKey, parser
from repro_torch.configs import get_reduced
from repro_torch.core import sketch as sk
from repro_torch.device import resolve_device
from repro_torch.training import train_loop as tl
from repro_torch.training.optimizer import OptimizerConfig


def run(device, key, *, steps=40, batch=8, seq=64) -> dict:
    device = resolve_device(device)
    cfg = get_reduced("gemma2-9b")
    tcfg = tl.TrainConfig(optimizer=OptimizerConfig(lr=1e-3, total_steps=60))

    state = key.train_state(cfg, tcfg, device)
    step_fn = tl.make_train_step(cfg, tcfg)
    data = tl.synthetic_batches(cfg, batch, seq)

    exact = collections.Counter()
    losses = []
    for s in range(steps):
        toks = data(s)["tokens"]
        for row in toks:
            exact.update(zip(row[:-1].tolist(), row[1:].tolist()))
        state, metrics = step_fn(state, {"tokens": torch.from_numpy(toks).to(device)})
        losses.append(float(metrics["loss"]))

    spec = tl.make_sketch_spec(cfg)
    sketch_state = sk.SketchState(params=sk.SketchParams(*state["sketch_params"]),
                                  table=state["sketch_table"])
    top = exact.most_common(10)
    grams = np.array([g for g, _ in top], dtype=np.uint32)
    est = sk.query(spec, sketch_state, grams).cpu().numpy()
    table = sketch_state.table.cpu().numpy()
    return dict(steps=steps, losses=losses, grams=grams,
                exact=np.array([c for _, c in top]), est=est, table=table,
                mean_over=float(np.mean([int(e) - c for (_, c), e in zip(top, est)])),
                total_mass=int(table.sum() // spec.width))


def main(argv=None) -> int:
    args = parser(__doc__).parse_args(argv)
    out = run(args.device, SeedKey(args.seed))
    print(f"trained {out['steps']} steps, loss={out['losses'][-1]:.3f}")
    print(f"{'bigram':>16s} {'exact':>8s} {'sketch':>8s}")
    for g, c, e in zip(out["grams"].tolist(), out["exact"].tolist(), out["est"].tolist()):
        print(f"{str(tuple(g)):>16s} {c:8d} {int(e):8d}")
    print(f"mean overestimate on top-10: {out['mean_over']:.1f} "
          f"(sketch never underestimates; total mass {out['total_mass']:,})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
