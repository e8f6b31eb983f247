"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``,
PyTorch port of ``repro/launch/train.py``.

Runs the fault-tolerant training loop on the card (``--device cpu`` for
the CPU); the defaults target the reduced configs.  The MOD-Sketch n-gram
statistics run inside the step (one K1 launch a step on the card), the
optional gradient compressor folds each compressed leaf with K8f, and the
closing bigram probe reads the table with K2.  With ``--ckpt-dir``
checkpoints restart automatically via the Supervisor.

``main(argv)`` returns the final state, the loss history and the probe's
estimates.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.device import resolve_device
from repro_torch.kernels.sketch_query import sketch_query
from repro_torch.streams import ngram
from repro_torch.training import train_loop as tl
from repro_torch.training.grad_compression import CompressionConfig
from repro_torch.training.optimizer import OptimizerConfig


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--full", action="store_true",
                    help="full config (default: reduced smoke config)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--no-sketch", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (cpu runs the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    tcfg = tl.TrainConfig(
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  warmup_steps=max(1, args.steps // 20)),
        microbatches=args.microbatches,
        sketch_enabled=not args.no_sketch,
        compression=CompressionConfig(enabled=args.grad_compression),
    )
    print(f"arch={cfg.name} params~{cfg.param_count()['total']:,} "
          f"steps={args.steps} batch={args.batch}x{args.seq}")
    t0 = time.perf_counter()
    state, history = tl.train(cfg, tcfg, args.steps, args.batch, args.seq,
                              torch.Generator(device=device).manual_seed(args.seed),
                              ckpt_dir=args.ckpt_dir, device=device)
    dt = time.perf_counter() - t0
    losses = history["loss"]
    print(f"done in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    est = None
    if tcfg.sketch_enabled:
        # top bigram frequency probe: the first batch's first 8 bigrams
        spec = tl.make_sketch_spec(cfg)
        toks = tl.synthetic_batches(cfg, args.batch, args.seq)(0)["tokens"]
        grams = ngram.ngram_items(torch.from_numpy(toks).to(device), cfg.sketch_ngrams)[:8]
        q, r = state["sketch_params"]
        est = sketch_query(tl.make_plan(spec), state["sketch_table"],
                           spec.schema.module_chunks(grams), q, r)
        print("sketch n-gram estimates (first batch bigrams):", est.tolist())
    return {"args": args, "cfg": cfg, "tcfg": tcfg, "state": state, "history": history,
            "estimates": est, "seconds": dt}


if __name__ == "__main__":
    main()
