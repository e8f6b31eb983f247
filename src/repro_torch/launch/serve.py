"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``,
PyTorch port of ``repro/launch/serve.py``.

Boots the batched engine (prefill + decode with KV/SSM caches) on the card
(``--device cpu`` for the CPU) and runs a synthetic batched-request
workload through the slot scheduler, reporting decode throughput.  A model
with a frontend stub (an encoder-decoder's frames, a vlm's patches) gets
seeded embeddings per request.

``--sketch-autotune`` runs the other serving stack instead: a
SketchTopKEndpoint under an online AutoTuner, fed a module-skew-flip
stream (streams.dstream.skew_flip_batches).  The tuner derives live
stats from the endpoint's own pools/tables, re-runs the strategy search,
and hot-migrates the endpoint to the re-drawn spec through a double-write
warmup window -- the launcher reports every tune decision and the final
heavy-hitter error of the migrated endpoint next to a stale
(never-retuned) twin fed the same stream.

``main(argv)`` returns what it ran (the endpoint and tuner, or the engine's
requests and params), so that a caller can check it.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

import numpy as np
import torch


def run_sketch_autotune(args, use_kernel: Optional[bool] = None) -> dict:
    """The auto-tune run; ``use_kernel`` is the endpoints' kernel switch
    (``None``: the kernels for tables on the card)."""
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.device import resolve_device
    from repro_torch.serving.autotune import AutoTuner, seeded_key_draw
    from repro_torch.serving.sketch_engine import (SketchServeEngine,
                                                   SketchTopKEndpoint)
    from repro_torch.streams import skew_flip_batches
    from repro_torch.streams.stats import topk_point_are

    device = resolve_device(args.device)
    domains = (args.domain, args.domain)
    schema = KeySchema(domains=domains)

    # Deliberately stale spec: ranges tuned for a skewed module 0 / wide
    # module 1 -- the stream flips that halfway through.
    h = args.sketch_h
    stale = sk.mod_sketch_spec(schema, [(0,), (1,)],
                               (max(2, h // 64), 64), args.sketch_w)
    params = sk.init_params(stale, torch.Generator().manual_seed(args.seed), "cpu")

    def endpoint():
        return SketchTopKEndpoint(stale, params, use_kernel=use_kernel,
                                  use_update_kernel=use_kernel, device=device)

    live = endpoint()
    tuner = AutoTuner(live, seeded_key_draw(args.seed + 1),
                      retune_every=args.retune_every, warmup=args.warmup,
                      min_improvement=args.min_improvement, sample_k=256,
                      min_threshold=1, search=args.search)
    # the tuner ticks on every sync() (snapshot boundary), so retune
    # decisions -- and the migrations they open -- happen between pipelined
    # blocks, never against half-folded tables
    engine = SketchServeEngine(live, max_staleness=None, tuner=tuner)

    batches = list(skew_flip_batches(domains, args.batches,
                                     args.rows_per_batch, seed=args.seed))
    window_start = 0          # first batch the CURRENT tables have seen
    t0 = time.perf_counter()
    for b, batch in enumerate(batches):
        n_prev = len(tuner.decisions)
        engine.ingest(batch.items, batch.freqs)
        engine.sync()
        d = tuner.decisions[-1] if len(tuner.decisions) > n_prev else None
        if d is not None:
            print(f"[batch {b:3d} total={d.at_total:,}] {d.reason}: "
                  f"sigma {d.sigma_current:.2f} -> {d.sigma_proposed:.2f}"
                  + (f" ranges {d.proposed_ranges}" if d.migrated else ""))
        if d is not None and d.migrated:
            # the successor starts absorbing from the NEXT ingest; after
            # cutover the endpoint's window starts here
            window_start = b + 1
        if live.migrating:
            print(f"[batch {b:3d}] warmup {live.migration_progress:.0%}")
    dt = time.perf_counter() - t0

    # Post-cutover the endpoint describes its post-migration window, so
    # score it against that window's exact counts -- and against a twin
    # endpoint on the STALE spec fed exactly the same window, isolating
    # the spec effect.
    frozen = endpoint()
    exact: dict = {}
    for batch in batches[window_start:]:
        frozen.ingest(batch.items, batch.freqs)
        for it, f in zip(batch.items.tolist(), batch.freqs.tolist()):
            exact[tuple(it)] = exact.get(tuple(it), 0) + f
    top = sorted(exact.items(), key=lambda kv: -kv[1])[:args.topk]
    q = np.array([k for k, _ in top], dtype=np.uint32)
    true = np.array([v for _, v in top], dtype=np.int64)
    are = {"auto_tuned": topk_point_are(live.hspec, live.state, q, true),
           "stale": topk_point_are(frozen.hspec, frozen.state, q, true)}

    print(f"\n{args.batches} batches in {dt:.2f}s; "
          f"migrations={sum(d.migrated for d in tuner.decisions)} "
          f"(spec now partition={live.hspec.base.partition} "
          f"ranges={live.hspec.base.ranges})")
    print(f"window batches [{window_start}:{len(batches)}] "
          f"top-{args.topk} ARE  auto-tuned={are['auto_tuned']:.4f}  "
          f"stale={are['stale']:.4f}")
    return {"endpoint": live, "frozen": frozen, "tuner": tuner, "engine": engine,
            "window_start": window_start, "are": are, "seconds": dt}


def run_model_serving(args) -> dict:
    from repro_torch.configs import get_config, get_reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import transformer as tfm
    from repro_torch.serving.model_engine import (Request, ServeConfig, ServeEngine,
                                                  SlotScheduler)

    device = resolve_device(args.device)
    cfg = get_config(args.arch) if args.full else get_reduced(args.arch)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = tfm.init_params(cfg, gen, device)
    n_prefix = cfg.frontend_len if cfg.frontend and not cfg.n_enc_layers else 0
    scfg = ServeConfig(max_len=n_prefix + args.prompt_len + args.max_new + 8,
                       temperature=args.temperature)
    engine = ServeEngine(cfg, params, scfg, seed=args.seed)
    sched = SlotScheduler(engine, n_slots=args.slots)

    rng = np.random.default_rng(args.seed)
    for rid in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size,
                              size=(args.prompt_len,)).astype(np.int32)
        embeds = None
        if cfg.frontend:
            embeds = (rng.standard_normal((cfg.frontend_len, cfg.d_model))
                      * 0.02).astype(np.float32)
        sched.submit(Request(rid=rid, prompt=prompt, max_new=args.max_new,
                             embeds=embeds))

    t0 = time.perf_counter()
    done = sched.run()
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out) for r in done)
    print(f"served {len(done)} requests, {n_tok} tokens in {dt:.2f}s "
          f"({n_tok / dt:.1f} tok/s decode incl. prefill)")
    print("sample output:", done[0].out[:8])
    return {"cfg": cfg, "params": params, "requests": done, "seconds": dt,
            "tokens": n_tok}


def parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.configs import ARCHS

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS,
                    help="model arch to serve (omit with --sketch-autotune)")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cpu runs the plain versions)")
    # sketch auto-tune mode
    ap.add_argument("--sketch-autotune", action="store_true",
                    help="serve a sketch endpoint under the online "
                         "auto-tuner over a skew-flip drift stream")
    ap.add_argument("--domain", type=int, default=1 << 16)
    ap.add_argument("--batches", type=int, default=24)
    ap.add_argument("--rows-per-batch", type=int, default=4_000)
    ap.add_argument("--sketch-h", type=int, default=4_096)
    ap.add_argument("--sketch-w", type=int, default=4)
    ap.add_argument("--retune-every", type=int, default=20_000)
    ap.add_argument("--warmup", type=int, default=8_000)
    ap.add_argument("--min-improvement", type=float, default=0.9)
    ap.add_argument("--search", choices=("greedy", "ranges"),
                    default="ranges")
    ap.add_argument("--topk", type=int, default=32)
    args = ap.parse_args(argv)
    if args.arch is None and not args.sketch_autotune:
        ap.error("--arch is required unless --sketch-autotune is set")
    return args


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.sketch_autotune:
        return run_sketch_autotune(args)
    return run_model_serving(args)


if __name__ == "__main__":
    main()
