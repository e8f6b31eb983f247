"""The conservative flat-sketch ingest system: the port's ``KernelSketch``
in mode ``"conservative"`` (hashing, chunking and the K5 fold on the card),
fed blocks of distinct keys with counts by one client in a closed loop.

Set-up: the traffic's pool of blocks (one pass of the stream, made on the
card, held on the host), hash parameters drawn on the card from the seed,
the sketch, and ``warmup_blocks`` blocks folded.  The window folds the
pool's blocks one after another, passing over the pool again where it
ends, for ``--seconds`` (a traced run: for the cell's ``trace_seconds``,
all of it traced), and ends with a synchronise: ``ingest_rows_per_s`` is
the rows of the window's blocks over the window's seconds.  After it,
``KernelSketch.query`` answers a seeded key set (K2).  The plain reference
then folds the same blocks in the same order (``reference/conservative.py``)
into an int64 table and answers the same keys: every cell of the table and
every answer has to be equal, so a table that wrapped past 2^31 - 1 is not
correct.
"""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import counts, harness
from perfbench.reference import conservative as ref_cons
from perfbench.reference import hashing as ref_hash

UPDATE_SPAN = "perfbench.update"
UNIT_BLOCKS = 16        # blocks the reference folds as one unit of rounds
REF_DTYPE = torch.int64


def _query_keys(keys: np.ndarray, n: int, seed: int) -> np.ndarray:
    """n keys: half drawn from the pool's edges, half uniform 32-bit pairs."""
    rng = np.random.default_rng(seed)
    flat = keys.reshape(-1, keys.shape[-1])
    present = flat[rng.integers(0, flat.shape[0], size=n // 2)]
    other = rng.integers(0, 1 << 32, size=(n - n // 2, keys.shape[-1]), dtype=np.uint64)
    return np.concatenate([present, other.astype(np.uint32)])


def _as_index(x: np.ndarray, device: str) -> torch.Tensor:
    return torch.from_numpy(x.astype(np.int64)).to(device)


def _sync(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def inputs(r: harness.Run):
    """What the benchmark makes and hands to both sides: the pool's keys
    and counts (host; their order drawn from the seed), the hash
    parameters (drawn on the device from the configuration's fixed
    ``hash_seed``: one deployment's sketch, whose collisions among the
    heaviest nodes would otherwise change the work from seed to seed) and
    the query keys (host, from the seed)."""
    cfg, tf, dev = r.config, r.traffic, r.device
    keys, freqs = harness.generator(tf["generator"]).generate(
        cfg, tf, harness.seed_for(r.seed, 1), dev)
    g = torch.Generator(device=dev).manual_seed(int(cfg["hash_seed"]))
    n_digits = sum(ref_hash.digits_per_module(cfg["key_domains"]))
    q = torch.randint(0, ref_hash.P31, (cfg["width"], n_digits), generator=g, device=dev)
    rr = torch.randint(0, ref_hash.P31, (cfg["width"], len(cfg["partition"])), generator=g,
                       device=dev)
    qkeys = _query_keys(keys, int(tf["query_keys"]), harness.seed_for(r.seed, 3))
    return keys, freqs, q, rr, qkeys


def reference(r: harness.Run, made, n_blocks: int, block_parallel: bool = False):
    """(the pool's cells [w, pool_blocks * rows], the int64 table, the
    answers) of the plain reference after the first ``n_blocks`` blocks of
    the sequence (the pool, passed over again and again from its start);
    ``block_parallel`` folds with the control instead."""
    cfg, dev = r.config, r.device
    keys, freqs, q, rr, qkeys = made
    domains, partition, ranges = cfg["key_domains"], cfg["partition"], cfg["ranges"]
    n_pool, rows = freqs.shape

    def cells_of(k: np.ndarray) -> torch.Tensor:
        return ref_hash.cells(_as_index(k, dev), q, rr, domains, partition, ranges)

    pool_cells = torch.cat([cells_of(keys[u : u + UNIT_BLOCKS].reshape(-1, keys.shape[-1]))
                            for u in range(0, n_pool, UNIT_BLOCKS)], dim=1)
    pool_freqs = torch.from_numpy(freqs.reshape(-1)).to(dev)
    h = int(np.prod(ranges))
    ref = torch.zeros((cfg["width"], h), dtype=REF_DTYPE, device=dev)
    # the sequence is cut into units of UNIT_BLOCKS blocks, aligned to the
    # pool's start; a unit recurs on every pass, and its rounds with it
    folder = ref_cons.SerialFolder(ref)
    first = torch.full((cfg["width"], h), torch.iinfo(torch.int32).max, dtype=torch.int32,
                       device=dev)
    rounds: Dict[int, List[torch.Tensor]] = {}
    done = 0
    while done < n_blocks:
        p = done % n_pool
        take = min(UNIT_BLOCKS, n_pool - p, n_blocks - done)
        c = pool_cells[:, p * rows : (p + take) * rows]
        f = pool_freqs[p * rows : (p + take) * rows]
        if block_parallel:
            ref_cons.fold_block_parallel_(ref, c, f, rows)
        else:
            whole = take == min(UNIT_BLOCKS, n_pool - p)
            if whole and p not in rounds:
                rounds[p] = ref_cons.schedule(c, first=first)
            folder.fold_(c, f, rounds[p] if whole else ref_cons.schedule(c, first=first))
        done += take
    want = ref_cons.point_query(ref, cells_of(qkeys))
    return pool_cells, ref, want


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.core import sketch as sk
    from repro_torch.core.hashing import KeySchema
    from repro_torch.kernels.ops import KernelSketch

    cfg, tf, dev = r.config, r.traffic, r.device
    keys, freqs, q, rr, qkeys = inputs(r)
    n_pool, rows = freqs.shape
    domains, partition = cfg["key_domains"], cfg["partition"]
    ranges, width = cfg["ranges"], cfg["width"]
    dtype = getattr(torch, cfg["table_dtype"])
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    spec = sk.mod_sketch_spec(KeySchema(tuple(domains)), partition, ranges, width)
    sketch = KernelSketch(spec, (q, rr), mode=cfg["mode"], dtype=dtype, device=dev,
                          block_b=rows)
    n_warm = int(tf["warmup_blocks"])
    for i in range(n_warm):
        sketch.update(keys[i % n_pool], freqs[i % n_pool])
    _sync(dev)

    # a traced run traces the whole of a window of the cell's trace_seconds
    seconds = min(float(r.cell["trace_seconds"]), r.seconds) if r.trace else r.seconds
    window = harness.TracedWindow(r.trace)
    window.start()
    probe_ms = harness.host_probe_ms()
    before = harness.host_snapshot()
    t0 = time.perf_counter()
    setup_s = t0 - r.t_process
    window.open()
    n = 0
    while True:
        b = (n_warm + n) % n_pool
        if r.trace:
            with torch.profiler.record_function(UPDATE_SPAN):
                sketch.update(keys[b], freqs[b])
        else:
            sketch.update(keys[b], freqs[b])
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    window.close(window_s)
    host = harness.host_readings(before, harness.host_snapshot())
    after_ms = harness.host_probe_ms()
    for k in probe_ms:
        host[f"probe_{k}_ms_before"], host[f"probe_{k}_ms_after"] = probe_ms[k], after_ms[k]
    answers = sketch.query(qkeys)
    peak = torch.cuda.max_memory_allocated() if torch.device(dev).type == "cuda" else 0
    table = sketch.table[:, : spec.table_size].to(REF_DTYPE)
    del sketch

    # the plain reference: the same blocks, in the same order, from zero
    pool_cells, ref, want = reference(r, (keys, freqs, q, rr, qkeys), n_warm + n)
    checks = harness.Checks(r.cell["limits"])
    checks.add("table_cells_differing", int((table != ref).sum()))
    checks.add("answers_differing",
               int((torch.from_numpy(np.asarray(answers)).to(dev).to(REF_DTYPE) != want).sum()))

    readings = None
    if r.trace:
        trace, span = window.finish()
        blocks = [(n_warm + i) % n_pool for i in range(n)]
        touched = {p: sum(int(torch.unique(pool_cells[k, p * rows : (p + 1) * rows]).numel())
                          for k in range(width)) for p in set(blocks)}
        fold_bytes = sum(counts.conservative_fold_bytes(
            rows, keys.itemsize * keys.shape[-1], freqs.itemsize, touched[p],
            dtype.itemsize) for p in blocks)
        readings = harness.Readings(
            trace=trace, window_us=span, window_s=window.host_s,
            counters={"blocks": n, "fold_bytes": fold_bytes, "update_span": UPDATE_SPAN})
    return harness.Outcome(
        attempted=n, failed=0,
        end_to_end={"ingest_rows_per_s": n * rows / window_s, "setup_s": setup_s,
                    "peak_mem_gb": peak / 1e9},
        checks=checks, peak_bytes=peak, readings=readings,
        details={"max_cell": int(ref.max()), "blocks": n_warm + n}, host=host)
