"""Runs of the benchmark's systems at sizes a CPU test holds: the
configuration, traffic and cell files themselves, with the sizes cut
down, on the CPU (where the port's wrappers take their plain versions)."""
from __future__ import annotations

import copy
import time

from perfbench import harness

# a pass of about 80 blocks of 64 distinct edges; the pool's 20 blocks are
# a unit of the reference's 16 and a part of one
INGEST_SIZES = {"n_src": 50, "n_tgt": 155, "n_edges": 600, "n_occurrences": 6000,
                "ranges": [16, 16]}
INGEST_TRAFFIC = {"block_rows": 64, "pool_blocks": 20, "warmup_blocks": 2, "query_keys": 64}


def ingest(seed: int = 7, seconds: float = 0.2) -> harness.Run:
    man = harness.manifest()
    wl = harness.workload(man, "twitter-cu.ingest")
    config = {**harness.config_of(man, wl), **INGEST_SIZES}
    traffic = {**harness.traffic(wl["traffic"]), **INGEST_TRAFFIC}
    return harness.Run(workload=wl["name"], config=config, traffic=traffic,
                       cell=copy.deepcopy(harness.cell(wl["name"])), seed=seed,
                       seconds=seconds, trace=False, t_process=time.perf_counter(),
                       device="cpu")
