"""A run of the model-serving cell at a size a CPU test holds: the cell's
configuration, traffic and cell files, with the model's widths and depth
and the traffic's lengths cut down, on the CPU."""
from __future__ import annotations

import copy
import time

from perfbench import harness

CELL = "mixtral-8x22b.decode"
MODEL = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
         "vocab_size": 512}
TRAFFIC = {"slots": 4, "prompt_tokens": 24, "new_tokens": 8, "pool_cohorts": 4,
           "warmup_new_tokens": 2}


def serve(seed: int = 7, seconds: float = 0.0, dtype: str = "float32") -> harness.Run:
    man = harness.manifest()
    wl = harness.workload(man, CELL)
    config = copy.deepcopy(harness.config_of(man, wl))
    config["model"].update(MODEL, dtype=dtype)
    traffic = {**harness.traffic(wl["traffic"]), **TRAFFIC}
    return harness.Run(workload=CELL, config=config, traffic=traffic,
                       cell=copy.deepcopy(harness.cell(CELL)), seed=seed, seconds=seconds,
                       trace=False, t_process=time.perf_counter(), device="cpu")
