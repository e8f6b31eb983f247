"""Cohorts of prompts for a slot scheduler: ``pool_cohorts`` cohorts of
``slots`` prompts, each of ``prompt_tokens`` token ids drawn from a Zipf
law of exponent ``zipf_s`` over the vocabulary (rank r has mass
proportional to r^-s; the ids of the ranks are a permutation drawn from
the seed), and, for each cohort, ``sampled_slots`` slots whose requests
the check compares with the reference.

Every prompt of every seed has the same length: the seed draws the
tokens and the sample, never the work.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def generate(config: dict, traffic: dict, seed: int) -> Tuple[np.ndarray, np.ndarray]:
    """(prompts int64 [pool_cohorts, slots, prompt_tokens], sampled slots
    int64 [pool_cohorts, sampled_slots]), the same for the same seed."""
    vocab = int(config["model"]["vocab_size"])
    n, slots = int(traffic["pool_cohorts"]), int(traffic["slots"])
    rng = np.random.default_rng(seed)
    ids = rng.permutation(vocab)
    mass = np.arange(1, vocab + 1, dtype=np.float64) ** -float(traffic["zipf_s"])
    ranks = rng.choice(vocab, size=(n, slots, int(traffic["prompt_tokens"])), p=mass / mass.sum())
    sampled = np.stack([rng.choice(slots, int(traffic["sampled_slots"]), replace=False)
                        for _ in range(n)])
    return ids[ranks].astype(np.int64), sampled.astype(np.int64)
