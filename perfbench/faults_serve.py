"""Faults planted in the serving path underneath a run, to show that the
check catches them (the CPU tests, and ``calibrate_serve.py --faults`` on
the card at the cell's own size); never used by a run of ``run.py``.

* ``state_unchanged``: a decode step never writes its key and value into the
  cache (the state left unchanged);
* ``cache_short``: a decode step reads the cache one position short (its own
  key and value, just written, are not seen);
* ``top1``: one expert a token in place of the configuration's two;
* ``token_altered``: the third token served is not the one computed.
"""
from __future__ import annotations

import contextlib
import dataclasses

FAULTS = ("state_unchanged", "cache_short", "top1", "token_altered")


@contextlib.contextmanager
def planted(fault: str):
    """The program with ``fault`` planted inside the block."""
    from repro_torch.models import attention, moe
    from repro_torch.serving.model_engine import ServeEngine

    if fault == "state_unchanged":
        where, name, new = attention, "_scatter_time", lambda cache, new, pos: None
    elif fault == "cache_short":
        attend = attention._attend

        def new(cfg, q, k, v, mask):
            if q.shape[1] == 1:
                seen = mask.sum(-1, keepdim=True)
                kpos = attention.torch.arange(k.shape[1], device=k.device)
                mask = mask & (kpos[None, None, None, :] < seen - 1)
            return attend(cfg, q, k, v, mask)

        where, name = attention, "_attend"
    elif fault == "top1":
        apply_moe = moe.apply_moe

        def new(cfg, p, x, groups=None):
            return apply_moe(dataclasses.replace(cfg, top_k=1), p, x, groups)

        where, name = moe, "apply_moe"
    elif fault == "token_altered":
        sample, calls = ServeEngine._sample, []

        def new(self, logits):
            out = sample(self, logits)
            calls.append(1)
            return (out + 1) % self.cfg.vocab_size if len(calls) == 3 else out

        where, name = ServeEngine, "_sample"
    else:
        raise ValueError(f"no fault {fault!r}; one of {FAULTS}")
    old = getattr(where, name)
    setattr(where, name, new)
    try:
        yield
    finally:
        setattr(where, name, old)
