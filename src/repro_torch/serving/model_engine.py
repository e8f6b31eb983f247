"""Batched model-serving engine: prefill + decode with a static KV cache,
PyTorch port of ``repro/serving/model_engine.py``.

The unit of work is one decode step: one new token for every sequence in
the batch against a ``max_len`` cache, which ``decode_step`` writes in
place.  The engine adds request batching (a uniform position across the
batch), greedy or temperature sampling, and a slot scheduler for
continuous batching at the granularity of whole cohorts.

Greedy decoding is ``argmax``, the first index on ties as ``jnp.argmax``.
Temperature sampling draws from the engine's own ``torch.Generator`` on its
device, seeded by ``seed``: the reference's ``jax.random.categorical``
stream cannot be reproduced.  Both look only at the real vocabulary, so a
padded vocab row (masked to -1e30 before a logit softcap, which leaves it
at ``-softcap``) is never served.

This module is the model half of the serving stack; the sketch half
(SketchTopKEndpoint, SketchServeEngine) lives in serving/sketch_engine.py.
Both sit behind the same submit/flush engine protocol
(serving/protocol.py); ``repro_torch.serving.engine`` re-exports everything.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

PyTree = Any


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 2048
    temperature: float = 0.0     # 0 = greedy
    eos_id: int = -1             # -1 = never stop early


class ServeEngine:
    """Prefill and decode for a batch of equal-length prompts, on the
    device that holds ``params``."""

    def __init__(self, cfg: ModelConfig, params: PyTree, scfg: ServeConfig,
                 seed: int = 0):
        self.cfg = cfg
        self.params = params
        self.scfg = scfg
        self.device = tr.leaves(params)[0].device
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V] float32 logits -> [B] token ids."""
        logits = logits[:, : self.cfg.vocab_size]
        if self.scfg.temperature <= 0.0:
            return torch.argmax(logits, dim=-1)
        probs = torch.softmax(logits / self.scfg.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self.generator)[:, 0]

    @torch.no_grad()
    def generate(
        self,
        prompts: np.ndarray,                # int[B, S] (uniform length)
        max_new_tokens: int,
        embeds: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """``max_new_tokens`` tokens per prompt -> int32[B, max_new_tokens]."""
        cfg = self.cfg
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                                  device=self.device)
        s = prompts.shape[1]
        n_prefix = 0
        if cfg.frontend and not cfg.n_enc_layers:
            n_prefix = cfg.frontend_len
        if embeds is not None:
            embeds = torch.as_tensor(np.asarray(embeds), device=self.device).to(
                cfg.activation_dtype)
        logits, cache = tfm.prefill(cfg, self.params, prompts, embeds=embeds,
                                    max_len=self.scfg.max_len)
        out = [self._sample(logits)[:, None]]
        pos = n_prefix + s
        for _ in range(max_new_tokens - 1):
            lg, cache = tfm.decode_step(cfg, self.params, cache, out[-1], pos)
            out.append(self._sample(lg[:, 0, :])[:, None])
            pos += 1
        return torch.cat(out, dim=1).cpu().numpy().astype(np.int32)


# --------------------------------------------------------------------------
# continuous batching (step-granular slot scheduler)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray
    max_new: int
    out: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # the frontend stub's embeddings ([F, D]): an encoder-decoder's encoder
    # input or a vlm's prefix; None for a text-only model
    embeds: Optional[np.ndarray] = None


class SlotScheduler:
    """Admit requests into fixed decode slots; refill as sequences finish.

    Slots turn over between ``generate()`` calls of cohorts of up to
    ``n_slots`` requests in submission order, each cohort's prompts cut to
    its shortest; this keeps the decode step's shape static.
    """

    def __init__(self, engine: ServeEngine, n_slots: int):
        self.engine = engine
        self.n_slots = n_slots
        self.queue: List[Request] = []
        self.completed: List[Request] = []

    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def run(self) -> List[Request]:
        while self.queue:
            cohort = self.queue[: self.n_slots]
            self.queue = self.queue[self.n_slots:]
            s = min(len(r.prompt) for r in cohort)
            prompts = np.stack([r.prompt[:s] for r in cohort])
            embeds = (np.stack([r.embeds for r in cohort])
                      if cohort[0].embeds is not None else None)
            max_new = max(r.max_new for r in cohort)
            toks = self.engine.generate(prompts, max_new, embeds=embeds)
            for r, row in zip(cohort, toks):
                r.out = row[: r.max_new].tolist()
                r.done = True
                self.completed.append(r)
        return self.completed

    def flush(self) -> List[Request]:
        """Engine-protocol alias for :meth:`run` (serving/protocol.py)."""
        return self.run()
