"""Training step factory + loop, PyTorch port of
``repro/training/train_loop.py``: the paper's sketch runs *inside* the step.

``make_train_step`` builds the step

    (state, batch) -> (new state, metrics)

over the state dict {"params", "opt", "sketch_params", "sketch_table",
"compression"}.  Each step folds the batch's token bigrams (modularity-2
keys, streams/ngram.py) into the int32 MOD-Sketch table, so corpus
statistics ride along with training; on the card that fold is one K1
launch on the reference's unpadded [w, h] table.  Optional sketch-based
gradient compression (grad_compression.py, K8f) sits between backward and
the optimizer.  Gradients come from ``torch.autograd.grad`` over the
parameter leaves in the reference's leaf order.

In place of the reference's jax key, :func:`init_train_state` takes a
``torch.Generator``; :func:`train` takes a generator or a ready state
(e.g. one carried across from the reference with
``repro_torch.interop.train_state_from_numpy``).  With ``ckpt_dir``,
:func:`train` restores the newest checkpoint there and runs under
training/fault_tolerance.Supervisor, saving every ``save_every`` steps
(training/checkpoint.py's format): a run killed and restarted ends bit
for bit where an uninterrupted run ends.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch import tree as tr
from repro_torch.configs.base import ModelConfig
from repro_torch.core import sketch as sk
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels.hashes import make_plan
from repro_torch.kernels.sketch_update import sketch_update
from repro_torch.models import transformer as tfm
from repro_torch.streams import ngram
from repro_torch.training import optimizer as opt
from repro_torch.training.grad_compression import (
    CompressionConfig,
    compress_decompress,
    init_compression,
)

PyTree = Any


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optimizer: opt.OptimizerConfig = opt.OptimizerConfig()
    microbatches: int = 1
    lb_coef: float = 0.01
    sketch_enabled: bool = True
    sketch_seed: int = 0
    compression: CompressionConfig = CompressionConfig()


def make_sketch_spec(cfg: ModelConfig) -> sk.SketchSpec:
    """MOD-Sketch over token bigrams: (prev, next) with equal vocab domains
    (the Thm-3 default beta=1 split)."""
    schema = ngram.ngram_schema(cfg.vocab_size, cfg.sketch_ngrams)
    a = max(2, int(round(cfg.sketch_range ** 0.5)))
    b = max(2, int(round(cfg.sketch_range / a)))
    return sk.mod_sketch_spec(schema, [(i,) for i in range(cfg.sketch_ngrams)],
                              (a, b) if cfg.sketch_ngrams == 2
                              else sk.equal_ranges(cfg.sketch_range, cfg.sketch_ngrams),
                              cfg.sketch_width)


def init_train_state(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    generator: torch.Generator,
    device: DeviceLike = None,
) -> Dict[str, PyTree]:
    """Fresh params, optimizer state, n-gram sketch and compression state,
    every draw from ``generator``."""
    device = resolve_device(device)
    params = tfm.init_params(cfg, generator, device)
    state: Dict[str, PyTree] = {
        "params": params,
        "opt": opt.init_state(tcfg.optimizer, params),
    }
    if tcfg.sketch_enabled:
        st = sk.init_state(make_sketch_spec(cfg), generator, device=device)
        state["sketch_params"] = st.params
        state["sketch_table"] = st.table
    if tcfg.compression.enabled:
        state["compression"] = init_compression(tcfg.compression, params, generator)
    return state


def make_train_step(
    cfg: ModelConfig,
    tcfg: TrainConfig,
) -> Callable[..., Tuple[Dict[str, PyTree], Dict[str, torch.Tensor]]]:
    """The train step over the state dict; the input state is not modified."""
    spec = make_sketch_spec(cfg) if tcfg.sketch_enabled else None
    plan = make_plan(spec) if spec is not None else None

    def grads_of(leaves, paths, tokens, embeds):
        live = tr.unflatten(zip(paths, leaves))
        loss, mets = tfm.loss_fn(cfg, live, tokens, embeds=embeds,
                                 lb_coef=tcfg.lb_coef)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), {k: v.detach() for k, v in mets.items()}, grads

    def step(state: Dict[str, PyTree], batch: Dict[str, torch.Tensor]):
        params = state["params"]
        tokens = batch["tokens"]
        embeds = batch.get("embeds")
        pairs = tr.flatten(params)
        paths = [path for path, _ in pairs]
        leaves = [p.detach().requires_grad_(True) for _, p in pairs]

        if tcfg.microbatches > 1:
            nm = tcfg.microbatches
            b = tokens.shape[0]
            if b % nm:
                raise ValueError(f"batch {b} % microbatches {nm}")
            mb = b // nm
            g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                     for p in leaves]
            loss = 0.0
            mets = []
            for i in range(nm):
                e_i = embeds[i * mb : (i + 1) * mb] if embeds is not None else None
                loss_i, mets_i, g = grads_of(leaves, paths,
                                             tokens[i * mb : (i + 1) * mb], e_i)
                g_acc = [a + x.to(a.dtype) for a, x in zip(g_acc, g)]
                loss = loss + loss_i
                mets.append(mets_i)
            grad_leaves = [g / nm for g in g_acc]
            loss = loss / nm
            metrics = {k: torch.mean(torch.stack([m[k] for m in mets]))
                       for k in mets[0]}
        else:
            loss, metrics, grad_leaves = grads_of(leaves, paths, tokens, embeds)
        grads = tr.unflatten(zip(paths, grad_leaves))

        new_state = dict(state)
        if tcfg.compression.enabled:
            grads, comp_state, cmet = compress_decompress(
                tcfg.compression, grads, state["compression"])
            new_state["compression"] = comp_state
            metrics.update(cmet)

        new_params, new_opt, omet = opt.apply_updates(
            tcfg.optimizer, params, grads, state["opt"])
        new_state["params"] = new_params
        new_state["opt"] = new_opt
        metrics.update(omet)
        metrics["loss"] = loss

        if tcfg.sketch_enabled:
            grams = ngram.ngram_items(tokens, cfg.sketch_ngrams)
            table = state["sketch_table"].clone()
            freqs = torch.ones((grams.shape[0],), dtype=table.dtype, device=table.device)
            q, r = state["sketch_params"]
            sketch_update(plan, table, spec.schema.module_chunks(grams), freqs, q, r)
            new_state["sketch_table"] = table
        return new_state, metrics

    return step


# --------------------------------------------------------------------------
# synthetic data pipeline (deterministic per step: exactly-once on replay)
# --------------------------------------------------------------------------

def synthetic_batches(
    cfg: ModelConfig,
    batch: int,
    seq: int,
    seed: int = 0,
) -> Callable[[int], Dict[str, np.ndarray]]:
    """step -> batch; Zipf-ish marginals so the n-gram sketch sees skew.
    The reference's numpy draws, unchanged."""
    def get(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(seed * 1_000_003 + step)
        z = rng.zipf(1.3, size=(batch, seq)).astype(np.int64)
        tokens = (z % cfg.vocab_size).astype(np.int32)
        out = {"tokens": tokens}
        if cfg.frontend:
            out["embeds"] = rng.standard_normal(
                (batch, cfg.frontend_len, cfg.d_model)).astype(np.float32) * 0.02
        return out
    return get


def train(
    cfg: ModelConfig,
    tcfg: TrainConfig,
    num_steps: int,
    batch: int,
    seq: int,
    key: Union[torch.Generator, Dict[str, PyTree]],
    ckpt_dir: Optional[str] = None,
    save_every: int = 50,
    log_every: int = 10,
    device: DeviceLike = None,
) -> Tuple[Dict[str, PyTree], Dict[str, list]]:
    """Single-host training loop with checkpoint/restart fault tolerance.

    ``key``: a ``torch.Generator`` for a fresh state on ``device``, or a
    ready state (which fixes the device).  With ``ckpt_dir`` the run starts
    from the newest complete checkpoint there (step and state) and runs
    ``num_steps`` more under a :class:`~repro_torch.training.fault_tolerance.Supervisor`
    that saves every ``save_every`` steps and at the end, and restores and
    replays on a failed step.  Each step's time ends with a device
    synchronisation."""
    if isinstance(key, torch.Generator):
        state = init_train_state(cfg, tcfg, key, device)
    else:
        state = key
    device = tr.leaves(state["params"])[0].device
    step_fn = make_train_step(cfg, tcfg)
    data = synthetic_batches(cfg, batch, seq)
    history: Dict[str, list] = {"loss": [], "step_time_s": []}

    start = 0
    if ckpt_dir:
        from repro_torch.training import checkpoint as ckpt

        if ckpt.latest_step(ckpt_dir) is not None:
            start, restored = ckpt.restore(ckpt_dir, {"state": state})
            state = restored["state"]

    def one_step(s: int, st):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(device) for k, v in data(s).items()}
        if "embeds" in b:
            b["embeds"] = b["embeds"].to(cfg.activation_dtype)
        st, metrics = step_fn(st, b)
        if s % log_every == 0:
            history["loss"].append(float(metrics["loss"]))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        history["step_time_s"].append(time.perf_counter() - t0)
        return st

    if ckpt_dir:
        from repro_torch.training.fault_tolerance import Supervisor

        sup = Supervisor(ckpt_dir, save_every=save_every)
        _, out = sup.run({"state": state},
                         lambda s, st: {"state": one_step(s, st["state"])},
                         start, num_steps)
        state = out["state"]
    else:
        for s in range(num_steps):
            state = one_step(s, state)
    return state, history
