"""The model-serving system: the port's ``ServeEngine`` under its
``SlotScheduler`` (``repro_torch/serving/model_engine.py``), greedy, with a
static key/value cache, serving cohorts of equal-length prompts in a
closed loop.

Set-up: the prompts (the traffic's generator), the weights (seeded on the
device in the served types, :func:`make_weights`), the engine, and one
warm-up cohort of ``warmup_new_tokens`` tokens (every shape a cohort
uses).  The window serves the pool's cohorts one after another, each
through ``SlotScheduler.run``, and ends at the cohort boundary nearest to
``--seconds`` (at least one cohort): ``serve_tokens_per_s`` is the tokens
of its cohorts over its seconds; the last cohort returns its tokens to
the host, so the window ends synchronised.

The benchmark wraps the module attributes that the engine calls,
``transformer.prefill`` and ``transformer.decode_step`` (:class:`Tap`):
every call keeps, on the device, the float32 logits of the cohort's
sampled slots (one ``index_select`` a step, into one buffer that each
cohort overwrites).  A traced run serves two cohorts: the first untraced,
whose host seconds ``serve_mfu`` reads, and the second traced from its
start through ``trace_decode_steps`` decode steps, with the spans
``perfbench.prefill`` and ``perfbench.decode`` around the calls and
``moe.apply_moe`` wrapped to read the routing of the traced steps.

After the window, with the engine freed, the plain reference
(``reference/mixtral.py``) is run teacher-forced over the sampled requests
(prompt and served tokens) of the window's last cohort, whose logits the
one kept buffer then holds (so the peak does not grow with the number of
cohorts), and three numbers are compared (``cells/<cell>.json`` holds
their limits):

* ``logit_err_median``: the median, over the served positions, of
  max |program logit - reference logit| / max |reference logit|;
* ``served_gap_mean``: the mean gap by which a served token's reference
  logit lies below the reference's best;
* ``served_tokens_unexplained``: served tokens whose gap is more than the
  program's own logit errors at the two tokens allow.  A greedy server
  picks the largest of its logits p, so r_best - r_served <= |p_best -
  r_best| + |p_served - r_served| holds for every token it serves,
  whatever its precision; a token altered after its logits breaks it.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench import counts_serve, harness
from perfbench.reference import mixtral as ref

PREFILL_SPAN = "perfbench.prefill"
DECODE_SPAN = "perfbench.decode"
KEEP_SPAN = "perfbench.keep"
# float64 room of the served-token test, on differences of float32 logits
SLACK = 1e-6


def model_config(config: dict):
    from repro_torch.configs.base import ModelConfig

    return ModelConfig(**config["model"])


def make_weights(m: dict, seed: int, device, query_key_gain: float) -> dict:
    """The weights, in the tree ``transformer.prefill`` takes, drawn on
    ``device`` from the seed: one call a stacked leaf, in the served type.

    Each query head's projection is its own draw plus ``query_key_gain``
    times the key projection of the key/value head it shares, so a
    position's query matches its own key: with the gain at 1 a token that
    is not repeated puts most of each head's weight on itself, and a
    decode step's attention output depends on the key and value that it
    writes into the cache.  With independent draws (gain 0) each head
    spreads its weight over all ~1,000 positions and attention adds next
    to nothing to the logits."""
    g = torch.Generator(device=device).manual_seed(harness.seed_for(seed, 2))
    n, d, e, f, v = m["n_layers"], m["d_model"], m["n_experts"], m["d_ff"], m["vocab_size"]
    hd = d // m["n_heads"]
    q, kv = d, m["n_kv_heads"] * hd
    served = torch.bfloat16 if m["dtype"] == "bfloat16" else torch.float32

    def normal(shape, std, dtype=served):
        return torch.empty(shape, dtype=dtype, device=device).normal_(0.0, std, generator=g)

    def ones(*shape):
        return torch.ones(shape, dtype=served, device=device)

    wq, wk = normal((n, d, q), d ** -0.5), normal((n, d, kv), d ** -0.5)
    if query_key_gain:
        rep = m["n_heads"] // m["n_kv_heads"]
        wq += query_key_gain * wk.reshape(n, d, -1, hd).repeat_interleave(rep, 2).reshape(n, d, q)
    return {
        "embed": normal((v, d), 0.02),
        "lm_head": normal((d, v), d ** -0.5),
        "final_norm": {"scale": ones(d)},
        "blocks": {"layer_0": {
            "norm1": {"scale": ones(n, d)},
            "norm2": {"scale": ones(n, d)},
            "attn": {"wq": wq, "wk": wk,
                     "wv": normal((n, d, kv), d ** -0.5), "wo": normal((n, q, d), q ** -0.5)},
            "moe": {"router": normal((n, d, e), d ** -0.5, torch.float32),
                    "w_gate": normal((n, e, d, f), d ** -0.5),
                    "w_in": normal((n, e, d, f), d ** -0.5),
                    "w_out": normal((n, e, f, d), f ** -0.5)},
        }},
    }


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Tap:
    """The benchmark's wrappers around ``transformer.prefill`` and
    ``decode_step`` (and, traced, ``moe.apply_moe``): they keep each
    call's logits of the sampled slots and, while the traced window is
    open, record the spans and the routing, and close the window after
    ``trace_steps`` decode steps."""

    def __init__(self, device, window: harness.TracedWindow, trace_steps: int):
        from repro_torch.models import moe, transformer

        self.tfm, self.moe = transformer, moe
        self.orig = (transformer.prefill, transformer.decode_step, moe.apply_moe)
        self.device, self.window, self.trace_steps = device, window, trace_steps
        self.kept: Optional[torch.Tensor] = None   # [new_tokens, sampled, vocab], the last cohort's
        self.tracing = False
        self.decode_pos: List[int] = []      # the traced decode steps' positions
        self.choices: List[torch.Tensor] = []
        self.t0 = 0.0
        self._slots = None
        self._step, self._in_decode = 0, False

    def __enter__(self):
        self.tfm.prefill, self.tfm.decode_step = self._prefill, self._decode
        if self.window.enabled:
            self.moe.apply_moe = self._apply_moe
        return self

    def __exit__(self, *exc):
        self.tfm.prefill, self.tfm.decode_step, self.moe.apply_moe = self.orig

    def cohort(self, slots: np.ndarray, new_tokens: int, vocab: int) -> None:
        self._slots = torch.as_tensor(slots, dtype=torch.int64, device=self.device)
        shape = (new_tokens, len(slots), vocab)
        if self.kept is None or self.kept.shape != shape:
            self.kept = torch.empty(shape, dtype=torch.float32, device=self.device)
        self._step = 0

    def open(self) -> None:
        self.window.open()
        self.tracing = self.window.enabled

    def close(self) -> None:
        if self.tracing:
            _sync(self.device)
            self.window.close(time.perf_counter() - self.t0)
            self.tracing = False

    def _span(self, name: str):
        return torch.profiler.record_function(name) if self.tracing else contextlib.nullcontext()

    def _keep(self, logits: torch.Tensor) -> None:
        with self._span(KEEP_SPAN):
            torch.index_select(logits, 0, self._slots, out=self.kept[self._step])
        self._step += 1

    def _prefill(self, cfg, params, tokens, embeds=None, max_len=None):
        with self._span(PREFILL_SPAN):
            logits, cache = self.orig[0](cfg, params, tokens, embeds=embeds, max_len=max_len)
        self._keep(logits)
        return logits, cache

    def _decode(self, cfg, params, cache, tokens_last, pos):
        self._in_decode = True
        try:
            with self._span(DECODE_SPAN):
                logits, cache = self.orig[1](cfg, params, cache, tokens_last, pos)
        finally:
            self._in_decode = False
        self._keep(logits[:, 0])
        if self.tracing:
            self.decode_pos.append(int(pos))
            if len(self.decode_pos) == self.trace_steps:
                self.close()
        return logits, cache

    def _apply_moe(self, cfg, p, x, groups=None):
        out, aux = self.orig[2](cfg, p, x, groups)
        if self.tracing and self._in_decode:
            self.choices.append(aux["expert_choice"])
        return out, aux


def serve_cohort(engine, tap: Tap, prompts: np.ndarray, sampled: np.ndarray,
                 new_tokens: int) -> np.ndarray:
    """One cohort through ``SlotScheduler.run`` -> served tokens int [slots, new_tokens]."""
    from repro_torch.serving.model_engine import Request, SlotScheduler

    sched = SlotScheduler(engine, len(prompts))
    for i, p in enumerate(prompts):
        sched.submit(Request(rid=i, prompt=p, max_new=new_tokens))
    tap.cohort(sampled, new_tokens, engine.cfg.padded_vocab)
    return np.asarray([req.out for req in sched.run()], dtype=np.int64)


def position_readings(r_logits: torch.Tensor, served: torch.Tensor,
                      p_logits: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Per served position ([..., V] logits, [...] tokens): the served
    token's ``gap`` below the reference's best, ``agree`` (the reference's
    best served) and, with the program's logits, ``err`` (max |p - r| over
    max |r|) and ``unexplained`` (a gap its logit errors do not allow)."""
    best = r_logits.argmax(-1)
    rb = r_logits.gather(-1, best[..., None])[..., 0].double()
    rs = r_logits.gather(-1, served[..., None])[..., 0].double()
    out = {"gap": rb - rs, "agree": best == served}
    if p_logits is not None:
        out["err"] = ((p_logits - r_logits).abs().amax(-1) / r_logits.abs().amax(-1)).double()
        pb = p_logits.gather(-1, best[..., None])[..., 0].double()
        ps = p_logits.gather(-1, served[..., None])[..., 0].double()
        out["unexplained"] = (rb - rs) - (pb - rb).abs() - (ps - rs).abs() > SLACK
    return out


def summary(per: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The numbers compared (and, beside them, the widest readings)."""
    out = {"served_gap_mean": float(per["gap"].mean()),
           "served_gap_max": float(per["gap"].max()),
           "argmax_agreement": float(per["agree"].double().mean())}
    if "err" in per:
        out.update(logit_err_median=float(per["err"].median()),
                   logit_err_max=float(per["err"].max()),
                   served_tokens_unexplained=int(per["unexplained"].sum()))
    return out


def checked_requests(prompts: np.ndarray, sampled: np.ndarray,
                     done: List[Tuple[int, np.ndarray]]) -> List[Tuple[np.ndarray, np.ndarray]]:
    """(token rows [sampled, prompt + new - 1], served [sampled, new]) of
    each cohort of the window: its sampled requests, teacher-forced."""
    out = []
    for c, served in done:
        rows = sampled[c]
        out.append((np.concatenate([prompts[c][rows], served[rows][:, :-1]], axis=1),
                    served[rows]))
    return out


def compare(m: dict, weights: dict, checked, kept: List[torch.Tensor], prompt: int,
            device, variant: ref.Variant = ref.Variant()) -> Dict[str, float]:
    """The reference over every checked request, a cohort's requests at a
    time; with ``kept`` (the program's logits of each, [new_tokens,
    sampled, vocab]) the program's readings, without, the readings of the
    variant put in the program's place."""
    parts: Dict[str, list] = {}
    for i, (rows, served) in enumerate(checked):
        tokens = torch.as_tensor(rows, device=device)
        r_logits = ref.logits(m, weights, tokens, first=prompt - 1)
        if kept:
            s = torch.as_tensor(served, device=device)
            per = position_readings(r_logits, s, kept[i].transpose(0, 1))
        else:
            v_logits = ref.logits(m, weights, tokens, first=prompt - 1, variant=variant)
            per = position_readings(r_logits, v_logits.argmax(-1), v_logits)
            del v_logits
        for k, x in per.items():
            parts.setdefault(k, []).append(x.reshape(-1).cpu())
        del r_logits
    return summary({k: torch.cat(v) for k, v in parts.items()})


def cohort_flops(m: dict, slots: int, prompt: int, new: int) -> int:
    """Model FLOPs of one cohort: its prefill and its ``new - 1`` decode steps."""
    return counts_serve.prefill_flops(m, slots, prompt) + sum(
        counts_serve.decode_flops(m, slots, prompt + i) for i in range(new - 1))


def _traced_readings(m: dict, tap: Tap, slots: int, prompt: int, new: int, untraced_s: float,
                     window) -> harness.Readings:
    trace, span = window.finish()
    steps = len(tap.decode_pos)
    decode_bytes = 0
    if tap.choices:
        # [steps, layers, tokens, k] -> distinct experts a step and layer
        ch = torch.stack(tap.choices).reshape(steps, m["n_layers"], -1)
        used = torch.zeros((steps, m["n_layers"], m["n_experts"]), dtype=torch.bool,
                           device=ch.device)
        used.scatter_(2, ch.long(), True)
        per_step = used.sum(-1).cpu().tolist()
        decode_bytes = sum(counts_serve.decode_bytes(m, slots, p, n)
                           for p, n in zip(tap.decode_pos, per_step))
    return harness.Readings(
        trace=trace, window_us=span, window_s=window.host_s,
        counters={"cohort_flops": cohort_flops(m, slots, prompt, new), "cohort_s": untraced_s,
                  "decode_bytes": decode_bytes, "decode_steps": steps,
                  "prefill_span": PREFILL_SPAN, "decode_span": DECODE_SPAN,
                  "keep_span": KEEP_SPAN})


def run(r: harness.Run) -> harness.Outcome:
    from repro_torch.serving.model_engine import ServeConfig, ServeEngine

    cfg, tf, dev = r.config, r.traffic, r.device
    m = cfg["model"]
    slots, prompt, new = int(tf["slots"]), int(tf["prompt_tokens"]), int(tf["new_tokens"])
    prompts, sampled = harness.generator(tf["generator"]).generate(
        cfg, tf, harness.seed_for(r.seed, 1))
    cuda = torch.device(dev).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    weights = make_weights(m, r.seed, dev, float(cfg["query_key_gain"]))
    engine = ServeEngine(model_config(cfg), weights,
                         ServeConfig(max_len=prompt + new, temperature=0.0, eos_id=-1))
    window = harness.TracedWindow(r.trace)
    with Tap(dev, window, int(r.cell.get("trace_decode_steps", 0))) as tap:
        serve_cohort(engine, tap, prompts[0], sampled[0], int(tf["warmup_new_tokens"]))
        _sync(dev)
        before = harness.host_snapshot()
        tap.t0 = t0 = time.perf_counter()
        setup_s = t0 - r.t_process
        done: List[Tuple[int, np.ndarray]] = []
        ends = []
        while True:
            if r.trace and len(done) == 1:               # the traced cohort
                window.start()
                tap.t0 = time.perf_counter()
                tap.open()
            c = 1 + len(done) % (len(prompts) - 1)       # pool cohort 0 warmed up
            done.append((c, serve_cohort(engine, tap, prompts[c], sampled[c], new)))
            ends.append(time.perf_counter() - t0)
            elapsed = ends[-1]
            # end at the cohort boundary nearest to --seconds; a traced run
            # serves one cohort untraced and one traced
            if r.trace:
                if len(done) == 2:
                    break
            elif elapsed + elapsed / len(done) / 2 >= r.seconds:
                break
        _sync(dev)
        window_s = time.perf_counter() - t0
        tap.close()
        host = harness.host_readings(before, harness.host_snapshot())
        host["cohort_s"] = np.diff([0.0] + ends).tolist()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    del engine
    if cuda:
        torch.cuda.empty_cache()

    checked = checked_requests(prompts, sampled, done[-1:])
    t_ref = time.perf_counter()
    got = compare(m, weights, checked, [tap.kept], prompt, dev)
    checks = harness.Checks(r.cell["limits"])
    for name in checks.limits:
        checks.add(name, got[name])
    details = {**got, "reference_s": time.perf_counter() - t_ref, "cohorts": len(done),
               "window_s": window_s, "served": done}
    readings = (_traced_readings(m, tap, slots, prompt, new, ends[0], window) if r.trace
                else None)
    n_tokens = len(done) * slots * new
    return harness.Outcome(
        attempted=len(done) * slots, failed=0,
        end_to_end={"serve_tokens_per_s": n_tokens / window_s, "setup_s": setup_s,
                    "peak_mem_gb": peak / 1e9},
        checks=checks, peak_bytes=peak, readings=readings, details=details, host=host)
