"""The serving cell's parts on the CPU: its generator, its FLOP and byte
counts, its plain reference against the port, its readers, and its
manifest entries."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from perfbench import calibrate_serve, counts_serve, harness, trace
from perfbench.reference import mixtral as ref
from perfbench.systems import model_serve as ms
from perfbench.tests import tiny_serve

CELL = "mixtral-8x22b.decode"
GAIN = harness.config_of(harness.manifest(), harness.workload(harness.manifest(), CELL))[
    "query_key_gain"]
# by hand: hd 2, one kv head; attention 16 + 16 + 16, an expert 3 * 4 * 3
HAND = {"n_layers": 1, "d_model": 4, "n_heads": 2, "n_kv_heads": 1, "d_ff": 3,
        "vocab_size": 5, "n_experts": 4, "top_k": 2}


def test_token_cohorts():
    gen = harness.generator("token_cohorts")
    config = {"model": {"vocab_size": 50}}
    traffic = {"pool_cohorts": 3, "slots": 4, "prompt_tokens": 7, "zipf_s": 1.1,
               "sampled_slots": 2}
    prompts, sampled = gen.generate(config, traffic, 5)
    again, same = gen.generate(config, traffic, 5)
    other, _ = gen.generate(config, traffic, 6)
    assert prompts.shape == (3, 4, 7) and prompts.dtype == np.int64   # one length a cohort
    assert np.array_equal(prompts, again) and np.array_equal(sampled, same)
    assert not np.array_equal(prompts, other)
    assert prompts.min() >= 0 and prompts.max() < 50
    assert sampled.shape == (3, 2) and all(len(set(row)) == 2 for row in sampled.tolist())
    assert sampled.min() >= 0 and sampled.max() < 4
    # Zipf: the most frequent id of many draws takes far more than 1/50
    many, _ = gen.generate(config, {**traffic, "prompt_tokens": 2000}, 5)
    assert np.bincount(many.ravel()).max() / many.size > 0.1


def test_counts_by_hand():
    assert counts_serve.attn_params(HAND) == 48 and counts_serve.expert_params(HAND) == 36
    assert counts_serve.token_flops(HAND) == 2 * (48 + 4 * 4 + 2 * 36)
    assert counts_serve.head_flops(HAND) == 40
    assert counts_serve.attention_flops(HAND, 6) == 4 * 2 * 2 * 6
    # two prompts of 3: 3 tokens, one head, 1 + 2 + 3 keys seen
    assert counts_serve.prefill_flops(HAND, 2, 3) == 2 * (3 * 272 + 40 + 16 * 6)
    assert counts_serve.decode_flops(HAND, 2, 3) == 2 * (272 + 40 + 16 * 4)
    # weights 112 + router 64 + final norm 8 + head 40 + embedding rows 16; three
    # experts 216; cache of 4 positions 64; new keys and values 16, logits 40
    assert counts_serve.decode_bytes(HAND, 2, 3, [3]) == 240 + 216 + 64 + 56


def test_counts_at_the_cells_size():
    m = harness.config_of(harness.manifest(), harness.workload(harness.manifest(), CELL))["model"]
    every = counts_serve.decode_bytes(m, 16, 1024, [8] * 7)
    assert 35.0e9 < every < 36.5e9          # the stage's weights dominate a step
    per_token = counts_serve.token_flops(m) / 2
    assert 4.8e9 < per_token < 4.9e9        # 7 x (88M + 49K + 2 x 302M)


def _reduced():
    from repro_torch.configs import mixtral_8x22b

    fields = {k: getattr(mixtral_8x22b.REDUCED, k) for k in
              ("name", "family", "n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
               "vocab_size", "mlp_type", "n_experts", "top_k", "sliding_window",
               "rope_theta", "norm_eps")}
    # dropless (E / k), float32
    return {**fields, "capacity_factor": fields["n_experts"] / fields["top_k"],
            "dtype": "float32"}


def test_reference_matches_the_port_at_its_reduced_config():
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import transformer as tfm

    m = _reduced()
    weights = ms.make_weights(m, 3, "cpu", GAIN)
    tokens = torch.randint(0, m["vocab_size"], (3, 16), generator=torch.Generator().manual_seed(1))
    want = ref.logits(m, weights, tokens)             # 16 positions: the window of 16 is whole
    got, _ = tfm.forward(ModelConfig(**m), weights, tokens)
    assert torch.allclose(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    # the last position only, and a control that differs
    assert torch.equal(ref.logits(m, weights, tokens, first=15), want[:, 15:])
    top1 = ref.logits(m, weights, tokens, variant=ref.Variant(top_k=1))
    assert (top1 - want).abs().max() > 0.1 * want.abs().max()


def test_reference_controls():
    x = torch.randn(64, 32, generator=torch.Generator().manual_seed(2))
    q = ref.e4m3(x)
    assert not torch.equal(q, x) and (q - x).abs().max() <= x.abs().max() / 16
    assert torch.equal(ref.e4m3(q), q)                # e4m3 values are kept
    m = _reduced()
    weights = ms.make_weights(m, 4, "cpu", GAIN)
    tokens = torch.randint(0, m["vocab_size"], (1, 12), generator=torch.Generator().manual_seed(3))
    full = ref.logits(m, weights, tokens)
    short = ref.logits(m, weights, tokens, variant=ref.Variant(short_from=8))
    assert torch.allclose(short[:, :8], full[:, :8], rtol=0, atol=1e-5)   # the prompt is not touched
    assert not torch.allclose(short[:, 8:], full[:, 8:])


def test_position_readings_by_hand():
    r = torch.tensor([[0.0, 3.0, 1.0], [2.0, 0.0, 1.9]])
    p = torch.tensor([[0.0, 2.9, 1.0], [1.8, 0.0, 2.0]])      # slot 1 serves token 2
    per = ms.position_readings(r, torch.tensor([1, 2]), p)
    assert per["gap"].tolist() == pytest.approx([0.0, 0.1])
    assert per["agree"].tolist() == [True, False]
    assert per["err"].tolist() == pytest.approx([0.1 / 3.0, 0.2 / 2.0])
    assert per["unexplained"].tolist() == [False, False]       # 0.1 <= 0.2 + 0.1
    per = ms.position_readings(r, torch.tensor([0, 2]), p)     # a token altered after its logits
    assert per["unexplained"].tolist() == [True, False]
    got = ms.summary(per)
    assert got["served_tokens_unexplained"] == 1 and got["served_gap_max"] == pytest.approx(3.0)


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _readings(counters):
    ev = [_x("user_annotation", harness.WINDOW_SPAN, 0, 1000),
          _x("user_annotation", ms.PREFILL_SPAN, 10, 100),
          _x("cuda_runtime", "cudaLaunchKernel", 20, 2, corr=1),
          _x("kernel", "gemm", 30, 300, tid=7, corr=1),
          _x("gpu_memset", "Memset", 335, 5, tid=7, corr=2),
          _x("cuda_runtime", "cudaMemsetAsync", 40, 2, corr=2)]
    for i, start in enumerate((400, 600)):      # two decode steps of two kernels each
        ev += [_x("user_annotation", ms.DECODE_SPAN, start, 50),
               _x("cuda_runtime", "cudaLaunchKernel", start + 5, 2, corr=10 + 2 * i),
               _x("cuda_runtime", "cudaLaunchKernel", start + 9, 2, corr=11 + 2 * i),
               _x("kernel", "bmm", start + 20, 60, tid=7, corr=10 + 2 * i),
               _x("kernel", "add", start + 80, 20, tid=7, corr=11 + 2 * i)]
    # a launch outside every span is nobody's
    ev += [_x("cuda_runtime", "cudaLaunchKernel", 900, 2, corr=99),
           _x("kernel", "argmax", 910, 10, tid=7, corr=99)]
    return harness.Readings(trace=trace.parse({"traceEvents": ev}), window_us=(0.0, 1000.0),
                            window_s=0.001, counters=counters)


def test_serve_readers_on_a_trace_by_hand():
    counters = {"cohort_flops": 4.947e9, "cohort_s": 0.001, "decode_bytes": 536.0e3, "decode_steps": 2,
                "prefill_span": ms.PREFILL_SPAN, "decode_span": ms.DECODE_SPAN}
    r = _readings(counters)

    def read(name):
        return harness.metric_reader(name).read(r)

    assert read("decode_ms.serve") == pytest.approx(0.08)       # (60 + 20) us a step
    assert read("prefill_ms.serve") == pytest.approx(0.305)     # the GEMM and the set
    assert read("decode_ops.serve") == pytest.approx(2.0)
    # 536 kB / 3.35 TB/s = 0.16 us over 160 us of decode
    assert read("decode_bw_share") == pytest.approx(100 * 0.16 / 160)
    # a cohort of 4.947 GFLOP in 1 ms = 4.947 TFLOP/s of 989.4
    assert read("serve_mfu") == pytest.approx(0.5)
    assert read("idle_pct.serve") == pytest.approx(100 * (1 - 475 / 1000))


def test_serve_readers_find_nothing_where_nothing_is():
    names = ["decode_ms.serve", "prefill_ms.serve", "decode_ops.serve", "decode_bw_share",
             "serve_mfu"]
    # the ingest cell's counters: no serving span, no FLOPs
    r = _readings({"blocks": 3, "fold_bytes": 10, "update_span": "perfbench.update"})
    assert all(harness.metric_reader(n).read(r) is None for n in names)
    # the serving spans, with no launch inside them
    empty = harness.Readings(
        trace=trace.parse({"traceEvents": [_x("user_annotation", harness.WINDOW_SPAN, 0, 10),
                                           _x("user_annotation", ms.DECODE_SPAN, 1, 2)]}),
        window_us=(0.0, 10.0), window_s=1e-5,
        counters={"cohort_flops": 0, "cohort_s": 0.0, "decode_bytes": 0, "prefill_span": ms.PREFILL_SPAN,
                  "decode_span": ms.DECODE_SPAN})
    assert all(harness.metric_reader(n).read(empty) is None for n in names)


def test_a_traced_run_on_the_cpu():
    run = tiny_serve.serve(seed=9, dtype="bfloat16")
    run.trace = True
    run.cell["trace_decode_steps"] = 3
    out = ms.run(run)
    assert out.checks.ok
    c = out.readings.counters
    m = run.config["model"]
    assert c["decode_steps"] == 3 and c["decode_bytes"] > 0
    # a whole cohort: the prefill of 4 x 24 and 7 decode steps, at 24 .. 30
    assert c["cohort_flops"] == (counts_serve.prefill_flops(m, 4, 24) + sum(
        counts_serve.decode_flops(m, 4, p) for p in range(24, 31)))
    # one untraced cohort timed, then one traced
    assert c["cohort_s"] > 0 and out.attempted == 8
    assert len(out.readings.trace.spans(ms.DECODE_SPAN)) == 3
    assert len(out.readings.trace.spans(ms.PREFILL_SPAN)) == 1


def test_the_cells_entries():
    man = harness.manifest()
    wl = harness.workload(man, CELL)
    assert wl["chips"] == 1 and harness.config_of(man, wl)["system"] == "model_serve"
    assert {m["name"] for m in harness.end_to_end_metrics(man, CELL)} == {
        "serve_tokens_per_s", "peak_mem_gb", "setup_s"}
    assert {m["name"] for m in harness.per_layer_metrics(man, CELL)} == {
        "serve_mfu", "decode_ms.serve", "prefill_ms.serve", "decode_ops.serve",
        "decode_bw_share", "idle_pct.serve"}
    # the ingest cell reports nothing of serving
    assert "serve_tokens_per_s" not in {
        m["name"] for m in harness.end_to_end_metrics(man, "twitter-cu.ingest")}
    config = harness.config_of(man, wl)
    assert config["model"]["n_layers"] == 7 and config["published"]["num_hidden_layers"] == 56
    assert config["model"]["capacity_factor"] == (
        config["model"]["n_experts"] / config["model"]["top_k"])
    assert set(harness.cell(CELL)["limits"]) == {
        "logit_err_median", "served_gap_mean", "served_tokens_unexplained"}


def test_spread_is_the_interquartile_range_over_the_median():
    lines = [{"metrics": {"x": {"value": v}}} for v in (1.0, 2.0, 3.0, 4.0, 5.0)]
    got = calibrate_serve.spread(lines)["x"]
    assert got["median"] == 3.0 and got["spread"] == pytest.approx((4.5 - 1.5) / 3.0)


def test_the_reference_loads_no_jax_nor_the_program():
    body = f"""
import sys, json
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r}]
import torch
from perfbench.reference import mixtral
m = dict(n_layers=1, d_model=8, n_heads=2, n_kv_heads=1, d_ff=4, vocab_size=11, n_experts=4,
         top_k=2, rope_theta=1e6, norm_eps=1e-5)
w = {{"embed": torch.randn(11, 8), "lm_head": torch.randn(8, 11),
      "final_norm": {{"scale": torch.ones(8)}},
      "blocks": {{"layer_0": {{"norm1": {{"scale": torch.ones(1, 8)}},
                             "norm2": {{"scale": torch.ones(1, 8)}},
                             "attn": {{"wq": torch.randn(1, 8, 8), "wk": torch.randn(1, 8, 4),
                                      "wv": torch.randn(1, 8, 4), "wo": torch.randn(1, 8, 8)}},
                             "moe": {{"router": torch.randn(1, 8, 4), "w_gate": torch.randn(1, 4, 8, 4),
                                     "w_in": torch.randn(1, 4, 8, 4), "w_out": torch.randn(1, 4, 4, 8)}}}}}}}}
assert mixtral.logits(m, w, torch.tensor([[1, 2, 3]])).shape == (1, 3, 11)
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", body], capture_output=True, text=True,
                         timeout=240, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in loaded
    assert not loaded & (set(harness.FORBIDDEN) | {"repro_torch"})


def test_a_serving_run_loads_no_jax_nor_the_jax_package():
    body = f"""
import sys, json
sys.path[:0] = [{str(harness.ROOT)!r}, {str(harness.ROOT / 'src')!r}]
from perfbench import calibrate_serve, counts_serve, serve_spans
from perfbench.systems import model_serve
from perfbench.tests import tiny_serve
assert model_serve.run(tiny_serve.serve(seconds=0.0)).checks.ok
print(json.dumps(sorted({{k.split('.')[0] for k in sys.modules}})))
"""
    out = subprocess.run([sys.executable, "-c", body], capture_output=True, text=True,
                         timeout=240, cwd=harness.ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in loaded                  # the program ran
    assert not loaded & set(harness.FORBIDDEN)
