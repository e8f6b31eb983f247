"""A serving run whose timed path is broken underneath comes out not
correct, and each control put in the program's place fails a limit.

The runs skip the harness's look for a card and drive the rest of a run of
the serving cell on the CPU at a small size (``tiny_serve``), in float32
(the cell's limits are set from bf16 runs at its own size, where many
more tokens are compared), with one fault of ``faults_serve`` planted in
the program: a decode step that leaves the cache as it was (its keys and
values never written); a decode step that reads the cache one position
short; one expert a token in place of two; a served token altered after
its logits were computed.  No cell serves on more than one card, and
serving takes no mean over a batch, so no exchange or half batch can be
left out."""
import pytest

from perfbench import faults_serve, harness
from perfbench.reference import mixtral as ref
from perfbench.systems import model_serve as ms
from perfbench.tests import tiny_serve


def _run(run: harness.Run) -> harness.Outcome:
    return ms.run(run)


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_sound_serving_runs_are_correct(seed):
    out = _run(tiny_serve.serve(seed=seed))
    assert out.checks.ok and set(out.checks.values) == set(out.checks.limits)
    assert out.attempted == 4 and out.end_to_end["serve_tokens_per_s"] > 0


@pytest.mark.parametrize("fault", faults_serve.FAULTS)
def test_serving_fault_is_caught(fault):
    with faults_serve.planted(fault):
        out = _run(tiny_serve.serve(seed=7))
    assert not out.checks.ok


@pytest.mark.parametrize("control", ["e4m3", "top1", "short"])
def test_control_fails_a_limit(control):
    run = tiny_serve.serve(seed=7)
    out = _run(run)
    m, tf = run.config["model"], run.traffic
    prompts, sampled = harness.generator(tf["generator"]).generate(
        run.config, tf, harness.seed_for(run.seed, 1))
    checked = ms.checked_requests(prompts, sampled, out.details["served"][-1:])
    variant = {"e4m3": ref.Variant(matmul="e4m3"), "top1": ref.Variant(top_k=1),
               "short": ref.Variant(short_from=int(tf["prompt_tokens"]))}[control]
    weights = ms.make_weights(m, run.seed, "cpu", run.config["query_key_gain"])
    got = ms.compare(m, weights, checked, [],
                     int(tf["prompt_tokens"]), "cpu", variant)
    limits = run.cell["limits"]
    assert any(got[k] > v for k, v in limits.items())
