"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run on the CPU at a small size (``tiny``), with one fault planted in the
program: a fold whose result is dropped (the state returned unchanged);
half of each block left out; an answer altered where it is produced.  No
cell runs on more than one card, so no exchange between cards can be
left out."""
import pytest

from perfbench import harness
from perfbench.tests import tiny


def _correct(run: harness.Run) -> bool:
    return harness.system(run.config["system"]).run(run).checks.ok


def test_sound_runs_are_correct():
    assert _correct(tiny.ingest(seconds=0.1))
    assert _correct(tiny.ingest(seed=8, seconds=0.1))


@pytest.mark.parametrize("fault", ["state_unchanged", "half_block", "answer_altered"])
def test_ingest_fault_is_caught(fault, monkeypatch):
    from repro_torch.kernels.ops import KernelSketch

    update, query = KernelSketch.update, KernelSketch.query
    if fault == "state_unchanged":   # the fold runs, its result is dropped
        def unchanged(self, items, freqs):
            before = self.table.clone()
            update(self, items, freqs)
            self.table.copy_(before)

        monkeypatch.setattr(KernelSketch, "update", unchanged)
    elif fault == "half_block":
        monkeypatch.setattr(KernelSketch, "update", lambda self, items, freqs: update(
            self, items[: len(items) // 2], freqs[: len(freqs) // 2]))
    else:
        def altered(self, items):
            out = query(self, items).copy()
            out[0] += 1
            return out

        monkeypatch.setattr(KernelSketch, "query", altered)
    assert not _correct(tiny.ingest(seconds=0.1))
