"""The program's spans (``repro_torch.tracing``): a shared no-op without a
profiler, one of each ingest span a ``KernelSketch.update`` under one,
nested on the calling thread (on a CPU table, and on the card through the
page-locked staging: marker ``gpu``), and no change to what the sketch
computes."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.core import sketch as sk
from repro_torch.core.hashing import KeySchema
from repro_torch.kernels.ops import MODES, KernelSketch

UPDATE = "repro_torch.ingest.update"
STEPS = ("repro_torch.ingest.check", "repro_torch.ingest.keys", "repro_torch.ingest.freqs")
KERNEL = "repro_torch.kernels.sketch_update_conservative"


def _sketch(mode, device="cpu"):
    spec = sk.mod_sketch_spec(KeySchema((1 << 32, 1 << 32)), [(0,), (1,)], (16, 16), 3)
    return KernelSketch(spec, torch.Generator().manual_seed(5), tile_h=128, block_b=64,
                        device=device, mode=mode)


def _block(seed, n=40):
    rng = np.random.default_rng(seed)
    items = rng.integers(0, 1 << 32, size=(n, 2), dtype=np.uint64).astype(np.uint32)
    items[n // 2:] = items[: n - n // 2]                # repeated keys
    return items, rng.integers(0, 9, size=n).astype(np.int64)


def test_no_record_function_without_a_profiler(monkeypatch):
    made = []
    real = torch.profiler.record_function

    def counted(name, *args, **kwargs):
        made.append(name)
        return real(name, *args, **kwargs)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    assert tracing.span("a") is tracing.span("b")
    for mode in MODES:
        _sketch(mode).update(*_block(1))
    assert made == []
    with profile(activities=[ProfilerActivity.CPU]):
        _sketch("linear").update(*_block(1))
    assert made and all(name.startswith("repro_torch.") for name in made)


def _spans_once_nested(ks, mode):
    items, freqs = _block(2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        ks.update(items, freqs)
    spans = {}
    for ev in prof.events():
        if ev.name.startswith("repro_torch."):
            assert ev.name not in spans, f"{ev.name} recorded twice"
            spans[ev.name] = ev
    inner = STEPS + ((KERNEL,) if mode == "conservative" else ())
    assert set(spans) == {UPDATE, *inner}
    outer = spans[UPDATE].time_range
    assert len({ev.thread for ev in spans.values()}) == 1
    for name in inner:
        t = spans[name].time_range
        assert outer.start <= t.start <= t.end <= outer.end, name
    order = [spans[name].time_range for name in inner]
    assert all(a.end <= b.start for a, b in zip(order, order[1:]))


@pytest.mark.parametrize("mode", MODES)
def test_update_records_each_span_once_nested(mode):
    _spans_once_nested(_sketch(mode), mode)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", MODES)
def test_staged_update_records_each_span_once_nested(mode):
    """The same spans where a host block crosses to the card through the
    page-locked ring."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ks = _sketch(mode, "cuda")
    _spans_once_nested(ks, mode)
    assert ks.staging.staged_blocks == 1


@pytest.mark.parametrize("mode", MODES)
def test_profiling_changes_nothing_computed(mode):
    plain, traced = _sketch(mode), _sketch(mode)
    blocks = [_block(s) for s in range(3, 6)]
    for items, freqs in blocks:
        plain.update(items, freqs)
    with profile(activities=[ProfilerActivity.CPU]):
        for items, freqs in blocks:
            traced.update(items, freqs)
    assert torch.equal(plain.table, traced.table)
    keys = np.concatenate([blocks[0][0][:10], _block(9)[0][:10]])
    assert np.array_equal(plain.query(keys), traced.query(keys))
