"""Port parity: windowed hierarchies, the windowed service and the
DStream harness.

The port's ``core.window`` ring (one concatenated buffer a slot) and its
``WindowedTopKService`` are held against the reference's jnp paths on the
same seeded blocks and the reference's own hash draw: merged window tables
bitwise equal for tumbling, landmark and decay (0.5 and 0.9, float32 tables
through the Horner recurrence) before and after the ring wraps; the
incremental running sum equal to the lazy merge; ``state_dict``s equal key
for key; a reference service's ``state_dict`` loaded into the port answers
``heavy_hitters``/``topk`` the same, order included; ``merge_from`` and the
refusals; the harness's reports and the exact counter's decay weights.
Tolerance 0 throughout.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import sketch as rsk
from repro.core import window as rwin
from repro.serving.windowed_topk import WindowedTopKService as RefService
from repro.streams import dstream as rds
from repro.streams import ngram_hh_workload as r_ngram_hh_workload
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch import interop
from repro_torch.core import sketch as psk
from repro_torch.core import window as win
from repro_torch.core.hashing import KeySchema
from repro_torch.device import kernel_switch
from repro_torch.serving.sketch_engine import SketchServeEngine, SketchTopKEndpoint
from repro_torch.serving.windowed_topk import WindowedTopKService
from repro_torch.streams import dstream as pds
from repro_torch.streams import ngram_hh_workload, zipf_hh_workload

KEY = jax.random.PRNGKey(7)
MODES = [("tumbling", 1.0), ("landmark", 1.0), ("decay", 0.5), ("decay", 0.9)]


@functools.lru_cache(maxsize=None)
def _workload(which: str):
    if which == "zipf":
        kw = dict(n_src=500, n_tgt=800, n_edges=3_000, n_occurrences=20_000, seed=3)
        wl, rwl = zipf_hh_workload(**kw), r_zipf_hh_workload(**kw)
    else:
        kw = dict(vocab_size=128, n=2, n_sequences=16, seq_len=128, seed=3)
        wl, rwl = ngram_hh_workload(**kw), r_ngram_hh_workload(**kw)
    np.testing.assert_array_equal(wl.stream.items, rwl.stream.items)
    np.testing.assert_array_equal(wl.stream.freqs, rwl.stream.freqs)
    return wl


def _specs(stream, ranges=(32, 32), w=3):
    return (rsk.mod_sketch_spec(stream.schema, [(0,), (1,)], ranges, w),
            psk.mod_sketch_spec(KeySchema(stream.schema.domains), [(0,), (1,)],
                                ranges, w))


def _epoch_blocks(stream, n_epochs: int):
    edges = np.linspace(0, len(stream.items), n_epochs + 1).astype(int)
    return [(stream.items[s:e], stream.freqs[s:e])
            for s, e in zip(edges[:-1], edges[1:])]


def _wspecs(stream, n_epochs, mode, decay):
    rspec, pspec = _specs(stream)
    return (rwin.WindowSpec(base=rspec, n_epochs=n_epochs, mode=mode, decay=decay),
            win.WindowSpec(base=pspec, n_epochs=n_epochs, mode=mode, decay=decay))


def _qr(rstate):
    fine = rstate.level_params[-1]
    return np.asarray(fine.q), np.asarray(fine.r)


def _assert_tables(got_states, want_states):
    assert len(got_states) == len(want_states)
    for g, w in zip(got_states, want_states):
        got, want = g.table.cpu().numpy(), np.asarray(w.table)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)       # bitwise, floats included


@pytest.mark.parametrize("mode,decay", MODES)
@pytest.mark.parametrize("n_epochs,total_epochs", [(3, 7), (5, 2)])
def test_merged_state_matches_reference(mode, decay, n_epochs, total_epochs):
    wl = _workload("zipf")
    rw, pw = _wspecs(wl.stream, n_epochs, mode, decay)
    blocks = _epoch_blocks(wl.stream, total_epochs)
    rstate = rwin.init_window(rw, KEY)
    pstate = win.init_window(pw, _qr(rstate), device="cpu")
    for b, (it, fr) in enumerate(blocks):
        if b:
            rstate = rwin.advance_window(rw, rstate)
            pstate = win.advance_window(pw, pstate)
        rstate = rwin.window_update(rw, rstate, it, fr)
        pstate = win.window_update(pw, pstate, it, fr)
        assert win.live_slots(pw, pstate) == rwin.live_slots(rw, rstate)
        _assert_tables(win.merged_state(pw, pstate).states,
                       rwin.merged_state(rw, rstate).states)
    for slot, tables in zip(pstate.ring, rstate.ring):
        for view, want in zip(win.level_views(pw, slot), tables):
            np.testing.assert_array_equal(view.numpy(), np.asarray(want))
    live = blocks if mode == "landmark" else blocks[-n_epochs:]
    _assert_tables(win.reference_window_state(pw, _qr(rstate), live, device="cpu").states,
                   rwin.reference_window_state(rw, KEY, live).states)
    # the ring carried across by interop merges the same
    carried = interop.window_state_from_numpy(
        pw, *_qr(rstate), [[np.asarray(t) for t in s] for s in rstate.ring],
        [np.asarray(t) for t in rstate.retired], rstate.head, rstate.epoch, device="cpu")
    _assert_tables(win.merged_state(pw, carried).states,
                   rwin.merged_state(rw, rstate).states)


@pytest.mark.parametrize("mode,decay", [("tumbling", 1.0), ("landmark", 1.0), ("decay", 0.9)])
def test_retired_is_held_in_landmark_mode_only(mode, decay):
    _, pw = _wspecs(_workload("zipf").stream, 3, mode, decay)
    st = win.init_window(pw, torch.Generator(), device="cpu")
    assert len(st.ring) == 3
    assert (st.retired is not None) == (mode == "landmark")


@pytest.mark.parametrize("surface", ["windowed", "endpoint"])
def test_kernel_switches_follow_the_tables_device(surface):
    assert kernel_switch(None, torch.device("cuda")) and kernel_switch(None, "cuda:0")
    assert not kernel_switch(None, torch.device("cpu"))
    assert kernel_switch(True, "cpu") and not kernel_switch(False, "cuda")
    _, pspec = _specs(_workload("zipf").stream)

    def build(**kw):
        if surface == "windowed":
            return WindowedTopKService(pspec, torch.Generator(), n_epochs=2,
                                       device="cpu", **kw)
        return SketchTopKEndpoint(pspec, torch.Generator(), device="cpu", **kw)

    def switches(s):
        return (s.use_kernel, s.use_update_kernel if surface == "windowed"
                else s._kh is not None)

    assert switches(build()) == (False, False)
    assert switches(build(use_kernel=True, use_update_kernel=True)) == (True, True)


def test_decay_refuses_int_tables_and_subtract_is_exact():
    wl = _workload("zipf")
    _, pw = _wspecs(wl.stream, 3, "decay", 0.5)
    with pytest.raises(ValueError, match="float table dtype"):
        win.init_window(pw, torch.Generator(), dtype=torch.int32, device="cpu")
    _, tw = _wspecs(wl.stream, 3, "tumbling", 1.0)
    st = win.init_window(tw, torch.Generator(), device="cpu")
    blocks = _epoch_blocks(wl.stream, 3)
    for b, (it, fr) in enumerate(blocks):
        if b:
            st = win.advance_window(tw, st)
        st = win.window_update(tw, st, it, fr)
    whole = win.merged_stack(tw, st)
    oldest = st.ring[win.live_slots(tw, st)[0]]
    rest = win.merge_sum([st.ring[s] for s in win.live_slots(tw, st)[1:]])
    assert torch.equal(win.subtract_tables(whole, oldest), rest)


def _services(mode, decay, *, n_epochs=3, incremental=True, **flags):
    wl = _workload("zipf")
    rspec, pspec = _specs(wl.stream)
    ref = RefService(rspec, KEY, n_epochs=n_epochs, window_mode=mode, decay=decay,
                     max_candidates_per_group=150, incremental=incremental)
    sd = ref.state_dict()
    port = WindowedTopKService(pspec, (sd["params.q"], sd["params.r"]), n_epochs=n_epochs,
                               window_mode=mode, decay=decay,
                               max_candidates_per_group=150, incremental=incremental,
                               device="cpu", **flags)
    return wl, ref, port


def _assert_sd_equal(want: dict, got: dict):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _assert_answer_equal(want, got):
    assert got[0].dtype == np.uint32 and got[1].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def _drive(services, blocks, per_epoch=2):
    for b, (it, fr) in enumerate(blocks):
        if b and b % per_epoch == 0:
            for s in services:
                s.advance()
        for s in services:
            s.ingest(it, fr)


@pytest.mark.parametrize("mode,decay", MODES)
@pytest.mark.parametrize("use_update_kernel,use_kernel", [(False, False), (True, True)])
def test_service_matches_reference(mode, decay, use_update_kernel, use_kernel):
    wl, ref, port = _services(mode, decay, use_update_kernel=use_update_kernel,
                              use_kernel=use_kernel)
    _drive([ref, port], _epoch_blocks(wl.stream, 11))
    assert port.total == ref.total and port.epoch == ref.epoch
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    _assert_tables(port.state().states, ref.state().states)
    for got, want in zip(port.candidates(), ref.candidates()):
        np.testing.assert_array_equal(got, want)
    thr = max(1, port.total // 50)
    _assert_answer_equal(ref.heavy_hitters(thr), port.heavy_hitters(thr))
    _assert_answer_equal(ref.topk(10), port.topk(10))


@pytest.mark.parametrize("mode", ["tumbling", "landmark"])
def test_incremental_equals_lazy(mode):
    wl, ref, inc = _services(mode, 1.0)
    _, _, lazy = _services(mode, 1.0, incremental=False)
    assert inc.incremental and not lazy.incremental
    blocks = _epoch_blocks(wl.stream, 7)
    for b, (it, fr) in enumerate(blocks):
        if b:
            inc.advance()
            lazy.advance()
        inc.ingest(it, fr)
        lazy.ingest(it, fr)
        _assert_tables(inc.state().states, lazy.state().states)
        _assert_answer_equal(lazy.topk(8), inc.topk(8))


@pytest.mark.parametrize("mode,decay", MODES)
def test_reference_state_dict_loads_into_port(mode, decay):
    wl, ref, port = _services(mode, decay)
    _drive([ref], _epoch_blocks(wl.stream, 9))
    sd = ref.state_dict()
    port.load_state_dict(sd)
    _assert_sd_equal(sd, port.state_dict())
    thr = max(1, ref.total // 40)
    _assert_answer_equal(ref.heavy_hitters(thr), port.heavy_hitters(thr))
    _assert_answer_equal(ref.topk(12), port.topk(12))
    # the service runs on after the restore exactly as the reference does
    extra = _epoch_blocks(wl.stream, 4)[:2]
    _drive([ref, port], extra, per_epoch=1)
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    bad = dict(sd, **{"meta.fingerprint": np.frombuffer(b"nope", dtype=np.uint8)})
    with pytest.raises(ValueError, match="fingerprint"):
        port.load_state_dict(bad)


@pytest.mark.parametrize("mode", ["tumbling", "landmark"])
@pytest.mark.parametrize("other_incremental", [True, False])
def test_merge_from_matches_reference(mode, other_incremental):
    wl, ra, pa = _services(mode, 1.0)
    _, rb, pb = _services(mode, 1.0, incremental=other_incremental)
    blocks = _epoch_blocks(wl.stream, 10)
    _drive([ra, pa], blocks[0::2])
    _drive([rb, pb], blocks[1::2])
    ra.merge_from(rb)
    pa.merge_from(pb)
    _assert_sd_equal(ra.state_dict(), pa.state_dict())
    _assert_answer_equal(ra.topk(10), pa.topk(10))


def test_merge_from_refuses_mismatches():
    wl, _, a = _services("tumbling", 1.0)
    _, _, b = _services("landmark", 1.0)
    with pytest.raises(ValueError, match="identical WindowSpecs"):
        a.merge_from(b)
    _, _, c = _services("tumbling", 1.0)
    c.advance()
    with pytest.raises(ValueError, match="aligned epoch clocks"):
        a.merge_from(c)
    d = WindowedTopKService(a.wspec.base, torch.Generator().manual_seed(3), n_epochs=3,
                            max_candidates_per_group=150, device="cpu")
    with pytest.raises(ValueError, match="identical hash params"):
        a.merge_from(d)


def test_conservative_refusals():
    wl = _workload("zipf")
    _, pspec = _specs(wl.stream)
    with pytest.raises(ValueError, match="only defined for linear tables"):
        WindowedTopKService(pspec, torch.Generator(), n_epochs=2, mode="conservative",
                            device="cpu")
    _, pw = _wspecs(wl.stream, 2, "tumbling", 1.0)
    with pytest.raises(ValueError, match="only defined for linear tables"):
        win.init_window(pw, torch.Generator(), mode="conservative", device="cpu")
    st = win.init_window(pw, torch.Generator(), device="cpu")
    with pytest.raises(ValueError, match="only defined for linear tables"):
        win.window_update(pw, st, wl.stream.items[:4], wl.stream.freqs[:4],
                          mode="conservative")


def test_window_spec_validation():
    _, pspec = _specs(_workload("zipf").stream)
    with pytest.raises(ValueError, match="n_epochs"):
        win.WindowSpec(base=pspec, n_epochs=0)
    with pytest.raises(ValueError, match="mode must be"):
        win.WindowSpec(base=pspec, n_epochs=2, mode="sliding")
    with pytest.raises(ValueError, match="decay in"):
        win.WindowSpec(base=pspec, n_epochs=2, mode="decay", decay=1.5)
    assert repr(win.WindowSpec(base=pspec, n_epochs=2)) == repr(
        rwin.WindowSpec(base=_specs(_workload("zipf").stream)[0], n_epochs=2))


@pytest.mark.parametrize("mode,decay", [("tumbling", 1.0), ("landmark", 1.0),
                                        ("decay", 0.9)])
@pytest.mark.parametrize("which", ["zipf", "ngram"])
def test_dstream_harness_matches_reference(mode, decay, which):
    wl = _workload(which)
    rspec, pspec = _specs(wl.stream)
    ref = RefService(rspec, KEY, n_epochs=3, window_mode=mode, decay=decay,
                     max_candidates_per_group=400)
    sd = ref.state_dict()
    port = WindowedTopKService(pspec, (sd["params.q"], sd["params.r"]), n_epochs=3,
                               window_mode=mode, decay=decay, max_candidates_per_group=400,
                               use_kernel=True, use_update_kernel=True, device="cpu")
    rh = rds.DStreamHarness(ref, k=16, phi=0.01, sample_p=0.05, sample_seed=2)
    ph = pds.DStreamHarness(port, k=16, phi=0.01, sample_p=0.05, sample_seed=2)
    items, freqs = wl.stream.items, wl.stream.freqs
    want = rh.run(rds.timestamped_batches(items, freqs, 10, batches_per_epoch=2))
    got = ph.run(pds.timestamped_batches(items, freqs, 10, batches_per_epoch=2))
    assert [dataclasses.asdict(r) for r in got] == [dataclasses.asdict(r) for r in want]
    if mode != "decay":
        assert all(r.recall == 1.0 for r in got)
    for a, b in zip(ph.sample(), rh.sample()):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="non-decreasing"):
        ph.step(pds.Batch(t=0, items=items[:3], freqs=freqs[:3]))


@pytest.mark.parametrize("mode,decay", [("tumbling", 1.0), ("landmark", 1.0),
                                        ("decay", 0.5), ("decay", 0.9)])
def test_exact_window_counter_matches_reference(mode, decay):
    wl = _workload("zipf")
    ref, port = rds.ExactWindowCounter(3, mode, decay), pds.ExactWindowCounter(3, mode, decay)
    for b, (it, fr) in enumerate(_epoch_blocks(wl.stream, 6)):
        if b:
            ref.advance()
            port.advance()
        ref.ingest(it, fr)
        port.ingest(it, fr)
        assert port.window_counts() == ref.window_counts()
    with pytest.raises(ValueError, match="unknown mode"):
        pds.ExactWindowCounter(2, "sliding")


def test_batch_generators_match_reference():
    wl = _workload("zipf")
    pairs = [
        (pds.timestamped_batches(wl.stream.items, wl.stream.freqs, 7, 3),
         rds.timestamped_batches(wl.stream.items, wl.stream.freqs, 7, 3)),
        (pds.drifting_batches((1 << 32, 1 << 32), 6, 500, batches_per_epoch=2, seed=1),
         rds.drifting_batches((1 << 32, 1 << 32), 6, 500, batches_per_epoch=2, seed=1)),
        (pds.skew_flip_batches((1 << 32, 1 << 32), 6, 500, seed=4),
         rds.skew_flip_batches((1 << 32, 1 << 32), 6, 500, seed=4)),
    ]
    for got, want in pairs:
        got, want = list(got), list(want)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.t == w.t
            np.testing.assert_array_equal(g.items, w.items)
            np.testing.assert_array_equal(g.freqs, w.freqs)


def test_engine_over_windowed_service_matches_service():
    wl, ref, port = _services("tumbling", 1.0, use_kernel=True, use_update_kernel=True)
    eng = SketchServeEngine(port, max_staleness=0)
    blocks = _epoch_blocks(wl.stream, 8)
    for b, (it, fr) in enumerate(blocks):
        if b and b % 2 == 0:
            eng.advance()
            ref.advance()
        eng.ingest(it, fr)
        ref.ingest(it, fr)
        thr = max(1, ref.total // 30)
        _assert_answer_equal(ref.heavy_hitters(thr), eng.heavy_hitters(thr))
        _assert_answer_equal(ref.topk(6), eng.topk(6))
