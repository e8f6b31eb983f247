"""Port parity: conservative (Estan-Varghese) counting.

The plain versions of K5 and K5i, ``core.sketch``'s conservative folds,
``KernelSketch(mode="conservative")``, the conservative hierarchy, the
endpoint and the engine over it are held against the JAX reference on the
CPU, with the reference's own hash draws handed to the port.  Blocks carry
many duplicate keys and zero-frequency rows; int32 cells sit near 2^31 so
``min + f`` wraps.  Tolerance 0 (exact equality) for int32 and float32
tables: gather, min, add and max are exact in both.  The kernels
themselves run on the card (tests/test_torch_cuda.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hashing as rh
from repro.core import hierarchy as rhh
from repro.core import sketch as rsk
from repro.kernels import ops as rops
from repro.serving import sketch_engine as rse
from repro.streams import zipf_hh_workload as r_zipf_hh_workload
from repro_torch.core import hashing as ph
from repro_torch.core import hierarchy as phh
from repro_torch.core import sketch as psk
from repro_torch.kernels import ops as pops
from repro_torch.kernels import sketch_update_conservative as psc
from repro_torch.kernels.hashes import make_plan
from repro_torch.launch.mesh import Mesh
from repro_torch.serving import sketch_engine as pse
from repro_torch.streams import zipf_hh_workload

DOMAINS = (1 << 32, 256, 1000, 70_000)
PARTITION = [(3, 1), (0,), (2,)]
RANGES = (16, 9, 7)
KEY = jax.random.PRNGKey(11)
NEAR_TOP = (1 << 31) - 20_000          # int32 cells this high wrap within a block
DTYPES = {"int32": (torch.int32, jnp.int32), "float32": (torch.float32, jnp.float32)}


def _specs(w=3, partition=PARTITION, ranges=RANGES):
    return (rsk.mod_sketch_spec(rh.KeySchema(DOMAINS), partition, ranges, w),
            psk.mod_sketch_spec(ph.KeySchema(DOMAINS), partition, ranges, w))


def _block(n, seed, n_keys=40, fmax=3000):
    """Zipf-ish block over ``n_keys`` distinct keys (many duplicates), with
    zero-frequency rows mixed in."""
    rng = np.random.default_rng(seed)
    keys = np.stack([rng.integers(0, d, n_keys, dtype=np.uint64).astype(np.uint32)
                     for d in DOMAINS], axis=1)
    items = keys[(rng.zipf(1.4, n) - 1) % n_keys]
    freqs = rng.integers(0, fmax, n).astype(np.int64)
    freqs[rng.random(n) < 0.15] = 0
    return items, freqs


def _table(shape, dtype, seed, high):
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, 4000, shape)
    if high:
        vals = vals + NEAR_TOP
    return vals.astype(np.int32 if dtype == "int32" else np.float32)


def _params(rspec, pspec, key=KEY):
    rp = rsk.init_params(rspec, key)
    return rp, psk.resolve_params(pspec, (np.asarray(rp.q), np.asarray(rp.r)), "cpu")


@pytest.mark.parametrize("dtype,high", [("int32", False), ("int32", True),
                                        ("float32", False)])
@pytest.mark.parametrize("w", [3, 4, 5])
def test_conservative_fold_matches_reference(w, dtype, high):
    """The plain K5i (through ``sk.conservative_fold``) against the
    reference's jnp fori_loop, at given indices with heavy collisions."""
    rng = np.random.default_rng(w)
    h, b = 37, 400
    idx = rng.integers(0, 8, (w, b)) * 4 + rng.integers(0, 2, (w, b))  # few cells
    freqs = rng.integers(0, 30_000 if high else 3000, b).astype(np.int64)
    freqs[::7] = 0
    table = _table((w, h), dtype, w, high)
    want = np.asarray(rsk.conservative_fold(jnp.asarray(table),
                                            jnp.asarray(idx.astype(np.uint32)),
                                            jnp.asarray(freqs)))
    got = psk.conservative_fold(torch.from_numpy(table), torch.from_numpy(idx), freqs)
    assert got.dtype == DTYPES[dtype][0]
    np.testing.assert_array_equal(got.numpy(), want)
    if high:   # some est wrapped: the same fold without wraparound differs
        wide = psk.conservative_fold(torch.from_numpy(table.astype(np.int64)),
                                     torch.from_numpy(idx), freqs)
        assert int(wide.max()) >= 1 << 31 and int(want.min()) > 0
    # the plain K5i folds several tables in one call, each at its own cells
    t2 = _table((w, 11), dtype, w + 1, high)
    idx2 = idx % 11
    want2 = np.asarray(rsk.conservative_fold(jnp.asarray(t2),
                                             jnp.asarray(idx2.astype(np.uint32)),
                                             jnp.asarray(freqs)))
    both = psc.conservative_fold_tables(
        [torch.from_numpy(table.copy()), torch.from_numpy(t2.copy())],
        [torch.from_numpy(idx), torch.from_numpy(idx2)], torch.from_numpy(freqs))
    np.testing.assert_array_equal(both[0].numpy(), want)
    np.testing.assert_array_equal(both[1].numpy(), want2)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("jit", [False, True])
def test_update_conservative_matches_reference(jit, dtype):
    tdt, jdt = DTYPES[dtype]
    rspec, pspec = _specs(w=4)
    rp, pp = _params(rspec, pspec)
    rstate = rsk.SketchState(rp, jnp.zeros((4, rspec.table_size), jdt))
    pstate = psk.init_state(pspec, (pp.q, pp.r), dtype=tdt, device="cpu")
    for seed in range(3):
        items, freqs = _block(300, seed)
        if jit:
            rstate = rsk.update_conservative_jit(rspec, rstate, jnp.asarray(items),
                                                 jnp.asarray(freqs))
            before = pstate.table
            pstate = psk.update_conservative_jit(pspec, pstate, items, freqs)
            assert pstate.table is before                      # in place
        else:
            rstate = rsk.update_conservative(rspec, rstate, jnp.asarray(items),
                                             jnp.asarray(freqs))
            before = pstate.table.clone()
            new = psk.update_conservative(pspec, pstate, items, freqs)
            assert torch.equal(pstate.table, before)           # a copy
            pstate = new
        np.testing.assert_array_equal(pstate.table.numpy(), np.asarray(rstate.table))
    # never below the linear table of the same draw, never below the truth
    lin = psk.build_sketch(pspec, (pp.q, pp.r), *_block(300, 0), device="cpu")
    first = psk.update_conservative(
        pspec, psk.init_state(pspec, (pp.q, pp.r), device="cpu"), *_block(300, 0))
    assert bool((first.table <= lin.table).all())


@pytest.mark.parametrize("dtype", ["int32", "int64", "float32"])
def test_conservative_frequency_refusals_match_reference(dtype):
    tdt = getattr(torch, dtype)
    bad = [np.array([1, -1, 2]), np.array([1.0, np.nan, 2.0]),
           np.array([1, 1 << 31, 2], np.int64), np.array([1, (1 << 31) + 5.0])]
    for freqs in bad:
        want = got = None
        try:
            rsk.check_conservative_freqs(freqs, getattr(jnp, dtype))
        except ValueError as e:
            want = str(e)
        try:
            psk.check_conservative_freqs(freqs, tdt)
        except ValueError as e:
            got = str(e)
        assert got == want
    psk.check_conservative_freqs(np.array([0, 5, (1 << 31) - 1]), torch.int32)
    psk.check_conservative_freqs(np.zeros(0), torch.int32)

    rspec, pspec = _specs()
    _, pp = _params(rspec, pspec)
    ks = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu", mode="conservative",
                           dtype=tdt)
    items, _ = _block(3, 0)
    for freqs in bad[:2]:
        with pytest.raises(ValueError, match="non-negative"):
            ks.update(items, freqs)
    assert int(ks.table.abs().sum()) == 0                   # refused = untouched


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_k5_matches_update_conservative_jit(dtype):
    """The plain K5 (hash, then fold in stream order) on the padded layout
    against the reference's jnp update on the same draw."""
    tdt, jdt = DTYPES[dtype]
    rspec, pspec = _specs(w=5)
    rp, pp = _params(rspec, pspec)
    plan = make_plan(pspec)
    h, h_pad = pspec.table_size, 1024
    items, freqs = _block(700, 3)
    table = _table((5, h), dtype, 1, high=dtype == "int32")
    want = rsk.update_conservative_jit(
        rspec, rsk.SketchState(rp, jnp.asarray(table)), jnp.asarray(items),
        jnp.asarray(freqs)).table
    padded = torch.zeros((5, h_pad), dtype=tdt)
    padded[:, :h] = torch.from_numpy(table)
    chunks = pspec.schema.module_chunks(torch.from_numpy(items.astype(np.int64)))
    psc.sketch_update_conservative(plan, padded, chunks, torch.from_numpy(freqs),
                                   pp.q, pp.r)
    np.testing.assert_array_equal(padded[:, :h].numpy(), np.asarray(want))
    assert int(padded[:, h:].abs().sum()) == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_sketch_conservative_matches_reference_kernel(dtype):
    """A small case against the reference's own Pallas K5 in interpret mode:
    the padded table, the queries and the state_dict in both directions."""
    tdt, jdt = DTYPES[dtype]
    rspec, pspec = _specs(w=3, partition=[(0, 1), (2, 3)], ranges=(12, 10))
    ref = rops.KernelSketch(rspec, KEY, tile_h=128, block_b=128, dtype=jdt,
                            interpret=True, mode="conservative")
    sd = ref.state_dict()
    port = pops.KernelSketch(pspec, (sd["params.q"], sd["params.r"]), tile_h=128,
                             block_b=100, dtype=tdt, device="cpu", mode="conservative")
    for seed in range(2):
        items, freqs = _block(150, seed)
        ref.update(items, freqs)
        port.update(items, freqs)
    np.testing.assert_array_equal(port.table.numpy(), np.asarray(ref.table))
    q = _block(60, 9)[0]
    np.testing.assert_array_equal(port.query(q), ref.query(q))
    psd, rsd = port.state_dict(), ref.state_dict()
    assert psd.keys() == rsd.keys()
    for k in rsd:
        assert psd[k].dtype == rsd[k].dtype, k
        np.testing.assert_array_equal(psd[k], rsd[k], err_msg=k)
    back = rops.KernelSketch(rspec, jax.random.PRNGKey(99), tile_h=128, block_b=128,
                             dtype=jdt, interpret=True, mode="conservative")
    back.load_state_dict(psd)
    np.testing.assert_array_equal(np.asarray(back.table), port.table.numpy())
    again = pops.KernelSketch(pspec, torch.Generator().manual_seed(1), tile_h=128,
                              dtype=tdt, device="cpu", mode="conservative")
    again.load_state_dict(rsd)
    assert torch.equal(again.table, port.table)
    np.testing.assert_array_equal(again.query(q), ref.query(q))


def test_kernel_sketch_conservative_refusals():
    rspec, pspec = _specs()
    _, pp = _params(rspec, pspec)
    cons = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu", mode="conservative")
    lin = pops.KernelSketch(pspec, (pp.q, pp.r), device="cpu")
    for a, b in ((cons, lin), (lin, cons)):
        with pytest.raises(ValueError, match="not linear"):
            a.merge(b)
    with pytest.raises(ValueError, match="cell-wise merge"):
        cons.state()
    with pytest.raises(ValueError, match="only defined for linear tables"):
        cons.sharded_update(None, ("data",), np.zeros((2, 4), np.uint32), np.ones(2))
    with pytest.raises(ValueError, match="signed-mode estimator"):
        cons.query_rows(np.zeros((2, 4), np.uint32))
    assert cons.table_view().shape == (3, pspec.table_size)
    rhspec, phspec = (rhh.HierarchySpec.from_spec(rspec),
                      phh.HierarchySpec.from_spec(pspec))
    with pytest.raises(ValueError) as got:
        pops.KernelHierarchy(phspec, (pp.q, pp.r), device="cpu", mode="conservative")
    with pytest.raises(ValueError) as want:
        rops.KernelHierarchy(rhspec, KEY, mode="conservative")
    assert str(got.value) == str(want.value)
    state = phh.init_hierarchy(phspec, (pp.q, pp.r), device="cpu")
    with pytest.raises(ValueError, match="only defined for linear tables"):
        phh.sharded_hierarchy_build(phspec, state, None, ("data",), None, None,
                                    mode="conservative")
    # the linear sharded build runs (tests/test_torch_sharded.py holds it
    # against the reference) and equals the serial fold
    mesh = Mesh((2,), ("data",), ["cpu", "cpu"])
    m = phspec.base.schema.modularity
    items = (np.arange(4 * m, dtype=np.uint32).reshape(4, m) * 37) % 251
    built = phh.sharded_hierarchy_build(phspec, state, mesh, ("data",), items,
                                        np.ones(4, np.int32))
    serial = phh.update(phspec, state, items, np.ones(4, np.int32))
    assert all(torch.equal(a.table, b.table) for a, b in zip(built.states, serial.states))


def test_residency_rule_switch_point():
    """Shared memory while the table fits one CTA's 227 KB beside the
    staging buffers of one chunk, global beyond."""
    limit = psc.SHARED_BYTES
    assert limit == 232_448
    assert [psc.index_chunk(w) for w in (1, 3, 4, 5, 40, 5000)] == [1024, 1024, 1024,
                                                                     819, 102, 1]
    assert psc.staging_bytes(4, 4) == 1024 * (16 + 4)
    for w in (1, 3, 4, 5, 40):
        cols = (limit - psc.staging_bytes(w, 4)) // (4 * w)
        assert psc.residency(w, cols, 4) == "shared"
        assert psc.residency(w, cols + 1, 4) == "global"
    assert psc.residency(5, 4096, 4) == "shared"             # the accuracy path
    assert psc.residency(4, 4096, 4) == "shared"             # main path, level 0
    assert psc.residency(4, 4096 * 4096, 4) == "global"      # main path, level 1
    assert psc.residency(4, 13_248, 4) == "shared"
    assert psc.residency(4, 13_249, 4) == "global"
    assert psc.residency(3, 100, 4, shared_bytes=100) == "global"


# --------------------------------------------------------------------------
# the hierarchy, the endpoint and the engine
# --------------------------------------------------------------------------

def _hspecs(w=3):
    rspec, pspec = _specs(w=w)
    return rhh.HierarchySpec.from_spec(rspec), phh.HierarchySpec.from_spec(pspec)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("jit", [False, True])
def test_hierarchy_update_conservative_matches_reference(jit, dtype):
    tdt, jdt = DTYPES[dtype]
    rspec, pspec = _hspecs(w=4)
    rstate = rhh.init_hierarchy(rspec, KEY, dtype=jdt)
    fine = rstate.states[-1].params
    pstate = phh.init_hierarchy(pspec, (np.asarray(fine.q), np.asarray(fine.r)),
                                dtype=tdt, device="cpu")
    rfold = rhh.update_conservative_jit if jit else rhh.update_conservative
    pfold = phh.update_conservative_jit if jit else phh.update_conservative
    for seed in range(3):
        items, freqs = _block(250, 20 + seed)
        rstate = rfold(rspec, rstate, jnp.asarray(items), jnp.asarray(freqs))
        tables = [st.table for st in pstate.states]
        new = pfold(pspec, pstate, items, freqs)
        assert all((a is b) == jit for a, b in zip(tables, (s.table for s in new.states)))
        pstate = new
        for lvl, (a, b) in enumerate(zip(rstate.states, pstate.states)):
            np.testing.assert_array_equal(b.table.numpy(), np.asarray(a.table),
                                          err_msg=f"level {lvl}")


CAP = 120


@functools.lru_cache(maxsize=1)
def _workload():
    kw = dict(n_src=200, n_tgt=400, n_edges=1500, n_occurrences=12_000, seed=6)
    wl, rwl = zipf_hh_workload(**kw), r_zipf_hh_workload(**kw)
    np.testing.assert_array_equal(wl.stream.items, rwl.stream.items)
    return wl


def _blocks(stream, sizes=(300, 128, 411)):
    out, s, i = [], 0, 0
    while s < stream.items.shape[0]:
        e = min(stream.items.shape[0], s + sizes[i % len(sizes)])
        out.append((stream.items[s:e], stream.freqs[s:e]))
        s, i = e, i + 1
    return out


def _endpoints(use_update_kernel=False, use_kernel=False):
    wl = _workload()
    schema = wl.stream.schema
    rspec = rsk.mod_sketch_spec(schema, [(0,), (1,)], (48, 32), 3)
    pspec = psk.mod_sketch_spec(ph.KeySchema(schema.domains), [(0,), (1,)], (48, 32), 3)
    ref = rse.SketchTopKEndpoint(rspec, KEY, max_candidates_per_group=CAP,
                                 mode="conservative")
    sd = ref.state_dict()
    port = pse.SketchTopKEndpoint(
        pspec, (sd["params.q"], sd["params.r"]), max_candidates_per_group=CAP,
        use_update_kernel=use_update_kernel, use_kernel=use_kernel,
        mode="conservative", device="cpu")
    return wl, ref, port


def _assert_sd_equal(want, got):
    assert want.keys() == got.keys()
    for k in want:
        assert want[k].dtype == got[k].dtype, k
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def _assert_answer_equal(want, got):
    np.testing.assert_array_equal(want[0], got[0])
    np.testing.assert_array_equal(want[1], got[1])


@pytest.mark.parametrize("use_update_kernel", [False, True])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_endpoint_conservative_matches_reference(use_update_kernel, use_kernel):
    wl, ref, port = _endpoints(use_update_kernel, use_kernel)
    assert port._kh is None                      # per-level folds, as the reference
    for items, freqs in _blocks(wl.stream):
        ref.ingest(items, freqs)
        port.ingest(items, freqs)
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    thr = max(1, wl.stream.total // 200)
    _assert_answer_equal(ref.heavy_hitters(thr), port.heavy_hitters(thr))
    _assert_answer_equal(ref.topk(10), port.topk(10))
    _assert_answer_equal(ref.topk(7, min_threshold=5), port.topk(7, min_threshold=5))
    # tighter than the linear endpoint on the same draw, cell by cell
    sd = ref.state_dict()
    lin = pse.SketchTopKEndpoint(port.hspec.base, (sd["params.q"], sd["params.r"]),
                                 max_candidates_per_group=CAP, device="cpu")
    lin.ingest(wl.stream.items, wl.stream.freqs)
    for a, b in zip(port.state.states, lin.state.states):
        assert bool((a.table <= b.table).all())
    # state_dict round trip both ways
    back = rse.SketchTopKEndpoint(ref.hspec.base, jax.random.PRNGKey(5),
                                  max_candidates_per_group=CAP, mode="conservative")
    back.load_state_dict(port.state_dict())
    _assert_sd_equal(ref.state_dict(), back.state_dict())
    again = pse.SketchTopKEndpoint(port.hspec.base, torch.Generator().manual_seed(2),
                                   max_candidates_per_group=CAP, mode="conservative",
                                   device="cpu")
    again.load_state_dict(ref.state_dict())
    _assert_sd_equal(ref.state_dict(), again.state_dict())
    _assert_answer_equal(ref.topk(10), again.topk(10))


def test_endpoint_conservative_refusals_match_reference():
    wl, ref, port = _endpoints()
    rlin = rse.SketchTopKEndpoint(ref.hspec.base, KEY, max_candidates_per_group=CAP)
    sd = rlin.state_dict()
    plin = pse.SketchTopKEndpoint(port.hspec.base, (sd["params.q"], sd["params.r"]),
                                  max_candidates_per_group=CAP, device="cpu")
    items, freqs = _blocks(wl.stream)[0]
    calls = {
        "merge_from": lambda ep, other: ep.merge_from(other),
        "merge_from (source)": lambda ep, other: other.merge_from(ep),
        "negative": lambda ep, other: ep.ingest(items[:4], np.array([1, -1, 1, 1])),
        "range": lambda ep, other: ep.ingest(items[:4], np.full(4, 1 << 31, np.int64)),
        "to_sharded": lambda ep, other: ep.to_sharded(None),
        "begin_migration": lambda ep, other: ep.begin_migration(
            ep.hspec.base, None, warmup=10),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError) as want:
            call(ref, rlin)
        with pytest.raises(ValueError) as got:
            call(port, plin)
        assert str(got.value) == str(want.value), name
    with pytest.raises(ValueError, match="conservative updates read the tables"):
        ref.stage_block(items, freqs)
    with pytest.raises(ValueError, match="conservative updates read the tables"):
        port.stage_block(items, freqs)
    assert port.total == 0 and all(len(p.values()) == 0 for p in port._pools)
    with pytest.raises(ValueError, match="mode must be"):
        pse.SketchTopKEndpoint(port.hspec.base, torch.Generator(), mode="nope",
                               device="cpu")
    eng = pse.SketchServeEngine(port)
    assert not eng._can_pipeline()


@pytest.mark.parametrize("max_staleness", [0, None])
def test_engine_over_conservative_endpoint_matches_reference(max_staleness):
    wl, ref, port = _endpoints(use_kernel=True)
    reng = rse.SketchServeEngine(ref, max_staleness=max_staleness)
    peng = pse.SketchServeEngine(port, max_staleness=max_staleness)
    thr = max(1, wl.stream.total // 300)
    for i, (items, freqs) in enumerate(_blocks(wl.stream)):
        reng.ingest(items, freqs)
        peng.ingest(items, freqs)
        if i % 3 == 1:
            _assert_answer_equal(reng.heavy_hitters(thr), peng.heavy_hitters(thr))
    reng.sync()
    peng.sync()
    _assert_sd_equal(ref.state_dict(), port.state_dict())
    for eng in (reng, peng):
        for k in (1, 5, 20):
            eng.submit_topk(k)
        eng.submit_heavy_hitters(thr)
    for a, b in zip(reng.flush(), peng.flush()):
        assert a.rid == b.rid and b.done
        _assert_answer_equal((a.items, a.est), (b.items, b.est))
    _assert_answer_equal(reng.topk(12), peng.topk(12))
